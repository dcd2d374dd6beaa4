"""The retrieval fine-tune slice with the CLIP-ViT vision tower: the losses
and gradients of XFMForRetrieval, three optimizer steps with no clip and the
eval encoders, against the JAX package at 384 px and a small width (2 layers
per encoder, width 128, 2 heads, B = 4, T = 8), and the run's entry point.

The JAX side is built by `config_from_yaml`'s CLIP branch
(`use_clip_vit: true`), as the port's `xfm_clip_retrieval_config` copies it.
At 384 px the tower has N = 577 tokens, so its self-attentions take the K3
dispatch on both sides: the port's plain version here, the JAX package's
Pallas kernel in interpret mode (its dispatch predicate, which asks for a
TPU, is widened to the CPU); the fusion cross-attention (Nq = 8) stays plain
on both. The ITM hard-negative pass takes the shared cross-k/v branch (577
image tokens).

Both sides run f32 (JAX matmuls at 'highest' precision, exact erf-GELU) on
the same weights, batch and hard negatives. Tolerances are those of
tests/test_torch_retrieval.py: losses rtol 1e-4; gradients and parameters
after 3 steps rtol 1e-3 / atol 1e-5 (parameters whose gradient is within f32
noise: atol lr·steps); encoder outputs atol 1e-5 / rtol 1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.configs import (batch_to_torch, make_clip_retrieval_run,
                                   make_retrieval_batch,
                                   xfm_clip_retrieval_config)
from xfm_tpu_torch.models import XFMForRetrieval
from xfm_tpu_torch.train.checkpoint import state_dict_from_jax
from xfm_tpu_torch.train.optim import create_optimizer
from xfm_tpu_torch.train.schedules import linear_warmup_decay
from xfm_tpu_torch.train.train_state import (TrainState, make_train_step,
                                             retrieval_loss_fn)
from _torch_threads import one_intra_op_thread  # noqa: F401

KW = dict(hidden=128, layers=2, heads=2, inter=256, vocab=99)
B, T, RES = 4, 8, 384
NEG = (np.array([1, 2, 3, 0]), np.array([2, 3, 0, 1]))
LR, STEPS = 1e-3, 3


def _yaml_config():
    """The reference YAML keys of Retrieval_coco.yaml with `use_clip_vit`
    and config_clipvitB.json's tower, cut to KW."""
    return {"use_clip_vit": True, "image_res": RES, "patch_size": 16,
            "_vision": {"vision_width": KW["hidden"], "patch_size": 16,
                        "hidden_act": "quick_gelu",
                        "num_attention_heads": KW["heads"],
                        "intermediate_size": KW["inter"],
                        "num_hidden_layers": KW["layers"],
                        "local_attn_depth": 4},
            "text_num_hidden_layers": KW["layers"],
            "fusion_num_hidden_layers": KW["layers"],
            "text_hidden_size": KW["hidden"],
            "text_num_attention_heads": KW["heads"],
            "text_intermediate_size": KW["inter"],
            "text_vocab_size": KW["vocab"], "embed_dim": 256, "temp": 0.07}


def _numpy_batch():
    nb = make_retrieval_batch(B, T, RES, KW["vocab"])
    nb["text_atts"][1, -3:] = 0  # one padded caption
    return nb


@pytest.fixture(scope="module")
def slice_setup():
    import xfm_tpu.models.losses as jlosses
    import xfm_tpu.ops.attention as jattn
    import xfm_tpu.ops.flash_attention as jfa
    from xfm_tpu.models.task_models import XFMForRetrieval as JRetrieval
    from xfm_tpu.models.xfm import config_from_yaml

    real_flash = jfa.flash_attention
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_EXACT_ERF", "1")
        mp.setattr(jattn, "_flash_ok", lambda q, k, rate, det:
                   q.shape[1] >= 512 and k.shape[1] >= 512)
        # (the custom_vjp's forward rule calls the module's name too)
        mp.setattr(jfa, "flash_attention",
                   lambda q, k, v, bias=None, scale=None, interpret=True:
                   real_flash(q, k, v, bias, scale, True))
        mp.setattr(jlosses, "hard_negative_indices",
                   lambda *a, **k: tuple(jnp.asarray(n) for n in NEG))
        jcfg = config_from_yaml(_yaml_config(), use_contrastive_loss=True,
                                use_matching_loss=True, dtype=jnp.float32)
        assert jcfg.vision_backbone == "clip_vit"
        jm = JRetrieval(jcfg)
        nb = _numpy_batch()
        jb = (jnp.asarray(nb["images"]),
              jnp.asarray(nb["text_ids"], jnp.int32),
              jnp.asarray(nb["text_atts"], jnp.int32))
        params = jax.jit(lambda: jm.init(
            {"params": jax.random.PRNGKey(0)}, *jb,
            method=JRetrieval.init_all)["params"])()
        r = np.random.RandomState(0)
        leaves, tree = jax.tree.flatten(params)
        params = jax.tree.unflatten(tree, [
            np.asarray(x) + 0.02 * np.asarray(r.randn(*x.shape), np.float32)
            for x in leaves])

        def loss(p):
            itc, itm = jm.apply({"params": p}, *jb, deterministic=True,
                                rngs={"hardneg": jax.random.PRNGKey(0)})
            return itc + itm, (itc, itm)

        yield dict(jcfg=jcfg, jm=jm, jb=jb, nb=nb, params=params,
                   value_and_grad=jax.jit(jax.value_and_grad(loss,
                                                             has_aux=True)))


def _port_model(setup):
    cfg = xfm_clip_retrieval_config(image_res=RES, dtype=torch.float32, **KW)
    model = XFMForRetrieval(cfg)
    model.load_state_dict(state_dict_from_jax(setup["params"],
                                              setup["jcfg"]), strict=True)
    return model


def _port_batch(setup):
    batch = batch_to_torch(setup["nb"], "cpu")
    batch["hard_negatives"] = tuple(torch.from_numpy(n) for n in NEG)
    return batch


def test_config_is_the_yaml_clip_branch(slice_setup):
    """The port's config carries the JAX config's CLIP tower and encoders
    field for field (dtypes aside)."""
    cfg = xfm_clip_retrieval_config(image_res=RES, dtype=torch.float32, **KW)
    j = slice_setup["jcfg"]
    assert cfg.vision_backbone == j.vision_backbone == "clip_vit"
    assert cfg.vision_width == j.vision_width == KW["hidden"]
    for name in ("image_res", "patch_size", "hidden_size",
                 "num_hidden_layers", "num_attention_heads",
                 "intermediate_size", "hidden_act", "layer_norm_eps",
                 "local_attn_depth", "num_patches"):
        assert getattr(cfg.vision, name) == getattr(j.vision, name), name
    for enc in ("text", "fusion"):
        for name in ("hidden_size", "num_hidden_layers", "fusion_layer",
                     "encoder_width", "hidden_act", "layer_norm_eps"):
            assert (getattr(getattr(cfg, enc), name)
                    == getattr(getattr(j, enc), name)), (enc, name)
    for name in ("embed_dim", "temp", "use_contrastive_loss",
                 "use_matching_loss", "use_mlm_loss", "use_bbox_loss"):
        assert getattr(cfg, name) == getattr(j, name), name


def test_clip_retrieval_losses_and_grads_match_jax(slice_setup):
    s = slice_setup
    (_, (jitc, jitm)), jgrads = s["value_and_grad"](s["params"])
    model = _port_model(s)
    total, out = retrieval_loss_fn(model, _port_batch(s))
    total.backward()
    np.testing.assert_allclose(out["loss_itc"].item(), float(jitc),
                               rtol=1e-4)
    np.testing.assert_allclose(out["loss_itm"].item(), float(jitm),
                               rtol=1e-4)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), s["jcfg"])
    for name, p in model.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        np.testing.assert_allclose(got, want[name].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    # the tower trains through ITC (the cls token) and ITM (cross-attention)
    for name in ("vision_encoder.encoder.layers.0.self_attn.q_proj.weight",
                 "vision_encoder.pos_embed.weight"):
        assert np.abs(want[name].numpy()).max() > 0, name


def test_three_optimizer_steps_match_jax(slice_setup):
    """make_train_step + HF-AdamW with no clip against optax, as in
    tests/test_torch_retrieval.py: elements whose gradient the two sides do
    not resolve to 1e-3 (sums that cancel to f32 noise, such as the key
    biases, whose gradient is zero) are held to atol = lr·steps."""
    from xfm_tpu.train.optim import create_optimizer as jcreate
    from xfm_tpu.train.schedules import linear_warmup_decay as jsched
    from xfm_tpu.train.train_state import TrainState as JState

    s = slice_setup
    jparams = jax.tree.map(jnp.asarray, s["params"])
    jstate = JState.create(jparams, jcreate(jparams, jsched(LR, 10, 0),
                                            clip_grad_norm=None))
    japply = jax.jit(lambda st, g: st.apply_gradients(g))
    model = _port_model(s)
    state = TrainState.create(model, create_optimizer(
        model, linear_warmup_decay(LR, 10, 0), clip_grad_norm=None))
    step = make_train_step(retrieval_loss_fn)
    batch = _port_batch(s)
    unresolved = {n: np.zeros(p.shape, bool)
                  for n, p in model.named_parameters()}
    for _ in range(STEPS):
        (jloss, _), g = s["value_and_grad"](jstate.params)
        jstate = japply(jstate, g)
        state, metrics = step(state, batch)
        loss = metrics["loss"]
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
        jg = state_dict_from_jax(jax.tree.map(np.asarray, g), s["jcfg"])
        for name, p in model.named_parameters():
            if p.grad is not None:
                want_g = jg[name].numpy()
                unresolved[name] |= (np.abs(p.grad.numpy() - want_g)
                                     > 1e-3 * np.abs(want_g))
    assert state.step == STEPS and state.optimizer.count == STEPS
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params),
                               s["jcfg"])
    for name, p in model.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        atol = np.where(unresolved[name], LR * STEPS, 1e-5)
        bad = np.abs(got - ref) > atol + 1e-3 * np.abs(ref)
        assert not bad.any(), (name, got[bad][:5], ref[bad][:5])


def test_encode_images_gives_the_post_ln_cls_features(slice_setup):
    """The eval's first stage: image embeds (post-LN over all tokens) and
    the features of their cls token, as the JAX package gives them."""
    from xfm_tpu.models.task_models import XFMForRetrieval as JRetrieval

    s = slice_setup
    jimg = s["jm"].apply({"params": s["params"]}, s["jb"][0],
                         method=JRetrieval.encode_images)
    model = _port_model(s)
    with torch.no_grad():
        img = model.encode_images(batch_to_torch(s["nb"], "cpu")["images"])
    assert img[0].shape == (B, 577, KW["hidden"])
    for got, want in zip(img, jimg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-4)


def test_make_clip_retrieval_run_on_the_cpu(monkeypatch):
    """The entry point at a tiny width: one step with finite losses, each
    vision self-attention (N = 577) through K3's dispatch and no text,
    fusion or cross-attention."""
    from xfm_tpu_torch.ops import flash_attention as fa

    calls = []
    real = fa.flash_attention

    def spy(q, k, v, bias=None, scale=None):
        calls.append((q.shape[1], k.shape[1]))
        return real(q, k, v, bias, scale)

    monkeypatch.setattr(fa, "flash_attention", spy)
    state, batch, step = make_clip_retrieval_run(
        B=2, T=8, device="cpu", hidden=64, layers=2, heads=1, inter=128,
        vocab=99)
    assert state.model.config.vision.num_patches == 576
    state, metrics = step(state, batch, torch.Generator().manual_seed(0))
    loss = metrics["loss"]
    assert torch.isfinite(loss) and state.step == 1
    assert calls == [(577, 577)] * 2
    with pytest.raises(NotImplementedError, match="MIM"):
        state.model.get_vision_embeds_pair(batch["images"], None)
