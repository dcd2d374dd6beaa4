"""The retrieval fine-tune slice: XFMForRetrieval losses and gradients, three
optimizer steps with no clip, the idx variants, the eval encoders and the
weight bridge, each against the JAX package at 384 px and a small width
(2 layers, width 64, 2 heads, B = 4, T = 8).

At 384 px the vision tower has N = 577 tokens, so the BEiT attention goes
through the rel-pos kernel's dispatch (K2) on both sides: the port's plain
version here, the JAX package's Pallas kernel in interpret mode (its
dispatch predicate, which asks for a TPU, is widened to the CPU). The ITM
hard-negative pass takes the shared cross-k/v branch on both sides (577
image tokens).

Both sides run f32 (JAX matmuls at 'highest' precision, exact erf-GELU) on
the same weights, batch and hard negatives (the JAX draw is replaced by
fixed indices; the port takes them as `hard_negatives`). Tolerances: losses
rtol 1e-4; gradients and parameters after 3 steps rtol 1e-3 / atol 1e-5
(parameters whose gradient is within f32 noise: atol lr·steps, see the
optimizer test); encoder outputs atol 1e-5 / rtol 1e-4.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
# bound before the slice fixture replaces the module's draw with fixed indices
from xfm_tpu.models.losses import hard_negative_indices as jax_hard_negatives

from xfm_tpu_torch.configs import (batch_to_torch, make_retrieval_batch,
                                   retrieval_step_flops,
                                   xfm_base_retrieval_config)
from xfm_tpu_torch.models import XFMForRetrieval
from xfm_tpu_torch.train.checkpoint import init_weights, state_dict_from_jax
from xfm_tpu_torch.train.optim import create_optimizer
from xfm_tpu_torch.train.schedules import linear_warmup_decay
from xfm_tpu_torch.train.train_state import (TrainState, make_train_step,
                                             retrieval_loss_fn)

KW = dict(hidden=64, layers=2, heads=2, inter=128, vocab=99)
B, T, RES = 4, 8, 384
NEG = (np.array([1, 2, 3, 0]), np.array([2, 3, 0, 1]))
IDX = np.array([0, 1, 0, 2])
LR, STEPS = 1e-3, 3


def _numpy_batch():
    nb = make_retrieval_batch(B, T, RES, KW["vocab"])
    nb["text_atts"][1, -3:] = 0  # one padded caption
    return nb


@pytest.fixture(scope="module")
def slice_setup():
    import xfm_tpu.models.losses as jlosses
    import xfm_tpu.ops.flash_attention as jfa
    from __graft_entry__ import _xfm_config
    from xfm_tpu.models.task_models import XFMForRetrieval as JRetrieval

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_BENCH_ACT", "gelu")
        mp.setenv("XFM_EXACT_ERF", "1")
        mp.setattr(jfa, "relpos_inkernel_ok",
                   lambda n, w: n == w[0] * w[1] + 1 and n >= 512)
        mp.setattr(jfa, "beit_attention_relpos",
                   functools.partial(jfa.beit_attention_relpos,
                                     interpret=True))
        mp.setattr(jlosses, "hard_negative_indices",
                   lambda *a, **k: tuple(jnp.asarray(n) for n in NEG))
        jcfg = _xfm_config(dtype=jnp.float32, image_res=RES, **KW)
        jm = JRetrieval(jcfg)
        nb = _numpy_batch()
        jb = (jnp.asarray(nb["images"]), jnp.asarray(nb["text_ids"], jnp.int32),
              jnp.asarray(nb["text_atts"], jnp.int32))
        params = jax.jit(lambda: jm.init(
            {"params": jax.random.PRNGKey(0)}, *jb,
            method=JRetrieval.init_all)["params"])()
        r = np.random.RandomState(0)
        leaves, tree = jax.tree.flatten(params)
        params = jax.tree.unflatten(tree, [
            np.asarray(x) + 0.02 * np.asarray(r.randn(*x.shape), np.float32)
            for x in leaves])

        def loss(p, idx=None):
            itc, itm = jm.apply({"params": p}, *jb, idx=idx,
                                deterministic=True,
                                rngs={"hardneg": jax.random.PRNGKey(0)})
            return itc + itm, (itc, itm)

        yield dict(jcfg=jcfg, jm=jm, jb=jb, nb=nb, params=params,
                   value_and_grad=jax.jit(jax.value_and_grad(loss,
                                                             has_aux=True)),
                   losses_idx=jax.jit(lambda p, idx: loss(p, idx)[1]))


def _port_model(setup):
    cfg = xfm_base_retrieval_config(image_res=RES, dtype=torch.float32, **KW)
    model = XFMForRetrieval(cfg)
    model.load_state_dict(state_dict_from_jax(setup["params"],
                                              setup["jcfg"]), strict=True)
    return model


def _port_batch(setup):
    batch = batch_to_torch(setup["nb"], "cpu")
    batch["hard_negatives"] = tuple(torch.from_numpy(n) for n in NEG)
    return batch


def test_retrieval_losses_and_grads_match_jax(slice_setup):
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
    # the fine-tune's ITM trains the text encoder through the fusion pass
    # (the pretrain step detaches it): its last layer's gradient is not ITC's
    # alone
    name = "text_encoder.roberta.encoder.layer.1.output.dense.weight"
    assert np.abs(want[name].numpy()).max() > 0


def test_three_optimizer_steps_match_jax(slice_setup):
    """make_train_step + HF-AdamW with no clip (the fine-tune recipe)
    against optax. Adam divides each gradient by its own magnitude, so an
    element whose gradient the two sides do not resolve to 1e-3 (a sum that
    cancels to f32 noise: the key biases, whose gradient is zero, and a few
    patch-kernel entries at 384 px) moves by up to ~lr per step on either
    side: those elements are held to atol = lr·steps, all others to rtol
    1e-3 / atol 1e-5."""
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
        state, loss = step(state, batch)
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


def test_idx_variant_of_itc_matches_jax(slice_setup):
    """Rows 0 and 2 show the same image: ITC spreads their positive mass."""
    s = slice_setup
    jitc, jitm = s["losses_idx"](s["params"], jnp.asarray(IDX))
    batch = _port_batch(s)
    batch["idx"] = torch.from_numpy(IDX)
    _, out = retrieval_loss_fn(_port_model(s), batch)
    np.testing.assert_allclose(out["loss_itc"].item(), float(jitc),
                               rtol=1e-4)
    np.testing.assert_allclose(out["loss_itm"].item(), float(jitm),
                               rtol=1e-4)


def test_idx_variant_of_the_negative_mask_matches_jax():
    """With idx, a row never draws a row of its own image; over 2000 draws
    the port's and the JAX function's frequencies match the weights
    softmax(sim/temp) + 1e-5 with every same-image pair zeroed (numpy),
    within 0.04 (about 4 standard errors)."""
    from xfm_tpu_torch.models.losses import hard_negative_indices

    r = np.random.RandomState(5)
    img = r.randn(B, 8).astype(np.float32)
    txt = r.randn(B, 8).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    temp, n = 0.5, 2000
    same = IDX[:, None] == IDX[None, :]

    def weights(sim):
        e = np.exp(sim - sim.max(1, keepdims=True))
        w = np.where(same, 0.0, e / e.sum(1, keepdims=True) + 1e-5)
        return w / w.sum(1, keepdims=True)

    ti, tt, tidx = (torch.from_numpy(x) for x in (img, txt, IDX))
    g = torch.Generator().manual_seed(0)
    draws = [hard_negative_indices(g, ti, tt, torch.tensor(temp), idx=tidx)
             for _ in range(n)]
    jimage, jtext = jax.jit(jax.vmap(lambda k: jax_hard_negatives(
        k, jnp.asarray(img), jnp.asarray(txt), temp,
        idx=jnp.asarray(IDX))))(jax.random.split(jax.random.PRNGKey(0), n))
    sim = img @ txt.T / temp
    rows = np.arange(B)
    for neg, w in ((torch.stack([d[1] for d in draws]).numpy(), weights(sim)),
                   (torch.stack([d[0] for d in draws]).numpy(),
                    weights(sim.T)),
                   (np.asarray(jtext), weights(sim)),
                   (np.asarray(jimage), weights(sim.T))):
        assert not np.any(same[rows, neg])
        freq = np.stack([np.bincount(neg[:, i], minlength=B) for i in rows])
        np.testing.assert_allclose(freq / n, w, atol=0.04)


def test_encode_images_and_texts_match_jax(slice_setup):
    from xfm_tpu.models.task_models import XFMForRetrieval as JRetrieval

    s = slice_setup
    images, ids, atts = s["jb"]
    jimg = s["jm"].apply({"params": s["params"]}, images,
                         method=JRetrieval.encode_images)
    jtxt = s["jm"].apply({"params": s["params"]}, ids, atts,
                         method=JRetrieval.encode_texts)
    model = _port_model(s)
    batch = batch_to_torch(s["nb"], "cpu")
    with torch.no_grad():
        img = model.encode_images(batch["images"])
        txt = model.encode_texts(batch["text_ids"], batch["text_atts"])
    for got, want in zip(img + txt, jimg + jtxt):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-4)


def test_state_dict_from_jax_equals_export_for_retrieval(slice_setup):
    """The retrieval tree sits under `backbone`; its rel-pos tables are
    [(2·24−1)² + 3, H] = [2212, H] at 384 px."""
    from xfm_tpu.train.checkpoint import export_xfm_checkpoint

    from xfm_tpu_torch.ops.patch_embed import patch_kernel_from_conv

    s = slice_setup
    assert "backbone" in s["params"]
    ours = state_dict_from_jax(s["params"], s["jcfg"])
    ref = export_xfm_checkpoint(s["params"], s["jcfg"])
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        v = torch.from_numpy(np.asarray(v))
        if k.endswith("patch_embed.proj.weight"):  # Conv2d → matmul layout
            v = patch_kernel_from_conv(v)
        assert torch.equal(ours[k], v), k
    table = ours["vision_encoder.blocks.1.attn.relative_position_bias_table"]
    assert tuple(table.shape) == (2212, KW["heads"])


def test_init_weights_at_384px_gives_finite_losses():
    cfg = xfm_base_retrieval_config(image_res=RES, dtype=torch.float32, **KW)
    model = XFMForRetrieval(cfg)
    init_weights(model, seed=1)
    for blk in model.vision_encoder.blocks:
        table = blk.attn.relative_position_bias_table
        assert tuple(table.shape) == (2212, KW["heads"])
        assert not table.any()
    batch = batch_to_torch(_numpy_batch(), "cpu")
    total, out = retrieval_loss_fn(model, batch,
                                   torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in (total, *out.values()))


def test_retrieval_step_flops_match_bench_finetune():
    """The port's copy of `scripts/bench_finetune.py`'s count: 18.495 TFLOP
    per step at B = 32."""
    from bench import transformer_flops

    Nv = 577
    fwd = (transformer_flops(12, 768, 3072, Nv, 32)
           + transformer_flops(12, 768, 3072, 40, 32)
           + transformer_flops(12, 768, 3072, 40, 96, cross_kv=Nv))
    assert retrieval_step_flops(32, 40, 576) == 3 * fwd
    assert round(3 * fwd / 1e12, 3) == 18.495
