"""Region attention and the BEiT tower's optional forms against the JAX
package (`tests/test_components_r1b.py`'s region cases): BEiT's
`forward_localattn` (per-block tables, and with the shared table too),
CLIP-ViT's region mode in both forms (`local_attn_depth` > 0 and 0), the
shared rel-pos table with absolute positions and the final norm (the
tokenizer and DINO layouts), `intermediate_layers`, the region stream of
`XFMForPretrain.loss` with `local_attn_depth` > 0, the K1 routing of each
form, and the shared table's exemption from weight decay.

f32 on both sides (JAX matmuls at 'highest'); weights carried across by
`beit2_from_jax` / `clip_vit_from_jax` / `state_dict_from_jax`. Outputs
atol 1e-4; losses rtol 1e-4; each gradient within 1e-3 of its tensor's
largest |value| (+ 1e-7 for BEiT's key biases, zero up to f32 noise;
CLIP's key bias, zero in exact arithmetic, is held under 1e-5 on both
sides).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.models.beit2 import BeitVisionTransformer, VisionConfig
from xfm_tpu_torch.models.clip_vit import (ClipVisionConfig,
                                           ClipVisionTransformer)
from xfm_tpu_torch.train.checkpoint import (beit2_from_jax,
                                            clip_vit_from_jax, to_torch)

IDX = np.array([0, 0, 1, 2, 1])
N = 17  # 64 px / 16, plus cls


def _perturb(tree, seed, scale=0.05):
    r = np.random.RandomState(seed)
    leaves, td = jax.tree.flatten(tree)
    return jax.tree.unflatten(td, [
        np.asarray(x) + scale * np.asarray(r.randn(*np.shape(x)), np.float32)
        for x in leaves])


def _inputs(seed=0):
    r = np.random.RandomState(seed)
    images = r.randn(3, 64, 64, 3).astype(np.float32)
    atts = (r.rand(len(IDX), N) < 0.6).astype(np.float32)
    atts[:, 0] = 1
    atts[2] = 1  # a region covering its whole image
    return images, atts


def _close_grads(model, want, extra=1e-7):
    for name, p in model.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        ref = want[name].numpy().reshape(got.shape)
        if name.endswith("k_proj.bias"):
            # CLIP's key bias: zero in exact arithmetic (softmax ignores a
            # per-row shift); both sides hold f32 noise
            assert max(np.abs(got).max(), np.abs(ref).max()) <= 1e-5, name
            continue
        assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max() + extra, \
            name


def _outputs_and_grads(jm, params, tm, call, seed=1):
    """Apply both towers through `call` (→ a tuple of outputs), weight each
    output by a random tensor, sum, differentiate."""
    images, atts = _inputs()
    jouts = call(lambda **kw: jm.apply({"params": params}, **kw), jnp,
                 images, atts)
    r = np.random.RandomState(seed)
    gs = [r.randn(*np.shape(o)).astype(np.float32) for o in jouts]

    def jloss(p):
        outs = call(lambda **kw: jm.apply({"params": p}, **kw), jnp, images,
                    atts)
        return sum(jnp.sum(o * g) for o, g in zip(outs, gs))

    jgrads = jax.grad(jloss)(params)
    tm.zero_grad(set_to_none=True)
    outs = call(lambda **kw: tm(**kw), torch, images, atts)
    sum(torch.sum(o * torch.from_numpy(g)) for o, g in zip(outs, gs)
        ).backward()
    for o, j in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(j),
                                   atol=1e-4)
    return outs, jax.tree.map(np.asarray, jgrads)


def _region_call(apply, xp, images, atts):
    to = (lambda a: jnp.asarray(a)) if xp is jnp else torch.from_numpy
    return apply(images=to(images), idx_to_group_img=to(IDX),
                 image_atts=to(atts))


BEIT = dict(image_res=64, patch_size=16, embed_dim=128, depth=3, num_heads=2,
            drop_path_rate=0.0, hidden_act="gelu")


def _beit_pair(seed, **kw):
    from xfm_tpu.models.beit2 import (BeitVisionTransformer as JBeit,
                                      VisionConfig as JCfg)

    jm = JBeit(JCfg(**BEIT, **kw))
    params = _perturb(jm.init(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 64, 64, 3)))["params"], seed)
    tm = BeitVisionTransformer(VisionConfig(**BEIT, **kw))
    tm.load_state_dict(to_torch(beit2_from_jax(params, BEIT["depth"])),
                       strict=True)
    return jm, params, tm


@pytest.fixture
def exact_erf(monkeypatch):
    monkeypatch.setenv("XFM_EXACT_ERF", "1")  # erf-GELU on the JAX side


@pytest.mark.parametrize("shared", [False, True])
def test_beit_local_attention_matches_jax(exact_erf, shared):
    """`forward_localattn` (the last 2 of 3 blocks over [regions ‖
    images]) with the per-block tables, and with the shared table beside
    them: region and image rows and every gradient; a region whose mask
    covers its image equals that image's row."""
    jm, params, tm = _beit_pair(2, local_attn_depth=2,
                                use_shared_rel_pos_bias=shared)
    (region, full), jgrads = _outputs_and_grads(jm, params, tm, _region_call)
    assert region.shape == (len(IDX), N, 128) and full.shape == (3, N, 128)
    torch.testing.assert_close(region[2], full[1], atol=1e-5, rtol=0)
    assert not torch.allclose(region[0], full[0], atol=1e-4)
    _close_grads(tm, to_torch(beit2_from_jax(jgrads, BEIT["depth"])))
    if shared:
        assert tm.rel_pos_bias.relative_position_bias_table.grad.abs().max() \
            > 0


def test_beit_shared_table_abs_pos_final_norm_match_jax(exact_erf):
    """The tokenizer's layout (no per-block tables, the shared table,
    absolute positions, the final `norm`, no LayerScale): the forward with
    a MIM mask, `pair`, `intermediate_layers` in the caller's order, and
    every gradient of the forward."""
    kw = dict(use_rel_pos_bias=False, use_shared_rel_pos_bias=True,
              use_abs_pos_emb=True, use_mean_pooling=False, init_values=0.0)
    jm, params, tm = _beit_pair(3, **kw)
    names = {n for n, _ in tm.named_parameters()}
    assert {"pos_embed", "norm.weight",
            "rel_pos_bias.relative_position_bias_table"} <= names
    assert not any("gamma" in n or "attn.relative_position" in n
                   or n.startswith("fc_norm") for n in names)
    images, _ = _inputs()
    mask = np.random.RandomState(4).rand(3, 16) < 0.4

    def fwd(apply, xp, images, atts):
        to = (lambda a: jnp.asarray(a)) if xp is jnp else torch.from_numpy
        return (apply(images=to(images), mask=to(mask)),)

    _, jgrads = _outputs_and_grads(jm, params, tm, fwd)
    _close_grads(tm, to_torch(beit2_from_jax(jgrads, BEIT["depth"])))
    ji, ti = jnp.asarray(images), torch.from_numpy(images)
    jpair = jm.apply({"params": params}, ji, jnp.asarray(mask),
                     method=lambda m, x, k: m.pair(x, k))
    with torch.no_grad():
        tpair = tm.pair(ti, torch.from_numpy(mask))
        tinter = tm.intermediate_layers(ti, [2, 0, 2])
    for a, b in zip(tpair, jpair):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    jinter = jm.apply({"params": params}, ji, [2, 0, 2],
                      method=lambda m, x, ids: m.intermediate_layers(x, ids))
    assert len(tinter) == 3
    for a, b in zip(tinter, jinter):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


CLIP = dict(image_res=64, patch_size=16, hidden_size=64, num_hidden_layers=3,
            num_attention_heads=2, intermediate_size=128)


@pytest.mark.parametrize("local", [2, 0])
def test_clip_region_mode_matches_jax(local):
    """CLIP-ViT region mode: the last `local` layers over each region's
    masked copy, or (0) the masked average-pool readout; both outputs and
    every gradient."""
    from xfm_tpu.models.clip_vit import (ClipVisionConfig as JCfg,
                                         ClipVisionTransformer as JClip)

    jm = JClip(JCfg(**CLIP, local_attn_depth=local))
    params = _perturb(jm.init(jax.random.PRNGKey(5),
                              jnp.zeros((1, 64, 64, 3)))["params"], 5)
    tm = ClipVisionTransformer(ClipVisionConfig(**CLIP,
                                                local_attn_depth=local))
    tm.load_state_dict(to_torch(clip_vit_from_jax(params, 3)), strict=True)
    (region, full), jgrads = _outputs_and_grads(jm, params, tm, _region_call)
    assert region.shape == (len(IDX), N, 64) and full.shape == (3, N, 64)
    if local:
        torch.testing.assert_close(region[2], full[1], atol=1e-5, rtol=0)
    _close_grads(tm, to_torch(clip_vit_from_jax(jgrads, 3)))
    with pytest.raises(NotImplementedError, match="MIM"):
        tm(torch.zeros(1, 64, 64, 3), mask=torch.zeros(1, 16, dtype=bool))


def test_k1_takes_each_bias_of_one_batch_row(monkeypatch):
    """The packed kernel's entry takes every block's bias of one batch row
    (per-block table, shared table, their sum) and no region block's (a
    batch axis: the plain attention); no bias at all never reaches it."""
    from xfm_tpu_torch.models import beit2

    calls = []
    real = beit2.flash_attention_packed

    def spy(qkv, bias, scale, heads):
        calls.append((qkv.shape[0], tuple(bias.shape)))
        return real(qkv, bias, scale, heads)

    monkeypatch.setattr(beit2, "flash_attention_packed", spy)
    images, atts = _inputs()
    ti = torch.from_numpy(images)
    for kw, want in (
            (dict(), [(3, (1, 2, N, N))] * 3),
            (dict(use_shared_rel_pos_bias=True), [(3, (1, 2, N, N))] * 3),
            (dict(use_rel_pos_bias=False, use_shared_rel_pos_bias=True),
             [(3, (1, 2, N, N))] * 3),
            (dict(use_rel_pos_bias=False), []),
            (dict(local_attn_depth=2), [(3, (1, 2, N, N))])):
        calls.clear()
        m = BeitVisionTransformer(VisionConfig(**BEIT, **kw))
        with torch.no_grad():
            if kw.get("local_attn_depth"):
                m(ti, idx_to_group_img=torch.from_numpy(IDX),
                  image_atts=torch.from_numpy(atts))
            else:
                m(ti)
        assert calls == want, kw


def test_shared_table_is_kept_out_of_decay():
    """The shared table's reference name holds 'bias', so HF-AdamW (the
    reference's name rule) does not decay it, where the JAX package's
    `decay_mask` decays `shared_rel_pos_table` (Queue 3B): after a step
    with a zero gradient and weight decay 0.5 the table has not moved and a
    decayed weight has."""
    from xfm_tpu.models.beit2 import (BeitVisionTransformer as JBeit,
                                      VisionConfig as JCfg)
    from xfm_tpu.train.optim import decay_mask

    from xfm_tpu_torch.train.optim import HFAdamW, decays

    kw = dict(use_shared_rel_pos_bias=True)
    jp = JBeit(JCfg(**BEIT, **kw)).init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 64, 64, 3)))["params"]
    assert decay_mask(jp)["shared_rel_pos_table"]  # the JAX fault
    name = "vision_encoder.rel_pos_bias.relative_position_bias_table"
    assert not decays(name)
    m = BeitVisionTransformer(VisionConfig(**BEIT, **kw))
    with torch.no_grad():
        for p in m.parameters():
            p.fill_(1.0)
    opt = HFAdamW(list(m.named_parameters()), 1.0, weight_decay=0.5,
                  clip_grad_norm=None)
    opt.step()
    table = m.rel_pos_bias.relative_position_bias_table
    assert torch.equal(table, torch.ones_like(table))
    assert not torch.equal(m.blocks[0].attn.qkv.weight,
                           torch.ones_like(m.blocks[0].attn.qkv.weight))


def test_pretrain_region_stream_with_local_attention_matches_jax():
    """`XFMForPretrain.loss` on the region stream with
    `local_attn_depth` 1 of 2 blocks (the config from the same YAML keys on
    both sides): every loss and every gradient, fixed hard negatives."""
    import xfm_tpu.models.losses as jlosses
    from xfm_tpu.models import XFMForPretrain as JPretrain
    from xfm_tpu.models import config_from_yaml as jfrom

    from xfm_tpu_torch.models import XFMForPretrain, config_from_yaml
    from xfm_tpu_torch.models.task_models import LOSS_KEYS
    from xfm_tpu_torch.train.checkpoint import state_dict_from_jax

    ycfg = {"compute_dtype": "float32", "local_attn_depth": 1,
            "vision_embed_dim": 64, "vision_depth": 2, "vision_num_heads": 2,
            "patch_size": 16, "image_res": 32, "hidden_act": "gelu_tanh",
            "text_num_hidden_layers": 1, "fusion_num_hidden_layers": 1,
            "text_hidden_size": 64, "text_num_attention_heads": 2,
            "text_intermediate_size": 128, "text_vocab_size": 40}
    flags = dict(use_contrastive_loss=True, use_matching_loss=True,
                 use_mlm_loss=True, use_bbox_loss=True)
    jcfg, cfg = jfrom(ycfg, **flags), config_from_yaml(ycfg, **flags)
    assert jcfg.vision.local_attn_depth == cfg.vision.local_attn_depth == 1
    jm = JPretrain(jcfg)
    r = np.random.RandomState(0)
    B, T, M = 4, 8, 3
    ids = r.randint(3, 39, (B, T))
    atts = np.zeros((B, 5), np.int64)
    atts[:, 0] = 1
    atts[np.arange(B), 1 + np.array([0, 3, 1, 2])] = 1
    batch = dict(images=r.randn(3, 32, 32, 3).astype(np.float32),
                 idx_to_group_img=np.array([0, 2, 0, 1]), image_atts=atts,
                 target_bbox=r.rand(B, 4).astype(np.float32) * 0.5 + 0.1,
                 is_image=np.array([0, 0, 1, 0], np.float32), text_ids=ids,
                 text_atts=np.ones((B, T), np.int64),
                 text_ids_masked=np.where(r.rand(B, T) < 0.3, 3, ids),
                 masked_pos=r.randint(1, 7, (B, M)),
                 masked_ids=r.randint(3, 39, (B, M)))
    params = _perturb(jm.init({"params": jax.random.PRNGKey(0)},
                              jnp.zeros((B, 32, 32, 3)), jnp.asarray(ids),
                              jnp.ones((B, T), jnp.int32),
                              method=JPretrain.init_all)["params"], 1, 0.02)
    neg = (np.array([1, 2, 3, 0]), np.array([2, 3, 0, 1]))
    rflags = dict(ret_itc=True, ret_match=True, ret_mlm=True, ret_mim=False,
                  ret_bbox=True, ret_bbox_giou=True, data_source="region")

    def jloss(p):
        out = jm.apply({"params": p},
                       **{k: jnp.asarray(v) for k, v in batch.items()},
                       **rflags, deterministic=True,
                       rngs={"hardneg": jax.random.PRNGKey(0)})
        return sum(out[k] for k in LOSS_KEYS), out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlosses, "hard_negative_indices",
                   lambda *a, **k: tuple(jnp.asarray(n) for n in neg))
        (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = XFMForPretrain(cfg)
    model.load_state_dict(state_dict_from_jax(params, jcfg), strict=True)
    out = model.loss(**{k: torch.from_numpy(np.asarray(v))
                        for k, v in batch.items()}, **rflags,
                     hard_negatives=tuple(torch.from_numpy(n) for n in neg))
    sum(out[k] for k in LOSS_KEYS).backward()
    for k in LOSS_KEYS:
        np.testing.assert_allclose(out[k].item(), float(jout[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    _close_grads(model, state_dict_from_jax(jax.tree.map(np.asarray, jgrads),
                                            jcfg))
