"""Dropout and drop-path in the port (`ops/dropout.py` and its sites in
`models/beit2.py`, `models/text_encoder.py`, `models/clip_vit.py` and
`ops/attention.py`).

Against the JAX package (f32, JAX matmuls at 'highest' precision, weights
carried across by the bridges): at rate 0 with `deterministic=False`, and
at live rates with `deterministic=True`, each module's output equals the
JAX module's at its parity test's tolerance (atol 1e-4). At live rates the
masks are the port's own (a JAX key and a torch generator draw different
bits), so they are held to their distribution: the kept share within 4σ
of 1 − p, survivors exactly x / (1 − p), drop-path keeping or zeroing each
sample whole; the same generator seed gives the same masks, and no mask is
drawn without a generator. BEiT at 384 px with drop-path 0.1 still goes
through K2's entry (the attention-dropout rate stays 0, as in the
recipes).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.models.beit2 import BeitVisionTransformer, VisionConfig
from xfm_tpu_torch.models.clip_vit import (ClipVisionConfig,
                                           ClipVisionTransformer)
from xfm_tpu_torch.models.text_encoder import TextConfig, TextTransformer
from xfm_tpu_torch.ops import attention, dropout as drop
from xfm_tpu_torch.train.checkpoint import (beit2_from_jax,
                                            clip_vit_from_jax,
                                            text_encoder_from_jax, to_torch)

LIVE = 0.1


def _perturbed(params, r, scale=0.05):
    leaves, tree = jax.tree.flatten(params)
    return jax.tree.unflatten(tree, [
        np.asarray(x) + scale * np.asarray(r.randn(*np.shape(x)), np.float32)
        for x in leaves])


def _beit_kw(rate):
    return dict(image_res=64, patch_size=16, embed_dim=128, depth=3,
                num_heads=2, drop_path_rate=rate, drop_rate=rate,
                attn_drop_rate=rate, hidden_act="gelu")


def _text_kw(rate):
    return dict(vocab_size=99, hidden_size=64, num_hidden_layers=3,
                num_attention_heads=2, intermediate_size=128,
                max_position_embeddings=40, fusion_layer=1, encoder_width=96,
                hidden_act="gelu", hidden_dropout_prob=rate,
                attention_probs_dropout_prob=rate)


def _clip_kw(rate):
    return dict(image_res=64, patch_size=16, hidden_size=64,
                num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=128, attention_dropout=rate)


@pytest.fixture(scope="module")
def params():
    """JAX params of each module (perturbed), made once at rate 0 (rates
    add no parameters), and the inputs."""
    from xfm_tpu.models.beit2 import BeitVisionTransformer as JBeit
    from xfm_tpu.models.beit2 import VisionConfig as JVCfg
    from xfm_tpu.models.clip_vit import ClipVisionConfig as JCCfg
    from xfm_tpu.models.clip_vit import ClipVisionTransformer as JClip
    from xfm_tpu.models.text_encoder import TextConfig as JTCfg
    from xfm_tpu.models.text_encoder import TextTransformer as JText

    r = np.random.RandomState(0)
    images = r.randn(2, 64, 64, 3).astype(np.float32)
    ids = r.randint(3, 99, (4, 9)).astype(np.int64)
    atts = np.ones((4, 9), np.int64)
    atts[1, 6:] = 0
    ids[1, 6:] = 1
    enc = r.randn(4, 5, 96).astype(np.float32)
    beit = _perturbed(JBeit(JVCfg(**_beit_kw(0.0))).init(
        jax.random.PRNGKey(0), jnp.asarray(images))["params"], r)
    text = _perturbed(JText(JTCfg.roberta_base(**_text_kw(0.0))).init(
        jax.random.PRNGKey(0), jnp.asarray(ids),
        attention_mask=jnp.asarray(atts),
        encoder_hidden_states=jnp.asarray(enc),
        method=JText.init_all)["params"], r)
    clip = _perturbed(JClip(JCCfg(dtype=jnp.float32, **_clip_kw(0.0))).init(
        jax.random.PRNGKey(0), jnp.asarray(images))["params"], r, 0.02)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_EXACT_ERF", "1")  # erf-GELU on the JAX side
        yield dict(images=images, ids=ids, atts=atts, enc=enc, beit=beit,
                   text=text, clip=clip)


def _beit(p, rate, deterministic):
    from xfm_tpu.models.beit2 import BeitVisionTransformer as JBeit
    from xfm_tpu.models.beit2 import VisionConfig as JVCfg

    want = JBeit(JVCfg(**_beit_kw(rate))).apply(
        {"params": p["beit"]}, jnp.asarray(p["images"]),
        deterministic=deterministic,
        rngs={"dropout": jax.random.PRNGKey(1)})
    tm = BeitVisionTransformer(VisionConfig(**_beit_kw(rate)))
    tm.load_state_dict(to_torch(beit2_from_jax(p["beit"], 3)), strict=True)
    return tm, want, lambda: tm(torch.from_numpy(p["images"]),
                                deterministic=deterministic)


def _text(p, rate, deterministic):
    from xfm_tpu.models.text_encoder import TextConfig as JTCfg
    from xfm_tpu.models.text_encoder import TextTransformer as JText

    want = JText(JTCfg.roberta_base(**_text_kw(rate))).apply(
        {"params": p["text"]}, jnp.asarray(p["ids"]),
        attention_mask=jnp.asarray(p["atts"]),
        encoder_hidden_states=jnp.asarray(p["enc"]),
        deterministic=deterministic,
        rngs={"dropout": jax.random.PRNGKey(1)})
    tm = TextTransformer(TextConfig.roberta_base(**_text_kw(rate)))
    res = tm.load_state_dict(to_torch(text_encoder_from_jax(p["text"], 3)),
                             strict=False)
    assert not res.missing_keys, res.missing_keys
    return tm, want, lambda: tm(
        torch.from_numpy(p["ids"]),
        attention_mask=torch.from_numpy(p["atts"]),
        encoder_hidden_states=torch.from_numpy(p["enc"]),
        deterministic=deterministic)


def _clip(p, rate, deterministic):
    from xfm_tpu.models.clip_vit import ClipVisionConfig as JCCfg
    from xfm_tpu.models.clip_vit import ClipVisionTransformer as JClip

    want = JClip(JCCfg(dtype=jnp.float32, **_clip_kw(rate))).apply(
        {"params": p["clip"]}, jnp.asarray(p["images"]),
        deterministic=deterministic,
        rngs={"dropout": jax.random.PRNGKey(1)})
    tm = ClipVisionTransformer(ClipVisionConfig(**_clip_kw(rate)))
    tm.load_state_dict(to_torch(clip_vit_from_jax(p["clip"], 2)),
                       strict=True)
    return tm, want, lambda: tm(torch.from_numpy(p["images"]),
                                deterministic=deterministic)


MODULES = {"beit2": _beit, "text": _text, "clip_vit": _clip}


@pytest.mark.parametrize("name", sorted(MODULES))
@pytest.mark.parametrize("rate,deterministic", [(0.0, False), (LIVE, True)])
def test_module_without_live_dropout_matches_jax(params, name, rate,
                                                 deterministic):
    """No generator is active: nothing may be drawn."""
    _, want, run = MODULES[name](params, rate, deterministic)
    with torch.no_grad():
        got = run()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_live_module_needs_a_generator_and_repeats_with_its_seed(params,
                                                                 name):
    _, want, run = MODULES[name](params, LIVE, False)
    with pytest.raises(ValueError, match="torch.Generator"):
        run()
    outs = []
    for seed in (5, 5, 6):
        with torch.no_grad(), drop.dropout_generator(
                torch.Generator().manual_seed(seed)):
            outs.append(run())
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    assert all(torch.isfinite(o).all() for o in outs)
    assert outs[0].shape == tuple(np.shape(want))
    assert not np.allclose(outs[0].numpy(), np.asarray(want), atol=1e-4)


def _within_4_sigma(kept: int, n: int, p: float):
    keep = 1.0 - p
    sigma = (n * keep * p) ** 0.5
    assert abs(kept - n * keep) <= 4 * sigma, (kept, n * keep, sigma)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keep_share_and_scale(dtype, p):
    x = (torch.rand(64, 33, 17, generator=torch.Generator().manual_seed(0))
         + 0.5).to(dtype)
    with drop.dropout_generator(torch.Generator().manual_seed(1)):
        y = drop.dropout(x, p, deterministic=False)
    assert y.dtype == dtype
    kept = y != 0
    _within_4_sigma(int(kept.sum()), x.numel(), p)
    assert torch.equal(y[kept], (x / (1.0 - p))[kept])
    assert drop.dropout(x, p, deterministic=True) is x
    assert drop.dropout(x, 0.0, deterministic=False) is x


def test_drop_path_zeroes_whole_samples():
    p, B = 0.3, 4000
    x = torch.rand(B, 5, 7, generator=torch.Generator().manual_seed(0)) + 1
    with drop.dropout_generator(torch.Generator().manual_seed(2)):
        y = drop.drop_path(x, p, deterministic=False)
    kept = (y != 0).flatten(1)
    whole = kept.all(1)
    assert torch.equal(whole, kept.any(1))  # each sample all or nothing
    _within_4_sigma(int(whole.sum()), B, p)
    assert torch.equal(y[whole], x[whole] / (1.0 - p))
    assert drop.drop_path(x, p, deterministic=True) is x


def test_attention_dropout_masks_probabilities():
    """q = 0 makes every probability 1/Nk and v = identity reads them out:
    each output entry is 0 or (1/Nk)/(1 − p); the rate sends
    `dot_product_attention` to the plain path even at Nq, Nk ≥ 512."""
    B, N, H, D, p = 2, 64, 2, 64, 0.2
    q = torch.zeros(B, N, H, D)
    v = torch.eye(N, D)[None, :, None, :].expand(B, N, H, D).contiguous()
    with drop.dropout_generator(torch.Generator().manual_seed(3)):
        out = attention.dot_product_attention(q, q, v, deterministic=False,
                                              dropout_rate=p)
    kept = out != 0
    _within_4_sigma(int(kept.sum()), out.numel(), p)
    torch.testing.assert_close(out[kept], torch.full(
        (int(kept.sum()),), 1.0 / N / (1.0 - p)), rtol=1e-6, atol=0)
    qq = torch.zeros(1, 512, 1, 64)
    assert not attention.flash_ok(qq, qq, False, p)
    assert attention.flash_ok(qq, qq, True, p)


def test_masks_on_device_follow_the_generator_device():
    g = torch.Generator().manual_seed(0)
    with drop.dropout_generator(g):
        a = drop.keep_mask((3, 4), 0.5, "cpu")
    with drop.dropout_generator(torch.Generator().manual_seed(0)):
        b = drop.keep_mask((3, 4), 0.5, "cpu")
    assert a.dtype == torch.bool and torch.equal(a, b)


def test_beit_384px_with_drop_path_still_takes_k2(monkeypatch):
    """Drop-path 0.1 and hidden dropout live at 384 px (N = 577), no
    attention dropout: every block's attention goes through K2's entry
    (`beit_attention_relpos`), and drop-path draws one mask a block past
    the first (whose rate is 0)."""
    from xfm_tpu_torch.models import beit2
    from xfm_tpu_torch.ops import flash_attention as fa

    calls, masks = [], []

    def spy(qkv, table, window, scale, H, dtype):
        calls.append((tuple(qkv.shape), window))
        return fa.beit_attention_relpos(qkv, table, window, scale, H, dtype)

    real_keep = drop.keep_mask

    def count(shape, keep, device):
        masks.append(tuple(shape))
        return real_keep(shape, keep, device)

    monkeypatch.setattr(beit2, "beit_attention_relpos", spy)
    monkeypatch.setattr(drop, "keep_mask", count)
    depth = 3
    tm = BeitVisionTransformer(VisionConfig(
        image_res=384, patch_size=16, embed_dim=64, depth=depth,
        num_heads=1, drop_path_rate=LIVE, drop_rate=LIVE, hidden_act="gelu"))
    images = torch.randn(2, 384, 384, 3,
                         generator=torch.Generator().manual_seed(0))
    with drop.dropout_generator(torch.Generator().manual_seed(1)):
        out = tm(images, deterministic=False)
    out.sum().backward()
    assert calls == [((2, 577, 192), (24, 24))] * depth
    per_sample = [s for s in masks if s == (2, 1, 1)]
    assert len(per_sample) == 2 * (depth - 1)  # two sites a block
    assert torch.isfinite(out).all()
    assert tm.blocks[0].drop_path == 0.0
    assert tm.blocks[-1].drop_path == pytest.approx(LIVE)
