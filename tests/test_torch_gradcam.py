"""GradCAM in the port against the JAX package: the gated attention
(`ops/attention.dot_product_attention(..., prob_gate=)`), `itm_gradcam`
and `rank_boxes_by_cam` (`xfm_tpu/ops/attention.py`,
`xfm_tpu/models/gradcam.py`).

Tolerances: the gated attention in f32 (JAX at 'highest' precision) atol
1e-6 on the output and 1e-5 on the gradients with respect to q, k, v and
the gate; in bf16 the output within 1 bf16 ulp of its magnitude (atol
2⁻⁸ at |x| ≤ 1) and the gradients within 2⁻⁶ of each one's largest
value (the two packages sum the backward's bf16 products in different
orders), the gate's within 2⁻¹² of its largest value (both round dP to
bf16 at the same point and multiply by the f32 probabilities; a gate
applied after the cast, or P kept in f32 for PV, moves it by 1.5e-3 or
more). `itm_gradcam` on a tiny `XFMForRetrieval` (width 32, 2 layers,
32 px, f32, the weights carried by `state_dict_from_jax`) within 1e-6 +
1e-4 of the cam's largest value, at `block_num` 0 and at the last layer;
`rank_boxes_by_cam` equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.configs import nlvr_yaml
from xfm_tpu_torch.models import (XFMForRetrieval, config_from_yaml,
                                  itm_gradcam, rank_boxes_by_cam)
from xfm_tpu_torch.ops.attention import dot_product_attention
from xfm_tpu_torch.train.checkpoint import state_dict_from_jax

C, V = 32, 60


def _qkv(B, Nq, Nk, H, D, seed):
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(B, n, H, D).astype(np.float32)
               for n in (Nq, Nk, Nk))
    bias = (r.randn(B, 1, 1, Nk) * 2).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gate_shape", ["full", "broadcast"])
def test_gated_attention_matches_jax(dtype, gate_shape):
    """Values and gradients (q, k, v, the gate) of the gate route, with a
    padding bias, for a gate [B, H, Nq, Nk] and one [1, 1, Nq, Nk]."""
    from xfm_tpu.ops.attention import dot_product_attention as jattn

    B, Nq, Nk, H, D = 2, 5, 7, 3, 8
    q, k, v, bias = _qkv(B, Nq, Nk, H, D, 0)
    r = np.random.RandomState(1)
    gshape = (B, H, Nq, Nk) if gate_shape == "full" else (1, 1, Nq, Nk)
    gate = (1.0 + 0.5 * r.randn(*gshape)).astype(np.float32)
    dout = r.randn(B, Nq, H, D).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jf(q, k, v, g):
        out = jattn(q, k, v, bias=jnp.asarray(bias), prob_gate=g)
        return jnp.sum(out.astype(jnp.float32) * dout), out

    (_, jout), jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3),
                                       has_aux=True)(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), jnp.asarray(gate))
    ts = [torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v)]
    tg = torch.tensor(gate).requires_grad_()
    out = dot_product_attention(*ts, bias=torch.tensor(bias), prob_gate=tg)
    assert out.dtype == tdt
    (out.float() * torch.tensor(dout)).sum().backward()
    got = out.float().detach().numpy()
    want = np.asarray(jout.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -8 * max(
            1.0, np.abs(want).max())
    for t, w in zip(ts + [tg], jg):
        g = t.grad.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        assert g.shape == w.shape
        tol = 1e-5 if dtype == "float32" else 2.0 ** -6 * np.abs(w).max()
        if t is tg and dtype == "bfloat16":
            tol = 2.0 ** -12 * np.abs(w).max()
        assert np.abs(g - w).max() <= tol


def _misplaced(where):
    """The gated attention with the gate misplaced: applied after the cast
    to the compute dtype ("after_cast"), or with P kept in f32 for PV
    ("f32_pv")."""
    def attention(q, k, v, bias, scale, dropout_rate=0.0, prob_gate=None):
        dt = q.dtype
        qs = (q.float() * scale).to(dt)
        logits = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
        probs = torch.softmax(logits + bias.float(), dim=-1)
        p = ((probs.to(dt) * prob_gate.to(dt)).float() if where ==
             "after_cast" else probs * prob_gate)
        return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(dt)
    return attention


@pytest.mark.parametrize("where", ["after_cast", "f32_pv"])
@pytest.mark.parametrize("gate_kind", ["ones", "random"])
def test_misplaced_gate_fails_the_gate_gradient_bound(where, gate_kind,
                                                      monkeypatch):
    """In bf16 a gate applied after the cast, or P kept in f32 for PV,
    moves the gradient with respect to the gate by more than 2⁻¹⁰ of its
    largest value from JAX's, so the 2⁻¹² bound above (and chip_smoke's
    card-vs-CPU bound) rejects it."""
    from xfm_tpu.ops.attention import dot_product_attention as jattn
    from xfm_tpu_torch.ops import attention

    B, Nq, Nk, H, D = 2, 5, 7, 3, 8
    q, k, v, bias = _qkv(B, Nq, Nk, H, D, 0)
    r = np.random.RandomState(1)
    gate = (np.ones((B, H, Nq, Nk), np.float32) if gate_kind == "ones"
            else (1.0 + 0.5 * r.randn(B, H, Nq, Nk)).astype(np.float32))
    dout = r.randn(B, Nq, H, D).astype(np.float32)
    want = jax.grad(lambda g: jnp.sum(jattn(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        bias=jnp.asarray(bias), prob_gate=g).astype(jnp.float32) * dout))(
        jnp.asarray(gate))
    want = np.asarray(want)
    monkeypatch.setattr(attention, "attention_reference", _misplaced(where))
    tg = torch.tensor(gate).requires_grad_()
    out = dot_product_attention(*(torch.tensor(x).bfloat16()
                                  for x in (q, k, v)),
                                bias=torch.tensor(bias), prob_gate=tg)
    (out.float() * torch.tensor(dout)).sum().backward()
    err = np.abs(tg.grad.numpy() - want).max()
    assert err > 2.0 ** -10 * np.abs(want).max()


def test_gate_of_ones_leaves_the_output_and_takes_no_kernel(monkeypatch):
    """A gate of ones gives the ungated plain output bit for bit, and the
    gate route never reaches the long-sequence kernel's dispatch, even at
    Nq, Nk ≥ 512."""
    from xfm_tpu_torch.ops import attention

    q, k, v, bias = _qkv(1, 4, 6, 2, 8, 2)
    q, k, v, bias = map(torch.tensor, (q, k, v, bias))
    ones = torch.ones(1, 2, 4, 6)
    assert torch.equal(dot_product_attention(q, k, v, bias=bias),
                       dot_product_attention(q, k, v, bias=bias,
                                             prob_gate=ones))
    monkeypatch.setattr(attention, "flash_ok", lambda *a: 1 / 0)
    big = torch.randn(1, 512, 1, 4)
    dot_product_attention(big, big, big, prob_gate=torch.ones(1, 1, 512, 512))


def _retrieval_pair(seed=0):
    """The JAX XFMForRetrieval (width 32, 2 + 2 + 2 layers, 32 px), its
    perturbed params and the port's model with them."""
    from xfm_tpu.models import XFMForRetrieval as JRet
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml

    ycfg = nlvr_yaml(image_res=32, layers=2, vision_embed_dim=C,
                     vision_num_heads=2, text_hidden_size=C,
                     text_num_attention_heads=2, text_intermediate_size=64,
                     text_vocab_size=V, compute_dtype="float32",
                     drop_path_rate=0.0)
    kw = dict(use_contrastive_loss=True, use_matching_loss=True)
    jcfg = jconfig_from_yaml(ycfg, **kw)
    jm = JRet(jcfg)
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((2, 32, 32, 3)),
        jnp.ones((2, 6), jnp.int32), jnp.ones((2, 6), jnp.int32),
        method=JRet.init_all)["params"])()
    r = np.random.RandomState(seed)
    params = jax.tree.map(lambda x: np.asarray(
        np.asarray(x) + 0.1 * r.randn(*x.shape), np.float32), params)
    model = XFMForRetrieval(config_from_yaml(ycfg, **kw))
    model.load_state_dict(state_dict_from_jax(params, jcfg), strict=True)
    return jm, params, model


@pytest.fixture(scope="module")
def retrieval_pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_EXACT_ERF", "1")
        yield _retrieval_pair()


@pytest.mark.parametrize("block_num", [0, 1])
def test_itm_gradcam_matches_jax(retrieval_pair, block_num, monkeypatch):
    """The cam [B, 4] (2 × 2 patches) at the first and the last fusion
    layer, text rows of three lengths; no parameter is left with a
    `.grad`."""
    from xfm_tpu.models.gradcam import itm_gradcam as jgradcam

    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    jm, params, model = retrieval_pair
    r = np.random.RandomState(block_num)
    B, T = 3, 7
    images = r.randn(B, 32, 32, 3).astype(np.float32)
    ids = r.randint(5, V - 1, (B, T)).astype(np.int32)
    ids[:, 0] = 1
    atts = np.ones((B, T), np.int32)
    for b, n in enumerate((7, 5, 3)):
        ids[b, n - 1], ids[b, n:], atts[b, n:] = 2, 0, 0
    want = np.asarray(jax.jit(lambda p, *a: jgradcam(
        jm, p, *a, block_num=block_num))(
        params, jnp.asarray(images), jnp.asarray(ids), jnp.asarray(atts)))
    got = itm_gradcam(model, torch.from_numpy(images),
                      torch.from_numpy(ids).long(),
                      torch.from_numpy(atts).long(), block_num=block_num)
    assert got.shape == want.shape == (B, 4) and got.dtype == torch.float32
    assert np.abs(want).max() > 0
    assert np.abs(got.numpy() - want).max() <= 1e-6 + 1e-4 * np.abs(
        want).max()
    assert all(p.grad is None for p in model.parameters())


def test_rank_boxes_by_cam_matches_jax():
    """Boxes inside the grid, at its edges, past them, and smaller than one
    patch (floored to a patch, at least one a side)."""
    from xfm_tpu.models.gradcam import rank_boxes_by_cam as jrank

    cam = np.random.RandomState(0).rand(24 * 24).astype(np.float32)
    boxes = [[0, 0, 384, 384], [0, 0, 5, 5], [380, 380, 384, 384],
             [370.7, 0.2, 400, 9.9], [15.9, 16.1, 16.5, 31.99],
             [100, 200, 260, 380], [383, 0, 383, 1], [0, 383.5, 2, 384]]
    got = rank_boxes_by_cam(cam, boxes, 384, 16)
    want = jrank(cam, boxes, 384, 16)
    assert got.shape == (len(boxes),)
    np.testing.assert_array_equal(got, want)
