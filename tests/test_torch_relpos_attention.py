"""K2 port: the plain PyTorch version of the in-kernel rel-pos BEiT attention
against the JAX package's Pallas kernel (`beit_attention_relpos`,
interpret mode) on the CPU, its compact table, the dispatch and the
wrapper's refusals (the CUDA kernel's own test is tests/test_torch_cuda.py).

Tolerances: with an f32 table both sides compute in f32 with f32
accumulation (JAX at matmul precision 'highest', set in conftest), so they
differ only in the order of sums: atol 1e-5 / rtol 1e-4 for values and
gradients. With a bf16 table, the JAX package's own bf16-bias test bound
(tests/test_attention.py, atol 2e-3 / rtol 1e-2); both sides round the
compact table to bf16 at the same point.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ATOL, RTOL = 1e-5, 1e-4
H, D = 2, 64


def _inputs(window, B, seed):
    wh, ww = window
    N = wh * ww + 1
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(B, N, H, D).astype(np.float32) for _ in range(3))
    table = (0.5 * r.randn((2 * wh - 1) * (2 * ww - 1) + 3, H)).astype(
        np.float32)
    g = r.randn(B, N, H * D).astype(np.float32)
    return q, k, v, table, g


def _port(q, k, v, table, g, window, bias_dtype=torch.float32):
    """→ out, dq, dk, dv, dtable of the port's beit_attention_relpos."""
    from xfm_tpu_torch.ops.flash_attention import beit_attention_relpos

    B, N = q.shape[:2]
    qkv = torch.from_numpy(np.concatenate(
        [x.reshape(B, N, H * D) for x in (q, k, v)], -1)).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    out = beit_attention_relpos(qkv, tt, window, D ** -0.5, H, bias_dtype)
    out.backward(torch.from_numpy(g))
    dq, dk, dv = (x.reshape(B, N, H, D).numpy()
                  for x in qkv.grad.split(H * D, dim=-1))
    return out.detach().numpy(), dq, dk, dv, tt.grad.numpy()


def _jax(q, k, v, table, g, window, bias_dtype=jnp.float32):
    from xfm_tpu.ops.flash_attention import beit_attention_relpos

    B, N = q.shape[:2]

    def loss(q, k, v, t):
        o = beit_attention_relpos(q, k, v, t, window, D ** -0.5,
                                  bias_dtype=bias_dtype,
                                  interpret=True).reshape(B, N, H * D)
        return jnp.sum(o * g), o

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                         has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v, table)))
    return (np.asarray(out),) + tuple(np.asarray(x) for x in grads)


@pytest.mark.parametrize("window,B", [((4, 4), 2), ((6, 6), 1), ((3, 5), 2)])
def test_plain_matches_pallas_relpos_kernel(window, B):
    """Values and the q, k, v and table gradients; (3, 5) is non-square, so
    a swapped wh/ww or a wrong stripe offset cannot pass."""
    args = _inputs(window, B, seed=window[0] * 10 + window[1])
    names = ("out", "dq", "dk", "dv", "dtable")
    for name, got, want in zip(names, _port(*args, window),
                               _jax(*args, window)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_plain_with_bf16_table_matches_pallas_bf16_path():
    args = _inputs((4, 4), 1, seed=11)
    got = _port(*args, (4, 4), torch.bfloat16)
    want = _jax(*args, (4, 4), jnp.bfloat16)
    for name, a, b in zip(("out", "dq", "dk", "dv", "dtable"), got, want):
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=1e-2, err_msg=name)


@pytest.mark.parametrize("window", [(4, 4), (3, 5), (24, 24)])
def test_compact_rel_pos_matches_jax(window):
    from xfm_tpu.ops.relpos import compact_rel_pos as jcompact
    from xfm_tpu_torch.ops.relpos import compact_rel_pos

    wh, ww = window
    table = np.random.RandomState(3).randn(
        (2 * wh - 1) * (2 * ww - 1) + 3, 3).astype(np.float32)
    cr, cls3 = compact_rel_pos(torch.from_numpy(table), wh, ww)
    jcr, jcls3 = jcompact(jnp.asarray(table), wh, ww)
    np.testing.assert_array_equal(cr.numpy(), np.asarray(jcr))
    np.testing.assert_array_equal(cls3.numpy(), np.asarray(jcls3))


@pytest.mark.parametrize("window", [(4, 4), (3, 5)])
def test_expanded_compact_form_is_the_materialized_bias(window):
    """Expanding the compact form gives the gather-built bias of the
    pretrain path (ops/relpos.py beit_rel_pos_bias), element for element."""
    from xfm_tpu_torch.ops.relpos import (beit_rel_pos_bias, compact_rel_pos,
                                          expand_compact_rel_pos,
                                          num_relative_distance,
                                          relative_position_index)

    wh, ww = window
    table = torch.from_numpy(np.random.RandomState(4).randn(
        num_relative_distance(window), 3).astype(np.float32))
    cr, cls3 = compact_rel_pos(table, wh, ww)
    got = expand_compact_rel_pos(cr.reshape(3, ww, -1), cls3, window)
    want = beit_rel_pos_bias(table,
                             torch.from_numpy(relative_position_index(window)))
    assert torch.equal(got, want)


def test_cpu_path_never_touches_the_cuda_library(monkeypatch):
    from xfm_tpu_torch.ops import flash_attention as fa

    def no_build(*_):
        raise AssertionError("CPU path tried to build the CUDA library")

    monkeypatch.setattr(fa, "build_library", no_build)
    monkeypatch.setattr(fa, "build_libraries", no_build)
    before = dict(fa.LAUNCHES)
    _port(*_inputs((3, 5), 1, seed=1), (3, 5))
    _port(*_inputs((3, 5), 1, seed=2), (3, 5), torch.bfloat16)
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("n,window,ok", [
    (577, (24, 24), True), (901, (30, 30), True), (601, (20, 30), True),
    (512, (511, 1), True), (511, (510, 1), False),
    (197, (14, 14), False), (577, (24, 23), False),
])
def test_relpos_inkernel_ok(n, window, ok):
    from xfm_tpu_torch.ops.flash_attention import relpos_inkernel_ok

    assert relpos_inkernel_ok(n, window) is ok


def _kernel_args(N=17, window=(4, 4), D_=64, dtype=torch.float32,
                 table_dtype=None):
    wh, ww = window
    qkv = torch.zeros(1, N, 3 * H * D_, dtype=dtype)
    cr = torch.zeros(H, ww, (2 * wh - 1) * ww, dtype=table_dtype or dtype)
    return qkv, cr, torch.zeros(H, 3), window


@pytest.mark.parametrize("kw,err,match", [
    (dict(), ValueError, "CUDA device"),                     # on the CPU
    (dict(N=18), ValueError, "wh"),                          # N != wh*ww + 1
    (dict(D_=32), NotImplementedError, "D=64"),              # head dim
    (dict(dtype=torch.float16), NotImplementedError, "bf16 or f32"),
    (dict(table_dtype=torch.bfloat16), NotImplementedError, "dtype of qkv"),
])
def test_kernel_wrapper_refuses_what_it_does_not_take(kw, err, match):
    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, cr, cls3, window = _kernel_args(**kw)
    with pytest.raises(err, match=match):
        fa._check_relpos_inputs(qkv, cr, cls3, window, H)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_beit_attention_dispatch_at_384px(dtype, monkeypatch):
    """N = 577 goes to K2 with the table in the compute dtype; N = 197 to K1
    with the f32 materialized bias."""
    from xfm_tpu_torch.models import beit2

    calls = []
    real_relpos, real_packed = (beit2.beit_attention_relpos,
                                beit2.flash_attention_packed)

    def relpos(qkv, table, window, scale, num_heads, bias_dtype):
        calls.append(("K2", qkv.shape[1], tuple(window), bias_dtype))
        return real_relpos(qkv, table, window, scale, num_heads, bias_dtype)

    def packed(qkv, bias, scale, num_heads):
        calls.append(("K1", qkv.shape[1], None, bias.dtype))
        return real_packed(qkv, bias, scale, num_heads)

    monkeypatch.setattr(beit2, "beit_attention_relpos", relpos)
    monkeypatch.setattr(beit2, "flash_attention_packed", packed)
    for res in (384, 224):
        c = beit2.VisionConfig(image_res=res, embed_dim=64, depth=1,
                               num_heads=2, drop_path_rate=0.0, dtype=dtype)
        attn = beit2.BeitAttention(c)
        x = torch.randn(1, c.num_patches + 1, 64, dtype=dtype)
        assert attn(x).shape == x.shape
    assert calls == [("K2", 577, (24, 24), dtype),
                     ("K1", 197, None, torch.float32)]
