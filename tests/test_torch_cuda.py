"""The port's CUDA kernels (K1, K2) against their plain versions, on a card.

Run on a machine with an H100 (JAX is not needed):
    python -m pytest tests/test_torch_cuda.py -q
Elsewhere every test here skips: a CUDA kernel has no CPU mode.
"""
import numpy as np
import pytest
import torch


def _inputs(B, N, H, D, seed):
    r = np.random.RandomState(seed)
    qkv = r.randn(B, N, 3 * H * D).astype(np.float32)
    bias = (0.5 * r.randn(1, H, N, N)).astype(np.float32)
    g = r.randn(B, N, H * D).astype(np.float32)
    return qkv, bias, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H", [(3, 50, 4), (2, 197, 12)])
def test_packed_attention_kernel_matches_plain(dtype, B, N, H):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, bias, g = _inputs(B, N, H, 64, seed=9)
    tq = torch.from_numpy(qkv).cuda().to(dtype)
    tb = torch.from_numpy(bias).cuda()
    tg = torch.from_numpy(g).cuda().to(dtype)
    out = fa.packed_attention_fwd(tq, tb, 0.125, H)
    dqkv, db = fa.packed_attention_bwd(tq, tb, tg, 0.125, H)
    rq, rb = tq.clone().requires_grad_(True), tb.clone().requires_grad_(True)
    ref = fa.packed_attention_reference(rq, rb, 0.125, H)
    ref.backward(tg)
    # bf16: 4 ulps at the largest value (P and ds are rounded to bf16 on
    # both sides, sums run in other orders); f32: the order of sums
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    for got, want in ((out, ref), (dqkv, rq.grad), (db, rb.grad)):
        want = want.float()
        assert (got.float() - want).abs().max() <= tol * want.abs().max()


def _relpos_inputs(B, window, H, dtype, seed):
    from xfm_tpu_torch.ops.relpos import compact_rel_pos

    wh, ww = window
    N = wh * ww + 1
    r = np.random.RandomState(seed)
    qkv = torch.from_numpy(r.randn(B, N, 3 * H * 64).astype(np.float32))
    table = torch.from_numpy(
        (0.5 * r.randn((2 * wh - 1) * (2 * ww - 1) + 3, H)).astype(np.float32))
    g = torch.from_numpy(r.randn(B, N, H * 64).astype(np.float32))
    cr, cls3 = compact_rel_pos(table, wh, ww)
    cr = cr.to(dtype).reshape(H, ww, (2 * wh - 1) * ww)
    return (qkv.cuda().to(dtype), cr.cuda(), cls3.to(dtype).float().cuda(),
            g.cuda().to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,window,H", [(3, (3, 5), 4), (2, (7, 11), 2),
                                        (2, (24, 24), 12), (1, (30, 30), 4)])
def test_relpos_attention_kernel_matches_plain(dtype, B, window, H):
    """K2 forward and backward (out, dqkv, dcr, dcls) against the plain
    version, on windows square and not, at 384 and 480 px among them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, cr, cls3, g = _relpos_inputs(B, window, H, dtype, seed=7)
    out, stats = fa.relpos_attention_fwd(qkv, cr, cls3, window, 0.125, H)
    dqkv, dcr, dcls = fa.relpos_attention_bwd(qkv, cr, cls3, stats, g,
                                              window, 0.125, H)
    rq, rc, rl = (x.clone().requires_grad_(True) for x in (qkv, cr, cls3))
    ref = fa.relpos_attention_reference(rq, rc, rl, window, 0.125, H)
    ref.backward(g)
    # as for K1: 4 bf16 ulps at the largest value, or the order of f32 sums
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    for got, want in ((out, ref), (dqkv, rq.grad), (dcr, rc.grad),
                      (dcls, rl.grad)):
        want = want.float()
        assert (got.float() - want).abs().max() <= tol * want.abs().max()


@pytest.mark.cuda
def test_relpos_backward_is_deterministic():
    """The table gradients are summed over the batch without atomics: two
    runs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, cr, cls3, g = _relpos_inputs(4, (24, 24), 12, torch.bfloat16, 8)
    _, stats = fa.relpos_attention_fwd(qkv, cr, cls3, (24, 24), 0.125, 12)
    first = fa.relpos_attention_bwd(qkv, cr, cls3, stats, g, (24, 24), 0.125,
                                    12)
    again = fa.relpos_attention_bwd(qkv, cr, cls3, stats, g, (24, 24), 0.125,
                                    12)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
