"""The port's CUDA kernels against their plain versions, on a card.

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
