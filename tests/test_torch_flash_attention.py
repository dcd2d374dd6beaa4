"""K1 port: the plain PyTorch version of the packed-qkv attention kernel
against the JAX package's Pallas kernel (interpret mode) and its XLA
reference, on the CPU (the CUDA kernel's own test is tests/test_torch_cuda.py).

Tolerances: both sides compute in f32 with f32 accumulation (JAX at
matmul precision 'highest', set in conftest), so they differ only in the
order of sums: atol 1e-5 / rtol 1e-4 for values and gradients. The card's
bf16 kernels, whose rounding points move at two places, are emulated here
and held to the card's bf16 gate, 2⁻⁶·max|ref|, against the Pallas kernel
in bf16.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ATOL, RTOL = 1e-5, 1e-4


def _inputs(B, N, H, D, seed):
    r = np.random.RandomState(seed)
    qkv = r.randn(B, N, 3 * H * D).astype(np.float32)
    bias = (0.5 * r.randn(1, H, N, N)).astype(np.float32)
    g = r.randn(B, N, H * D).astype(np.float32)
    return qkv, bias, g


def _port(qkv, bias, g, scale, H):
    from xfm_tpu_torch.ops.flash_attention import flash_attention_packed

    tq = torch.from_numpy(qkv).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    out = flash_attention_packed(tq, tb, scale, H)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), tq.grad.numpy(), tb.grad.numpy()


@pytest.mark.parametrize("B,N,H", [(2, 17, 2), (3, 13, 4)])
def test_plain_matches_pallas_packed_kernel(B, N, H):
    from xfm_tpu.ops.flash_attention import _packed_bwd_impl, _packed_fwd_impl

    D = 64
    qkv, bias, g = _inputs(B, N, H, D, seed=N)
    scale = D ** -0.5
    out, dqkv, db = _port(qkv, bias, g, scale, H)

    jout = _packed_fwd_impl(jnp.asarray(qkv), jnp.asarray(bias), scale, H,
                            interpret=True)
    jdqkv, jdb = _packed_bwd_impl(jnp.asarray(qkv), jnp.asarray(bias), scale,
                                  H, jnp.asarray(g), interpret=True)
    np.testing.assert_allclose(out, np.asarray(jout), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dqkv, np.asarray(jdqkv), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(db, np.asarray(jdb), atol=ATOL, rtol=RTOL)


def test_plain_matches_xla_reference_with_grads():
    from xfm_tpu.ops.flash_attention import _xla_reference

    B, N, H, D = 2, 21, 2, 64
    qkv, bias, g = _inputs(B, N, H, D, seed=5)
    scale = D ** -0.5
    out, dqkv, db = _port(qkv, bias, g, scale, H)

    def loss(qkv, bias):
        q, k, v = (t.reshape(B, N, H, D) for t in jnp.split(qkv, 3, -1))
        o = _xla_reference(q, k, v, bias, scale).reshape(B, N, H * D)
        return jnp.sum(o * g), o

    (_, jout), (jdq, jdb) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(qkv),
                                            jnp.asarray(bias))
    np.testing.assert_allclose(out, np.asarray(jout), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dqkv, np.asarray(jdq), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(db, np.asarray(jdb), atol=ATOL, rtol=RTOL)


def test_cpu_path_never_touches_the_cuda_library(monkeypatch):
    from xfm_tpu_torch.ops import flash_attention as fa

    def no_build():
        raise AssertionError("CPU path tried to build the CUDA library")

    monkeypatch.setattr(fa, "build_library", no_build)
    before = dict(fa.LAUNCHES)
    qkv, bias, g = _inputs(1, 9, 2, 64, seed=1)
    _port(qkv, bias, g, 0.125, 2)
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("shape,err", [
    ((1, 512, 3 * 2 * 64), NotImplementedError),   # K2's range
    ((1, 17, 3 * 2 * 32), NotImplementedError),    # D != 64
    ((1, 17, 3 * 2 * 64), ValueError),             # not on a CUDA device
])
def test_kernel_wrapper_refuses_what_it_does_not_take(shape, err):
    from xfm_tpu_torch.ops.flash_attention import _check_inputs

    N = shape[1]
    with pytest.raises(err):
        _check_inputs(torch.zeros(shape), torch.zeros(1, 2, N, N), 2)


@pytest.mark.parametrize("B,N,H", [(2, 197, 2), (3, 50, 2)])
def test_bf16_kernel_rounding_holds_the_card_gate(B, N, H):
    """K1's bf16 path runs the shared kernels of K2 and K3
    (tests/test_torch_long_attention.py `_emulate_bf16_kernels`: exp(S − m)
    rounded per key tile for PV, delta = rowsum(dO ⊙ O) from the rounded
    output) with the f32 bias read beside each score, and db the f32 dS
    summed over the batch. Out, dqkv and db stay within the card's bf16
    gate, 2⁻⁶·max|ref| (`chip_smoke.py` phase 2), of the JAX package's
    Pallas kernel in bf16 (interpret mode), at the pretrain length (4 key
    tiles, the last holding 5 keys) and at one shorter than a tile."""
    from test_torch_long_attention import _emulate_bf16_kernels
    from xfm_tpu.ops.flash_attention import _packed_bwd_impl, _packed_fwd_impl

    D, scale, bf = 64, 0.125, torch.bfloat16
    qkv, bias, g = _inputs(B, N, H, D, seed=N + 7)
    tq = torch.from_numpy(qkv).to(bf)
    tg = torch.from_numpy(g).to(bf)
    q, k, v = (t.reshape(B, N, H, D) for t in tq.split(H * D, dim=-1))
    out, dq, dk, dv, db = _emulate_bf16_kernels(
        q, k, v, torch.from_numpy(bias), tg.reshape(B, N, H, D), scale)
    dqkv = torch.cat([t.reshape(B, N, H * D) for t in (dq, dk, dv)], -1)
    jq = jnp.asarray(tq.float().numpy(), jnp.bfloat16)
    jg = jnp.asarray(tg.float().numpy(), jnp.bfloat16)
    jout = _packed_fwd_impl(jq, jnp.asarray(bias), scale, H, interpret=True)
    jdqkv, jdb = _packed_bwd_impl(jq, jnp.asarray(bias), scale, H, jg,
                                  interpret=True)
    for name, a, b in (("out", out.reshape(B, N, H * D), jout),
                       ("dqkv", dqkv, jdqkv), ("db", db, jdb)):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape, name
        err = np.abs(a - b).max()
        assert err <= 2.0 ** -6 * np.abs(b).max(), (name, err)
