"""K3 port: the plain PyTorch version of the generic long-sequence attention
against the JAX package's Pallas kernel (`flash_attention`, interpret mode)
on the CPU, the dispatch (`flash_ok`, `dot_product_attention`) and the
wrapper's refusals (the CUDA kernel's own test is tests/test_torch_cuda.py).

Tolerances: both sides compute in f32 with f32 accumulation (JAX at matmul
precision 'highest', set in conftest), so they differ only in the order of
sums: atol 1e-5 / rtol 1e-4 for the values and the q, k, v and bias
gradients.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ATOL, RTOL = 1e-5, 1e-4
D = 64


def _mask_bias(B, Nk, masked):
    """[B, 1, 1, Nk] f32 padding bias: row b masks its last masked[b] keys."""
    atts = np.ones((B, Nk), np.float32)
    for b, n in enumerate(masked):
        if n:
            atts[b, Nk - n:] = 0
    return ((1.0 - atts) * -1e9)[:, None, None, :]


def _inputs(B, Nq, Nk, H, bias, seed):
    r = np.random.RandomState(seed)
    q = r.randn(B, Nq, H, D).astype(np.float32)
    k, v = (r.randn(B, Nk, H, D).astype(np.float32) for _ in range(2))
    g = r.randn(B, Nq, H, D).astype(np.float32)
    if isinstance(bias, tuple):  # a broadcast shape: random values
        bias = (0.5 * r.randn(*bias)).astype(np.float32)
    return q, k, v, bias, g


def _port(q, k, v, bias, g):
    """→ out, dq, dk, dv (, dbias) of the port's flash_attention."""
    from xfm_tpu_torch.ops.flash_attention import flash_attention

    ts = [torch.from_numpy(x).requires_grad_(True)
          for x in (q, k, v) + ((bias,) if bias is not None else ())]
    out = flash_attention(*ts[:3], ts[3] if bias is not None else None)
    out.backward(torch.from_numpy(g))
    return (out.detach().numpy(),) + tuple(t.grad.numpy() for t in ts)


def _jax(q, k, v, bias, g):
    from xfm_tpu.ops.flash_attention import flash_attention

    args = [jnp.asarray(x) for x in (q, k, v)]
    if bias is not None:
        args.append(jnp.asarray(bias))

    def loss(*a):
        o = flash_attention(*a[:3], a[3] if bias is not None else None,
                            D ** -0.5, True)
        return jnp.sum(o * g), o

    (_, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True)(*args)
    return (np.asarray(out),) + tuple(np.asarray(x) for x in grads)


NAMES = ("out", "dq", "dk", "dv", "dbias")


@pytest.mark.parametrize("B,Nq,Nk,H,bias", [
    (2, 520, 520, 2, None),                            # no bias
    (3, 577, 577, 2, "mask"),                          # padding mask, tails
    (1, 577, 577, 2, (1, 2, 577, 577)),                # rel-pos shaped
    (2, 520, 600, 2, (1, 2, 520, 600)),                # Nq != Nk
    (2, 512, 512, 2, "dead_row"),                      # a fully masked row
])
def test_plain_matches_pallas_flash_kernel(B, Nq, Nk, H, bias):
    """Values and all gradients. At N ≥ 512 the JAX backward takes its
    loop-over-q kernel. The fully masked row (batch row 1 masks every key)
    gets the uniform softmax over its keys on both sides; its Nk is a
    multiple of 128, the Pallas kernel's key padding, which would otherwise
    share that row's mass (the port and the JAX package's XLA path exclude
    the tail keys exactly)."""
    if bias == "mask":
        bias = _mask_bias(B, Nk, [0, 7, 70])
    elif bias == "dead_row":
        bias = _mask_bias(B, Nk, [3, Nk])
    args = _inputs(B, Nq, Nk, H, bias, seed=Nq + Nk + B)
    got, want = _port(*args), _jax(*args)
    assert len(got) == len(want) == (4 if args[3] is None else 5)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=name)


def test_plain_matches_pallas_loopq_with_a_per_row_head_bias(monkeypatch):
    """A [B, H, 1, Nk] bias through the loop-over-q backward in 3 q blocks
    (`XFM_BWD_QBLK`, as tests/test_attention.py forces it): its gradient is
    summed over q per (b, h)."""
    monkeypatch.setenv("XFM_BWD_QBLK", "200")
    args = _inputs(2, 600, 600, 2, (2, 2, 1, 600), seed=3)
    for name, a, b in zip(NAMES, _port(*args), _jax(*args)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=name)


def test_dead_row_is_uniform_over_its_keys():
    """A row with every key masked averages v over exactly its Nk keys (577
    is not a multiple of 64 or 128), as the JAX package's XLA path does."""
    from xfm_tpu.ops.flash_attention import _xla_reference

    q, k, v, _, _ = _inputs(2, 577, 577, 2, None, seed=4)
    bias = _mask_bias(2, 577, [0, 577])
    got = _port(q, k, v, bias, np.zeros_like(q))[0]
    want = _xla_reference(*(jnp.asarray(x) for x in (q, k, v, bias)),
                          D ** -0.5)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        got[1], np.broadcast_to(v[1].mean(0), got[1].shape), atol=ATOL,
        rtol=RTOL)


@pytest.mark.parametrize("nq,nk,deterministic,rate,ok", [
    (577, 577, True, 0.0, True), (512, 512, True, 0.0, True),
    (901, 901, False, 0.0, True), (577, 577, False, 0.1, False),
    (577, 577, True, 0.1, True), (40, 577, True, 0.0, False),
    (577, 40, True, 0.0, False), (511, 600, True, 0.0, False),
])
def test_flash_ok(nq, nk, deterministic, rate, ok):
    """As the JAX `_flash_ok` on its accelerator: both lengths ≥ 512 and no
    live dropout; the fusion cross-attention (Nq = 40, Nk = 577) stays
    plain."""
    from xfm_tpu.ops import attention as jattn
    from xfm_tpu_torch.ops.attention import flash_ok

    q, k = torch.zeros(1, nq, 1, 8), torch.zeros(1, nk, 1, 8)
    assert flash_ok(q, k, deterministic, rate) is ok
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattn, "_on_tpu", lambda: True)
        assert jattn._flash_ok(jnp.zeros((1, nq, 1, 8)),
                               jnp.zeros((1, nk, 1, 8)), rate,
                               deterministic) is ok


def test_dot_product_attention_routes_and_folds_mask_and_scale(monkeypatch):
    """N ≥ 512 self-attention goes to K3, cross-attention from 40 queries
    stays plain; `mask` and `scale` are folded in as the JAX entry does."""
    from xfm_tpu.ops.attention import dot_product_attention as jdpa
    from xfm_tpu_torch.ops import attention, flash_attention as fa

    calls = []
    real = fa.flash_attention

    def spy(q, k, v, bias=None, scale=None):
        calls.append((q.shape[1], k.shape[1]))
        return real(q, k, v, bias, scale)

    monkeypatch.setattr(fa, "flash_attention", spy)
    r = np.random.RandomState(5)
    q = r.randn(2, 577, 2, D).astype(np.float32)
    kv = r.randn(2, 577, 2, D).astype(np.float32)
    qx = r.randn(2, 40, 2, D).astype(np.float32)
    mask = np.ones((2, 577), np.int64)
    mask[1, 500:] = 0
    for qq in (q, qx):
        got = attention.dot_product_attention(
            *(torch.from_numpy(x) for x in (qq, kv, kv)),
            mask=torch.from_numpy(mask), scale=0.1)
        want = jdpa(*(jnp.asarray(x) for x in (qq, kv, kv)),
                    mask=jnp.asarray(mask), scale=0.1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
    assert calls == [(577, 577)]


def test_cpu_path_never_touches_the_cuda_library(monkeypatch):
    from xfm_tpu_torch.ops import flash_attention as fa

    def no_build(*_):
        raise AssertionError("CPU path tried to build the CUDA library")

    monkeypatch.setattr(fa, "build_library", no_build)
    monkeypatch.setattr(fa, "build_libraries", no_build)
    before = dict(fa.LAUNCHES)
    _port(*_inputs(1, 520, 520, 1, (1, 1, 520, 520), seed=1))
    _port(*_inputs(1, 520, 520, 1, None, seed=2))
    assert fa.LAUNCHES == before


def _kernel_args(Nq=520, Nk=520, D_=64, dtype=torch.float32, bias_shape=None,
                 bias_dtype=torch.float32):
    q = torch.zeros(2, Nq, 2, D_, dtype=dtype)
    k = torch.zeros(2, Nk, 2, D_, dtype=dtype)
    bias = (torch.zeros(bias_shape, dtype=bias_dtype)
            if bias_shape is not None else None)
    return q, k, k.clone(), bias


@pytest.mark.parametrize("kw,err,match", [
    (dict(), ValueError, "CUDA device"),                     # on the CPU
    (dict(D_=32), NotImplementedError, "D=64"),              # head dim
    (dict(dtype=torch.float16), NotImplementedError, "bf16 or f32"),
    (dict(bias_shape=(2, 2, 520)), ValueError, "broadcast"),
    (dict(bias_shape=(3, 1, 1, 520)), ValueError, "broadcast"),
    (dict(bias_shape=(1, 2, 520, 520), bias_dtype=torch.float16),
     NotImplementedError, "f32 or bf16 bias"),
])
def test_kernel_wrapper_refuses_what_it_does_not_take(kw, err, match):
    from xfm_tpu_torch.ops import flash_attention as fa

    with pytest.raises(err, match=match):
        fa._check_flash_inputs(*_kernel_args(**kw))


# ---------------------------------------------------------------------------
# The bf16 kernels' rounding points, emulated on the CPU


def _emulate_bf16_kernels(q, k, v, bias, g, scale=D ** -0.5, tile=64):
    """What the card's bf16 kernels compute, in torch on the CPU:
    forward, one pass over 64-key tiles with an online softmax whose
    unnormalised exp(S − m) is rounded to bf16 per tile for PV (the O sums
    rescaled as the row max grows, divided by the row sum at the end);
    backward with delta = rowsum(dO ⊙ O) from the rounded output O, P
    recomputed from the saved (m, l), dS = P ⊙ (dP − delta) rounded to
    bf16 for dq and dk, P rounded for dv, dbias the f32 dS summed to the
    bias's shape. q, k, v, g bf16 [B, N, H, D]; bias f32 or None. → out,
    dq, dk, dv (, dbias)."""
    f = torch.float32
    bf = torch.bfloat16
    Nk = k.shape[1]
    qs = (q.float() * scale).to(bf).float()
    kf, vf, gf = k.float(), v.float(), g.float()
    bias_f = None if bias is None else bias.float()
    s_all = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    if bias_f is not None:
        s_all = s_all + bias_f
    B, H, Nq = s_all.shape[:3]
    m = torch.full((B, H, Nq, 1), -float("inf"), dtype=f)
    l = torch.zeros(B, H, Nq, 1, dtype=f)
    o = torch.zeros(B, H, Nq, D, dtype=f)
    for k0 in range(0, Nk, tile):
        s = s_all[..., k0:k0 + tile]
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - mn)
        e = torch.exp(s - mn)
        l = l * alpha + e.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bhqk,bkhd->bhqd", e.to(bf).float(),
                                     vf[:, k0:k0 + tile])
        m = mn
    out = (o / l).to(bf)                                    # [B, H, Nq, D]
    delta = (out.float() * gf.transpose(1, 2)).sum(-1, keepdim=True)
    p = torch.exp(s_all - m) / l
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta)
    dsb = ds.to(bf).float()
    dq = (torch.einsum("bhqk,bkhd->bqhd", dsb, kf) * scale).to(bf)
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, qs).to(bf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(bf).float(), gf).to(bf)
    res = [out.transpose(1, 2), dq, dk, dv]
    if bias is not None:
        dims = [i for i in range(3) if bias.shape[i] == 1]
        res.append(ds.sum(dims, keepdim=True) if dims else ds)
    return res


@pytest.mark.parametrize("B,Nq,Nk,H,bias", [
    (2, 577, 577, 2, None),                            # the CLIP length
    (2, 577, 577, 2, (1, 2, 577, 577)),                # rel-pos shaped
    (2, 520, 700, 2, None),                            # Nq != Nk, ragged
    (2, 520, 700, 2, (1, 2, 520, 700)),
    (2, 577, 640, 2, "dead_row"),                      # a fully masked row
])
def test_bf16_kernel_rounding_holds_the_card_gate(B, Nq, Nk, H, bias):
    """The bf16 kernels round the unnormalised exp(S − m) per key tile where
    the TPU kernel rounds the normalised P, and take delta = rowsum(dO ⊙ O)
    where it sums P ⊙ dP: their emulation stays within the card's bf16
    gate, 2⁻⁶·max|ref| (`chip_smoke.py` phase 8), of the JAX package's
    Pallas kernel (interpret mode) in bf16, values and gradients. The fully
    masked row sits at Nk = 640, a multiple of the Pallas kernel's 128-key
    padding, which would otherwise share its mass."""
    if bias == "dead_row":
        bias = _mask_bias(B, Nk, [5, Nk])
    q, k, v, bias, g = _inputs(B, Nq, Nk, H, bias, seed=Nq + Nk + 11)
    bf = torch.bfloat16
    q, k, v, g = (torch.from_numpy(x).to(bf) for x in (q, k, v, g))
    got = _emulate_bf16_kernels(
        q, k, v, None if bias is None else torch.from_numpy(bias), g)
    want = _jax(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                  for x in (q, k, v)), bias, g.float().numpy())
    assert len(got) == len(want) == (4 if bias is None else 5)
    for name, a, b in zip(NAMES, got, want):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape, name
        err = np.abs(a - b).max()
        assert err <= 2.0 ** -6 * np.abs(b).max(), (name, err)
