"""K5, the fused activation-prologue MLP matmul: the port's `act_matmul` on
the CPU (its plain version, through the autograd Function) against the JAX
package's Pallas kernels in interpret mode (`act_matmul(..., interpret=
True)`), y and the gradients dh, dW and db; and the activation pairs K5
computes against the JAX package's.

Shapes of `tests/test_fused_mlp.py`: K = 128, N = 64, M = 48 and 100 (the
JAX kernel pads 100 rows to its block). The port's weight is the nn.Linear
[N, K], the JAX kernel its transpose. Tolerances, per tensor against its
largest |JAX| value: f32 1e-5 (the same math; sums run in other orders,
and XLA's tanh and torch's differ by an ulp, which the (1 − t²) factor of
tanh-GELU's act' multiplies by up to 30 at |h| = 8: measured 1.6e-6); bf16
2⁻⁶ (the same rounding points; a product summed in another order may land
one bf16 ulp apart).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu.ops import fused_mlp as jmlp

from xfm_tpu_torch.ops import fused_mlp as fm
from xfm_tpu_torch.ops.activations import FUSED_ACT
from _torch_threads import one_intra_op_thread  # noqa: F401

K, N = 128, 64
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _data(M, seed=0):
    r = np.random.RandomState(seed)
    h = (2.0 * r.randn(M, K)).astype(np.float32)
    w = (0.1 * r.randn(N, K)).astype(np.float32)   # nn.Linear layout
    b = (0.1 * r.randn(N)).astype(np.float32)
    g = r.randn(M, N).astype(np.float32)
    return h, w, b, g


def _close(got, want, dtype, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    tol = 1e-5 if dtype == "f32" else 2.0 ** -6
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), what


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("M", [48, 100])
@pytest.mark.parametrize("act", ["gelu_tanh", "gelu", "relu"])
def test_plain_version_matches_pallas_kernels(act, M, dtype):
    tdt, jdt = DTYPES[dtype]
    h, w, b, g = _data(M, seed=M)
    y, vjp = jax.vjp(lambda h, w, b: jmlp.act_matmul(h, w, b, act, True),
                     jnp.asarray(h, jdt), jnp.asarray(w.T, jdt),
                     jnp.asarray(b, jdt))
    jdh, jdw, jdb = vjp(jnp.asarray(g, jdt))
    ht, wt, bt = (torch.from_numpy(a).to(tdt).requires_grad_(True)
                  for a in (h, w, b))
    out = fm.act_matmul(ht, wt, bt, act)
    out.backward(torch.from_numpy(g).to(tdt))
    for got in (out, ht.grad, wt.grad, bt.grad):
        assert got.dtype == tdt
    _close(out, y, dtype, "y")
    _close(ht.grad, jdh, dtype, "dh")
    _close(wt.grad, np.asarray(jdw, np.float32).T, dtype, "dW")
    _close(bt.grad, jdb, dtype, "db")


def test_act_dense_takes_leading_dims_and_gelu_new():
    h, w, b, _ = _data(24)
    x = torch.from_numpy(h).reshape(2, 12, K)
    got = fm.act_dense(x, torch.from_numpy(w), torch.from_numpy(b),
                       "gelu_new")
    want = fm.act_matmul_reference(torch.from_numpy(h), torch.from_numpy(w),
                                   torch.from_numpy(b), "gelu_tanh")
    assert got.shape == (2, 12, N)
    assert torch.equal(got.reshape(24, N), want)


@pytest.mark.parametrize("act", ["gelu_tanh", "gelu", "relu"])
def test_activation_pairs_match_jax(act):
    """(act, act') of the port against the JAX `_act_fns`, beyond the ±6
    clamp too; `gelu` is Φ̂ in both. act' to atol 1e-5: the tanh ulp that
    tanh-GELU's (1 − t²) multiplies (see the module note)."""
    x = np.linspace(-8, 8, 4001).astype(np.float32)
    jf, jdf = jmlp._act_fns(act)
    f, df = FUSED_ACT[act]
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(f(xt).numpy(), np.asarray(jf(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(df(xt).numpy(),
                               np.asarray(jdf(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-5)


def test_gelu_phi_hat_is_the_jax_fast_erf_gelu():
    """K5's `gelu` equals the JAX package's `gelu_erf_fast` (its default
    erf-GELU) in f32, value and gradient, and differs from the exact erf
    form that the port's default route computes by the fit's error."""
    from xfm_tpu.ops.activations import gelu_erf_fast

    x = np.linspace(-8, 8, 4001).astype(np.float32)
    f, df = FUSED_ACT["gelu"]
    xt = torch.from_numpy(x)
    jy, jvjp = jax.vjp(gelu_erf_fast, jnp.asarray(x))
    np.testing.assert_allclose(f(xt).numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(df(xt).numpy(),
                               np.asarray(jvjp(jnp.ones_like(jy))[0]),
                               rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(xt)
    assert 0 < (f(xt) - exact).abs().max() < 1e-5


@pytest.mark.parametrize("act,ok", [("gelu", True), ("gelu_tanh", True),
                                    ("gelu_new", True), ("relu", True),
                                    ("quick_gelu", False)])
def test_fused_mlp_ok_takes_the_jax_activations(act, ok):
    assert fm.fused_mlp_ok(act) is ok


def test_cpu_path_never_touches_the_cuda_library(monkeypatch):
    def no_build(*_):
        raise AssertionError("CPU path tried to build the CUDA library")

    monkeypatch.setattr(fm, "build_library", no_build)
    before = dict(fm.LAUNCHES)
    h, w, b, g = (torch.from_numpy(a) for a in _data(16))
    h.requires_grad_(True)
    (fm.act_matmul(h, w, b, "gelu") * g).sum().backward()
    assert fm.LAUNCHES == before


@pytest.mark.parametrize("kw,err,match", [
    (dict(), ValueError, "one CUDA device"),                 # on the CPU
    (dict(K_=100), NotImplementedError, "multiples of 8"),
    (dict(dtype=torch.float16), NotImplementedError, "bf16 or f32"),
    (dict(w_shape=(64, 120)), ValueError, r"W \[N, K\]"),
    (dict(b_shape=(63,)), ValueError, "b"),
])
def test_kernel_wrapper_refuses_what_it_does_not_take(kw, err, match):
    K_ = kw.get("K_", 128)
    dtype = kw.get("dtype", torch.bfloat16)
    h = torch.zeros(4, K_, dtype=dtype)
    w = torch.zeros(kw.get("w_shape", (64, K_)), dtype=dtype)
    b = torch.zeros(kw.get("b_shape", (64,)), dtype=dtype)
    with pytest.raises(err, match=match):
        fm._check_mm(h, w, b, (w.shape[0],), "b")
    with pytest.raises(NotImplementedError, match="act="):
        fm.act_matmul_reference(h, w, b, "quick_gelu")


@pytest.mark.parametrize("M,K,N,splits", [
    (18912, 3072, 768, 8),   # the BEiT site: 72 dW tiles, about four waves
    (5760, 3072, 768, 8),    # the fusion rows
    (1440, 3072, 768, 2),    # the text rows: each chunk at least 8 steps
    (130, 3072, 768, 1),     # too few rows to split
    (130, 200, 72, 1),
    (4096, 8192, 8192, 1),   # 2,048 tiles already fill the card
])
def test_dw_splits_fill_the_card_in_whole_steps(M, K, N, splits):
    """The bf16 dW's split count over M (runs on the CPU): 1 where its
    [K x N] tiles already fill a wave of 132 blocks, else enough blocks for
    about four waves, never a chunk under 8 reduction steps of 64 rows;
    its workspace is [S, K, N] f32."""
    assert fm.dw_splits(M, K, N) == splits
    assert fm.dw_workspace_shape(M, K, N) == (splits, K, N)
    chunk = -(-(-(-M // fm.DW_STEP)) // splits) * fm.DW_STEP
    assert splits == 1 or chunk >= 8 * fm.DW_STEP
    assert (splits - 1) * chunk < M  # every split but none past the last sums rows
