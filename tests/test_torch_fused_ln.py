"""K4, the fused (residual +) LayerNorm: the port's three entries on the CPU
(their plain versions, through the autograd Function) against the JAX
package's Pallas kernel in interpret mode, values and all four gradients.

R = 300 and 1100 rows give the JAX kernel a single partial 512-row block
and full blocks with a partial tail; C = 256. Tolerances: f32 atol/rtol
1e-5 for values and 2e-4 for gradients (the JAX test's own); bf16
2⁻⁶·max|JAX| per tensor (the two sides round the same f32 values at the
same points; sums run in other orders, so an element may land one bf16 ulp
apart).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu.ops import fused_ln as jfl

from xfm_tpu_torch.ops import fused_ln as fl
from _torch_threads import one_intra_op_thread  # noqa: F401

C = 256
EPS = 1e-6
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _data(R, C, seed=0):
    r = np.random.RandomState(seed)
    x = (2 * r.randn(R, C) + 1).astype(np.float32)
    y = r.randn(R, C).astype(np.float32)
    gamma = (0.3 * r.randn(C) + 1.0).astype(np.float32)
    beta = (0.1 * r.randn(C)).astype(np.float32)
    dh = r.randn(R, C).astype(np.float32)
    dxn = r.randn(R, C).astype(np.float32)
    return x, y, gamma, beta, dh, dxn


def _jax_side(variant, x, y, gamma, beta, dh, dxn, jdt):
    xj, yj = jnp.asarray(x, jdt), jnp.asarray(y, jdt)
    gj, bj = jnp.asarray(gamma), jnp.asarray(beta)
    if variant == "plain":
        out, vjp = jax.vjp(lambda x, g, b: jfl.fused_ln(x, g, b, EPS, True),
                           xj, gj, bj)
        dx, dg, db = vjp(jnp.asarray(dh, jdt))
        return [out], [dx, None, dg, db]
    if variant == "post":
        out, vjp = jax.vjp(
            lambda x, y, g, b: jfl.fused_ln_post(x, y, g, b, EPS, True),
            xj, yj, gj, bj)
        return [out], list(vjp(jnp.asarray(dh, jdt)))
    out, vjp = jax.vjp(
        lambda x, y, g, b: jfl.fused_add_ln(x, y, g, b, EPS, True),
        xj, yj, gj, bj)
    cts = (jnp.asarray(dxn, jdt), jnp.asarray(dh, jdt))
    return list(out), list(vjp(cts))


def _port_side(variant, x, y, gamma, beta, dh, dxn, tdt):
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    yt = torch.from_numpy(y).to(tdt).requires_grad_(True)
    gt = torch.from_numpy(gamma).requires_grad_(True)
    bt = torch.from_numpy(beta).requires_grad_(True)
    dht = torch.from_numpy(dh).to(tdt)
    if variant == "plain":
        outs = [fl.fused_ln(xt, gt, bt, EPS)]
        outs[0].backward(dht)
        return outs, [xt.grad, None, gt.grad, bt.grad]
    if variant == "post":
        outs = [fl.fused_ln_post(xt, yt, gt, bt, EPS)]
        outs[0].backward(dht)
    else:
        outs = list(fl.fused_add_ln(xt, yt, gt, bt, EPS))
        torch.autograd.backward(outs, [torch.from_numpy(dxn).to(tdt), dht])
    return outs, [xt.grad, yt.grad, gt.grad, bt.grad]


def _f32(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("R", [300, 1100])
@pytest.mark.parametrize("variant", ["plain", "post", "add"])
def test_plain_version_matches_pallas_kernel(variant, R, dtype):
    tdt, jdt = DTYPES[dtype]
    data = _data(R, C, seed=R)
    jouts, jgrads = _jax_side(variant, *data, jdt)
    touts, tgrads = _port_side(variant, *data, tdt)
    for got, want in zip(touts, jouts):
        assert got.dtype == tdt
        if dtype == "f32":
            np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5,
                                       rtol=1e-5)
        else:
            w = _f32(want)
            assert np.abs(_f32(got) - w).max() <= 2.0 ** -6 * np.abs(w).max()
    for name, got, want in zip(("dx", "dy", "dgamma", "dbeta"), tgrads,
                               jgrads):
        if want is None:
            assert got is None
            continue
        if dtype == "f32":
            np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-4,
                                       rtol=2e-4, err_msg=name)
        else:
            w = _f32(want)
            assert np.abs(_f32(got) - w).max() <= 2.0 ** -6 * np.abs(w).max(), \
                name
    if variant != "plain":
        # the residual's gradient equals dx, as the JAX package aliases it
        np.testing.assert_array_equal(_f32(tgrads[0]), _f32(tgrads[1]))


@pytest.mark.parametrize("variant", ["post", "add"])
def test_residual_gradient_is_the_dx_tensor(variant):
    """The backward returns one tensor for dx and dy (the JAX custom_vjp's
    `return dx, dx, dg, db`)."""
    x, y, gamma, beta, dh, dxn = (torch.from_numpy(a) for a in _data(8, 128))
    x.requires_grad_(True)
    if variant == "post":
        out = fl.fused_ln_post(x, y, gamma, beta)
        grads = out.grad_fn.apply(dh)
    else:
        xn, out = fl.fused_add_ln(x, y, gamma, beta)
        grads = out.grad_fn.apply(dxn, dh)
    assert grads[0] is grads[1]
    assert grads[2].dtype == grads[3].dtype == torch.float32


@pytest.mark.parametrize("shape,dtype,ok", [
    ((4, 9, 768), torch.bfloat16, True),
    ((18912, 768), torch.float32, True),
    ((2, 8192), torch.float32, True),
    ((2, 8320), torch.float32, False),    # C > 8192
    ((2, 100), torch.float32, False),     # C % 128
    ((2, 64), torch.bfloat16, False),
    ((2, 128), torch.float16, False),
    ((2, 128), torch.int32, False),
])
def test_fused_ln_ok_keeps_the_jax_conditions(shape, dtype, ok):
    assert fl.fused_ln_ok(shape, dtype) is ok


def test_cpu_path_never_touches_the_cuda_library(monkeypatch):
    def no_build(*_):
        raise AssertionError("CPU path tried to build the CUDA library")

    monkeypatch.setattr(fl, "build_library", no_build)
    before = dict(fl.LAUNCHES)
    x, y, gamma, beta, dh, _ = (torch.from_numpy(a) for a in _data(5, 128))
    x.requires_grad_(True)
    xn, h = fl.fused_add_ln(x, y, gamma, beta)
    (h * dh).sum().backward()
    assert fl.LAUNCHES == before


@pytest.mark.parametrize("kw,err,match", [
    (dict(), ValueError, "one CUDA device"),                 # on the CPU
    (dict(C_=100), NotImplementedError, "C % 128"),
    (dict(dtype=torch.float16), NotImplementedError, "bf16 or f32"),
    (dict(y_dtype=torch.float32), ValueError, "beside x"),
    (dict(gamma_dtype=torch.bfloat16), ValueError, "f32"),
])
def test_kernel_wrapper_refuses_what_it_does_not_take(kw, err, match):
    C_ = kw.get("C_", 128)
    dtype = kw.get("dtype", torch.bfloat16)
    x = torch.zeros(4, C_, dtype=dtype)
    y = torch.zeros(4, C_, dtype=kw.get("y_dtype", dtype))
    gamma = torch.ones(C_, dtype=kw.get("gamma_dtype", torch.float32))
    with pytest.raises(err, match=match):
        fl._check_rows(x, y, vectors=(gamma,))


def test_default_route_bf16_backward_gap_is_bounded():
    """The default route (`core/precision.add_layer_norm`, autograd through
    F.layer_norm) takes its backward statistics from the unrounded f32 sum;
    the JAX custom_vjp and K4 take them from the sum rounded to bf16. In
    f32 the two agree; in bf16 dx differs by what rounding the sum moves
    the statistics, measured here and held under 2⁻⁶·max|dx| (ROADMAP,
    Queue 3)."""
    from xfm_tpu_torch.core.precision import add_layer_norm

    x, y, gamma, beta, dh, dxn = _data(1100, 768, seed=5)
    gaps = {}
    for dt in (torch.float32, torch.bfloat16):
        ln = torch.nn.LayerNorm(768, eps=EPS)
        with torch.no_grad():
            ln.weight.copy_(torch.from_numpy(gamma))
            ln.bias.copy_(torch.from_numpy(beta))
        grads = []
        for route in ("default", "fused"):
            xt = torch.from_numpy(x).to(dt).requires_grad_(True)
            yt = torch.from_numpy(y).to(dt)
            if route == "default":
                xn, h = add_layer_norm(xt, yt, ln, dt)
            else:
                xn, h = fl.fused_add_ln(xt, yt, ln.weight, ln.bias, EPS)
            torch.autograd.backward(
                [xn, h], [torch.from_numpy(dxn).to(dt),
                          torch.from_numpy(dh).to(dt)])
            grads.append(xt.grad.float())
        gaps[dt] = ((grads[0] - grads[1]).abs().max().item(),
                    grads[1].abs().max().item())
    err, scale = gaps[torch.float32]
    assert err <= 1e-5 * scale
    err, scale = gaps[torch.bfloat16]
    assert 0 < err <= 2.0 ** -6 * scale


# ---- the backward kernel's plan (ops/fused_ln.bwd_plan), here on the CPU

@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("R", [1, 7, 1440, 5760, 18912])
def test_bwd_plan_covers_every_row_once(R, sms):
    """The blocks' contiguous row ranges cover rows 0 .. R-1 once each, in
    block order, none empty; the grid is the SM count unless the rows have
    fewer groups."""
    for C in (768, 1152, 8192):
        plan = fl.bwd_plan(R, C, torch.bfloat16, sms)
        assert plan.blocks == min(sms, plan.groups)
        assert plan.groups * plan.rows >= R > \
            (plan.groups - 1) * plan.rows
        stop = 0
        for b in range(plan.blocks):
            start, end = fl.block_rows(plan, R, b)
            assert start == stop and end > start
            stop = end
        assert stop == R
        assert plan.fold_groups * plan.fold_group >= plan.blocks
        assert (plan.fold_group - 1) ** 2 < plan.blocks \
            <= plan.fold_group ** 2


@pytest.mark.parametrize("has_dxn", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_plan_fits_shared_memory(dtype, has_dxn):
    """For every C the kernel takes: the ring, γ and the barriers fit in a
    block's 232,448 bytes; each bulk copy (a full group, and the ragged
    last group's true bytes) is a multiple of 16 bytes; the block's fold of
    its row slots ([rows, C] f32) fits in one stage; the ring holds the
    ~25 KB an SM that keeps 3.35 TB/s busy. C = 8,192 in f32 takes 2
    stages."""
    esz = 2 if dtype == torch.bfloat16 else 4
    for C in range(128, 8193, 128):
        plan = fl.bwd_plan(18912, C, dtype, 132, has_dxn)
        assert 1 <= plan.stages <= fl.BWD_MAX_STAGES
        assert plan.smem <= fl.BWD_SMEM_LIMIT <= 232_448
        assert plan.rows * fl.warps_per_row(C) == fl.BWD_CONSUMER_WARPS
        assert plan.copy_bytes == plan.rows * C * esz
        for rows in range(1, plan.rows + 1):
            assert rows * C * esz % 16 == 0
        stage = plan.copy_bytes * (3 if has_dxn else 2)
        assert plan.smem == C * 4 + fl.BWD_BAR_BYTES + plan.stages * stage
        assert plan.rows * C * 4 <= stage
        assert plan.stages * stage >= 25 * 1024   # Little's law's bytes
    big = fl.bwd_plan(18912, 8192, torch.float32, 132, True)
    assert big.stages == 2 and big.rows == 1


def test_bwd_plan_constants_are_the_kernels():
    """The plan's constants are the ones `csrc/fused_ln.cu` compiles in (the
    C entry also checks the plan's shared bytes against its own count)."""
    import re
    from pathlib import Path

    src = (Path(fl.__file__).resolve().parents[1] / "csrc"
           / "fused_ln.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("BWD_CWARPS") == fl.BWD_CONSUMER_WARPS
    assert const("BWD_MAX_STAGES") == fl.BWD_MAX_STAGES
    assert const("BWD_BAR_BYTES") == fl.BWD_BAR_BYTES
    assert const("BWD_SMEM_LIMIT") == fl.BWD_SMEM_LIMIT
    assert const("MAXV") * 4 * 32 == 1024   # a lane holds 32 values a row


def _fold_as_the_kernel(xn, dh, sms=132):
    """dγ, dβ summed in f32 in the kernel's order: each row slot of a block
    over the block's rows in order, the slots in order, the blocks of a
    fold group in order, then the fold groups in order."""
    R, C = xn.shape
    plan = fl.bwd_plan(R, C, torch.float32, sms, has_dxn=False)
    x = torch.from_numpy(xn)
    d = x - x.mean(-1, keepdim=True)
    xhat = d * torch.rsqrt((d * d).mean(-1, keepdim=True) + EPS)
    dh = torch.from_numpy(dh)
    terms = (dh * xhat, dh)
    rows = plan.rows
    partial = []
    for b in range(plan.blocks):
        start, stop = fl.block_rows(plan, R, b)
        slots = torch.zeros(2, rows, C)
        for r in range(start, stop):
            for w in range(2):
                slots[w, r % rows] = slots[w, r % rows] + terms[w][r]
        acc = torch.zeros(2, C)
        for s in range(rows):
            acc = acc + slots[:, s]
        partial.append(acc)
    group_sums = []
    for g in range(plan.fold_groups):
        acc = torch.zeros(2, C)
        for b in range(g * plan.fold_group,
                       min((g + 1) * plan.fold_group, plan.blocks)):
            acc = acc + partial[b]
        group_sums.append(acc)
    total = torch.zeros(2, C)
    for acc in group_sums:
        total = total + acc
    return total[0], total[1]


@pytest.mark.parametrize("R", [7, 1100, 2000])
def test_kernel_fold_order_matches_plain_and_pallas(R):
    """The kernel's order of the dγ/dβ sums, emulated in f32 on the CPU,
    stays within 1e-5 of the largest |value| of the plain version and of
    the Pallas `_bwd_kernel` in interpret mode."""
    x, y, gamma, _, dh, _ = _data(R, C, seed=R + 1)
    xn = x + y
    dg, db = _fold_as_the_kernel(xn, dh)
    _, rdg, rdb = fl.fused_ln_bwd_reference(
        torch.from_numpy(xn), torch.from_numpy(dh), None,
        torch.from_numpy(gamma), EPS)
    _, jdg, jdb = jfl._bwd_pallas(jnp.asarray(xn), jnp.asarray(dh), None,
                                  jnp.asarray(gamma), EPS, True)
    for got, plain, pallas in ((dg, rdg, jdg), (db, rdb, jdb)):
        for want in (plain.numpy(), np.asarray(pallas)):
            err = np.abs(got.numpy() - want).max()
            assert err <= 1e-5 * np.abs(want).max()
