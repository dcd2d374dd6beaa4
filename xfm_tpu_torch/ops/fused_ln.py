"""K4: the fused (residual-add +) LayerNorm (`xfm_tpu/ops/fused_ln.py`).

    fused_ln(x, γ, β)          → LN(x)·γ + β
    fused_ln_post(x, y, γ, β)  → LN(x + y)·γ + β           (post-LN BERT)
    fused_add_ln(x, y, γ, β)   → (x + y, LN(x + y)·γ + β)  (pre-LN BEiT)

Rows [..., C]: the sum and the row statistics in f32, the outputs in x's
dtype (the sum rounded to it); γ and β f32. The backward recomputes the row
statistics from the saved, rounded sum, returns the residual's gradient as
the same tensor as dx, and dγ, dβ in f32, as the JAX package's custom_vjp
does. On a CUDA tensor each entry runs the hand-written kernel
(`csrc/fused_ln.cu`, whose note says what bounds it and how dγ/dβ are summed
without atomics on the data; the backward is one launch of persistent
blocks laid out by `bwd_plan`); on a CPU tensor the plain version
(`fused_ln_reference`, `fused_ln_bwd_reference`). A CUDA tensor the kernel
does not take raises.

The models reach K4 only with their config's `fused_ln` flag on (the JAX
package's `XFM_FUSED_LN=1`), at the sites `fused_ln_ok` accepts.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .kernels import (LAUNCHES, aligned, build_library, check, on_card,
                      stream_of)

# The backward kernel's layout (`csrc/fused_ln.cu`, the BWD_* constants):
# 8 consumer warps and a producer warp a block, a ring of at most 8 stages
# behind 256 bytes of barriers and γ, all within 227 KB less 1 KB of
# dynamic shared memory. The ring holds about BWD_RING_BYTES (at least 2
# stages, at least the ~25 KB an SM that Little's law asks at 3.35 TB/s):
# at C = 768 bf16 (add) 2 stages ran 2–4 % faster than 3 and 4, and 6
# slower still (PERF.md, K4).
BWD_CONSUMER_WARPS = 8
BWD_MAX_STAGES = 8
BWD_BAR_BYTES = 256
BWD_SMEM_LIMIT = 231_424
BWD_RING_BYTES = 64 * 1024


def fused_ln_ok(shape, dtype) -> bool:
    """The JAX package's `fused_ln_ok` conditions on the rows: C % 128 = 0,
    C ≤ 8192, bf16 or f32. Its environment and TPU tests are the config's
    `fused_ln` flag in the port."""
    C = shape[-1]
    return (C % 128 == 0 and C <= 8192
            and dtype in (torch.bfloat16, torch.float32))


def warps_per_row(C: int) -> int:
    """Warps that share a row, so that a lane holds at most 32 of its
    values (the kernels' `warps_per_row`)."""
    return next(w for w in (1, 2, 4, 8) if C <= 1024 * w)


class BwdPlan(NamedTuple):
    """The backward kernel's launch (see `bwd_plan`)."""
    blocks: int       # persistent blocks: one an SM, at most one a group
    rows: int         # rows a group: one a row slot of the consumer warps
    groups: int       # row groups in all
    stages: int       # ring stages
    smem: int         # dynamic shared bytes
    copy_bytes: int   # one tensor's bulk copy of a full group
    fold_group: int   # blocks a ticket of the fold: ⌈√blocks⌉
    fold_groups: int  # fold groups (tickets over the blocks)


@functools.lru_cache(maxsize=256)
def bwd_plan(R: int, C: int, dtype, sms: int,
             has_dxn: bool = True) -> BwdPlan:
    """The backward kernel's launch for rows [R, C] on a card with `sms`
    SMs. The ring takes enough stages for ~64 KB, at least 2, at most 8,
    as many as fit and at most the groups of the busiest block. Cached: the
    wrappers call it on every launch."""
    esz = 2 if dtype == torch.bfloat16 else 4
    rows = BWD_CONSUMER_WARPS // warps_per_row(C)
    groups = -(-R // rows)
    blocks = max(1, min(groups, sms))
    copy_bytes = rows * C * esz
    stage = copy_bytes * (3 if has_dxn else 2)
    fixed = C * 4 + BWD_BAR_BYTES
    stages = min(BWD_MAX_STAGES, max(2, -(-BWD_RING_BYTES // stage)),
                 (BWD_SMEM_LIMIT - fixed) // stage, -(-groups // blocks))
    fold_group = math.isqrt(blocks - 1) + 1
    return BwdPlan(blocks, rows, groups, stages, fixed + stages * stage,
                   copy_bytes, fold_group, -(-blocks // fold_group))


def block_rows(plan: BwdPlan, R: int, b: int) -> tuple:
    """The rows [start, stop) that block b of `plan` owns, as the kernel
    reckons them: groups ⌊b·groups / blocks⌋ up to the next block's."""
    g0 = b * plan.groups // plan.blocks
    g1 = (b + 1) * plan.groups // plan.blocks
    return g0 * plan.rows, min(g1 * plan.rows, R)


_SMS: dict = {}        # CUDA device -> its SM count
_COUNTERS: dict = {}   # CUDA device -> the fold's int32 tickets, all 0


def sm_count(device) -> int:
    """The SM count of a CUDA device, read once."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def fold_tickets(device, fold_groups: int) -> torch.Tensor:
    """The device's ticket counters, allocated once (grown when a plan needs
    more); the kernel leaves them at 0."""
    counters = _COUNTERS.get(device)
    if counters is None or counters.numel() < 1 + fold_groups:
        counters = torch.zeros(1 + fold_groups, device=device,
                               dtype=torch.int32)
        _COUNTERS[device] = counters
    return counters


def fused_ln_reference(x, y, gamma, beta, eps):
    """Plain forward (`_fwd_reference`) → (xn, h): xn = x + y rounded to
    x's dtype (x itself without y), h = LN(xn)·γ + β from the unrounded f32
    sum, in x's dtype."""
    xf = x.float()
    xn = xf + y.float() if y is not None else xf
    mu = xn.mean(-1, keepdim=True)
    d = xn - mu
    var = (d * d).mean(-1, keepdim=True)
    h = d * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return (xn.to(x.dtype) if y is not None else x), h.to(x.dtype)


def fused_ln_bwd_reference(xn, dh, dxn, gamma, eps):
    """Plain backward (`_bwd_impl`'s plain branch) from the saved sum xn →
    (dx in xn's dtype, with dxn added where given; dγ, dβ f32 summed over
    all rows)."""
    C = xn.shape[-1]
    xf = xn.float()
    dhf = dh.float()
    mu = xf.mean(-1, keepdim=True)
    d = xf - mu
    var = (d * d).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = d * rstd
    g = dhf * gamma.float()
    m1 = g.mean(-1, keepdim=True)
    m2 = (g * xhat).mean(-1, keepdim=True)
    total = rstd * (g - m1 - xhat * m2)
    if dxn is not None:
        total = total + dxn.float()
    dg = (dhf * xhat).reshape(-1, C).sum(0)
    db = dhf.reshape(-1, C).sum(0)
    return total.to(xn.dtype), dg, db


def _check_rows(x, *like, vectors=()):
    """x and the tensors `like` it: [..., C] on one CUDA device, in one
    dtype the kernel takes; `vectors`: f32 [C]."""
    if not fused_ln_ok(x.shape, x.dtype):
        raise NotImplementedError(f"fused LN kernel takes rows with C % 128 "
                                  f"== 0, C <= 8192, bf16 or f32; got "
                                  f"{tuple(x.shape)} {x.dtype}")
    for t in like:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"fused LN kernel takes {tuple(x.shape)} "
                             f"{x.dtype} beside x, got {tuple(t.shape)} "
                             f"{t.dtype}")
    C = x.shape[-1]
    for v in vectors:
        if v.shape != (C,) or v.dtype != torch.float32:
            raise ValueError(f"fused LN kernel takes γ and β f32 [{C}], got "
                             f"{tuple(v.shape)} {v.dtype}")
    devices = {t.device for t in (x, *like, *vectors)}
    if x.device.type != "cuda" or devices != {x.device}:
        raise ValueError(f"fused LN kernel takes its tensors on one CUDA "
                         f"device, got {sorted(map(str, devices))}")
    return x.numel() // C, C


def fused_ln_fwd(x, y, gamma, beta, eps):
    """Kernel forward: x (and y) [..., C] cuda → (xn, h) as
    `fused_ln_reference`."""
    R, C = _check_rows(x, *([y] if y is not None else []),
                       vectors=(gamma, beta))
    lib = build_library("fused_ln")
    x2, g, b = aligned(x, gamma, beta)
    y2 = aligned(y)[0] if y is not None else None
    h = torch.empty_like(x2)
    xn = torch.empty_like(x2) if y is not None else None
    rc = lib.xfm_fused_ln_fwd(
        x2.data_ptr(), y2.data_ptr() if y2 is not None else None,
        g.data_ptr(), b.data_ptr(), xn.data_ptr() if xn is not None else None,
        h.data_ptr(), R, C, float(eps), int(x.dtype == torch.bfloat16),
        stream_of(x))
    check(rc, "fused LN forward launch")
    LAUNCHES["fused_ln_fwd"] += 1
    return (xn if xn is not None else x), h


def fused_ln_bwd(xn, dh, dxn, gamma, eps):
    """Kernel backward → (dx like xn, dγ f32 [C], dβ f32 [C]), as
    `fused_ln_bwd_reference`."""
    R, C = _check_rows(xn, dh, *([dxn] if dxn is not None else []),
                       vectors=(gamma,))
    lib = build_library("fused_ln")
    xn2, dh2, g = aligned(xn, dh, gamma)
    dxn2 = aligned(dxn)[0] if dxn is not None else None
    plan = bwd_plan(R, C, xn.dtype, sm_count(xn.device), dxn is not None)
    counters = fold_tickets(xn.device, plan.fold_groups)
    dx = torch.empty_like(xn2)
    dg = torch.empty(C, device=xn.device, dtype=torch.float32)
    db = torch.empty(C, device=xn.device, dtype=torch.float32)
    scratch = torch.empty(2, plan.blocks + plan.fold_groups, C,
                          device=xn.device, dtype=torch.float32)
    rc = lib.xfm_fused_ln_bwd(
        xn2.data_ptr(), dh2.data_ptr(),
        dxn2.data_ptr() if dxn2 is not None else None, g.data_ptr(),
        dx.data_ptr(), dg.data_ptr(), db.data_ptr(), scratch.data_ptr(),
        counters.data_ptr(), R, C, plan.blocks, plan.rows, plan.stages,
        plan.fold_group, plan.smem, float(eps),
        int(xn.dtype == torch.bfloat16), stream_of(xn))
    check(rc, "fused LN backward launch")
    LAUNCHES["fused_ln_bwd"] += 1
    return dx, dg, db


class _FusedLN(torch.autograd.Function):
    """One Function for the three entries; saves (xn, γ) as the JAX
    custom_vjp does, xn being x itself without a residual."""

    @staticmethod
    def forward(ctx, x, y, gamma, beta, eps, return_sum):
        fwd = fused_ln_fwd if on_card(x, "fused LN") else fused_ln_reference
        xn, h = fwd(x, y, gamma, beta, eps)
        ctx.save_for_backward(xn, gamma)
        ctx.eps, ctx.has_y, ctx.return_sum = eps, y is not None, return_sum
        ctx.set_materialize_grads(False)
        return (xn, h) if return_sum else h

    @staticmethod
    def backward(ctx, *grads):
        xn, gamma = ctx.saved_tensors
        dxn, dh = grads if ctx.return_sum else (None, grads[0])
        if dh is None:
            dh = torch.zeros_like(xn)
        bwd = (fused_ln_bwd if on_card(xn, "fused LN")
               else fused_ln_bwd_reference)
        dx, dg, db = bwd(xn, dh, dxn, gamma, ctx.eps)
        # the residual's gradient is dx itself
        return (dx, dx if ctx.has_y else None, dg.to(gamma.dtype),
                db.to(gamma.dtype), None, None)


def fused_ln(x, gamma, beta, eps: float = 1e-6):
    """LN(x)·γ + β."""
    return _FusedLN.apply(x, None, gamma, beta, eps, False)


def fused_ln_post(x, y, gamma, beta, eps: float = 1e-6):
    """LN(x + y)·γ + β — the post-LN BERT residual site."""
    return _FusedLN.apply(x, y, gamma, beta, eps, False)


def fused_add_ln(x, y, gamma, beta, eps: float = 1e-6):
    """→ (x + y, LN(x + y)·γ + β) — the pre-LN residual site."""
    return _FusedLN.apply(x, y, gamma, beta, eps, True)
