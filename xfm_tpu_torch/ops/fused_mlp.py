"""K5: the MLP's second projection with the activation fused into the
matmuls (`xfm_tpu/ops/fused_mlp.py`).

    act_matmul(h, W, b, act) = act(h)·Wᵀ + b,  h [M, K], W [N, K], b [N]

W is the `nn.Linear` weight [N, K] (the JAX package's kernel is its
transpose, [K, N]); the kernels read it in place. act(h) is computed in f32
and rounded to h's dtype before the product; the product sums in f32 and b
is added in f32, the result in h's dtype. The backward: dW = gᵀ·act(h)
summed over all M in f32, in W's dtype; dh = (g·W)·act'(h) in f32, in h's
dtype; db = Σ g in f32, in h's dtype (a torch reduction, as the JAX package
leaves it to XLA). act(h) is never written to memory.

On a CUDA tensor `act_matmul` runs the hand-written kernels
(`csrc/fused_mlp.cu`: the forward, dh and dW, whose note says what bounds
them and how dW is summed without atomics; in bf16 dW sums `dw_splits`
chunks of M into a workspace [S, K, N] f32 and a second kernel adds them in
order); on a CPU tensor the plain
version (`act_matmul_reference`, `act_matmul_bwd_reference`). A CUDA tensor
the kernels do not take raises. The models reach K5 only with their
config's `fused_mlp` flag on (the JAX package's `XFM_MLP_FUSED=1`) for an
activation `fused_mlp_ok` accepts.
"""
from __future__ import annotations

import torch

from .activations import FUSED_ACT, FUSED_ACT_ID
from .kernels import (LAUNCHES, aligned, build_library, check, on_card,
                      stream_of)


def fused_mlp_ok(act: str) -> bool:
    """The activations K5 computes (the JAX `ActDense`'s list); its
    environment and TPU tests are the config's `fused_mlp` flag here."""
    return act in FUSED_ACT


SMS = 132       # the H100's multiprocessors
DW_TILE = (128, 256)   # csrc `WBM`, `WBN`: a bf16 dW block's [K x N] tile
DW_STEP = 64           # csrc `WBK`: rows of M a reduction step takes


def dw_splits(M: int, K: int, N: int) -> int:
    """The chunks S that the bf16 dW cuts its sum over M into: 1 when its
    [K x N] tiles already fill a wave of the card, else enough blocks for
    about four waves, each chunk at least 8 reduction steps long."""
    tiles = -(-K // DW_TILE[0]) * -(-N // DW_TILE[1])
    if tiles >= SMS:
        return 1
    return max(1, min(-(-4 * SMS // tiles), -(-M // DW_STEP) // 8))


def dw_workspace_shape(M: int, K: int, N: int):
    """The bf16 dW partials [S, K, N] f32 (written once, read once)."""
    return (dw_splits(M, K, N), K, N)


def _act_pair(act: str):
    if act not in FUSED_ACT:
        raise NotImplementedError(f"fused MLP does not support act={act!r}")
    return FUSED_ACT[act]


def act_matmul_reference(h, weight, bias, act: str):
    """Plain forward, the kernel's rounding points: act in f32 rounded to
    h's dtype, the product and the bias in f32, the result in h's dtype."""
    f = _act_pair(act)[0]
    a = f(h.float()).to(h.dtype)
    return (a.float() @ weight.float().t() + bias.float()).to(h.dtype)


def act_matmul_bwd_reference(h, weight, g, act: str):
    """Plain backward → (dh like h, dW like weight, db in h's dtype)."""
    f, df = _act_pair(act)
    hf, gf = h.float(), g.float()
    a = f(hf).to(h.dtype).float()
    dw = (gf.t() @ a).to(weight.dtype)
    dh = ((gf @ weight.float()) * df(hf)).to(h.dtype)
    return dh, dw, gf.sum(0).to(h.dtype)


def _check_mm(h, weight, other, other_shape, what):
    if h.dim() != 2 or weight.dim() != 2 or h.shape[1] != weight.shape[1]:
        raise ValueError(f"fused MLP takes h [M, K] and W [N, K], got "
                         f"{tuple(h.shape)} and {tuple(weight.shape)}")
    M, K = h.shape
    N = weight.shape[0]
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"fused MLP kernel takes bf16 or f32, got "
                                  f"{h.dtype}")
    if K % 8 or N % 8:
        raise NotImplementedError(f"fused MLP kernel takes K and N that are "
                                  f"multiples of 8, got K={K} N={N}")
    if tuple(other.shape) != other_shape:
        raise ValueError(f"fused MLP takes {what} {other_shape}, got "
                         f"{tuple(other.shape)}")
    tensors = (h, weight, other)
    if h.device.type != "cuda" or {t.device for t in tensors} != {h.device} \
            or {t.dtype for t in tensors} != {h.dtype}:
        raise ValueError(f"fused MLP kernel takes h, W and {what} in one "
                         f"dtype on one CUDA device, got "
                         f"{[(t.dtype, str(t.device)) for t in tensors]}")
    return M, K, N


def act_matmul_fwd(h, weight, bias, act: str):
    """Kernel forward: h [M, K], W [N, K], b [N] (cuda, one dtype) →
    act(h)·Wᵀ + b [M, N] in h's dtype."""
    M, K, N = _check_mm(h, weight, bias, (weight.shape[0],), "b")
    _act_pair(act)  # raises for an activation the kernel does not compute
    lib = build_library("fused_mlp")
    h, weight, bias = aligned(h, weight, bias)
    y = torch.empty(M, N, device=h.device, dtype=h.dtype)
    rc = lib.xfm_act_matmul_fwd(
        h.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), M, K,
        N, FUSED_ACT_ID[act], int(h.dtype == torch.bfloat16), stream_of(h))
    check(rc, "fused MLP forward launch")
    LAUNCHES["fused_mlp_fwd"] += 1
    return y


def act_matmul_bwd(h, weight, g, act: str):
    """Kernel backward (the dW kernels, then dh) → (dh like h, dW like W,
    db = Σ g in f32, in h's dtype)."""
    M, K, N = _check_mm(h, weight, g, (h.shape[0], weight.shape[0]), "g")
    _act_pair(act)  # raises for an activation the kernel does not compute
    lib = build_library("fused_mlp")
    h, weight, g = aligned(h, weight, g)
    dh = torch.empty_like(h)
    dw = torch.empty_like(weight)
    bf16 = h.dtype == torch.bfloat16
    ws = (torch.empty(dw_workspace_shape(M, K, N), device=h.device,
                      dtype=torch.float32) if bf16 else None)
    rc = lib.xfm_act_matmul_bwd(
        h.data_ptr(), weight.data_ptr(), g.data_ptr(), dh.data_ptr(),
        dw.data_ptr(), ws.data_ptr() if bf16 else None, M, K, N,
        FUSED_ACT_ID[act], ws.shape[0] if bf16 else 1, int(bf16),
        stream_of(h))
    check(rc, "fused MLP backward launch")
    LAUNCHES["fused_mlp_bwd"] += 1
    return dh, dw, g.sum(0, dtype=torch.float32).to(h.dtype)


class _ActMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, weight, bias, act):
        fwd = (act_matmul_fwd if on_card(h, "fused MLP")
               else act_matmul_reference)
        ctx.save_for_backward(h, weight)
        ctx.act = act
        return fwd(h, weight, bias, act)

    @staticmethod
    def backward(ctx, g):
        h, weight = ctx.saved_tensors
        bwd = (act_matmul_bwd if on_card(h, "fused MLP")
               else act_matmul_bwd_reference)
        dh, dw, db = bwd(h, weight, g.to(h.dtype), ctx.act)
        return dh, dw, db, None


def act_matmul(h, weight, bias, act: str = "gelu_tanh"):
    """act(h)·Wᵀ + b for h [M, K], the Linear weight W [N, K] and b [N], all
    in one dtype; differentiable in h, W and b."""
    return _ActMatmul.apply(h, weight, bias, act)


def act_dense(x, weight, bias, act: str):
    """[..., K] → [..., N]: `act_matmul` over any leading dims."""
    y = act_matmul(x.reshape(-1, x.shape[-1]), weight, bias, act)
    return y.reshape(*x.shape[:-1], weight.shape[0])
