"""The attention kernels: BEiT self-attention over the packed qkv projection
(K1, K2) and the generic long-sequence attention (K3).

- K1, `flash_attention_packed`: port of `xfm_tpu/ops/flash_attention.py`
  `flash_attention_packed` (`_packed_fwd_kernel` + `_packed_bwd_kernel`),
  N < 512, a materialized f32 bias [1, H, N, N]; `csrc/packed_attention.cu`.
- K2, `beit_attention_relpos`: port of `beit_attention_relpos`
  (`_relpos_fwd_kernel` + `_relpos_bwd_kernel`), N = wh·ww + 1 ≥ 512, the
  rel-pos bias expanded inside the kernel from the compact table;
  `csrc/relpos_attention.cu`.
- K3, `flash_attention`: port of `flash_attention` (`_attn_fwd_kernel`,
  `_attn_bwd_loopq_kernel` and `_attn_bwd_kernel`), q/k/v [B, N, H, D] with
  an additive bias of any broadcast shape [1|B, 1|H, 1|Nq, Nk];
  `csrc/flash_attention.cu`. Reached through `ops/attention.py`
  `dot_product_attention` when Nq, Nk ≥ 512 (`flash_ok`).

On a CUDA tensor each runs its hand-written Hopper kernel; on a CPU tensor
its plain PyTorch version (`packed_attention_reference`,
`relpos_attention_reference`, `flash_attention_reference`) with the same
rounding points. There is no fallback: a CUDA tensor a kernel does not take
raises.

K1's, K2's and K3's bf16 paths are one templated set of kernels,
`csrc/attention_mma.cuh`, instantiated with each one's bias source. The
source note of each kernel (what it replaces, what bounds it on the card and
how its batch sum is made without atomics) heads its .cu file. Building,
loading and launch counting are `ops/kernels.py`'s, shared with K4 and K5.
"""
from __future__ import annotations

import torch

from .attention import attention_reference
from .kernels import DIMS as _DIMS
from .kernels import LAUNCHES, build_library, stream_of
from .kernels import aligned as _aligned
from .kernels import build_libraries  # noqa: F401  (the tests patch it here)
from .kernels import check as _check
from .relpos import compact_rel_pos, expand_compact_rel_pos

HEAD_DIM = 64
MAX_N = 512  # N >= 512 is the long-sequence kernel K2's range


def _check_inputs(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int):
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be [B, N, 3*H*D], got {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    D = C3 // 3 // num_heads
    if N >= MAX_N:
        raise NotImplementedError(
            f"N={N} >= {MAX_N}: BEiT attention at this length goes through "
            "the long-sequence kernel K2 (beit_attention_relpos)")
    if D != HEAD_DIM:
        raise NotImplementedError(f"packed attention kernel takes D=64, got "
                                  f"D={D}")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"packed attention kernel takes bf16 or "
                                  f"f32, got {qkv.dtype}")
    if tuple(bias.shape) != (1, num_heads, N, N):
        raise NotImplementedError(f"packed attention kernel takes a shared "
                                  f"bias [1, H, N, N], got "
                                  f"{tuple(bias.shape)}")
    if bias.dtype != torch.float32:
        raise NotImplementedError(f"packed attention kernel takes an f32 "
                                  f"bias, got {bias.dtype}")
    if qkv.device.type != "cuda" or bias.device != qkv.device:
        raise ValueError(f"packed attention kernel takes qkv and bias on one "
                         f"CUDA device, got {qkv.device} and {bias.device}")
    return B, N, D


def _padded_bias(bias: torch.Tensor):
    """Room for the bf16 kernels' copy of the bias [1, H, N, N] with rows
    padded to 16 bytes (csrc `PackedBias`, written by the kernel call): f32
    [H, N, ⌈N/4⌉·4]."""
    H, N = bias.shape[1], bias.shape[2]
    return torch.empty(H, N, -(-N // 4) * 4, device=bias.device,
                       dtype=torch.float32)


def packed_attention_fwd(qkv: torch.Tensor, bias: torch.Tensor, scale: float,
                         num_heads: int):
    """Kernel forward: qkv [B, N, 3HD] (cuda), bias [1, H, N, N] f32 →
    (out [B, N, HD] in qkv's dtype, row statistics [2, B·H·N] f32 for the
    backward; the f32 kernels leave them unwritten and recompute them). bf16
    takes room for the kernels' padded copy of the bias (`_padded_bias`)."""
    B, N, _ = _check_inputs(qkv, bias, num_heads)
    lib = build_library("packed_attention")
    qkv, bias = _aligned(qkv, bias)
    out = torch.empty(B, N, qkv.shape[-1] // 3, device=qkv.device,
                      dtype=qkv.dtype)
    stats = torch.empty(2, B * num_heads * N, device=qkv.device,
                        dtype=torch.float32)
    bf16 = qkv.dtype == torch.bfloat16
    pad = _padded_bias(bias) if bf16 else None
    rc = lib.xfm_packed_attention_fwd(
        qkv.data_ptr(), bias.data_ptr(), pad.data_ptr() if bf16 else None,
        out.data_ptr(), stats.data_ptr(), B, N, num_heads, float(scale),
        int(bf16), stream_of(qkv))
    _check(rc, "packed attention forward launch")
    LAUNCHES["packed_attention_fwd"] += 1
    return out, stats


def packed_attention_bwd(qkv: torch.Tensor, bias: torch.Tensor,
                         out: torch.Tensor, stats: torch.Tensor,
                         dout: torch.Tensor, scale: float, num_heads: int):
    """Kernel backward from the forward's output `out` and row statistics
    (the bf16 kernels take delta = rowsum(dout ⊙ out) from `out`) → (dqkv
    like qkv, db [1, H, N, N] f32 summed over the batch). bf16 writes db
    directly (and takes room for its padded copy of the bias, as the
    forward); f32 writes every ds row to a scratch [B, H, N, N] f32 first
    and recomputes the statistics into a scratch of its own."""
    B, N, _ = _check_inputs(qkv, bias, num_heads)
    C = qkv.shape[-1] // 3
    for name, t in (("dout", dout), ("out", out)):
        if t.shape != (B, N, C) or t.device != qkv.device:
            raise ValueError(f"{name} must be [B, N, H*D] beside qkv, got "
                             f"{tuple(t.shape)} on {t.device}")
    if out.dtype != qkv.dtype or not out.is_contiguous():
        raise ValueError("out must be the forward's output: contiguous, in "
                         "qkv's dtype")
    if stats.shape != (2, B * num_heads * N):
        raise ValueError(f"stats must be [2, B*H*N], got {tuple(stats.shape)}")
    lib = build_library("packed_attention")
    qkv, bias, out, stats, dout = _aligned(qkv, bias, out, stats,
                                           dout.to(qkv.dtype))
    dqkv = torch.empty_like(qkv)
    db = torch.empty(1, num_heads, N, N, device=qkv.device,
                     dtype=torch.float32)
    bf16 = qkv.dtype == torch.bfloat16
    if bf16:
        scratch = torch.empty(B * num_heads * N, device=qkv.device,
                              dtype=torch.float32)  # delta
    else:
        stats = torch.empty_like(stats)
        scratch = torch.empty(B, num_heads, N, N, device=qkv.device,
                              dtype=torch.float32)  # ds
    pad = _padded_bias(bias) if bf16 else None
    rc = lib.xfm_packed_attention_bwd(
        qkv.data_ptr(), bias.data_ptr(), pad.data_ptr() if bf16 else None,
        out.data_ptr(), stats.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
        db.data_ptr(), scratch.data_ptr(), B, N, num_heads, float(scale),
        int(bf16), stream_of(qkv))
    _check(rc, "packed attention backward launch")
    LAUNCHES["packed_attention_bwd"] += 1
    return dqkv, db


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, scale, num_heads):
        out, stats = packed_attention_fwd(qkv, bias, scale, num_heads)
        # the output is saved, not recomputed: the caller's out-projection
        # keeps the same storage alive
        ctx.save_for_backward(qkv, bias, out, stats)
        ctx.scale, ctx.num_heads = scale, num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, out, stats = ctx.saved_tensors
        dqkv, db = packed_attention_bwd(qkv, bias, out, stats, dout,
                                        ctx.scale, ctx.num_heads)
        return dqkv, db.to(bias.dtype), None, None


def packed_attention_reference(qkv: torch.Tensor, bias: torch.Tensor,
                               scale: float, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same rounding points; autograd
    through it is the plain backward."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    q, k, v = (t.reshape(B, N, num_heads, D) for t in qkv.split(C, dim=-1))
    return attention_reference(q, k, v, bias, scale).reshape(B, N, C)


def flash_attention_packed(qkv: torch.Tensor, bias: torch.Tensor,
                           scale: float, num_heads: int) -> torch.Tensor:
    """softmax((q·scale)kᵀ + bias)·v from the packed projection
    qkv [B, N, 3·H·D] (layout [q ‖ k ‖ v]) with bias [1, H, N, N] →
    [B, N, H·D]. CPU tensor: the plain version. CUDA tensor: the kernel, or
    an error for what it does not take."""
    if qkv.device.type == "cpu":
        return packed_attention_reference(qkv, bias, scale, num_heads)
    if qkv.device.type != "cuda":
        raise NotImplementedError(f"no packed attention for {qkv.device}")
    return _PackedAttention.apply(qkv, bias, scale, num_heads)


# ---------------------------------------------------------------------------
# K2: the long-sequence BEiT attention, rel-pos bias expanded in the kernel


def relpos_inkernel_ok(n: int, window) -> bool:
    """Dispatch predicate for K2 (`xfm_tpu/ops/flash_attention.py`
    `relpos_inkernel_ok` without its TPU and environment switches):
    N == wh·ww + 1 and N ≥ 512."""
    wh, ww = window
    return n == wh * ww + 1 and n >= MAX_N


def _check_relpos_inputs(qkv, cr, cls3, window, num_heads: int):
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be [B, N, 3*H*D], got {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    D = C3 // 3 // num_heads
    wh, ww = window
    if wh < 1 or ww < 1 or N != wh * ww + 1:
        raise ValueError(f"rel-pos attention needs N == wh*ww + 1, got N={N} "
                         f"and window {tuple(window)}")
    if D != HEAD_DIM:
        raise NotImplementedError(f"rel-pos attention kernel takes D=64, got "
                                  f"D={D}")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"rel-pos attention kernel takes bf16 or "
                                  f"f32, got {qkv.dtype}")
    if tuple(cr.shape) != (num_heads, ww, (2 * wh - 1) * ww):
        raise ValueError(f"compact table must be [H, ww, (2wh-1)*ww], got "
                         f"{tuple(cr.shape)}")
    if cr.dtype != qkv.dtype:
        raise NotImplementedError(f"rel-pos attention kernel takes the table "
                                  f"in the dtype of qkv ({qkv.dtype}), got "
                                  f"{cr.dtype}")
    if tuple(cls3.shape) != (num_heads, 3) or cls3.dtype != torch.float32:
        raise ValueError(f"cls3 must be f32 [H, 3], got {cls3.dtype} "
                         f"{tuple(cls3.shape)}")
    if qkv.device.type != "cuda" or {cr.device, cls3.device} != {qkv.device}:
        raise ValueError(f"rel-pos attention kernel takes qkv and its tables "
                         f"on one CUDA device, got {qkv.device}, {cr.device} "
                         f"and {cls3.device}")
    return B, N


def _shifted_table(cr: torch.Tensor, window):
    """Room for the bf16 kernels' eight shifted copies of the table
    (csrc `RelposBias`, written by the kernel call) → (crs [H, 8, P], P),
    or (None, 0) for f32."""
    if cr.dtype != torch.bfloat16:
        return None, 0
    wh, ww = window
    P = -(-(ww * (2 * wh - 1) * ww + 71) // 8) * 8
    return torch.empty(cr.shape[0], 8, P, device=cr.device, dtype=cr.dtype), P


def relpos_attention_fwd(qkv: torch.Tensor, cr: torch.Tensor,
                         cls3: torch.Tensor, window, scale: float,
                         num_heads: int):
    """Kernel forward: qkv [B, N, 3HD] (cuda), compact table cr
    [H, ww, (2wh−1)·ww] in qkv's dtype, cls3 [H, 3] f32 → (out [B, N, HD]
    in qkv's dtype, row statistics [2, B·H·N] f32 for the backward)."""
    B, N = _check_relpos_inputs(qkv, cr, cls3, window, num_heads)
    lib = build_library("relpos_attention")
    qkv, cr, cls3 = _aligned(qkv, cr, cls3)
    out = torch.empty(B, N, qkv.shape[-1] // 3, device=qkv.device,
                      dtype=qkv.dtype)
    stats = torch.empty(2, B * num_heads * N, device=qkv.device,
                        dtype=torch.float32)
    crs, P = _shifted_table(cr, window)
    stream = stream_of(qkv)
    rc = lib.xfm_relpos_attention_fwd(
        qkv.data_ptr(), cr.data_ptr(), cls3.data_ptr(),
        crs.data_ptr() if crs is not None else None, out.data_ptr(),
        stats.data_ptr(), B, N, num_heads, window[0], window[1], P,
        float(scale), int(qkv.dtype == torch.bfloat16), stream)
    _check(rc, "rel-pos attention forward launch")
    LAUNCHES["relpos_attention_fwd"] += 1
    return out, stats


def relpos_attention_bwd(qkv: torch.Tensor, cr: torch.Tensor,
                         cls3: torch.Tensor, out: torch.Tensor,
                         stats: torch.Tensor, dout: torch.Tensor, window,
                         scale: float, num_heads: int):
    """Kernel backward from the forward's output `out` and row statistics
    (the bf16 kernels take delta = rowsum(dout ⊙ out) from `out`) → (dqkv
    like qkv, dcr f32 like cr, dcls f32 [H, 3]), the table gradients summed
    over the batch. bf16 sums ds over the batch into db [H, N, N] f32; f32
    writes it to a scratch [B, H, N, ⌈N/64⌉·64] f32 first. bf16 also
    takes room for its shifted copies of the table, as the forward."""
    B, N = _check_relpos_inputs(qkv, cr, cls3, window, num_heads)
    C = qkv.shape[-1] // 3
    for name, t in (("dout", dout), ("out", out)):
        if t.shape != (B, N, C) or t.device != qkv.device:
            raise ValueError(f"{name} must be [B, N, H*D] beside qkv, got "
                             f"{tuple(t.shape)} on {t.device}")
    if out.dtype != qkv.dtype or not out.is_contiguous():
        raise ValueError("out must be the forward's output: contiguous, in "
                         "qkv's dtype")
    if stats.shape != (2, B * num_heads * N):
        raise ValueError(f"stats must be [2, B*H*N], got {tuple(stats.shape)}")
    lib = build_library("relpos_attention")
    qkv, cr, cls3, out, stats, dout = _aligned(qkv, cr, cls3, out, stats,
                                               dout.to(qkv.dtype))
    dqkv = torch.empty_like(qkv)
    dcr = torch.empty(cr.shape, device=qkv.device, dtype=torch.float32)
    dcls = torch.empty(num_heads, 3, device=qkv.device, dtype=torch.float32)
    bf16 = qkv.dtype == torch.bfloat16
    crs, P = _shifted_table(cr, window)
    if bf16:
        delta = torch.empty(B * num_heads * N, device=qkv.device,
                            dtype=torch.float32)
        scratch = torch.empty(num_heads, N, N, device=qkv.device,
                              dtype=torch.float32)
    else:
        delta = None
        scratch = torch.empty(B, num_heads, N, -(-N // 64) * 64,
                              device=qkv.device, dtype=torch.float32)
    stream = stream_of(qkv)
    rc = lib.xfm_relpos_attention_bwd(
        qkv.data_ptr(), cr.data_ptr(), cls3.data_ptr(),
        crs.data_ptr() if bf16 else None, out.data_ptr(), stats.data_ptr(),
        dout.data_ptr(), dqkv.data_ptr(), dcr.data_ptr(), dcls.data_ptr(),
        delta.data_ptr() if bf16 else None, scratch.data_ptr(), B, N,
        num_heads, window[0], window[1], P, float(scale), int(bf16), stream)
    _check(rc, "rel-pos attention backward launch")
    LAUNCHES["relpos_attention_bwd"] += 1
    return dqkv, dcr, dcls


class _RelposAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, cr, cls3, window, scale, num_heads):
        out, stats = relpos_attention_fwd(qkv, cr, cls3, window, scale,
                                          num_heads)
        # the output is saved, not recomputed: the caller's out-projection
        # keeps the same storage alive
        ctx.save_for_backward(qkv, cr, cls3, out, stats)
        ctx.window, ctx.scale, ctx.num_heads = window, scale, num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, cr, cls3, out, stats = ctx.saved_tensors
        dqkv, dcr, dcls = relpos_attention_bwd(qkv, cr, cls3, out, stats,
                                               dout, ctx.window, ctx.scale,
                                               ctx.num_heads)
        # the table gradient leaves in the table's dtype, as the JAX
        # package's `_relpos_core_bwd` casts it
        return dqkv, dcr.to(cr.dtype), dcls, None, None, None


def relpos_attention_reference(qkv: torch.Tensor, cr: torch.Tensor,
                               cls3: torch.Tensor, window, scale: float,
                               num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of K2, same rounding points: the bias expanded
    from the compact table (upcast exactly to f32, so that its gradient is
    summed in f32 and rounded to the table's dtype once) and plain
    attention; autograd through it is the plain backward."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    bias = expand_compact_rel_pos(cr.float(), cls3, window)
    q, k, v = (t.reshape(B, N, num_heads, D) for t in qkv.split(C, dim=-1))
    return attention_reference(q, k, v, bias, scale).reshape(B, N, C)


def beit_attention_relpos(qkv: torch.Tensor, table: torch.Tensor, window,
                          scale: float, num_heads: int,
                          bias_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """BEiT self-attention from the packed projection qkv [B, N, 3·H·D]
    (N = wh·ww + 1) with the rel-pos bias of `table`
    [(2wh−1)(2ww−1)+3, H] expanded inside the kernel → [B, N, H·D].

    As the JAX package's `beit_attention_relpos`: the compact form is
    rounded to `bias_dtype` once, the cls entries the same way; the table
    gradient flows back through `compact_rel_pos` by autograd. CPU tensor:
    the plain version. CUDA tensor: the kernel (which takes the table in
    qkv's dtype), or an error for what it does not take."""
    wh, ww = window
    cr, cls3 = compact_rel_pos(table, wh, ww)
    cr = cr.to(bias_dtype).reshape(num_heads, ww, (2 * wh - 1) * ww)
    cls3 = cls3.to(bias_dtype).float()
    if qkv.device.type == "cpu":
        return relpos_attention_reference(qkv, cr, cls3, window, scale,
                                          num_heads)
    if qkv.device.type != "cuda":
        raise NotImplementedError(f"no rel-pos attention for {qkv.device}")
    return _RelposAttention.apply(qkv, cr, cls3, tuple(window), scale,
                                  num_heads)


# ---------------------------------------------------------------------------
# K3: the generic long-sequence attention, any broadcast bias


flash_attention_reference = attention_reference


def _check_flash_inputs(q, k, v, bias):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, N, H, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    if k.shape != (B, Nk, H, D) or v.shape != k.shape:
        raise ValueError(f"k and v must be [B, Nk, H, D] beside q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if D != HEAD_DIM:
        raise NotImplementedError(f"flash attention kernel takes D=64, got "
                                  f"D={D}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"flash attention kernel takes bf16 or f32, "
                                  f"got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(f"flash attention kernel takes q, k, v in "
                                  f"one dtype, got {q.dtype}, {k.dtype} and "
                                  f"{v.dtype}")
    tensors = [q, k, v]
    if bias is not None:
        if (bias.dim() != 4 or bias.shape[0] not in (1, B)
                or bias.shape[1] not in (1, H)
                or bias.shape[2] not in (1, Nq) or bias.shape[3] != Nk):
            raise ValueError(f"bias must broadcast as [1|B, 1|H, 1|Nq, Nk] = "
                             f"[1|{B}, 1|{H}, 1|{Nq}, {Nk}], got "
                             f"{tuple(bias.shape)}")
        if bias.dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f"flash attention kernel takes an f32 "
                                      f"or bf16 bias, got {bias.dtype}")
        tensors.append(bias)
    if q.device.type != "cuda" or {t.device for t in tensors} != {q.device}:
        raise ValueError(f"flash attention kernel takes q, k, v and the bias "
                         f"on one CUDA device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    return B, Nq, Nk, H


def _rows_layout(x: torch.Tensor) -> torch.Tensor:
    """x [B, N, H, D] as the kernels read it in place: each row's [H, D]
    block dense, rows and batches at strides (and a start) that keep 16-byte
    vectors aligned. The projections' reshaped outputs are such views; other
    layouts (an expanded gradient) are copied once."""
    vec = 16 // x.element_size()
    if (x.stride(3) != 1 or x.stride(2) != x.shape[3] or x.stride(1) % vec
            or x.stride(0) % vec or x.data_ptr() % 16):
        x = x.contiguous()
        if x.data_ptr() % 16:
            raise ValueError("the attention kernels need 16-byte aligned "
                             "tensors")
    return x


def _bias_layout(bias):
    """The bias with unit stride along Nk, and its strides along b, h, q (0
    where it broadcasts) and its sizes there."""
    if bias is None:
        return None, [0] * 6
    if bias.stride(3) != 1 and bias.shape[3] > 1:
        bias = bias.contiguous()
    sizes = list(bias.shape[:3])
    strides = [bias.stride(i) if sizes[i] > 1 else 0 for i in range(3)]
    return bias, strides + sizes


def _flash_dims(q, k, v, dout, bias_fields):
    """csrc `Dims`: sizes, the in-place strides of q, k, v and dout, the
    bias's, then those of out, dq and dk/dv ([B, N, H, 64] contiguous)."""
    B, Nq, H, _ = q.shape
    Nk, C = k.shape[1], H * HEAD_DIM
    g = (dout.stride(0), dout.stride(1)) if dout is not None else (0, 0)
    return _DIMS(B, Nq, Nk, H, q.stride(0), q.stride(1), k.stride(0),
                 k.stride(1), v.stride(0), v.stride(1), *g, *bias_fields,
                 Nq * C, C, Nq * C, C, Nk * C, C)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias, scale: float):
    """Kernel forward: q [B, Nq, H, 64], k/v [B, Nk, H, 64] (cuda, bf16 or
    f32), bias None or f32/bf16 [1|B, 1|H, 1|Nq, Nk] → (out [B, Nq, H, 64]
    in q's dtype, row statistics [2, B·H·Nq] f32 for the backward)."""
    B, Nq, Nk, H = _check_flash_inputs(q, k, v, bias)
    lib = build_library("flash_attention")
    q, k, v = (_rows_layout(t) for t in (q, k, v))
    bias, bias_fields = _bias_layout(bias)
    out = torch.empty(B, Nq, H, HEAD_DIM, device=q.device, dtype=q.dtype)
    stats = torch.empty(2, B * H * Nq, device=q.device, dtype=torch.float32)
    stream = stream_of(q)
    rc = lib.xfm_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        stats.data_ptr(), _flash_dims(q, k, v, None, bias_fields),
        int(bias is not None and bias.dtype == torch.bfloat16), float(scale),
        int(q.dtype == torch.bfloat16), stream)
    _check(rc, "flash attention forward launch")
    LAUNCHES["flash_attention_fwd"] += 1
    return out, stats


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias, out: torch.Tensor, stats: torch.Tensor,
                        dout: torch.Tensor, scale: float,
                        bias_grad: bool = True):
    """Kernel backward from the forward's output `out` and row statistics
    (the bf16 kernels take delta = rowsum(dout ⊙ out) from `out`) →
    (dq like q, dk like k, dv like v, db f32 of the bias's own shape, or
    None without a bias or with `bias_grad` False: then the db kernel is not
    launched and nothing is allocated for it)."""
    B, Nq, Nk, H = _check_flash_inputs(q, k, v, bias)
    for name, t in (("dout", dout), ("out", out)):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} must be [B, Nq, H, D] beside q, got "
                             f"{tuple(t.shape)} on {t.device}")
    if out.dtype != q.dtype or not out.is_contiguous():
        raise ValueError("out must be the forward's output: contiguous, in "
                         "q's dtype")
    if stats.shape != (2, B * H * Nq):
        raise ValueError(f"stats must be [2, B*H*Nq], got "
                         f"{tuple(stats.shape)}")
    lib = build_library("flash_attention")
    q, k, v, dout = (_rows_layout(t) for t in (q, k, v, dout.to(q.dtype)))
    bias, bias_fields = _bias_layout(bias)
    dq = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    dk = torch.empty(k.shape, device=q.device, dtype=q.dtype)
    dv = torch.empty(k.shape, device=q.device, dtype=q.dtype)
    db = (torch.empty(bias.shape, device=q.device, dtype=torch.float32)
          if bias is not None and bias_grad else None)
    delta = torch.empty(B * H * Nq, device=q.device, dtype=torch.float32)
    stream = stream_of(q)
    rc = lib.xfm_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        dout.data_ptr(), stats.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        db.data_ptr() if db is not None else None,
        _flash_dims(q, k, v, dout, bias_fields),
        int(bias is not None and bias.dtype == torch.bfloat16), float(scale),
        int(q.dtype == torch.bfloat16), stream)
    _check(rc, "flash attention backward launch")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv, db


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        out, stats = flash_attention_fwd(q, k, v, bias, scale)
        # the output is saved, not recomputed: the caller's out-projection
        # keeps the same storage alive
        ctx.save_for_backward(q, k, v, bias, out, stats)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, stats = ctx.saved_tensors
        # a bias that needs no gradient (a padding mask) costs no db kernel
        dq, dk, dv, db = flash_attention_bwd(q, k, v, bias, out, stats, dout,
                                             ctx.scale,
                                             ctx.needs_input_grad[3])
        # db leaves in the bias's dtype, as the JAX package's `_bwd` casts it
        return dq, dk, dv, (db.to(bias.dtype) if db is not None
                            else None), None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias=None, scale=None) -> torch.Tensor:
    """softmax((q·scale)kᵀ + bias)·v over q [B, Nq, H, D], k/v
    [B, Nk, H, D], bias None or broadcastable as [1|B, 1|H, 1|Nq, Nk]
    (scale D^-1/2 by default) → [B, Nq, H, D] in q's dtype; the bias
    gradient is reduced to the bias's shape. CPU tensor: the plain version.
    CUDA tensor: the kernel, or an error for what it does not take."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise NotImplementedError(f"no flash attention for {q.device}")
    return _FlashAttention.apply(q, k, v, bias, scale)
