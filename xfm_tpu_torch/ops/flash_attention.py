"""BEiT self-attention over the packed qkv projection: two kernels.

- K1, `flash_attention_packed`: port of `xfm_tpu/ops/flash_attention.py`
  `flash_attention_packed` (`_packed_fwd_kernel` + `_packed_bwd_kernel`),
  N < 512, a materialized f32 bias; `csrc/packed_attention.cu`.
- K2, `beit_attention_relpos`: port of `beit_attention_relpos`
  (`_relpos_fwd_kernel` + `_relpos_bwd_kernel`), N = wh·ww + 1 ≥ 512, the
  rel-pos bias expanded inside the kernel from the compact table;
  `csrc/relpos_attention.cu`.

On a CUDA tensor each runs its hand-written Hopper kernel; on a CPU tensor
its plain PyTorch version (`packed_attention_reference`,
`relpos_attention_reference`) with the same rounding points. There is no
fallback: a CUDA tensor a kernel does not take raises.

The source note of each kernel (what it replaces, what bounds it on the card
and how its batch sum is made without atomics) heads its .cu file. The
libraries build on first use with `nvcc` from the checkout's sources into
`build/xfm_tpu_torch/`, keyed by the sources' hash, and load with ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .attention import attention_reference
from .relpos import compact_rel_pos, expand_compact_rel_pos

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "xfm_tpu_torch"
HEAD_DIM = 64
MAX_N = 512  # N >= 512 is the long-sequence kernel K2's range

# Launches of the kernels on the card, one per wrapper call that launched
# (a backward call launches its kernels as one). Reset by callers that count
# the launches of one run.
LAUNCHES = {"packed_attention_fwd": 0, "packed_attention_bwd": 0,
            "relpos_attention_fwd": 0, "relpos_attention_bwd": 0}

_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library name -> its C functions' argument types (source csrc/<name>.cu)
_LIBRARIES = {
    "packed_attention": {
        "xfm_packed_attention_fwd": [_VP] * 3 + [_CI] * 3 + [_CF, _CI, _VP],
        "xfm_packed_attention_bwd": [_VP] * 7 + [_CI] * 3 + [_CF, _CI, _VP],
    },
    "relpos_attention": {
        "xfm_relpos_attention_fwd": [_VP] * 5 + [_CI] * 5 + [_CF, _CI, _VP],
        "xfm_relpos_attention_bwd": [_VP] * 9 + [_CI] * 5 + [_CF, _CI, _VP],
    },
}
_libs: dict = {}
# library name -> {"library": path of the .so, "ptxas": nvcc's -Xptxas -v
# report when this process built it}
build_info: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the attention kernels are built "
                           "from source on a machine with the CUDA toolkit")
    return path


def _so_path(name: str) -> Path:
    """Library path keyed by the hash of its source and the shared
    headers."""
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return _BUILD_DIR / f"libxfm_{name}_{h.hexdigest()[:12]}.so"


def build_libraries(*names: str) -> dict:
    """Compile the named kernel libraries that are not built yet, one nvcc
    process each, all started together, and load them. → {name: CDLL}.
    A library loaded once is returned without touching a file: the
    wrappers call this before every launch."""
    missing = {n: _so_path(n) for n in names if n not in _libs}
    if missing:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, so in missing.items():
        if so.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        log = tempfile.TemporaryFile(mode="w+")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, str(_CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=log, stderr=log, text=True),
                      tmp, so, log)
    failed = []
    for name, (proc, tmp, so, log) in jobs.items():
        rc = proc.wait()
        log.seek(0)
        report = log.read()
        log.close()
        if rc != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {name} ({rc}):\n{report}")
            continue
        os.replace(tmp, so)
        build_info.setdefault(name, {})["ptxas"] = report
    if failed:
        raise RuntimeError("\n".join(failed))
    for name, so in missing.items():
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _LIBRARIES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _CI
        build_info.setdefault(name, {})["library"] = str(so)
        _libs[name] = lib
    return {name: _libs[name] for name in names}


def build_library(name: str = "packed_attention") -> ctypes.CDLL:
    """Compile (once per source content) and load one kernel library."""
    lib = _libs.get(name)
    return lib if lib is not None else build_libraries(name)[name]


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


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


def _aligned(*tensors: torch.Tensor):
    """Contiguous tensors whose data starts on a 16-byte boundary (the
    kernels move 16-byte vectors)."""
    out = []
    for t in tensors:
        t = t.contiguous()
        if t.data_ptr() % 16:
            raise ValueError("the attention kernels need 16-byte aligned "
                             "tensors")
        out.append(t)
    return out


def packed_attention_fwd(qkv: torch.Tensor, bias: torch.Tensor, scale: float,
                         num_heads: int) -> torch.Tensor:
    """Kernel forward: qkv [B, N, 3HD] (cuda), bias [1, H, N, N] f32 →
    out [B, N, HD] in qkv's dtype."""
    B, N, _ = _check_inputs(qkv, bias, num_heads)
    lib = build_library()
    qkv, bias = _aligned(qkv, bias)
    out = torch.empty(B, N, qkv.shape[-1] // 3, device=qkv.device,
                      dtype=qkv.dtype)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = lib.xfm_packed_attention_fwd(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), B, N, num_heads,
        float(scale), int(qkv.dtype == torch.bfloat16), stream)
    _check(rc, "packed attention forward launch")
    LAUNCHES["packed_attention_fwd"] += 1
    return out


def packed_attention_bwd(qkv: torch.Tensor, bias: torch.Tensor,
                         dout: torch.Tensor, scale: float, num_heads: int):
    """Kernel backward → (dqkv like qkv, db [1, H, N, N] f32 summed over the
    batch)."""
    B, N, _ = _check_inputs(qkv, bias, num_heads)
    if dout.shape != (B, N, qkv.shape[-1] // 3) or dout.device != qkv.device:
        raise ValueError(f"dout must be [B, N, H*D] beside qkv, got "
                         f"{tuple(dout.shape)} on {dout.device}")
    lib = build_library()
    qkv, bias, dout = _aligned(qkv, bias, dout.to(qkv.dtype))
    dqkv = torch.empty_like(qkv)
    db = torch.empty(1, num_heads, N, N, device=qkv.device,
                     dtype=torch.float32)
    stats = torch.empty(2, B * num_heads * N, device=qkv.device,
                        dtype=torch.float32)
    ds_rows = torch.empty(B, num_heads, N, N, device=qkv.device,
                          dtype=torch.float32)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = lib.xfm_packed_attention_bwd(
        qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
        db.data_ptr(), stats.data_ptr(), ds_rows.data_ptr(), B, N, num_heads,
        float(scale), int(qkv.dtype == torch.bfloat16), stream)
    _check(rc, "packed attention backward launch")
    LAUNCHES["packed_attention_bwd"] += 1
    return dqkv, db


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, scale, num_heads):
        ctx.save_for_backward(qkv, bias)
        ctx.scale, ctx.num_heads = scale, num_heads
        return packed_attention_fwd(qkv, bias, scale, num_heads)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias = ctx.saved_tensors
        dqkv, db = packed_attention_bwd(qkv, bias, dout, ctx.scale,
                                        ctx.num_heads)
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
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = lib.xfm_relpos_attention_fwd(
        qkv.data_ptr(), cr.data_ptr(), cls3.data_ptr(), out.data_ptr(),
        stats.data_ptr(), B, N, num_heads, window[0], window[1],
        float(scale), int(qkv.dtype == torch.bfloat16), stream)
    _check(rc, "rel-pos attention forward launch")
    LAUNCHES["relpos_attention_fwd"] += 1
    return out, stats


def relpos_attention_bwd(qkv: torch.Tensor, cr: torch.Tensor,
                         cls3: torch.Tensor, stats: torch.Tensor,
                         dout: torch.Tensor, window, scale: float,
                         num_heads: int):
    """Kernel backward → (dqkv like qkv, dcr f32 like cr, dcls f32 [H, 3]),
    the table gradients summed over the batch."""
    B, N = _check_relpos_inputs(qkv, cr, cls3, window, num_heads)
    if dout.shape != (B, N, qkv.shape[-1] // 3) or dout.device != qkv.device:
        raise ValueError(f"dout must be [B, N, H*D] beside qkv, got "
                         f"{tuple(dout.shape)} on {dout.device}")
    if stats.shape != (2, B * num_heads * N):
        raise ValueError(f"stats must be [2, B*H*N], got {tuple(stats.shape)}")
    lib = build_library("relpos_attention")
    qkv, cr, cls3, stats, dout = _aligned(qkv, cr, cls3, stats,
                                          dout.to(qkv.dtype))
    dqkv = torch.empty_like(qkv)
    dcr = torch.empty(cr.shape, device=qkv.device, dtype=torch.float32)
    dcls = torch.empty(num_heads, 3, device=qkv.device, dtype=torch.float32)
    npad = -(-N // 64) * 64
    ds_rows = torch.empty(B, num_heads, N, npad, device=qkv.device,
                          dtype=torch.float32)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = lib.xfm_relpos_attention_bwd(
        qkv.data_ptr(), cr.data_ptr(), cls3.data_ptr(), stats.data_ptr(),
        dout.data_ptr(), dqkv.data_ptr(), dcr.data_ptr(), dcls.data_ptr(),
        ds_rows.data_ptr(), B, N, num_heads, window[0], window[1],
        float(scale), int(qkv.dtype == torch.bfloat16), stream)
    _check(rc, "rel-pos attention backward launch")
    LAUNCHES["relpos_attention_bwd"] += 1
    return dqkv, dcr, dcls


class _RelposAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, cr, cls3, window, scale, num_heads):
        out, stats = relpos_attention_fwd(qkv, cr, cls3, window, scale,
                                          num_heads)
        ctx.save_for_backward(qkv, cr, cls3, stats)
        ctx.window, ctx.scale, ctx.num_heads = window, scale, num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, cr, cls3, stats = ctx.saved_tensors
        dqkv, dcr, dcls = relpos_attention_bwd(qkv, cr, cls3, stats, dout,
                                               ctx.window, ctx.scale,
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
