"""K1: BEiT self-attention over the packed qkv projection.

Port of `xfm_tpu/ops/flash_attention.py` `flash_attention_packed`
(`_packed_fwd_kernel` + `_packed_bwd_kernel`). On a CUDA tensor it runs the
hand-written Hopper kernel in `xfm_tpu_torch/csrc/packed_attention.cu`; on a
CPU tensor it runs `packed_attention_reference`, the plain PyTorch version
with the same rounding points. There is no fallback: a CUDA tensor the
kernel does not take raises.

The source note of the kernel (what it replaces, what bounds it on the card
and how the batch sum of db is made without atomics) heads the .cu file.
The library builds on first use with `nvcc` from the checkout's sources
into `build/xfm_tpu_torch/` and is loaded with ctypes.
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

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "packed_attention.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "xfm_tpu_torch"
HEAD_DIM = 64
MAX_N = 512  # N >= 512 is the long-sequence kernel K2's range

# Launches of the kernel on the card, one per wrapper call that launched
# (the backward call launches its three kernels as one). Reset by callers that
# count the launches of one run.
LAUNCHES = {"packed_attention_fwd": 0, "packed_attention_bwd": 0}

_lib = None
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
        raise RuntimeError("nvcc not found: the packed attention kernel is "
                           "built from source on a machine with the CUDA "
                           "toolkit")
    return path


def build_library() -> ctypes.CDLL:
    """Compile (once per source content) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:12]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _BUILD_DIR / f"libxfm_packed_attention_{tag}.so"
    if not so.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, str(_SRC)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)
        build_info["ptxas"] = res.stderr
    lib = ctypes.CDLL(str(so))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.xfm_packed_attention_fwd.argtypes = [vp, vp, vp, ci, ci, ci, cf, ci,
                                             vp]
    lib.xfm_packed_attention_fwd.restype = ci
    lib.xfm_packed_attention_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci,
                                             ci, ci, cf, ci, vp]
    lib.xfm_packed_attention_bwd.restype = ci
    build_info["library"] = str(so)
    _lib = lib
    return lib


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
            f"N={N} >= {MAX_N}: BEiT attention at this length belongs to the "
            "long-sequence kernel K2 (beit_attention_relpos), not ported yet")
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
    kernel moves 16-byte vectors)."""
    out = []
    for t in tensors:
        t = t.contiguous()
        if t.data_ptr() % 16:
            raise ValueError("packed attention kernel needs 16-byte aligned "
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
