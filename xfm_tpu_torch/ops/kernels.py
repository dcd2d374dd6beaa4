"""Building, loading and counting the port's CUDA kernels (K1–K5).

Every kernel library is one source `csrc/<name>.cu` with a plain C
interface. It builds on first use with `nvcc` from the checkout's sources
into `build/xfm_tpu_torch/`, keyed by the hash of the source and the shared
headers, and loads with ctypes. Each wrapper adds one to its entry of
`LAUNCHES` where it launches its kernel (a backward call that launches
several kernels counts once), and nowhere else; callers that count the
launches of one run reset the counts first.
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

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "xfm_tpu_torch"

LAUNCHES = {"packed_attention_fwd": 0, "packed_attention_bwd": 0,
            "relpos_attention_fwd": 0, "relpos_attention_bwd": 0,
            "flash_attention_fwd": 0, "flash_attention_bwd": 0,
            "fused_ln_fwd": 0, "fused_ln_bwd": 0,
            "fused_mlp_fwd": 0, "fused_mlp_bwd": 0}

_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DIMS = ctypes.c_longlong * 24  # K3's sizes and strides (csrc `Dims`)
_DP = ctypes.POINTER(ctypes.c_longlong)
# library name -> its C functions' argument types (source csrc/<name>.cu)
_LIBRARIES = {
    "packed_attention": {
        "xfm_packed_attention_fwd": [_VP] * 5 + [_CI] * 3 + [_CF, _CI, _VP],
        "xfm_packed_attention_bwd": [_VP] * 9 + [_CI] * 3 + [_CF, _CI, _VP],
    },
    "relpos_attention": {
        "xfm_relpos_attention_fwd": [_VP] * 6 + [_CI] * 6 + [_CF, _CI, _VP],
        "xfm_relpos_attention_bwd": [_VP] * 12 + [_CI] * 6 + [_CF, _CI, _VP],
    },
    "flash_attention": {
        "xfm_flash_attention_fwd": [_VP] * 6 + [_DP, _CI, _CF, _CI, _VP],
        "xfm_flash_attention_bwd": [_VP] * 12 + [_DP, _CI, _CF, _CI, _VP],
    },
    "fused_ln": {
        "xfm_fused_ln_fwd": [_VP] * 6 + [_CI] * 2 + [_CF, _CI, _VP],
        "xfm_fused_ln_bwd": [_VP] * 9 + [_CI] * 7 + [_CF, _CI, _VP],
    },
    "fused_mlp": {
        "xfm_act_matmul_fwd": [_VP] * 4 + [_CI] * 5 + [_VP],
        "xfm_act_matmul_bwd": [_VP] * 6 + [_CI] * 6 + [_VP],
    },
}
KERNEL_LIBRARIES = tuple(_LIBRARIES)
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
        raise RuntimeError("nvcc not found: the port's kernels are built "
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


def build_library(name: str) -> ctypes.CDLL:
    """Compile (once per source content) and load one kernel library."""
    lib = _libs.get(name)
    return lib if lib is not None else build_libraries(name)[name]


def check(rc: int, what: str) -> None:
    """Raise for a launch that the C side reports as failed."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def aligned(*tensors: torch.Tensor):
    """Contiguous tensors whose data starts on a 16-byte boundary (the
    kernels move 16-byte vectors)."""
    out = []
    for t in tensors:
        t = t.contiguous()
        if t.data_ptr() % 16:
            raise ValueError("the port's kernels need 16-byte aligned "
                             "tensors")
        out.append(t)
    return out


def on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (the kernel's route), False for a CPU tensor
    (the plain version's); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise NotImplementedError(f"no {what} for {t.device}")
    return True


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the C functions take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
