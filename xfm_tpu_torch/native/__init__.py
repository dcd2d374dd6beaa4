"""The C++ host loader (`loader.cpp`; the JAX package's
`xfm_tpu/native`): threaded JPEG/PNG decode, crop, bilinear resize and
flip into uint8 batches, and RandAugment's ops in place on them.

It builds at first use with g++ (`-O3 -march=native`, linked against
libjpeg and libpng) into `build/xfm_tpu_torch/libxfm_loader_<hash>.so`,
keyed by the hash of the source and the command, and loads with ctypes
(`RTLD_LOCAL`, so its C symbols never meet the JAX package's copy in one
process). Before building, a preprocessor probe looks for g++,
`jpeglib.h` and `png.h`: where one is missing, `available()` is False and
the reason is printed once (`unavailable_reason()`); the streams then
decode with PIL. Where they exist, a failed compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("loader.cpp")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "xfm_tpu_torch"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_LIBS = ["-ljpeg", "-lpng", "-lpthread"]
_PROBE = "#include <cstdio>\n#include <jpeglib.h>\n#include <png.h>\n"

_lock = threading.Lock()
# batches and images `decode_batch` has decoded in this process
DECODED = {"batches": 0, "images": 0}
_lib = None
_reason: str | None = None
_probed = False

# op name → code, loader.cpp's RandaugOp enum
RANDAUG_OP_CODES = {
    "Identity": 0, "AutoContrast": 1, "Equalize": 2, "Brightness": 3,
    "Sharpness": 4, "ShearX": 5, "ShearY": 6, "TranslateX": 7,
    "TranslateY": 8, "Rotate": 9, "Invert": 10, "Posterize": 11,
    "Solarize": 12, "Color": 13, "Contrast": 14,
}


def _probe() -> str | None:
    """None where g++ preprocesses libjpeg's and libpng's headers, else
    why not."""
    gxx = shutil.which("g++")
    if gxx is None:
        return "g++ not found"
    res = subprocess.run([gxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                         input=_PROBE, capture_output=True, text=True,
                         timeout=60)
    if res.returncode != 0:
        errors = [ln.split("error: ", 1)[-1].strip()
                  for ln in res.stderr.splitlines() if "error" in ln]
        return errors[0] if errors else f"g++ -E exited {res.returncode}"
    return None


def library_path() -> Path:
    """The built library's path: the source and the command hashed."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS + _LIBS).encode())
    return _BUILD_DIR / f"libxfm_loader_{h.hexdigest()[:12]}.so"


def _build(so: Path) -> None:
    """g++ into a temporary file beside `so`, then renamed onto it, so
    that processes building at once never load a half-written library."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", tmp, *_LIBS]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the native loader failed "
                           f"({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, so)


def _load(so: Path):
    lib = ctypes.CDLL(str(so))
    c_int, c_long, c_float = ctypes.c_int, ctypes.c_long, ctypes.c_float
    p_int = ctypes.POINTER(c_int)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.xfm_decode_batch_status.restype = c_int
    lib.xfm_decode_batch_status.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(c_long), p_int,
        c_int, p_int, p_u8, c_int, c_int, p_int]
    for fn in (lib.xfm_image_dims, lib.xfm_image_dims_fast):
        fn.restype = c_int
        fn.argtypes = [ctypes.c_char_p, c_long, p_int, p_int]
    lib.xfm_randaugment_batch.restype = c_int
    lib.xfm_randaugment_batch.argtypes = [
        p_u8, c_int, c_int, p_int, ctypes.POINTER(c_float), c_int, c_float,
        c_int]
    return lib


def get_lib():
    """The loaded library, built first if needed; None where the toolchain
    or the headers are missing (the reason printed once)."""
    global _lib, _reason, _probed
    with _lock:
        if _lib is not None or _probed:
            return _lib
        _probed = True
        _reason = _probe()
        if _reason is not None:
            print(f"native_loader: unavailable ({_reason})", flush=True)
            return None
        so = library_path()
        if not so.exists():
            _build(so)
        _lib = _load(so)
        return _lib


def available() -> bool:
    return get_lib() is not None


def unavailable_reason() -> str | None:
    """Why the loader is unavailable, or None where it loads."""
    get_lib()
    return _reason


def _require():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native loader is unavailable ({_reason})")
    return lib


def _threads(threads: int | None) -> int:
    return threads if threads is not None else min(
        max(os.cpu_count() or 4, 1), 16)


def image_dims(data: bytes, fast: bool = False):
    """(w, h) of an encoded image, or None where it does not decode.
    `fast=True` reads the JPEG SOF or PNG IHDR header alone, and decodes
    in full only where that parse fails."""
    lib = _require()
    w, h = ctypes.c_int(), ctypes.c_int()
    if fast and lib.xfm_image_dims_fast(data, len(data), ctypes.byref(w),
                                        ctypes.byref(h)) == 0:
        return w.value, h.value
    if lib.xfm_image_dims(data, len(data), ctypes.byref(w),
                          ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def randaugment_batch(images: np.ndarray, plans: list, m: float,
                      threads: int | None = None) -> None:
    """RandAugment plans applied IN PLACE to a C-contiguous [B, S, S, 3]
    uint8 batch; `plans[i]` is `RandomAugment.plan()`'s [(name, sign)] of
    image i."""
    lib = _require()
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError("randaugment_batch takes uint8 [B, S, S, 3]")
    if not images.flags["C_CONTIGUOUS"]:  # a copy would drop the results
        raise ValueError("randaugment_batch works in place: pass a "
                         "C-contiguous batch")
    n, s = images.shape[0], images.shape[1]
    max_ops = max([len(p) for p in plans] + [1])
    codes = np.full((n, max_ops), -1, np.int32)
    signs = np.zeros((n, max_ops), np.float32)
    for i, plan in enumerate(plans):
        for k, (name, sign) in enumerate(plan):
            codes[i, k] = RANDAUG_OP_CODES[name]
            signs[i, k] = sign
    lib.xfm_randaugment_batch(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, s,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        signs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_ops, float(m), _threads(threads))


def decode_batch(blobs: list, out_size: int, crops=None, hflips=None,
                 threads: int | None = None):
    """Encoded JPEG/PNG blobs → (uint8 [B, out_size, out_size, 3], status
    int32 [B]: 0 decoded, 1 failed and zero-filled). crops: [B, 4] int32
    (x, y, w, h; w <= 0 takes the full frame); hflips: [B] int32."""
    lib = _require()
    n = len(blobs)
    crops = np.ascontiguousarray(
        np.zeros((n, 4)) if crops is None else crops, np.int32)
    hflips = np.ascontiguousarray(
        np.zeros((n,)) if hflips is None else hflips, np.int32)
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    status = np.zeros((n,), np.int32)
    datas = (ctypes.c_char_p * n)(*blobs)
    lens = (ctypes.c_long * n)(*[len(b) for b in blobs])
    lib.xfm_decode_batch_status(
        ctypes.cast(datas, ctypes.POINTER(ctypes.c_char_p)),
        ctypes.cast(lens, ctypes.POINTER(ctypes.c_long)),
        crops.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), out_size,
        hflips.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
        _threads(threads),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    with _lock:
        DECODED["batches"] += 1
        DECODED["images"] += n
    return out, status
