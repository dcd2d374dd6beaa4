"""K1's, K2's, K3's, K4's and K5's kernel times at their main shapes, from
one checkout or several in turns on one card.

    python3 -m xfm_tpu_torch.ab_kernels ROOT [ROOT ...]
    python3 -m xfm_tpu_torch.ab_kernels --k4-split ROOT

For each ROOT in the order given (a checkout holding `xfm_tpu_torch/`, e.g.
a parent unpacked by `git archive` beside this one: `build/parent . .
build/parent`), a fresh process imports that checkout's package, builds its
kernels, runs the card for 2 s so that its clocks are up, and prints one
JSON line: K1 (`packed_attention_fwd` / `_bwd`, qkv [96, 197, 2304] bf16,
bias [1, 12, 197, 197] f32), K2 (`relpos_attention_fwd` / `_bwd`, qkv
[32, 577, 2304] bf16, window 24 × 24), K3 (`flash_attention_fwd` / `_bwd`,
q/k/v [32, 577, 12, 64] bf16, no bias) and K5 (`act_matmul_fwd` / `_bwd`,
h [18912, 3072], W [768, 3072] bf16, tanh-GELU; also ReLU's forward, whose
act costs next to nothing, and the text rows' M = 1,440), ms each, from
CUDA events over 20 launches after 3 warm-up launches; K1's and K5's times
by kernel at the main shape (`torch.profiler` over 10 calls, the mean of
each kernel's recorded launches); and K4 (`fused_ln_fwd` / `_bwd`, C = 768
bf16) at its three sites of the fused pretrain step, the BEiT add at
R = 18,912 and the post-LN at the fusion's 5,760 and the text's 1,440
rows: device time a call (CUDA events around 20 calls queued behind a
sleeping kernel, so that the host's launch time, which at these sizes is
longer than the kernels', does not count) and the backward by kernel;
beside the card's name and power limit.

`--k4-split` times K4's backward (device time a call) at the three sites
as the checkout builds it and as a throwaway variant built from its source
into build/ab_kernels/ without the fold across blocks (each block writes
its partial dγ/dβ rows and ends, so dγ and dβ are not finished), which
splits the kernel's time between the row pass and the fold; and, at the
BEiT site, with the plan's ring set 2, 3 and 4 stages deep. Needs a CUDA
card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

_PRELUDE = r"""
import ctypes, inspect, json, os, subprocess, sys, time
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from xfm_tpu_torch.ops import flash_attention as fa
from xfm_tpu_torch.ops import fused_ln as fl
from xfm_tpu_torch.ops import fused_mlp as fm
from xfm_tpu_torch.ops import kernels
from xfm_tpu_torch.ops.relpos import compact_rel_pos


def ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


K4_SITES = (("beit_add", 18912, "add"), ("fusion_post", 5760, "post"),
            ("text_post", 1440, "post"))


def by_kernel(fn, iters=10):
    # ms of each kernel fn launches, keyed by its name up to "(",
    # namespaces dropped: the mean over the launches the profiler recorded
    # (it now and then drops some, or all: then try again). Each kernel
    # here launches once a call.
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        runs = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.replace("(anonymous namespace)::", "").replace("void ", "")
                runs.setdefault(name.split("(")[0][:60], []).append(e.time_range.elapsed_us() / 1e3)
        if runs:
            return {k: sum(v) / len(v) for k, v in runs.items()}
    raise RuntimeError("the profiler recorded no kernel")


def dev_ms(fn, iters=20):
    # device ms a call: CUDA events around `iters` calls queued behind a
    # sleeping kernel, so that the card runs them back to back whatever the
    # host's launch time
    fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
t0 = time.time()
while time.time() - t0 < 2:  # the card's clocks up before anything is timed
    a @ a
    torch.cuda.synchronize()
del a
r = np.random.RandomState(1)
bf = torch.bfloat16


def k4_inputs(R, variant):
    x, y, dh, dxn = (torch.from_numpy(r.randn(R, 768).astype(np.float32)).cuda().to(bf)
                     for _ in range(4))
    g = torch.from_numpy((0.3 * r.randn(768) + 1).astype(np.float32)).cuda()
    b = torch.from_numpy((0.1 * r.randn(768)).astype(np.float32)).cuda()
    xn, _ = fl.fused_ln_fwd(x, y, g, b, 1e-6)
    return x, y, g, b, xn, dh, dxn if variant == "add" else None


"""

_TIMES = r"""
B, (wh, ww), H, scale = 32, (24, 24), 12, 0.125
N = wh * ww + 1
qkv = torch.from_numpy(r.randn(B, N, 3 * H * 64).astype(np.float32)).cuda().to(bf)
table = torch.from_numpy(0.5 * r.randn((2 * wh - 1) * (2 * ww - 1) + 3, H).astype(np.float32))
dout = torch.from_numpy(r.randn(B, N, H * 64).astype(np.float32)).cuda().to(bf)
cr, cls3 = compact_rel_pos(table, wh, ww)
cr = cr.to(bf).reshape(H, ww, (2 * wh - 1) * ww).contiguous().cuda()
cls3 = cls3.to(bf).float().cuda()
out, stats = fa.relpos_attention_fwd(qkv, cr, cls3, (wh, ww), scale, H)
# a checkout from before the backward took the forward's output
takes_out = "out" in inspect.signature(fa.relpos_attention_bwd).parameters
args = (qkv, cr, cls3) + ((out,) if takes_out else ()) + (stats, dout, (wh, ww), scale, H)
res = {"k2_fwd_ms": ms(lambda: fa.relpos_attention_fwd(qkv, cr, cls3, (wh, ww), scale, H)),
       "k2_bwd_ms": ms(lambda: fa.relpos_attention_bwd(*args))}
q, k, v, g = (torch.from_numpy(r.randn(B, N, H, 64).astype(np.float32)).cuda().to(bf)
              for _ in range(4))
o, st = fa.flash_attention_fwd(q, k, v, None, scale)
res["k3_fwd_ms"] = ms(lambda: fa.flash_attention_fwd(q, k, v, None, scale))
res["k3_bwd_ms"] = ms(lambda: fa.flash_attention_bwd(q, k, v, None, o, st, g, scale))
# K1; a checkout from before its forward returned the row statistics takes
# (qkv, bias, dout) in its backward
B1, N1 = 96, 197
qkv1 = torch.from_numpy(r.randn(B1, N1, 3 * H * 64).astype(np.float32)).cuda().to(bf)
bias1 = torch.from_numpy(0.5 * r.randn(1, H, N1, N1).astype(np.float32)).cuda()
dout1 = torch.from_numpy(r.randn(B1, N1, H * 64).astype(np.float32)).cuda().to(bf)
fwd1 = fa.packed_attention_fwd(qkv1, bias1, scale, H)
if isinstance(fwd1, tuple):
    args1 = (qkv1, bias1) + fwd1 + (dout1, scale, H)
else:
    args1 = (qkv1, bias1, dout1, scale, H)
res["k1_fwd_ms"] = ms(lambda: fa.packed_attention_fwd(qkv1, bias1, scale, H))
res["k1_bwd_ms"] = ms(lambda: fa.packed_attention_bwd(*args1))
res["k1_bwd_by_kernel"] = by_kernel(lambda: fa.packed_attention_bwd(*args1))
M5, K5, N5 = 18912, 3072, 768
h5 = torch.from_numpy(2 * r.randn(M5, K5).astype(np.float32)).cuda().to(bf)
w5 = torch.from_numpy(0.02 * r.randn(N5, K5).astype(np.float32)).cuda().to(bf)
b5 = torch.from_numpy(0.1 * r.randn(N5).astype(np.float32)).cuda().to(bf)
g5 = torch.from_numpy(r.randn(M5, N5).astype(np.float32)).cuda().to(bf)
res["k5_fwd_ms"] = ms(lambda: fm.act_matmul_fwd(h5, w5, b5, "gelu_tanh"))
res["k5_bwd_ms"] = ms(lambda: fm.act_matmul_bwd(h5, w5, g5, "gelu_tanh"))
res["k5_fwd_relu_ms"] = ms(lambda: fm.act_matmul_fwd(h5, w5, b5, "relu"))
res["k5_bwd_by_kernel"] = by_kernel(lambda: fm.act_matmul_bwd(h5, w5, g5, "gelu_tanh"))
h6, g6 = h5[:1440].contiguous(), g5[:1440].contiguous()
res["k5_m1440_fwd_ms"] = ms(lambda: fm.act_matmul_fwd(h6, w5, b5, "gelu_tanh"))
res["k5_m1440_bwd_ms"] = ms(lambda: fm.act_matmul_bwd(h6, w5, g6, "gelu_tanh"))
for site, R, variant in K4_SITES:
    x, y, g, b, xn, dh, dxn = k4_inputs(R, variant)
    res[f"k4_{site}_fwd_ms"] = dev_ms(lambda: fl.fused_ln_fwd(x, y, g, b, 1e-6))
    res[f"k4_{site}_bwd_ms"] = dev_ms(lambda: fl.fused_ln_bwd(xn, dh, dxn, g, 1e-6))
    res[f"k4_{site}_bwd_by_kernel"] = by_kernel(lambda: fl.fused_ln_bwd(xn, dh, dxn, g, 1e-6), 20)
res["device"] = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(json.dumps(res))
"""

_K4_SPLIT = r"""
# the fold across blocks cut out of the checkout's source: a timing variant
CUT = ("  // Across blocks: the last block",
       "  return;  // timing variant: no fold across blocks\n"
       "  // Across blocks: the last block")
src = open("xfm_tpu_torch/csrc/fused_ln.cu").read()
if CUT[0] not in src:
    raise SystemExit("this checkout's K4 backward has no fold across blocks to cut")
os.makedirs("build/ab_kernels", exist_ok=True)
cu, so = "build/ab_kernels/fused_ln_nofold.cu", "build/ab_kernels/libfused_ln_nofold.so"
open(cu, "w").write(src.replace(*CUT))
subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                "-shared", "-Xcompiler", "-fPIC", "-I", "xfm_tpu_torch/csrc", "-o", so, cu],
               check=True, capture_output=True, text=True)
nofold = ctypes.CDLL(so)
for fn, argtypes in kernels._LIBRARIES["fused_ln"].items():
    getattr(nofold, fn).argtypes = argtypes
    getattr(nofold, fn).restype = ctypes.c_int
built = kernels.build_library("fused_ln")
res = {}
for site, R, variant in K4_SITES:
    x, y, g, b, xn, dh, dxn = k4_inputs(R, variant)
    for name, lib in (("kernel", built), ("no_fold", nofold)):
        kernels._libs["fused_ln"] = lib
        res[f"k4_{site}_bwd_{name}_ms"] = dev_ms(
            lambda: fl.fused_ln_bwd(xn, dh, dxn, g, 1e-6))
    kernels._libs["fused_ln"] = built
plan = fl.bwd_plan
x, y, g, b, xn, dh, dxn = k4_inputs(18912, "add")
for stages in (2, 3, 4):
    def deeper(R, C, dtype, sms, has_dxn=True):
        p = plan(R, C, dtype, sms, has_dxn)
        extra = (stages - p.stages) * p.copy_bytes * (3 if has_dxn else 2)
        return p._replace(stages=stages, smem=p.smem + extra)
    fl.bwd_plan = deeper
    res[f"k4_beit_add_bwd_{stages}_stages_ms"] = dev_ms(
        lambda: fl.fused_ln_bwd(xn, dh, dxn, g, 1e-6))
fl.bwd_plan = plan
res["device"] = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(json.dumps(res))
"""


def _run(script: str, root: str) -> dict:
    """Run `script` in a fresh process that imports the checkout at root;
    → its last line's JSON."""
    res = subprocess.run([sys.executable, "-c", script], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(res.stdout + res.stderr)
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    script = _PRELUDE + _TIMES
    if args[:1] == ["--k4-split"]:
        script, args = _PRELUDE + _K4_SPLIT, args[1:]
    for root in args or ["."]:
        root = os.path.abspath(root)
        line = _run(script, root)
        print(json.dumps({"root": os.path.relpath(root), **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
