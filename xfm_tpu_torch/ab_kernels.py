"""K1's, K2's, K3's and K5's kernel times at their main shapes, from one
checkout or several in turns on one card.

    python3 -m xfm_tpu_torch.ab_kernels ROOT [ROOT ...]

For each ROOT in the order given (a checkout holding `xfm_tpu_torch/`, e.g.
a parent unpacked by `git archive` beside this one: `build/parent . .
build/parent`), a fresh process imports that checkout's package, builds its
kernels and prints one JSON line: K1 (`packed_attention_fwd` / `_bwd`, qkv
[96, 197, 2304] bf16, bias [1, 12, 197, 197] f32), K2
(`relpos_attention_fwd` / `_bwd`, qkv [32, 577, 2304] bf16, window
24 × 24), K3 (`flash_attention_fwd` / `_bwd`, q/k/v [32, 577, 12, 64] bf16,
no bias) and K5 (`act_matmul_fwd` / `_bwd`, h [18912, 3072], W [768, 3072]
bf16, tanh-GELU; also ReLU's forward, whose act costs next to nothing, and
the text rows' M = 1,440), ms each, from CUDA events over 20 launches
after 3 warm-up launches; and K1's and K5's times by kernel at the main
shape (`torch.profiler` over 10 calls), beside the card's name and power
limit. Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

_TIMES = r"""
import inspect, json, subprocess, sys
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from xfm_tpu_torch.ops import flash_attention as fa
from xfm_tpu_torch.ops import fused_mlp as fm
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


def by_kernel(fn, iters=10):
    # ms a call of each kernel fn launches, keyed by its name up to "(",
    # namespaces dropped
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0][:60]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    return out


r = np.random.RandomState(1)
bf = torch.bfloat16
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
res["device"] = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(json.dumps(res))
"""


def main(argv=None) -> int:
    roots = (argv if argv is not None else sys.argv[1:]) or ["."]
    for root in roots:
        root = os.path.abspath(root)
        res = subprocess.run([sys.executable, "-c", _TIMES], cwd=root,
                             env=dict(os.environ, PYTHONPATH=root),
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"root": os.path.relpath(root), **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
