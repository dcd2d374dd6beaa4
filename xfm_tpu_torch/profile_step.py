"""Where the time of one XFM-base train step goes on the card.

    python3 -m xfm_tpu_torch.profile_step [pretrain|retrieval] [--trace PATH]

Runs the full-width step of the chosen path as `chip_smoke.py` does
(pretrain: B = 48 at 224 px, the default; retrieval: the 384 px fine-tune,
B = 32, T = 40; random weights, bf16 compute), then profiles STEPS steps
with torch.profiler. From that one profiled window it prints the device's
span per step (first kernel start to last kernel end, on the trace's clock),
its busy time per step (sum of kernel times), the idle share of the span,
the host-clock time per step of the same window (profiler overhead
included), kernel time by group (K1, K2, matmuls, the rest) and the TOP
kernels by name. The chrome trace goes to `--trace`
(build/xfm_tpu_torch/profile_<path>.json by default). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

STEPS = 3
TOP = 25


def _group(name: str) -> str:
    n = name.lower()
    if "packed_" in n:
        return "k1_packed_attention"
    if "relpos_" in n:
        return "k2_relpos_attention"
    if any(k in n for k in ("gemm", "cutlass", "xmma", "nvjet", "sm90_")):
        return "matmul"
    if "foreach" in n or "multi_tensor" in n:
        return "optimizer_foreach"
    if "softmax" in n:
        return "softmax"
    if "layer_norm" in n or "layernorm" in n:
        return "layer_norm"
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default="pretrain",
                    choices=("pretrain", "retrieval"))
    ap.add_argument("--trace")
    args = ap.parse_args(argv)
    trace = args.trace or f"build/xfm_tpu_torch/profile_{args.path}.json"
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from .configs import make_pretrain_run, make_retrieval_run

    make_run = (make_pretrain_run if args.path == "pretrain"
                else make_retrieval_run)
    state, batch, step = make_run()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(2):
        state, loss = step(state, batch, gen)
    torch.cuda.synchronize()

    # CUDA activity only: recording every host op triples the step.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, loss = step(state, batch, gen)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / STEPS * 1e3
    kernels = {}
    first, last = float("inf"), float("-inf")
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.setdefault(e.name, [0.0, 0])
            kernels[e.name][0] += e.time_range.elapsed_us() / 1e3 / STEPS
            kernels[e.name][1] += 1
            first = min(first, e.time_range.start)
            last = max(last, e.time_range.end)
    span = (last - first) / 1e3 / STEPS
    busy = sum(v[0] for v in kernels.values())
    groups = {}
    for name, (ms, _) in kernels.items():
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + ms
    print(f"device_span_ms={span:.3f} device_busy_ms={busy:.3f} "
          f"idle_share={1 - busy / span:.4f} host_ms={host_ms:.3f}")
    print("groups_ms_per_step " + json.dumps(
        dict(sorted(groups.items(), key=lambda kv: -kv[1]))))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    for name, (ms, n) in top:
        print(f"  {ms:9.3f} ms/step {n // STEPS:6d} calls/step  "
              f"{name[:110]}")
    os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
    prof.export_chrome_trace(trace)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
