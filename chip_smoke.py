#!/usr/bin/env python3
"""Smoke run of the PyTorch port (xfm_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. device and build: prints the card's name and power limit, builds the
     packed-qkv attention kernel (K1) from xfm_tpu_torch/csrc/ with nvcc;
  2. kernel parity: K1 forward and backward against the plain PyTorch
     version at the main-path shape (qkv [96, 197, 2304] bf16, bias
     [1, 12, 197, 197] f32), an odd shape and an f32 case, with their
     times, the bound and the time of F.scaled_dot_product_attention as a
     yardstick;
  3. slice parity: the XFM pretrain loss and gradients at full width and
     depth 2 in f32, on the CPU (plain versions) and on the card (kernel);
  4. full width: the XFM-base pretrain step, bf16 compute, f32 params,
     batch 48: 2 warm-up and 5 timed train steps (each read back, the
     median reported), finite losses, K1 launched 12 times forward and 12
     backward per step;
  5. a JSON line of the kernels, then the device line and the result line.
Needs one CUDA card; imports nothing of JAX or of the xfm_tpu package.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# phase-2 tolerances: max |kernel - plain| <= TOL * max |plain| per tensor.
# bf16: 4 bf16 ulps at the tensor's largest value — the two sides round P,
# ds and the outputs to bf16 at the same points but sum in other orders, so
# an element may land one ulp apart. f32: the sums' order alone.
TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-4}
# phase-3 tolerances (f32, CPU vs card, the same weights and batch): the
# losses, and each sampled gradient relative to its own max |value|
SLICE_LOSS_RTOL = 1e-4
SLICE_GRAD_RTOL = 1e-3


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters`
    back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_work(B: int, N: int, H: int, D: int, dtype: torch.dtype) -> dict:
    """Bytes each direction must move (each input read once, each output
    written once) and the operations it must do, and the bound they give."""
    isz = torch.tensor([], dtype=dtype).element_size()
    qkv = B * N * 3 * H * D * isz
    o = B * N * H * D * isz
    bias = H * N * N * 4
    fwd_bytes = qkv + bias + o                       # qkv, bias in; out
    bwd_bytes = qkv + bias + o + qkv + bias  # qkv, bias, dout; dqkv, db
    fwd_ops = 4 * B * H * N * N * D                  # QK^T, PV
    bwd_ops = 10 * B * H * N * N * D                 # S, dP, dV, dQ, dK
    out = {}
    for d, nbytes, ops in (("fwd", fwd_bytes, fwd_ops),
                           ("bwd", bwd_bytes, bwd_ops)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FLOPS[dtype] * 1e3
        out[d] = dict(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                      bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


def make_k1_inputs(B, N, H, dtype, seed, device="cuda"):
    g = np.random.RandomState(seed)
    C = H * 64
    qkv = torch.from_numpy(g.randn(B, N, 3 * C).astype(np.float32))
    bias = torch.from_numpy(0.5 * g.randn(1, H, N, N).astype(np.float32))
    dout = torch.from_numpy(g.randn(B, N, C).astype(np.float32))
    return (qkv.to(device, dtype), bias.to(device), dout.to(device, dtype))


def k1_parity(B, N, H, dtype, seed=0) -> dict:
    """Kernel vs plain version on the same inputs → max abs errors."""
    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, bias, dout = make_k1_inputs(B, N, H, dtype, seed)
    scale = 64 ** -0.5
    out = fa.packed_attention_fwd(qkv, bias, scale, H)
    dqkv, db = fa.packed_attention_bwd(qkv, bias, dout, scale, H)
    qr = qkv.clone().requires_grad_(True)
    br = bias.clone().requires_grad_(True)
    ref = fa.packed_attention_reference(qr, br, scale, H)
    ref.backward(dout)
    torch.cuda.synchronize()
    res = {}
    for name, got, want in (("out", out, ref), ("dqkv", dqkv, qr.grad),
                            ("db", db, br.grad)):
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"K1 {name} not finite at B={B} N={N}")
        err = (got - want).abs().max().item()
        tol = TOL[dtype] * want.abs().max().item()
        res[name] = (err, tol)
        ok = err <= tol
        print(f"  K1 parity B={B} N={N} H={H} {str(dtype)[6:]}: {name} "
              f"max_abs_err={err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1 {name} disagrees with the plain version")
    return res


def k1_times(B, N, H, dtype) -> dict:
    """Kernel, plain and library times (ms) at one shape."""
    import torch.nn.functional as F

    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, bias, dout = make_k1_inputs(B, N, H, dtype, 1)
    scale = 64 ** -0.5
    t = {}
    t["fwd_ms"] = cuda_ms(lambda: fa.packed_attention_fwd(qkv, bias, scale, H))
    t["bwd_ms"] = cuda_ms(
        lambda: fa.packed_attention_bwd(qkv, bias, dout, scale, H))
    with torch.no_grad():
        t["plain_fwd_ms"] = cuda_ms(
            lambda: fa.packed_attention_reference(qkv, bias, scale, H), 5)
    qr = qkv.clone().requires_grad_(True)
    br = bias.clone().requires_grad_(True)

    def plain_fwd_bwd():
        fa.packed_attention_reference(qr, br, scale, H).backward(dout)

    t["plain_fwd_bwd_ms"] = cuda_ms(plain_fwd_bwd, 5)
    t["plain_bwd_ms"] = t["plain_fwd_bwd_ms"] - t["plain_fwd_ms"]
    C = H * 64
    q, k, v = (x.reshape(B, N, H, 64).transpose(1, 2).contiguous()
               for x in qkv.split(C, dim=-1))
    mask = bias.to(dtype)
    with torch.no_grad():
        t["library_fwd_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale))
    ql, kl, vl = (x.clone().requires_grad_(True) for x in (q, k, v))
    ml = mask.clone().requires_grad_(True)
    g = dout.reshape(B, N, H, 64).transpose(1, 2).contiguous()

    def lib_fwd_bwd():
        F.scaled_dot_product_attention(ql, kl, vl, attn_mask=ml,
                                       scale=scale).backward(g)

    t["library_fwd_bwd_ms"] = cuda_ms(lib_fwd_bwd)
    t["library_bwd_ms"] = t["library_fwd_bwd_ms"] - t["library_fwd_ms"]
    return t


def build_model(cfg, device, seed=0):
    from xfm_tpu_torch.models import XFMForPretrain
    from xfm_tpu_torch.train.checkpoint import init_weights

    model = XFMForPretrain(cfg).to(device)
    init_weights(model, seed)
    return model


def slice_parity() -> None:
    """f32, full width, depth 2: the same weights and batch on the CPU and
    on the card → losses and sampled gradients agree."""
    from xfm_tpu_torch.configs import (batch_to_torch, make_batch,
                                       xfm_base_pretrain_config)
    from xfm_tpu_torch.train.train_state import pretrain_loss_fn

    cfg = xfm_base_pretrain_config(layers=2, dtype=torch.float32)
    nb = make_batch(4, 30, 15, 224, cfg.vision.num_patches,
                    cfg.text.vocab_size, seed=1)
    cpu = build_model(cfg, "cpu", seed=3)
    gpu = build_model(cfg, "cpu", seed=3).to("cuda")
    neg = (torch.tensor([1, 2, 3, 0]), torch.tensor([2, 3, 0, 1]))
    results = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        batch = batch_to_torch(nb, dev)
        batch["hard_negatives"] = tuple(n.to(dev) for n in neg)
        total, out = pretrain_loss_fn(model, batch)
        total.backward()
        results[name] = ({k: v.item() for k, v in out.items()},
                         dict(model.named_parameters()))
    (lc, pc), (lg, pg) = results["cpu"], results["cuda"]
    for k in ("loss_itc", "loss_itm", "loss_mlm", "loss_mim"):
        ok = math.isclose(lc[k], lg[k], rel_tol=SLICE_LOSS_RTOL)
        print(f"  slice {k}: cpu={lc[k]:.6f} cuda={lg[k]:.6f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"slice parity: {k}")
    sample = ["vision_encoder.blocks.0.attn.qkv.weight",
              "vision_encoder.blocks.1.attn.relative_position_bias_table",
              "vision_encoder.patch_embed.proj.weight",
              "text_encoder.roberta.encoder.layer.0.attention.self."
              "query.weight",
              "fusion_encoder.roberta.encoder.layer.1.crossattention.self."
              "key.weight",
              "itm_head.0.weight", "temp"]
    for n in sample:
        a = pc[n].grad.float()
        b = pg[n].grad.float().cpu()
        err = (a - b).abs().max().item()
        tol = SLICE_GRAD_RTOL * a.abs().max().item()
        print(f"  slice grad {n}: max_abs_err={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"slice parity: grad of {n}")


def full_width(steps: int = 5, warmup: int = 2) -> dict:
    from xfm_tpu_torch.configs import make_pretrain_run, pretrain_step_flops
    from xfm_tpu_torch.ops import flash_attention as fa

    B, T, M = 48, 30, 15
    state, batch, step = make_pretrain_run(B, T, M)
    cfg = state.model.config
    n_params = sum(p.numel() for p in state.model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses, times = [], []
    for _ in range(warmup + steps):
        t0 = time.perf_counter()
        state, loss = step(state, batch, gen)
        # a trainer reads each step's loss; the read waits for the step
        losses.append(loss.item())
        times.append(time.perf_counter() - t0)
    launches = dict(fa.LAUNCHES)
    dt = float(np.median(times[warmup:]))
    print(f"  params={n_params} losses={['%.4f' % v for v in losses]}")
    print(f"  step ms: {['%.1f' % (t * 1e3) for t in times]} "
          f"(first {warmup} are warm-up)")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite loss in the full-width run")
    n = steps + warmup
    depth = cfg.vision.depth
    if launches != {"packed_attention_fwd": depth * n,
                    "packed_attention_bwd": depth * n}:
        raise AssertionError(f"K1 launches {launches}, expected {depth} fwd "
                             f"and {depth} bwd per step over {n} steps")
    flops = pretrain_step_flops(B, T, M, cfg.vision.num_patches)
    # step_ms: the median of the timed steps
    res = dict(step_ms=dt * 1e3, samples_per_s=B / dt,
               mfu=flops / dt / PEAK_FLOPS[torch.bfloat16],
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches=launches, params=n_params)
    print("  full width: " + json.dumps(res))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "xfm_tpu_torch")):
        print("chip_smoke: run from a checkout that holds xfm_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"phase 1: device {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    from xfm_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    fa.build_library()
    print(f"  K1 build {time.perf_counter() - t0:.1f} s "
          f"({fa.build_info.get('library')})")
    for line in fa.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    main_shape = dict(B=96, N=197, H=12)
    work = k1_work(**main_shape, D=64, dtype=torch.bfloat16)
    print("phase 2: K1 parity and times")
    err = k1_parity(**main_shape, dtype=torch.bfloat16)
    k1_parity(B=3, N=50, H=4, dtype=torch.bfloat16, seed=1)
    k1_parity(B=3, N=50, H=4, dtype=torch.float32, seed=2)
    k1_parity(B=4, N=197, H=12, dtype=torch.float32, seed=3)
    times = k1_times(**main_shape, dtype=torch.bfloat16)
    print("  K1 times (ms): " + json.dumps(times))
    print("  K1 bound: " + json.dumps(work))
    print("phase 3: slice parity, CPU vs card")
    slice_parity()
    print("phase 4: full-width XFM-base pretrain step")
    full = full_width()

    kernels = []
    src = "xfm_tpu_torch/csrc/packed_attention.cu"
    for d, line, e in (("fwd", 983, err["out"][0]),
                       ("bwd", 1007, max(err["dqkv"][0], err["db"][0]))):
        kernels.append(dict(
            name=f"packed_attention_{d}", route="cuda", source=src,
            replaces=f"xfm_tpu/ops/flash_attention.py:{line}",
            launches=full["launches"][f"packed_attention_{d}"],
            max_abs_err=e, ms=times[f"{d}_ms"],
            plain_ms=times[f"plain_{d}_ms"], bound_ms=work[d]["bound_ms"],
            bound_by=work[d]["bound_by"],
            library_ms=times[f"library_{d}_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
