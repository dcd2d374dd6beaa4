#!/usr/bin/env python3
"""Smoke run of the PyTorch port (xfm_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. device and build: prints the card's name and power limit, builds the
     five kernel libraries (K1 packed-qkv attention, K2 rel-pos attention,
     K3 long-sequence attention, K4 fused residual + LayerNorm, K5 fused
     activation-prologue MLP matmul) from xfm_tpu_torch/csrc/, one nvcc
     each, started together;
  2. K1 parity: forward and backward against the plain PyTorch version at
     the pretrain shape (qkv [96, 197, 2304] bf16, bias [1, 12, 197, 197]
     f32), an odd shape and an f32 case; the bf16 forward and backward
     bit-equal over two runs at the main shape; ptxas's registers and
     spills of each K1 kernel; the times, the bound and the time of
     F.scaled_dot_product_attention as a yardstick;
  3. pretrain slice parity: the XFM pretrain loss and gradients at full
     width and depth 2 in f32, on the CPU (plain versions) and on the card
     (kernels);
  4. full-width pretrain: the XFM-base pretrain step, bf16 compute, f32
     params, batch 48: 2 warm-up and 5 timed train steps (each read back,
     the median reported), finite losses, K1 launched 12 times forward and
     12 backward per step, K2 never;
  5. K2 parity: forward and backward (out, dqkv, dcr, dcls) against the
     plain version at the retrieval shape (qkv [32, 577, 2304], window
     24 x 24), at 480 px (B = 4, N = 901), at a non-square window and at
     a window shorter than one tile (3 x 5, N = 16), each in bf16 and f32;
     the bf16 forward and backward bit-equal over two runs at the main
     shape; ptxas's registers and spills of each K2 kernel; the times at
     the retrieval shape, the bound and SDPA with the bias materialized as
     a [1, H, N, N] mask as a yardstick (the mask's construction is not
     timed);
  6. retrieval slice parity: the retrieval losses and gradients at full
     width, depth 2, 384 px, B = 4, f32, on the CPU and on the card;
  7. full-width retrieval: the XFM-base retrieval fine-tune step at 384 px,
     B = 32, T = 40, bf16: 2 warm-up and 5 timed steps, finite losses, K2
     launched 12 times forward and 12 backward per step, K1 and K3 never;
  8. K3 parity: forward and backward (out, dq, dk, dv, and db where a bias
     needs it) against the plain version at the CLIP-ViT-B/16 shape
     (q/k/v [32, 577, 12, 64], no bias) in bf16 and f32, with a
     [1, 12, 577, 577] bias (f32, and bf16), a [32, 1, 1, 577] padding mask
     with masked tails, at 480 px (B = 4, N = 901) and at Nq != Nk
     (520 x 700), with the times at the main shape, the bound and
     F.scaled_dot_product_attention with no mask as a yardstick;
  9. CLIP retrieval slice parity: the retrieval losses and gradients with the
     CLIP-ViT tower at full width, depth 2, 384 px, B = 4, f32, on the CPU
     and on the card, on the default route and again with both fused routes
     (K4 and K5 in the text and fusion encoders, launched as the depth-2
     step asks; the tower stays plain);
 10. full-width CLIP retrieval: the retrieval step with the CLIP-ViT-B/16
     tower, B = 32, T = 40, bf16: 2 warm-up and 5 timed steps, finite
     losses, K3 launched 12 times forward and 12 backward per step, K1 and
     K2 never;
 11. K4 parity: the three variants (plain LN, post-LN, add + LN) forward
     (h, xn) and backward (dx, dγ, dβ) against the plain version at the
     BEiT rows (R = 18,912, C = 768), the fusion rows (R = 5,760), the
     text rows (R = 1,440) and a ragged R = 1,100, in bf16 and f32; the
     backward's edges: R = 1, R under the grid, R not a multiple of the
     row group, C = 1,152 (two warps a row) and C = 8,192 in f32 (the
     largest stage); ptxas's registers and spills of each K4 kernel (none
     may spill in the backward); dx, dγ and dβ bit-equal over two calls
     at R = 18,912 and over calls at other R in between (the fold's
     tickets reset); the times (forward, backward, their device time with
     the host's launch time kept out, plain, the default route's
     F.layer_norm(x + y) as a yardstick) and bounds of the three
     main-path sites: the BEiT add at R = 18,912, the post-LN at the
     fusion's 5,760 and the text's 1,440 rows;
 12. K5 parity: forward (y) and backward (dh, dW, db) against the plain
     version for tanh-GELU, the Φ̂ GELU and ReLU at M = 18,912, 5,760,
     1,440 and 100 rows (K = 3,072, N = 768) in bf16 and f32, at M = 130
     in bf16, and at M = 130, K = 200, N = 72 in both; the bf16 backward
     bit-equal over two runs at M = 18,912 (its dW split over M); ptxas's
     registers and spills of each K5 kernel (none may spill in the wgmma
     and dW-sum kernels) and the count of HGMMA (wgmma) instructions in
     the library where cuobjdump is at hand (it must be > 0); the times of
     tanh-GELU at the main shape, the bound and F.linear(act(h)) as a
     yardstick;
 13. fused pretrain slice parity: the pretrain slice of phase 3 with both
     fused routes on (XFM_FUSED_LN=1 XFM_MLP_FUSED=1), CPU vs card, K4 and
     K5 launched as the depth-2 step asks;
 14. full-width fused pretrain: phase 4's step with both fused routes on,
     K1 12 + 12, K4 96 + 72 and K5 48 + 36 launches per step, K2 and K3
     never;
 15. kernel parity at the retrieval eval's shapes: K3's forward as the
     grouped image → text rerank calls it (q the [U·gs, 40, 12, 64]
     projection viewed as [U, gs·40, 12, 64], k/v [U, 577, 12, 64], the
     bias [U, 1, 1, 577] from image masks): U = 8, gs = 256 in bf16 with an
     all-ones mask, with masked tails and in f32; U = 3 (the last chunk)
     and gs = 16 in bf16; K2's forward at the stage-1 batch, qkv
     [64, 577, 2304], in bf16 and f32; the times, the bounds and SDPA as
     the yardstick (K3 with no mask, K2 with the bias as a mask, built
     untimed);
 16. eval slice parity: the eval at full width, depth 2, 384 px, f32, with
     the BEiT-2 and with the CLIP-ViT tower, on the CPU and on the card,
     from the same weights: 16 images and 32 captions (T = 40), k_test =
     16 (gs·T = 640, so K3 takes the grouped rerank on the card), both
     sides reranking on the CPU's similarities; the score matrices within
     1e-4 of their largest candidate score, R@K equal, and on the card the
     grouped image → text rerank equal to the repeat form;
 17. the full-width eval: XFM-base from `Retrieval_coco.yaml`'s keys
     (BEiT-2, 384 px, 12/12/12 layers), bf16 compute, its weights a seeded
     224 px model saved as a reference checkpoint and loaded through the
     port's loader (the rel-pos tables interpolated from window 14 to 24);
     a seeded corpus of 256 images and 1,280 captions (5 each, 8-40
     tokens), k_test = 256, batch_size_test = 64: stage 1's images/s and
     texts/s, stage 2's ITM rows/s each way, the total seconds, the peak
     memory and R@K; K2 forward 48 and K3 forward 384 launches, nothing
     else; then, where PyYAML and PIL import, `python3 -m
     xfm_tpu_torch.run --task itr_coco --evaluate` on 8 PNGs;
 18. the full-width fine-tune: `run.main` (the entry point of `python3 -m
     xfm_tpu_torch.run --task itr_coco`, without --evaluate) on
     `Retrieval_coco.yaml`'s keys with `resume: true`, random weights from
     the seed, the YAML's dropout and drop-path live,
     36 synthetic PNGs of 300-640 px with 2 captions each (72 pairs),
     `--bs 24` (3 steps an epoch), `--epoch 2`, a test split of 16 of
     those images: each step's seconds and
     loss (finite), each epoch's and each eval's seconds and launches (K2
     12 forward + 12 backward a step and nothing else in an epoch; K2
     forward 12 and K3 forward 24 and nothing else in an eval, the
     zero-shot one included), the peak memory, `ckpt/` (both epochs) and
     `ckpt_best/` (the last epoch that raised R_mean, absent if none did);
     then `ckpt/1` deleted and the same command again: the restored state
     bit-equal to `ckpt/0` on disk, the run going on at epoch 1 at the
     schedule's lr for the restored count, its first step's loss bit-equal
     to the first run's and the others within FT_RESUME_RTOL; the output
     directory (3.4-4.4 GB a checkpoint) deleted at the end;
then a JSON line of the kernels, the device line and the result line.
Phases 4, 7 and 10 also check that no kernel but their own (K4 and K5
included) is launched there. All five libraries build together in
phase 1.
Needs one CUDA card; imports nothing of JAX or of the xfm_tpu package.
"""
from __future__ import annotations

import json
import math
import os
import shutil
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
# phase-18 tolerance for the resumed epoch's losses after its first step:
# that step runs from the restored state on the same batch and masks, so
# its loss is bit-equal; its backward sums through atomics (index_add_ of
# the shared cross-k/v gather), so the next states differ in the last bits.
# A random-weight model on noise images, whose loss jumps at the second
# step (4.1 to 5.7), carries those bits through the bf16 activations of
# the next two steps: 3.9e-5 to 2.9e-3 of the loss measured over four runs
# on the H100; the bound keeps 7x the largest
FT_RESUME_RTOL = 2e-2


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


def device_ms(fn, iters: int = 20) -> float:
    """Device time of fn() in ms: CUDA events around `iters` calls queued
    behind a sleeping kernel, so that the card runs them back to back
    whatever the host's launch time (where a call's kernels take less than
    its host work, `cuda_ms` times the host)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _compare(tag: str, pairs, dtype) -> dict:
    """max |kernel - plain| of each (name, kernel, plain) against TOL[dtype]
    · max |plain| → {name: (err, tol)}; raises on a miss."""
    res = {}
    for name, got, want in pairs:
        got, want = got.float(), want.float()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{tag}: {name} wrong shape or not finite")
        err = (got - want).abs().max().item()
        tol = TOL[dtype] * want.abs().max().item()
        res[name] = (err, tol)
        ok = err <= tol
        print(f"  {tag}: {name} max_abs_err={err:.3e} tol={tol:.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: {name} disagrees with the plain "
                                 f"version")
    return res


def _bounds(directions, peak: float) -> dict:
    """{direction: (bytes, ops)} → the bytes, the operations and the bound
    they give at the card's memory rate and the `peak` rate."""
    out = {}
    for d, (nbytes, ops) in directions.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / peak * 1e3
        out[d] = dict(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                      bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


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
    return _bounds({"fwd": (fwd_bytes, fwd_ops), "bwd": (bwd_bytes, bwd_ops)},
                   PEAK_FLOPS[dtype])


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
    out, stats = fa.packed_attention_fwd(qkv, bias, scale, H)
    dqkv, db = fa.packed_attention_bwd(qkv, bias, out, stats, dout, scale, H)
    qr = qkv.clone().requires_grad_(True)
    br = bias.clone().requires_grad_(True)
    ref = fa.packed_attention_reference(qr, br, scale, H)
    ref.backward(dout)
    torch.cuda.synchronize()
    return _compare(f"K1 parity B={B} N={N} H={H} {str(dtype)[6:]}",
                    [("out", out, ref), ("dqkv", dqkv, qr.grad),
                     ("db", db, br.grad)], dtype)


def k1_deterministic(B, N, H, dtype, seed=4) -> None:
    """K1's forward and backward (out, dqkv, db) twice on the same inputs
    → the same bits, or raise."""
    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, bias, dout = make_k1_inputs(B, N, H, dtype, seed)
    scale = 64 ** -0.5
    runs = []
    for _ in range(2):
        out, stats = fa.packed_attention_fwd(qkv, bias, scale, H)
        runs.append((out,) + fa.packed_attention_bwd(qkv, bias, out, stats,
                                                     dout, scale, H))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"  K1 B={B} N={N} H={H} {str(dtype)[6:]}: out, dqkv, db bit-equal "
          f"over two runs: {same}")
    if not same:
        raise AssertionError("K1's backward is not deterministic")


def k1_times(B, N, H, dtype) -> dict:
    """Kernel, plain and library times (ms) at one shape."""
    import torch.nn.functional as F

    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, bias, dout = make_k1_inputs(B, N, H, dtype, 1)
    scale = 64 ** -0.5
    t = {}
    out, stats = fa.packed_attention_fwd(qkv, bias, scale, H)
    t["fwd_ms"] = cuda_ms(lambda: fa.packed_attention_fwd(qkv, bias, scale, H))
    t["bwd_ms"] = cuda_ms(lambda: fa.packed_attention_bwd(
        qkv, bias, out, stats, dout, scale, H))
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


def k2_work(B: int, N: int, H: int, D: int, window, dtype: torch.dtype
            ) -> dict:
    """As `k1_work`, for K2: qkv and the compact table (in qkv's dtype) and
    cls3 in, out; backward: qkv, table, cls3 and dout in, dqkv, dcr (f32)
    and dcls out."""
    wh, ww = window
    isz = torch.tensor([], dtype=dtype).element_size()
    qkv = B * N * 3 * H * D * isz
    o = B * N * H * D * isz
    table = H * ww * (2 * wh - 1) * ww
    cls = H * 3 * 4
    fwd_bytes = qkv + table * isz + cls + o
    bwd_bytes = qkv + table * isz + cls + o + qkv + table * 4 + cls
    return _bounds({"fwd": (fwd_bytes, 4 * B * H * N * N * D),
                    "bwd": (bwd_bytes, 10 * B * H * N * N * D)},
                   PEAK_FLOPS[dtype])


def make_k2_inputs(B, window, H, dtype, seed, device="cuda"):
    """qkv, the compact table in `dtype` (as the model rounds it), cls3 and
    dout, from a seeded table [(2wh-1)(2ww-1)+3, H]."""
    from xfm_tpu_torch.ops.relpos import compact_rel_pos

    wh, ww = window
    N = wh * ww + 1
    g = np.random.RandomState(seed)
    qkv = torch.from_numpy(g.randn(B, N, 3 * H * 64).astype(np.float32))
    table = torch.from_numpy(0.5 * g.randn(
        (2 * wh - 1) * (2 * ww - 1) + 3, H).astype(np.float32))
    dout = torch.from_numpy(g.randn(B, N, H * 64).astype(np.float32))
    cr, cls3 = compact_rel_pos(table, wh, ww)
    cr = cr.to(dtype).reshape(H, ww, (2 * wh - 1) * ww)
    return (qkv.to(device, dtype), cr.to(device), cls3.to(dtype).float()
            .to(device), dout.to(device, dtype))


def k2_parity(B, window, H, dtype, seed=0) -> dict:
    """Kernel vs plain version on the same inputs → max abs errors."""
    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, cr, cls3, dout = make_k2_inputs(B, window, H, dtype, seed)
    scale = 64 ** -0.5
    out, stats = fa.relpos_attention_fwd(qkv, cr, cls3, window, scale, H)
    dqkv, dcr, dcls = fa.relpos_attention_bwd(qkv, cr, cls3, out, stats,
                                              dout, window, scale, H)
    qr, crr, clr = (x.clone().requires_grad_(True) for x in (qkv, cr, cls3))
    ref = fa.relpos_attention_reference(qr, crr, clr, window, scale, H)
    ref.backward(dout)
    torch.cuda.synchronize()
    return _compare(f"K2 parity B={B} N={qkv.shape[1]} window={window} H={H} "
                    f"{str(dtype)[6:]}",
                    [("out", out, ref), ("dqkv", dqkv, qr.grad),
                     ("dcr", dcr, crr.grad), ("dcls", dcls, clr.grad)], dtype)


def k2_deterministic(B, window, H, dtype, seed=4) -> None:
    """K2's forward and backward (dqkv, dcr, dcls) twice on the same inputs
    → the same bits, or raise."""
    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, cr, cls3, dout = make_k2_inputs(B, window, H, dtype, seed)
    scale = 64 ** -0.5
    runs = []
    for _ in range(2):
        out, stats = fa.relpos_attention_fwd(qkv, cr, cls3, window, scale, H)
        runs.append((out,) + fa.relpos_attention_bwd(
            qkv, cr, cls3, out, stats, dout, window, scale, H))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"  K2 B={B} window={window} {str(dtype)[6:]}: out, dqkv, dcr, dcls "
          f"bit-equal over two runs: {same}")
    if not same:
        raise AssertionError("K2's backward is not deterministic")


def ptxas_kernels(report: str) -> list:
    """nvcc's -Xptxas -v report → [(kernel, registers, spill line)], one
    entry a compiled kernel, its name demangled where c++filt is on PATH."""
    import re
    import shutil

    out, name, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    if out and shutil.which("c++filt"):
        res = subprocess.run(["c++filt"], input="\n".join(n for n, _, _ in out),
                             capture_output=True, text=True, timeout=60)
        names = res.stdout.splitlines()
        if len(names) == len(out):
            out = [(n, r, s) for n, (_, r, s) in zip(names, out)]
    return out


def print_ptxas(tag: str, library: str, no_spills_in=()) -> list:
    """Print ptxas's registers and spills of each kernel of `library` (when
    this run built it); raise if a kernel whose name holds one of
    `no_spills_in` spills."""
    from xfm_tpu_torch.ops import kernels

    found = ptxas_kernels(kernels.build_info[library].get("ptxas", ""))
    if not found:
        print(f"  {tag} ptxas: none (the library was built before this run)")
    for kname, regs, spill in found:
        print(f"  {tag} ptxas: {regs} registers, {spill}: {kname[:150]}")
        if any(k in kname for k in no_spills_in) and \
                "0 bytes spill stores, 0 bytes spill loads" not in spill:
            raise AssertionError(f"{tag}: {kname} spills ({spill})")
    return found


def sass_count(library: str, opcode: str):
    """How many `opcode` instructions the built library holds, from
    cuobjdump (the toolkit's, or the one Triton's package carries), or None
    where there is no cuobjdump."""
    import shutil

    from xfm_tpu_torch.ops import kernels

    tools = [shutil.which("cuobjdump"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "cuobjdump")]
    try:
        import triton
        tools.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    tool = next((t for t in tools if t and os.path.exists(t)), None)
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", kernels.build_info[library]["library"]],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return sum(opcode in line for line in sass.splitlines())


def k2_times(B, window, H, dtype) -> dict:
    """Kernel, plain and library times (ms) at one shape. The library's
    mask (the bias materialized [1, H, N, N]) is built before timing."""
    import torch.nn.functional as F

    from xfm_tpu_torch.ops import flash_attention as fa
    from xfm_tpu_torch.ops.relpos import expand_compact_rel_pos

    qkv, cr, cls3, dout = make_k2_inputs(B, window, H, dtype, 1)
    N, scale = qkv.shape[1], 64 ** -0.5
    out, stats = fa.relpos_attention_fwd(qkv, cr, cls3, window, scale, H)
    t = {}
    t["fwd_ms"] = cuda_ms(
        lambda: fa.relpos_attention_fwd(qkv, cr, cls3, window, scale, H))
    t["bwd_ms"] = cuda_ms(lambda: fa.relpos_attention_bwd(
        qkv, cr, cls3, out, stats, dout, window, scale, H))
    with torch.no_grad():
        t["plain_fwd_ms"] = cuda_ms(lambda: fa.relpos_attention_reference(
            qkv, cr, cls3, window, scale, H), 5)
    qr, crr, clr = (x.clone().requires_grad_(True) for x in (qkv, cr, cls3))

    def plain_fwd_bwd():
        fa.relpos_attention_reference(qr, crr, clr, window, scale,
                                      H).backward(dout)

    t["plain_fwd_bwd_ms"] = cuda_ms(plain_fwd_bwd, 5)
    t["plain_bwd_ms"] = t["plain_fwd_bwd_ms"] - t["plain_fwd_ms"]
    C = H * 64
    q, k, v = (x.reshape(B, N, H, 64).transpose(1, 2).contiguous()
               for x in qkv.split(C, dim=-1))
    mask = expand_compact_rel_pos(cr.float(), cls3, window).to(dtype)
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


def k3_work(B: int, Nq: int, Nk: int, H: int, D: int, dtype: torch.dtype,
            bias=None) -> dict:
    """As `k1_work`, for K3: q, k, v (and the bias) in, out; backward: q,
    k, v, the bias and dout in, dq, dk, dv and db out (db only with a bias,
    in its dtype)."""
    isz = torch.tensor([], dtype=dtype).element_size()
    q = B * Nq * H * D * isz
    kv = 2 * B * Nk * H * D * isz
    nb = bias.numel() * bias.element_size() if bias is not None else 0
    fwd_bytes = q + kv + nb + q
    bwd_bytes = q + kv + nb + q + q + kv + nb
    return _bounds({"fwd": (fwd_bytes, 4 * B * H * Nq * Nk * D),
                    "bwd": (bwd_bytes, 10 * B * H * Nq * Nk * D)},
                   PEAK_FLOPS[dtype])


def make_k3_inputs(B, Nq, Nk, H, dtype, bias_kind, seed, device="cuda"):
    """q, k, v, dout [B, N, H, 64] and a bias: None; "relpos" (f32, or
    "relpos_bf16") [1, H, Nq, Nk]; "mask" f32 [B, 1, 1, Nk] where row b
    masks its last 7·b keys."""
    from xfm_tpu_torch.ops.attention import mask_to_bias

    g = np.random.RandomState(seed)
    q = torch.from_numpy(g.randn(B, Nq, H, 64).astype(np.float32))
    k, v = (torch.from_numpy(g.randn(B, Nk, H, 64).astype(np.float32))
            for _ in range(2))
    dout = torch.from_numpy(g.randn(B, Nq, H, 64).astype(np.float32))
    bias = None
    if bias_kind in ("relpos", "relpos_bf16"):
        bias = torch.from_numpy(0.5 * g.randn(1, H, Nq, Nk).astype(
            np.float32)).to(device)
        if bias_kind == "relpos_bf16":
            bias = bias.to(torch.bfloat16)
    elif bias_kind == "mask":
        atts = np.ones((B, Nk), np.int64)
        for b in range(B):
            atts[b, Nk - 7 * b:] = 0
        bias = mask_to_bias(torch.from_numpy(atts)).to(device)
    return (*(x.to(device, dtype) for x in (q, k, v, dout)), bias)


def k3_parity(B, Nq, Nk, H, dtype, bias_kind=None, seed=0) -> dict:
    """Kernel vs plain version on the same inputs → max abs errors. A
    relpos bias gets its gradient (the db kernel); a mask does not."""
    from xfm_tpu_torch.ops import flash_attention as fa

    q, k, v, dout, bias = make_k3_inputs(B, Nq, Nk, H, dtype, bias_kind,
                                         seed)
    scale = 64 ** -0.5
    bias_grad = bias_kind in ("relpos", "relpos_bf16")
    out, stats = fa.flash_attention_fwd(q, k, v, bias, scale)
    dq, dk, dv, db = fa.flash_attention_bwd(q, k, v, bias, out, stats,
                                            dout, scale, bias_grad)
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    rb = bias.clone().requires_grad_(bias_grad) if bias is not None else None
    ref = fa.flash_attention_reference(*refs, rb, scale)
    ref.backward(dout)
    torch.cuda.synchronize()
    pairs = [("out", out, ref), ("dq", dq, refs[0].grad),
             ("dk", dk, refs[1].grad), ("dv", dv, refs[2].grad)]
    if bias_grad:
        pairs.append(("db", db.to(bias.dtype), rb.grad))
    elif db is not None:
        raise AssertionError("K3 computed a db nobody asked for")
    return _compare(f"K3 parity B={B} Nq={Nq} Nk={Nk} H={H} "
                    f"{str(dtype)[6:]} bias={bias_kind}", pairs, dtype)


def k3_times(B, N, H, dtype) -> dict:
    """Kernel, plain and library times (ms) at one shape, no bias."""
    import torch.nn.functional as F

    from xfm_tpu_torch.ops import flash_attention as fa

    q, k, v, dout, _ = make_k3_inputs(B, N, N, H, dtype, None, 1)
    scale = 64 ** -0.5
    out, stats = fa.flash_attention_fwd(q, k, v, None, scale)
    t = {}
    t["fwd_ms"] = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, None,
                                                         scale))
    t["bwd_ms"] = cuda_ms(lambda: fa.flash_attention_bwd(
        q, k, v, None, out, stats, dout, scale))
    with torch.no_grad():
        t["plain_fwd_ms"] = cuda_ms(lambda: fa.flash_attention_reference(
            q, k, v, None, scale), 5)
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]

    def plain_fwd_bwd():
        fa.flash_attention_reference(*refs, None, scale).backward(dout)

    t["plain_fwd_bwd_ms"] = cuda_ms(plain_fwd_bwd, 5)
    t["plain_bwd_ms"] = t["plain_fwd_bwd_ms"] - t["plain_fwd_ms"]
    ql, kl, vl = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    with torch.no_grad():
        t["library_fwd_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, scale=scale))
    ql, kl, vl = (x.requires_grad_(True) for x in (ql, kl, vl))
    g = dout.transpose(1, 2).contiguous()

    def lib_fwd_bwd():
        F.scaled_dot_product_attention(ql, kl, vl, scale=scale).backward(g)

    t["library_fwd_bwd_ms"] = cuda_ms(lib_fwd_bwd)
    t["library_bwd_ms"] = t["library_fwd_bwd_ms"] - t["library_fwd_ms"]
    return t


def k3_grouped_inputs(U, gs, dtype, bias_kind, seed, T=40, H=12, Nk=577):
    """q as the grouped rerank gives it to K3 (the cross-attention's
    [U·gs, T, H·64] projection viewed, without a copy, as
    [U, gs·T, H, 64]), k/v [U, Nk, H, 64] and the bias [U, 1, 1, Nk] of
    image masks: all ones ("ones") or image u's last 5 + 40·u keys masked
    ("tails")."""
    from xfm_tpu_torch.ops.attention import mask_to_bias

    g = np.random.RandomState(seed)
    proj = torch.from_numpy(g.randn(U * gs, T, H * 64).astype(np.float32))
    proj = proj.to("cuda", dtype)
    q = proj.view(U, gs * T, H, 64)
    assert q.data_ptr() == proj.data_ptr()
    k, v = (torch.from_numpy(g.randn(U, Nk, H, 64).astype(np.float32))
            .to("cuda", dtype) for _ in range(2))
    atts = np.ones((U, Nk), np.int64)
    if bias_kind == "tails":
        for u in range(U):
            atts[u, Nk - 5 - 40 * u:] = 0
    return q, k, v, mask_to_bias(torch.from_numpy(atts)).cuda()


def k3_grouped_parity(U, gs, dtype, bias_kind="ones", seed=0) -> dict:
    from xfm_tpu_torch.ops import flash_attention as fa

    q, k, v, bias = k3_grouped_inputs(U, gs, dtype, bias_kind, seed)
    out, _ = fa.flash_attention_fwd(q, k, v, bias, 64 ** -0.5)
    ref = fa.flash_attention_reference(q, k, v, bias, 64 ** -0.5)
    torch.cuda.synchronize()
    return _compare(f"K3 grouped fwd U={U} gs={gs} q={list(q.shape)} "
                    f"{str(dtype)[6:]} bias={bias_kind}", [("out", out, ref)],
                    dtype)


def k3_grouped_times(U, gs, dtype) -> dict:
    """Forward times (ms) at the grouped shape with its all-ones mask bias:
    kernel, plain, and SDPA with no mask; and the kernel with no bias."""
    import torch.nn.functional as F

    from xfm_tpu_torch.ops import flash_attention as fa

    q, k, v, bias = k3_grouped_inputs(U, gs, dtype, "ones", 1)
    scale = 64 ** -0.5
    t = {"fwd_ms": cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, bias,
                                                          scale)),
         "fwd_no_bias_ms": cuda_ms(lambda: fa.flash_attention_fwd(
             q, k, v, None, scale))}
    t["plain_fwd_ms"] = cuda_ms(lambda: fa.flash_attention_reference(
        q, k, v, bias, scale), 5)
    ql, kl, vl = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    t["library_fwd_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        ql, kl, vl, scale=scale))
    return t


def k2_fwd_parity(B, dtype, seed=0) -> dict:
    from xfm_tpu_torch.ops import flash_attention as fa

    window = (24, 24)
    qkv, cr, cls3, _ = make_k2_inputs(B, window, 12, dtype, seed)
    out, _ = fa.relpos_attention_fwd(qkv, cr, cls3, window, 64 ** -0.5, 12)
    ref = fa.relpos_attention_reference(qkv, cr, cls3, window, 64 ** -0.5,
                                        12)
    torch.cuda.synchronize()
    return _compare(f"K2 fwd B={B} N=577 {str(dtype)[6:]}",
                    [("out", out, ref)], dtype)


def k2_fwd_times(B, dtype) -> dict:
    """Forward times (ms) at the stage-1 batch: kernel, plain, and SDPA
    with the bias materialized as a [1, H, N, N] mask (built untimed)."""
    import torch.nn.functional as F

    from xfm_tpu_torch.ops import flash_attention as fa
    from xfm_tpu_torch.ops.relpos import expand_compact_rel_pos

    window, H, scale = (24, 24), 12, 64 ** -0.5
    qkv, cr, cls3, _ = make_k2_inputs(B, window, H, dtype, 1)
    t = {"fwd_ms": cuda_ms(lambda: fa.relpos_attention_fwd(
        qkv, cr, cls3, window, scale, H))}
    t["plain_fwd_ms"] = cuda_ms(lambda: fa.relpos_attention_reference(
        qkv, cr, cls3, window, scale, H), 5)
    N = qkv.shape[1]
    q, k, v = (x.reshape(B, N, H, 64).transpose(1, 2).contiguous()
               for x in qkv.split(H * 64, dim=-1))
    mask = expand_compact_rel_pos(cr.float(), cls3, window).to(dtype)
    t["library_fwd_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale))
    return t


# phase-16 tolerance (f32, CPU vs card, the same weights and similarities):
# each score matrix on its candidates, relative to its largest |score|
EVAL_SCORE_RTOL = 1e-4


def _scores_close(tag: str, want, got) -> None:
    """Two rerank score matrices: the same candidate sets (the -100 fill in
    the same places) and the candidates' scores within EVAL_SCORE_RTOL of
    the largest |score|."""
    cand = want != -100.0
    if not np.array_equal(cand, got != -100.0):
        raise AssertionError(f"{tag}: the candidate sets differ")
    err = float(np.abs(want[cand] - got[cand]).max())
    tol = EVAL_SCORE_RTOL * float(np.abs(want[cand]).max())
    print(f"  {tag}: {int(cand.sum())} scores, max_abs_err={err:.3e} "
          f"tol={tol:.3e} {'ok' if err <= tol else 'FAIL'}")
    if not err <= tol:
        raise AssertionError(f"{tag}: scores disagree")


def eval_slice_parity(clip: bool, n_img=16, per_image=2, k_test=16,
                      layers=2) -> None:
    """The eval at full width and depth `layers`, 384 px, f32, on the CPU
    and on the card from the same weights; both rerank on the CPU's
    similarities. On the card the grouped image → text rerank launches K3
    once a layer and chunk of 8 images, the repeat form never."""
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.models import XFMForRetrieval
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks import retrieval

    tower = "clip" if clip else "beit"
    cfg = configs.xfm_retrieval_eval_config(dtype=torch.float32,
                                            layers=layers, clip=clip)
    cpu = build_model(XFMForRetrieval, cfg, "cpu", seed=3)
    gpu = build_model(XFMForRetrieval, cfg, "cpu", seed=3).to("cuda")
    data = configs.SyntheticRetrievalEvalData(
        n_img, per_image, cfg.vision.image_res, cfg.text.vocab_size, seed=5)
    enc_c = retrieval.encode_corpus(cpu, data, 8)
    enc_g = retrieval.encode_corpus(gpu, data, 8)
    for name, i in (("image feats", 1), ("text feats", 3)):
        _scores_close(f"eval slice {tower} {name}", enc_c[i], enc_g[i])
    sims = enc_c[1] @ enc_c[3].T
    prev = os.environ.get("XFM_EVAL_GROUPED")
    runs, k3 = {}, {}
    try:
        for grouped in ("1", "0"):
            os.environ["XFM_EVAL_GROUPED"] = grouped
            kernels.reset_launch_counts()
            runs[grouped] = retrieval.rerank_scores(
                gpu, enc_g[0], enc_g[2], enc_g[4], sims, k_test)
            k3[grouped] = kernels.LAUNCHES["flash_attention_fwd"]
        os.environ["XFM_EVAL_GROUPED"] = "1"
        want = retrieval.rerank_scores(cpu, *enc_c[0::2], sims, k_test)
    finally:
        if prev is None:
            os.environ.pop("XFM_EVAL_GROUPED", None)
        else:
            os.environ["XFM_EVAL_GROUPED"] = prev
    for d, name in enumerate(("score_i2t", "score_t2i")):
        _scores_close(f"eval slice {tower} {name} cpu vs cuda", want[d],
                      runs["1"][d])
        _scores_close(f"eval slice {tower} {name} grouped vs repeat",
                      runs["1"][d], runs["0"][d])
    def recall(scores):
        return {k: float(v) for k, v in retrieval.itm_eval(
            *scores, data.img2txt, data.txt2img).items()}

    r_want = recall(want)
    for grouped, scores in runs.items():
        r_got = recall(scores)
        print(f"  eval slice {tower} R@K cpu={r_want} cuda(grouped="
              f"{grouped})={r_got}")
        if r_got != r_want:
            raise AssertionError(f"eval slice {tower}: R@K differ")
    want_k3 = {"1": layers * -(-n_img // 8), "0": 0}
    print(f"  eval slice {tower} K3 launches in the image -> text rerank: "
          f"grouped {k3['1']}, repeat {k3['0']}, expected {want_k3}")
    if k3 != want_k3:
        raise AssertionError(f"eval slice {tower}: K3 launched {k3}")


def full_eval(n_img=256, per_image=5, k_test=256, seed=0) -> dict:
    """Phase 17: the full-width eval through `tasks/retrieval.evaluation`,
    its weights loaded from a 224 px reference checkpoint; launch counts
    set to 0 just before the eval and read just after."""
    import tempfile

    from xfm_tpu_torch import configs
    from xfm_tpu_torch.models import XFMForRetrieval
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks import retrieval
    from xfm_tpu_torch.train import checkpoint as ck

    m224 = build_model(XFMForRetrieval, configs.xfm_retrieval_eval_config(
        image_res=224), "cuda", seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for blk in m224.vision_encoder.blocks:
            blk.attn.relative_position_bias_table.normal_(0.0, 0.02,
                                                          generator=g)
    cfg = configs.xfm_retrieval_eval_config()
    model = build_model(XFMForRetrieval, cfg, "cuda", seed=seed + 1)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "xfm_base_224.pth")
        torch.save({"model": ck.reference_state_dict(m224)}, path)
        t224 = m224.vision_encoder.blocks[0].attn.relative_position_bias_table
        want0 = ck.interpolate_rel_pos_bias_table(
            t224.detach().float().cpu().numpy(), (24, 24))
        del m224
        missing, unexpected = ck.load_xfm_checkpoint(
            model, ck.load_torch_state_dict(path))
    table = model.vision_encoder.blocks[0].attn.relative_position_bias_table
    print(f"  checkpoint 224 px -> 384 px: {len(missing)} missing, "
          f"{len(unexpected)} unexpected; rel-pos table "
          f"{tuple(t224.shape)} -> {tuple(table.shape)}")
    if missing or unexpected or not np.array_equal(
            table.detach().cpu().numpy(), want0):
        raise AssertionError("the checkpoint did not load whole")
    data = configs.SyntheticRetrievalEvalData(
        n_img, per_image, cfg.vision.image_res, cfg.text.vocab_size,
        seed=seed)
    n_txt = n_img * per_image
    config = dict(configs.RETRIEVAL_COCO, k_test=k_test)
    timings = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = retrieval.evaluation(model, data, config, timings)
    total = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    layers = cfg.vision.depth
    want = {name: 0 for name in launches}
    want["relpos_attention_fwd"] = layers * -(-n_img // 64)
    want["flash_attention_fwd"] = cfg.fusion.num_hidden_layers * \
        -(-n_img // 8)
    flops = configs.retrieval_eval_flops(n_img, n_txt, k_test,
                                         configs.RETRIEVAL_COCO["max_tokens"],
                                         cfg.vision.num_patches)
    stage1_s = timings["images_s"] + timings["texts_s"]
    res = dict(
        n_img=n_img, n_txt=n_txt, k_test=k_test,
        tflop_per_s={"stage1": flops["stage1"] / stage1_s / 1e12,
                     "i2t": flops["i2t"] / timings["i2t_s"] / 1e12,
                     "t2i": flops["t2i"] / timings["t2i_s"] / 1e12},
        images_per_s=n_img / timings["images_s"],
        texts_per_s=n_txt / timings["texts_s"],
        i2t_rows_per_s=n_img * k_test / timings["i2t_s"],
        t2i_rows_per_s=n_txt * k_test / timings["t2i_s"],
        timings_s=timings, total_s=total,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        metrics={k: float(v) for k, v in metrics.items()},
        launches=launches)
    print("  full eval: " + json.dumps(res))
    if launches != want:
        raise AssertionError(f"eval launches {launches}, expected {want}")
    if not all(math.isfinite(v) and 0.0 <= v <= 100.0
               for v in res["metrics"].values()):
        raise AssertionError(f"eval R@K out of range: {res['metrics']}")
    return res


def cli_eval() -> None:
    """`python3 -m xfm_tpu_torch.run --task itr_coco --evaluate` on 8 PNGs
    of 2 captions each (the config `Retrieval_coco.yaml`'s keys, its
    annotation and image paths replaced), where PyYAML and PIL import;
    its log's R@K must be finite."""
    import tempfile

    try:
        import yaml
        from PIL import Image
    except ImportError as e:
        print(f"  run.py --evaluate: not driven here ({e}); the tests drive "
              f"it on the CPU")
        return
    from xfm_tpu_torch import configs

    with tempfile.TemporaryDirectory() as d:
        r = np.random.RandomState(0)
        ann = []
        for i in range(8):
            Image.fromarray(r.randint(0, 255, (64, 48, 3)).astype(np.uint8)) \
                .save(os.path.join(d, f"img{i}.png"))
            ann.append({"image": f"img{i}.png",
                        "caption": [f"a photo of thing {i}",
                                    f"thing number {i} in a photo"]})
        with open(os.path.join(d, "test.json"), "w") as f:
            json.dump(ann, f)
        cfg = {k: v for k, v in configs.RETRIEVAL_COCO.items()
               if k not in ("train_file", "val_file")}
        cfg.update(test_file=os.path.join(d, "test.json"), image_root=d)
        with open(os.path.join(d, "ret.yaml"), "w") as f:
            yaml.safe_dump(cfg, f)
        out = os.path.join(d, "out")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "xfm_tpu_torch.run", "--task", "itr_coco",
             "--config", os.path.join(d, "ret.yaml"), "--evaluate",
             "--output_dir", out, "--seed", "0"], cwd=REPO,
            capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-3000:])
            raise AssertionError("run.py --evaluate failed")
        with open(os.path.join(out, "log.txt")) as f:
            metrics = json.loads(f.read().splitlines()[-1])["eval"]
    print(f"  run.py --task itr_coco --evaluate on 8 PNGs: "
          f"{time.perf_counter() - t0:.1f} s, {metrics}")
    if not all(math.isfinite(v) and 0.0 <= v <= 100.0
               for v in metrics.values()):
        raise AssertionError("run.py --evaluate: R@K out of range")


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _finetune_corpus(root, n_train, n_test, seed):
    """`n_train` random PNGs of 300-640 px a side, 2 captions each →
    (train json, test json): the train file one pair a caption with its
    image_id; the test file one entry for each of the first `n_test`
    images with its captions (so that what the steps learn shows in
    R@K)."""
    from PIL import Image

    r = np.random.RandomState(seed)
    words = ["a", "photo", "of", "the", "red", "blue", "dog", "cat", "on",
             "grass", "with", "sky", "man", "riding", "street"]
    train, test = [], []
    for i in range(n_train):
        # a colour and a wave of its own under pixel noise, so that the
        # images differ in more than their noise
        h, w = r.randint(300, 641, 2)
        yy, xx = np.mgrid[0:h, 0:w]
        wave = np.sin(xx * r.uniform(0.01, 0.1) + yy * r.uniform(0.01, 0.1)
                      + r.uniform(0, 2 * np.pi))
        arr = (r.randint(0, 256, 3) + 60 * wave[..., None] * r.uniform(
            -1, 1, 3) + r.normal(0, 12, (h, w, 3)))
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
            os.path.join(root, f"img{i}.png"))
        caps = [" ".join(r.choice(words, 4 + (i + j) % 9)) + f" {i}."
                for j in range(2)]
        train += [{"image": f"img{i}.png", "caption": c, "image_id": i}
                  for c in caps]
        if i < n_test:
            test.append({"image": f"img{i}.png", "caption": caps})
    paths = []
    for name, ann in (("train.json", train), ("test.json", test)):
        paths.append(os.path.join(root, name))
        with open(paths[-1], "w") as f:
            json.dump(ann, f)
    return paths


def finetune_runs(root, keys=None, n_train=36, n_test=16, bs=24, epochs=2,
                  seed=0, device="cuda") -> dict:
    """Phase 18's two runs of `run.main` in `root` (`keys` set on
    `Retrieval_coco.yaml`'s): the whole fine-tune, then, after deleting
    ckpt/1, the resumed one. Each eval, epoch and step is recorded:
    seconds, launches, losses, the lr each step took."""
    import yaml

    from xfm_tpu_torch import configs, run
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks import retrieval
    from xfm_tpu_torch.train.schedules import schedule_from_config

    train, test = _finetune_corpus(root, n_train, n_test, seed)
    cfg = {k: v for k, v in configs.RETRIEVAL_COCO.items()
           if k != "val_file"}
    cfg.update(train_file=[train], test_file=test, image_root=root,
               resume=True, **(keys or {}))
    cfg_path = os.path.join(root, "ft.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = os.path.join(root, "out")
    argv = ["--task", "itr_coco", "--config", cfg_path, "--output_dir", out,
            "--bs", str(bs), "--epoch", str(epochs), "--seed", str(seed),
            "--device", device]
    real_eval, real_epoch = retrieval.evaluation, retrieval.train_epoch
    real_resume = retrieval.maybe_resume_epochs
    rec = {}

    def evaluation(model, data, config, timings=None):
        _sync()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = real_eval(model, data, config, timings)
        _sync()
        rec["evals"].append(dict(s=time.perf_counter() - t0,
                                 launches=dict(kernels.LAUNCHES),
                                 r_mean=float(metrics["r_mean"])))
        return metrics

    def train_epoch(ctx, state, step_fn, loader, generator, epoch, sched,
                    **kw):
        steps = []

        def step(state, batch, gen):
            lr = state.optimizer.lr(state.optimizer.count)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch, gen)
            loss = metrics["loss"].item()
            steps.append(dict(s=time.perf_counter() - t0, loss=loss, lr=lr))
            return state, metrics

        _sync()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state, stats = real_epoch(ctx, state, step, loader, generator,
                                  epoch, sched, **kw)
        _sync()
        rec["epochs"].append(dict(
            epoch=epoch, s=time.perf_counter() - t0,
            launches=dict(kernels.LAUNCHES), steps=steps, stats=stats,
            max_memory_allocated=(torch.cuda.max_memory_allocated()
                                  if device == "cuda" else None)))
        return state, stats

    def maybe_resume_epochs(ctx, state):
        state, start = real_resume(ctx, state)
        if start:  # the restored state against the file it came from
            saved = torch.load(os.path.join(out, "ckpt", str(start - 1),
                                            "state.pt"),
                               map_location=device, weights_only=True)
            opt = state.optimizer
            equal = (state.step == saved["step"]
                     and opt.count == saved["optimizer"]["count"])
            for name, p in zip(opt.names, opt.params):
                equal &= torch.equal(p, saved["params"][name])
            for key in ("mu", "nu"):
                for name, t in zip(opt.names, getattr(opt, key)):
                    equal &= torch.equal(t, saved["optimizer"][key][name])
            rec["restored"] = dict(start=start, bit_equal=bool(equal),
                                   count=opt.count,
                                   lr=opt.lr(opt.count))
            del saved
        return state, start

    runs = {}
    retrieval.evaluation = evaluation
    retrieval.train_epoch = train_epoch
    retrieval.maybe_resume_epochs = maybe_resume_epochs
    try:
        for name in ("full", "resumed"):
            if name == "resumed":
                runs["layout"] = {d: sorted(os.listdir(os.path.join(out, d)))
                                  for d in ("ckpt", "ckpt_best")
                                  if os.path.isdir(os.path.join(out, d))}
                shutil.rmtree(os.path.join(out, "ckpt", str(epochs - 1)))
            rec = dict(evals=[], epochs=[])
            t0 = time.perf_counter()
            rec["result"] = run.main(argv)
            rec["s"] = time.perf_counter() - t0
            with open(os.path.join(out, "log.txt")) as f:
                rec["log"] = [json.loads(x) for x in f.read().splitlines()]
            runs[name] = rec
    finally:
        retrieval.evaluation, retrieval.train_epoch = real_eval, real_epoch
        retrieval.maybe_resume_epochs = real_resume
    steps_per_epoch = n_train * 2 // bs
    runs["schedule_lr"] = schedule_from_config(
        dict(cfg, schedular=dict(cfg["schedular"], epochs=epochs)),
        steps_per_epoch)(steps_per_epoch * (epochs - 1))
    runs["steps_per_epoch"] = steps_per_epoch
    runs["checkpoint_bytes"] = os.path.getsize(os.path.join(
        out, "ckpt", "0", "state.pt"))
    return runs


def full_finetune(epochs=2, n_test=16) -> dict:
    """Phase 18: `finetune_runs` at full width on the card, checked; its
    output directory deleted at the end."""
    import tempfile

    from xfm_tpu_torch import configs

    root = tempfile.mkdtemp(prefix="xfm_ft_")
    try:
        runs = finetune_runs(root, n_test=n_test, epochs=epochs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg = configs.xfm_retrieval_eval_config()
    layers, fusion = cfg.vision.depth, cfg.fusion.num_hidden_layers
    spe = runs["steps_per_epoch"]
    names = list(runs["full"]["evals"][0]["launches"])
    want_eval = {n: 0 for n in names}
    # one stage-1 batch (batch_size_test 64); k_test = 16 candidates of
    # 40 tokens (640 ≥ 512 query rows) in chunks of 8 images
    want_eval.update(relpos_attention_fwd=layers * -(-n_test // 64),
                     flash_attention_fwd=fusion * -(-n_test // 8))
    want_epoch = {n: 0 for n in names}
    want_epoch.update(relpos_attention_fwd=layers * spe,
                      relpos_attention_bwd=layers * spe)
    full, resumed = runs["full"], runs["resumed"]
    for name in ("full", "resumed"):
        r = runs[name]
        print(f"  {name}: {r['s']:.1f} s, result {r['result']}")
        for i, e in enumerate(r["evals"]):
            print(f"    eval {i}: {e['s']:.2f} s, r_mean {e['r_mean']:.3f}, "
                  f"launches {json.dumps(e['launches'])}")
            if e["launches"] != want_eval:
                raise AssertionError(f"{name} eval {i} launches "
                                     f"{e['launches']}, expected {want_eval}")
        for e in r["epochs"]:
            print(f"    epoch {e['epoch']}: {e['s']:.2f} s, peak memory "
                  f"{e['max_memory_allocated']} B, step s "
                  f"{[round(x['s'], 4) for x in e['steps']]}, losses "
                  f"{[x['loss'] for x in e['steps']]}, lr "
                  f"{[x['lr'] for x in e['steps']]}, launches "
                  f"{json.dumps(e['launches'])}")
            print(f"      logged {json.dumps(e['stats'])}")
            if e["launches"] != want_epoch or len(e["steps"]) != spe:
                raise AssertionError(f"{name} epoch {e['epoch']}: "
                                     f"{len(e['steps'])} steps, launches "
                                     f"{e['launches']}, expected "
                                     f"{want_epoch}")
            if not all(math.isfinite(x["loss"]) for x in e["steps"]):
                raise AssertionError(f"{name}: a non-finite loss")
    best, best_epoch = full["log"][0]["r_mean"], None
    for e in full["log"][1:]:
        if e["r_mean"] > best:
            best, best_epoch = e["r_mean"], e["epoch"]
    want_layout = {"ckpt": [str(i) for i in range(epochs)]}
    if best_epoch is not None:
        want_layout["ckpt_best"] = [str(best_epoch)]
    print(f"  checkpoints after the first run: {runs['layout']} (expected "
          f"{want_layout}: the best R_mean from epoch {best_epoch}), "
          f"{runs['checkpoint_bytes']} B each")
    if runs["layout"] != want_layout:
        raise AssertionError(f"checkpoint layout {runs['layout']}")
    if len(full["evals"]) != epochs + 1 or len(full["epochs"]) != epochs:
        raise AssertionError("the first run: one zero-shot eval and an "
                             "eval and an epoch each")
    restored = resumed.get("restored", {})
    print(f"  resume: {json.dumps(restored)}; schedule lr at count "
          f"{spe * (epochs - 1)}: {runs['schedule_lr']}")
    if not (restored.get("bit_equal") and restored["start"] == epochs - 1
            and [e["epoch"] for e in resumed["epochs"]] == [epochs - 1]
            and restored["lr"] == runs["schedule_lr"]
            == resumed["epochs"][0]["steps"][0]["lr"]):
        raise AssertionError("the resume did not restore the state whole "
                             "or did not go on at the last epoch")
    a = [x["loss"] for x in full["epochs"][-1]["steps"]]
    b = [x["loss"] for x in resumed["epochs"][0]["steps"]]
    rel = [abs(x - y) / abs(x) for x, y in zip(a, b)]
    print(f"  last epoch's losses, first run {a}, resumed {b}, "
          f"relative differences {rel}")
    if a[0] != b[0] or not all(d <= FT_RESUME_RTOL for d in rel):
        raise AssertionError("the resumed epoch's losses differ")
    return dict(r_mean=[e["r_mean"] for e in full["log"]],
                ckpt_best=runs["layout"].get("ckpt_best"),
                epoch_s=[e["s"] for e in full["epochs"]],
                eval_s=[e["s"] for e in full["evals"]],
                step_s=[x["s"] for e in full["epochs"] for x in e["steps"]],
                max_memory_allocated=max(e["max_memory_allocated"]
                                         for e in full["epochs"]),
                resume_rel=rel)


def eval_kernel_entries(k2_err, k2_t, k2w, k3_err, k3_t, k3w,
                        launches) -> list:
    """The `kernels` entries of the eval's path: K2's forward at the
    stage-1 batch and K3's forward at the grouped rerank shape, their
    launches from phase 17."""
    out = []
    for name, prefix, line, src, err, t, w in (
            ("relpos_attention_fwd_eval_b64", "relpos_attention", 689,
             "relpos_attention.cu", k2_err, k2_t, k2w),
            ("flash_attention_fwd_grouped_rerank", "flash_attention", 71,
             "flash_attention.cu", k3_err, k3_t, k3w)):
        out.append(dict(
            name=name, route="cuda", source=f"xfm_tpu_torch/csrc/{src}",
            replaces=f"xfm_tpu/ops/flash_attention.py:{line}",
            launches=launches[f"{prefix}_fwd"], max_abs_err=err["out"][0],
            ms=t["fwd_ms"], plain_ms=t["plain_fwd_ms"],
            bound_ms=w["fwd"]["bound_ms"], bound_by=w["fwd"]["bound_by"],
            library_ms=t["library_fwd_ms"]))
    return out


LN_EPS = 1e-6


def _randn(gen, *shape, scale=1.0, shift=0.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale + shift


def k4_work(R: int, C: int, dtype: torch.dtype, variant: str = "add"
            ) -> dict:
    """As `k1_work`, for K4's add + LN variant: x, y, γ, β in, xn and h out;
    backward xn, dh, dxn and γ in, dx, dγ, dβ out; the post-LN variant
    writes no xn and reads no dxn. Its arithmetic is f32 on the CUDA cores
    (about 8 operations an element forward, 17 backward)."""
    t = R * C * torch.tensor([], dtype=dtype).element_size()
    n = 4 if variant == "add" else 3
    return _bounds({"fwd": (n * t + 2 * C * 4, 8 * R * C),
                    "bwd": (n * t + 3 * C * 4, 17 * R * C)},
                   PEAK_FLOPS[torch.float32])


def make_k4_inputs(R, C, dtype, seed):
    """x, y, dh, dxn [R, C] in `dtype`; γ, β f32 [C]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = _randn(gen, R, C, scale=2.0, shift=1.0).to(dtype)
    y, dh, dxn = (_randn(gen, R, C).to(dtype) for _ in range(3))
    gamma = _randn(gen, C, scale=0.3, shift=1.0)
    beta = _randn(gen, C, scale=0.1)
    return x, y, gamma, beta, dh, dxn


def k4_parity(variant: str, R: int, C: int, dtype, seed=0) -> dict:
    """Kernel vs plain version of one variant ("plain", "post", "add") on
    the same inputs; both backwards from the plain forward's sum."""
    from xfm_tpu_torch.ops import fused_ln as fl

    x, y, gamma, beta, dh, dxn = make_k4_inputs(R, C, dtype, seed)
    y = None if variant == "plain" else y
    dxn = dxn if variant == "add" else None
    xn, h = fl.fused_ln_fwd(x, y, gamma, beta, LN_EPS)
    rxn, rh = fl.fused_ln_reference(x, y, gamma, beta, LN_EPS)
    dx, dg, db = fl.fused_ln_bwd(rxn, dh, dxn, gamma, LN_EPS)
    rdx, rdg, rdb = fl.fused_ln_bwd_reference(rxn, dh, dxn, gamma, LN_EPS)
    torch.cuda.synchronize()
    pairs = [("out", h, rh)] + ([("xn", xn, rxn)] if y is not None else [])
    pairs += [("dx", dx, rdx), ("dgamma", dg, rdg), ("dbeta", db, rdb)]
    return _compare(f"K4 {variant} R={R} C={C} {str(dtype)[6:]}", pairs,
                    dtype)


def k4_deterministic(R: int, C: int, dtype, seed=4) -> None:
    """The backward's dx, dγ and dβ bit-equal over two calls at R rows,
    the second after calls at other R (so with the fold's tickets reset by
    the calls between), and the tickets at 0 after them."""
    from xfm_tpu_torch.ops import fused_ln as fl

    x, _, gamma, _, dh, dxn = make_k4_inputs(R, C, dtype, seed)
    first = fl.fused_ln_bwd(x, dh, dxn, gamma, LN_EPS)
    again = fl.fused_ln_bwd(x, dh, dxn, gamma, LN_EPS)
    for r in (1, 1440, 5761):
        fl.fused_ln_bwd(x[:r], dh[:r], None, gamma, LN_EPS)
    third = fl.fused_ln_bwd(x, dh, dxn, gamma, LN_EPS)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(first, again, third))
    tickets = int(fl.fold_tickets(x.device, 0).abs().sum())
    print(f"  K4 R={R} C={C} {str(dtype)[6:]}: dx, dgamma, dbeta bit-equal "
          f"over two calls and after calls at R = 1, 1440, 5761: {same}; "
          f"tickets left {tickets}")
    if not same or tickets:
        raise AssertionError("K4's backward is not deterministic or left "
                             "its tickets set")


def k4_times(R: int, C: int, dtype, variant: str = "add") -> dict:
    """Kernel, plain and library times (ms) of the add or post variant, and
    the kernels' device time a call (`kernel_*_ms`). The library yardstick
    is the default route: F.layer_norm of the f32 sum, cast (and the sum
    itself, add)."""
    import torch.nn.functional as F

    from xfm_tpu_torch.ops import fused_ln as fl

    x, y, gamma, beta, dh, dxn = make_k4_inputs(R, C, dtype, 1)
    dxn = dxn if variant == "add" else None
    xn, _ = fl.fused_ln_fwd(x, y, gamma, beta, LN_EPS)
    t = {}
    t["fwd_ms"] = cuda_ms(lambda: fl.fused_ln_fwd(x, y, gamma, beta, LN_EPS))
    t["bwd_ms"] = cuda_ms(lambda: fl.fused_ln_bwd(xn, dh, dxn, gamma,
                                                  LN_EPS))
    t["kernel_fwd_ms"] = device_ms(
        lambda: fl.fused_ln_fwd(x, y, gamma, beta, LN_EPS))
    t["kernel_bwd_ms"] = device_ms(
        lambda: fl.fused_ln_bwd(xn, dh, dxn, gamma, LN_EPS))
    t["plain_fwd_ms"] = cuda_ms(lambda: fl.fused_ln_reference(
        x, y, gamma, beta, LN_EPS), 5)
    t["plain_bwd_ms"] = cuda_ms(lambda: fl.fused_ln_bwd_reference(
        xn, dh, dxn, gamma, LN_EPS), 5)

    def library(x, y, gamma, beta):
        s = x.float() + y.float()
        h = F.layer_norm(s, (C,), gamma, beta, LN_EPS)
        return (s.to(dtype), h.to(dtype)) if variant == "add" \
            else (h.to(dtype),)

    with torch.no_grad():
        t["library_fwd_ms"] = cuda_ms(lambda: library(x, y, gamma, beta))
    leaves = [v.clone().requires_grad_(True) for v in (x, y, gamma, beta)]
    grads = [dxn, dh] if variant == "add" else [dh]

    def lib_fwd_bwd():
        torch.autograd.backward(library(*leaves), grads)

    t["library_fwd_bwd_ms"] = cuda_ms(lib_fwd_bwd)
    t["library_bwd_ms"] = t["library_fwd_bwd_ms"] - t["library_fwd_ms"]
    return t


def k5_work(M: int, K: int, N: int, dtype: torch.dtype) -> dict:
    """As `k1_work`, for K5: h, W, b in, y out; backward h, W, g in, dh,
    dW, db out; 2·M·K·N operations a product, one forward, two backward."""
    isz = torch.tensor([], dtype=dtype).element_size()
    fwd_bytes = (M * K + N * K + N + M * N) * isz
    bwd_bytes = (M * K + N * K + M * N + M * K + N * K + N) * isz
    return _bounds({"fwd": (fwd_bytes, 2 * M * K * N),
                    "bwd": (bwd_bytes, 4 * M * K * N)}, PEAK_FLOPS[dtype])


def make_k5_inputs(M, K, N, dtype, seed):
    """h [M, K] (2·randn, so the activations' tails are reached), the
    Linear weight W [N, K], b [N], g [M, N], all in `dtype`."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = _randn(gen, M, K, scale=2.0)
    w = _randn(gen, N, K, scale=0.02)
    b = _randn(gen, N, scale=0.1)
    g = _randn(gen, M, N)
    return tuple(v.to(dtype) for v in (h, w, b, g))


def k5_parity(act: str, M: int, dtype, K=3072, N=768, seed=0) -> dict:
    """Kernel vs plain version on the same inputs → max abs errors."""
    from xfm_tpu_torch.ops import fused_mlp as fm

    h, w, b, g = make_k5_inputs(M, K, N, dtype, seed)
    y = fm.act_matmul_fwd(h, w, b, act)
    dh, dw, db = fm.act_matmul_bwd(h, w, g, act)
    ry = fm.act_matmul_reference(h, w, b, act)
    rdh, rdw, rdb = fm.act_matmul_bwd_reference(h, w, g, act)
    torch.cuda.synchronize()
    return _compare(f"K5 {act} M={M} K={K} N={N} {str(dtype)[6:]}",
                    [("out", y, ry), ("dh", dh, rdh), ("dW", dw, rdw),
                     ("db", db, rdb)], dtype)


def k5_deterministic(M: int, dtype, act="gelu_tanh", K=3072, N=768,
                     seed=5) -> None:
    """K5's backward (dh, dW, db) twice on the same inputs → the same bits,
    or raise: the split dW adds its partials in a fixed order."""
    from xfm_tpu_torch.ops import fused_mlp as fm

    h, w, _, g = make_k5_inputs(M, K, N, dtype, seed)
    runs = [fm.act_matmul_bwd(h, w, g, act) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"  K5 M={M} {str(dtype)[6:]} ({fm.dw_splits(M, K, N)} dW splits): "
          f"dh, dW, db bit-equal over two runs: {same}")
    if not same:
        raise AssertionError("K5's backward is not deterministic")


def k5_times(M: int, dtype, act="gelu_tanh", K=3072, N=768) -> dict:
    """Kernel, plain and library times (ms) at one shape. The library
    yardstick is the default route's two calls, F.linear(act(h), W, b)."""
    import torch.nn.functional as F

    from xfm_tpu_torch.ops import fused_mlp as fm
    from xfm_tpu_torch.ops.activations import ACT

    h, w, b, g = make_k5_inputs(M, K, N, dtype, 1)
    t = {}
    t["fwd_ms"] = cuda_ms(lambda: fm.act_matmul_fwd(h, w, b, act))
    t["bwd_ms"] = cuda_ms(lambda: fm.act_matmul_bwd(h, w, g, act))
    t["plain_fwd_ms"] = cuda_ms(lambda: fm.act_matmul_reference(
        h, w, b, act), 5)
    t["plain_bwd_ms"] = cuda_ms(lambda: fm.act_matmul_bwd_reference(
        h, w, g, act), 5)
    with torch.no_grad():
        t["library_fwd_ms"] = cuda_ms(lambda: F.linear(ACT[act](h), w, b))
    hl, wl, bl = (v.clone().requires_grad_(True) for v in (h, w, b))

    def lib_fwd_bwd():
        F.linear(ACT[act](hl), wl, bl).backward(g)

    t["library_fwd_bwd_ms"] = cuda_ms(lib_fwd_bwd)
    t["library_bwd_ms"] = t["library_fwd_bwd_ms"] - t["library_fwd_ms"]
    return t


def fused_launches_per_step(cfg) -> dict:
    """K4 and K5 launches (forward, backward) of one pretrain step with the
    fused routes: the vision pair pass runs its blocks once (norm2, fc2);
    the text encoder runs twice, clean and masked (two post-LNs and one
    output.dense a layer), the masked pass detached, so without a backward;
    the 4B-row fusion pass once (three post-LNs, one output.dense)."""
    v, t, f = (cfg.vision.depth, cfg.text.num_hidden_layers,
               cfg.fusion.num_hidden_layers)
    return {"fused_ln": (v + 2 * 2 * t + 3 * f, v + 2 * t + 3 * f),
            "fused_mlp": (v + 2 * t + f, v + t + f)}


def clip_fused_launches_per_step(cfg) -> dict:
    """K4 and K5 launches (forward, backward) of one CLIP retrieval step
    with the fused routes: the text pass (two post-LNs and one output.dense
    a layer) and the ITM positive and negative fusion passes (three post-LNs
    and one output.dense a layer each), all trained; the tower takes
    neither."""
    t, f = cfg.text.num_hidden_layers, cfg.fusion.num_hidden_layers
    return {"fused_ln": (2 * t + 2 * 3 * f,) * 2,
            "fused_mlp": (t + 2 * f,) * 2}


def build_model(cls, cfg, device, seed=0):
    from xfm_tpu_torch.train.checkpoint import init_weights

    model = cls(cfg).to(device)
    init_weights(model, seed)
    return model


def slice_parity(path: str) -> None:
    """f32, full width, depth 2: the same weights and batch on the CPU and
    on the card → losses and sampled gradients agree. `path`: "pretrain"
    (224 px), "pretrain_fused" (the same with K4 and K5, whose launches on
    the card are checked), "retrieval" (384 px, so K2 on the card) or
    "clip_retrieval" (384 px with the CLIP-ViT tower, so K3 on the card)
    or "clip_retrieval_fused" (the same with K4 and K5 in the text and
    fusion encoders, their launches checked)."""
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.models import XFMForPretrain, XFMForRetrieval
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.train import train_state

    vision_sample = ["vision_encoder.blocks.0.attn.qkv.weight",
                   "vision_encoder.blocks.1.attn.relative_position_bias_table",
                   "vision_encoder.patch_embed.proj.weight"]
    if path in ("pretrain", "pretrain_fused"):
        fused = path == "pretrain_fused"
        cfg = configs.xfm_base_pretrain_config(layers=2, dtype=torch.float32,
                                               fused_ln=fused,
                                               fused_mlp=fused)
        if fused:  # K4's and K5's own parameters
            vision_sample += ["vision_encoder.blocks.0.norm2.weight",
                              "vision_encoder.blocks.1.mlp.fc2.weight",
                              "fusion_encoder.roberta.encoder.layer.1."
                              "crossattention.output.LayerNorm.bias",
                              "text_encoder.roberta.encoder.layer.0.output."
                              "dense.weight"]
        nb = configs.make_batch(4, 30, 15, 224, cfg.vision.num_patches,
                                cfg.text.vocab_size, seed=1)
        cls, loss_fn = XFMForPretrain, train_state.pretrain_loss_fn
        names = ("loss_itc", "loss_itm", "loss_mlm", "loss_mim")
        text_weight = "text_encoder.roberta.encoder.layer.0.attention.self." \
                      "query.weight"
    else:
        if path == "retrieval":
            cfg = configs.xfm_base_retrieval_config(layers=2,
                                                    dtype=torch.float32)
        else:
            fused = path == "clip_retrieval_fused"
            cfg = configs.xfm_clip_retrieval_config(layers=2,
                                                    dtype=torch.float32,
                                                    fused_ln=fused,
                                                    fused_mlp=fused)
            vision_sample = [
                "vision_encoder.encoder.layers.0.self_attn.q_proj.weight",
                "vision_encoder.encoder.layers.1.self_attn.k_proj.weight",
                "vision_encoder.pos_embed.weight",
                "vision_encoder.patch_embed.weight"]
            if fused:  # K4's parameters (K5's: the text output.dense)
                vision_sample += [
                    "fusion_encoder.roberta.encoder.layer.1.crossattention."
                    "output.LayerNorm.bias",
                    "text_encoder.roberta.encoder.layer.0.attention.output."
                    "LayerNorm.weight"]
        nb = configs.make_retrieval_batch(4, 40, 384, cfg.text.vocab_size,
                                          seed=1)
        cls, loss_fn = XFMForRetrieval, train_state.retrieval_loss_fn
        names = ("loss_itc", "loss_itm")
        # trained through ITM's fusion passes as well as ITC
        text_weight = "text_encoder.roberta.encoder.layer.1.output.dense." \
                      "weight"
    cpu = build_model(cls, cfg, "cpu", seed=3)
    gpu = build_model(cls, cfg, "cpu", seed=3).to("cuda")
    neg = (torch.tensor([1, 2, 3, 0]), torch.tensor([2, 3, 0, 1]))
    results = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        batch = configs.batch_to_torch(nb, dev)
        batch["hard_negatives"] = tuple(n.to(dev) for n in neg)
        kernels.reset_launch_counts()
        total, out = loss_fn(model, batch)
        total.backward()
        results[name] = ({k: v.item() for k, v in out.items()},
                         dict(model.named_parameters()))
    fused_counts = {"pretrain_fused": fused_launches_per_step,
                    "clip_retrieval_fused": clip_fused_launches_per_step}
    if path in fused_counts:
        for k, (f, b) in fused_counts[path](cfg).items():
            got = (kernels.LAUNCHES[f"{k}_fwd"], kernels.LAUNCHES[f"{k}_bwd"])
            print(f"  {path} slice {k} launches {got}, expected {(f, b)}")
            if got != (f, b):
                raise AssertionError(f"{path} slice: {k} launched {got}")
    (lc, pc), (lg, pg) = results["cpu"], results["cuda"]
    for k in names:
        ok = math.isclose(lc[k], lg[k], rel_tol=SLICE_LOSS_RTOL)
        print(f"  {path} slice {k}: cpu={lc[k]:.6f} cuda={lg[k]:.6f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{path} slice parity: {k}")
    sample = vision_sample + [
        text_weight,
        "fusion_encoder.roberta.encoder.layer.1.crossattention.self."
        "key.weight",
        "itm_head.0.weight", "temp"]
    for n in sample:
        a = pc[n].grad.float()
        b = pg[n].grad.float().cpu()
        err = (a - b).abs().max().item()
        tol = SLICE_GRAD_RTOL * a.abs().max().item()
        print(f"  {path} slice grad {n}: max_abs_err={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"{path} slice parity: grad of {n}")


def full_width(path: str, steps: int = 5, warmup: int = 2) -> dict:
    """The full-width step of `path` ("pretrain": B = 48 at 224 px, K1;
    "pretrain_fused": the same with both fused routes, K1, K4 and K5;
    "retrieval": B = 32 at 384 px, K2; "clip_retrieval": the same with the
    CLIP-ViT-B/16 tower, K3): launch counts set to 0 just before the steps
    and read just after; every other kernel must stay at 0."""
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.ops import kernels

    per_step = {}  # kernel -> its (forward, backward) launches a step
    if path in ("pretrain", "pretrain_fused"):
        B, T, M = 48, 30, 15
        fused = path == "pretrain_fused"
        state, batch, step = configs.make_pretrain_run(
            B, T, M, fused_ln=fused, fused_mlp=fused)
        cfg = state.model.config
        flops = configs.pretrain_step_flops(B, T, M, cfg.vision.num_patches)
        kernel = "packed_attention"
        if fused:
            per_step = fused_launches_per_step(cfg)
    else:
        B, T = 32, 40
        if path == "retrieval":
            state, batch, step = configs.make_retrieval_run(B, T)
            kernel = "relpos_attention"
        else:
            state, batch, step = configs.make_clip_retrieval_run(B, T)
            kernel = "flash_attention"
        cfg = state.model.config
        flops = configs.retrieval_step_flops(B, T, cfg.vision.num_patches)
    n_params = sum(p.numel() for p in state.model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(warmup + steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        # a trainer reads each step's loss; the read waits for the step
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    dt = float(np.median(times[warmup:]))
    print(f"  {path} params={n_params} losses="
          f"{['%.4f' % v for v in losses]}")
    print(f"  {path} step ms: {['%.1f' % (t * 1e3) for t in times]} "
          f"(first {warmup} are warm-up)")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss in the full-width {path} run")
    n = steps + warmup
    depth = (cfg.vision.num_hidden_layers
             if cfg.vision_backbone == "clip_vit" else cfg.vision.depth)
    per_step[kernel] = (depth, depth)
    want = {name: 0 for name in kernels.LAUNCHES}
    for k, (f, b) in per_step.items():
        want.update({f"{k}_fwd": f * n, f"{k}_bwd": b * n})
    if launches != want:
        raise AssertionError(f"{path} launches {launches}, expected {want}: "
                             f"{per_step} (fwd, bwd) per step over {n} "
                             f"steps")
    # step_ms: the median of the timed steps
    res = dict(step_ms=dt * 1e3, samples_per_s=B / dt,
               mfu=flops / dt / PEAK_FLOPS[torch.bfloat16],
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches=launches, params=n_params)
    print(f"  full width {path}: " + json.dumps(res))
    return res


def kernel_entries(prefix, tpu_file, line_fwd, line_bwd, src, err, bwd_errs,
                   times, work, launches, also_bwd=None) -> list:
    """The two `kernels` entries (fwd, bwd) of one kernel, whose TPU bodies
    are at `tpu_file`:line_fwd and :line_bwd; `also_bwd` names a second TPU
    body that the same CUDA backward replaces. The forward's error is the
    largest of its outputs' (every key of `err` not in `bwd_errs`)."""
    out = []
    fwd_err = max(v[0] for k, v in err.items() if k not in bwd_errs)
    for d, line, e in (("fwd", line_fwd, fwd_err),
                       ("bwd", line_bwd, max(err[k][0] for k in bwd_errs))):
        entry = dict(
            name=f"{prefix}_{d}", route="cuda", source=src,
            replaces=f"{tpu_file}:{line}",
            launches=launches[f"{prefix}_{d}"], max_abs_err=e,
            ms=times[f"{d}_ms"], plain_ms=times[f"plain_{d}_ms"],
            bound_ms=work[d]["bound_ms"], bound_by=work[d]["bound_by"],
            library_ms=times[f"library_{d}_ms"])
        if d == "bwd" and also_bwd:
            entry["also_replaces"] = f"{tpu_file}:{also_bwd}"
        out.append(entry)
    return out


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
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    print(f"phase 1: device {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    from xfm_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.build_libraries(*kernels.KERNEL_LIBRARIES)
    print(f"  K1-K5 build {time.perf_counter() - t0:.1f} s")
    for name, info in kernels.build_info.items():
        print(f"  {name}: {info.get('library')}")
        for line in info.get("ptxas", "").splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    k1_shape = dict(B=96, N=197, H=12)
    k1w = k1_work(**k1_shape, D=64, dtype=torch.bfloat16)
    print("phase 2: K1 parity and times")
    print_ptxas("K1", "packed_attention")
    k1_err = k1_parity(**k1_shape, dtype=torch.bfloat16)
    k1_parity(B=3, N=50, H=4, dtype=torch.bfloat16, seed=1)
    k1_parity(B=3, N=50, H=4, dtype=torch.float32, seed=2)
    k1_parity(B=4, N=197, H=12, dtype=torch.float32, seed=3)
    k1_deterministic(**k1_shape, dtype=torch.bfloat16)
    k1_t = k1_times(**k1_shape, dtype=torch.bfloat16)
    print("  K1 times (ms): " + json.dumps(k1_t))
    print("  K1 bound: " + json.dumps(k1w))
    print("phase 3: pretrain slice parity, CPU vs card")
    slice_parity("pretrain")
    print("phase 4: full-width XFM-base pretrain step")
    pretrain = full_width("pretrain")

    k2_shape = dict(B=32, window=(24, 24), H=12)
    k2w = k2_work(B=32, N=577, H=12, D=64, window=(24, 24),
                  dtype=torch.bfloat16)
    print("phase 5: K2 parity and times")
    print_ptxas("K2", "relpos_attention")
    k2_err = k2_parity(**k2_shape, dtype=torch.bfloat16)
    k2_parity(**k2_shape, dtype=torch.float32, seed=1)
    for dtype in (torch.bfloat16, torch.float32):
        k2_parity(B=4, window=(30, 30), H=12, dtype=dtype, seed=2)
        k2_parity(B=3, window=(7, 11), H=4, dtype=dtype, seed=3)
        k2_parity(B=4, window=(3, 5), H=12, dtype=dtype, seed=5)
    k2_deterministic(**k2_shape, dtype=torch.bfloat16)
    k2_t = k2_times(**k2_shape, dtype=torch.bfloat16)
    print("  K2 times (ms): " + json.dumps(k2_t))
    print("  K2 bound (k2_work): " + json.dumps(k2w))
    print("phase 6: retrieval slice parity, CPU vs card")
    slice_parity("retrieval")
    print("phase 7: full-width XFM-base retrieval step, 384 px")
    retrieval = full_width("retrieval")

    k3_shape = dict(B=32, N=577, H=12)
    k3w = k3_work(B=32, Nq=577, Nk=577, H=12, D=64, dtype=torch.bfloat16)
    print("phase 8: K3 parity and times")
    k3_err = k3_parity(32, 577, 577, 12, torch.bfloat16)
    k3_parity(32, 577, 577, 12, torch.float32, seed=1)
    k3_parity(32, 577, 577, 12, torch.bfloat16, "relpos", seed=2)
    k3_parity(4, 577, 577, 12, torch.bfloat16, "relpos_bf16", seed=3)
    k3_parity(32, 577, 577, 12, torch.bfloat16, "mask", seed=4)
    k3_parity(4, 901, 901, 12, torch.bfloat16, None, seed=5)
    k3_parity(4, 901, 901, 12, torch.float32, "relpos", seed=6)
    for dtype in (torch.bfloat16, torch.float32):
        k3_parity(2, 520, 700, 12, dtype, "relpos", seed=7)
    k3_t = k3_times(**k3_shape, dtype=torch.bfloat16)
    print("  K3 times (ms): " + json.dumps(k3_t))
    print("  K3 bound (k3_work): " + json.dumps(k3w))
    print("phase 9: CLIP retrieval slice parity, CPU vs card, default and "
          "fused routes")
    slice_parity("clip_retrieval")
    slice_parity("clip_retrieval_fused")
    print("phase 10: full-width CLIP-ViT-B/16 retrieval step, 384 px")
    clip = full_width("clip_retrieval")

    print("phase 11: K4 parity and times")
    from xfm_tpu_torch.ops import fused_ln as fl

    print_ptxas("K4", "fused_ln", no_spills_in=("xfm_ln_bwd",))
    for i, (R, dtype) in enumerate((
            (18912, torch.bfloat16), (18912, torch.float32),
            (5760, torch.bfloat16), (5760, torch.float32),
            (1440, torch.bfloat16), (1440, torch.float32),
            (1100, torch.bfloat16), (1100, torch.float32))):
        for variant in ("plain", "post", "add"):
            err = k4_parity(variant, R, 768, dtype, seed=10 + i)
            if (variant, R, dtype) == ("add", 18912, torch.bfloat16):
                k4_err = err
    # the backward's edges: one row; fewer row groups than SMs; a ragged
    # last group; two warps a row with lanes holding unequal numbers of
    # vectors; the largest stage (one row of 8,192 f32 a group, 2 stages)
    for i, (R, C, dtype) in enumerate((
            (1, 768, torch.bfloat16), (1, 768, torch.float32),
            (50, 768, torch.bfloat16), (1003, 768, torch.bfloat16),
            (1003, 768, torch.float32), (999, 1152, torch.bfloat16),
            (999, 1152, torch.float32), (300, 8192, torch.float32))):
        for variant in ("post", "add"):
            k4_parity(variant, R, C, dtype, seed=40 + i)
    k4_deterministic(18912, 768, torch.bfloat16)
    k4_sites = {"beit_add": (18912, "add"), "fusion_post": (5760, "post"),
                "text_post": (1440, "post")}
    k4_site_t, k4_site_w = {}, {}
    for site, (R, variant) in k4_sites.items():
        plan = fl.bwd_plan(R, 768, torch.bfloat16,
                           fl.sm_count(torch.device("cuda", 0)),
                           variant == "add")
        k4_site_w[site] = k4_work(R, 768, torch.bfloat16, variant)
        k4_site_t[site] = k4_times(R, 768, torch.bfloat16, variant)
        print(f"  K4 {site} R={R} plan: " + json.dumps(plan._asdict()))
        print(f"  K4 {site} times (ms): " + json.dumps(k4_site_t[site]))
        print(f"  K4 {site} bound (k4_work): " + json.dumps(k4_site_w[site]))
    k4_t, k4w = k4_site_t["beit_add"], k4_site_w["beit_add"]
    print("phase 12: K5 parity and times")
    print_ptxas("K5", "fused_mlp", no_spills_in=("wgmma", "dw_sum"))
    hgmma = sass_count("fused_mlp", "HGMMA")
    print(f"  K5 HGMMA instructions in the fused_mlp library: "
          f"{'no cuobjdump here' if hgmma is None else hgmma}")
    if hgmma is not None and hgmma <= 0:
        raise AssertionError("K5's library holds no wgmma (HGMMA)")
    # the main path's rows (BEiT 18,912, fusion 5,760, text 1,440) and the
    # edges: one partial tile of M (100, 130), K and N not multiples of 64
    for i, (M, K, N, dtype) in enumerate((
            (18912, 3072, 768, torch.bfloat16),
            (18912, 3072, 768, torch.float32),
            (5760, 3072, 768, torch.bfloat16),
            (5760, 3072, 768, torch.float32),
            (1440, 3072, 768, torch.bfloat16),
            (1440, 3072, 768, torch.float32),
            (100, 3072, 768, torch.bfloat16),
            (100, 3072, 768, torch.float32),
            (130, 3072, 768, torch.bfloat16),
            (130, 200, 72, torch.bfloat16),
            (130, 200, 72, torch.float32))):
        for act in ("gelu_tanh", "gelu", "relu"):
            err = k5_parity(act, M, dtype, K=K, N=N, seed=20 + i)
            if (act, M, dtype) == ("gelu_tanh", 18912, torch.bfloat16):
                k5_err = err
    k5_deterministic(18912, torch.bfloat16)
    k5w = k5_work(18912, 3072, 768, torch.bfloat16)
    k5_t = k5_times(18912, torch.bfloat16)
    print("  K5 times (ms): " + json.dumps(k5_t))
    print("  K5 bound (k5_work): " + json.dumps(k5w))
    print("phase 13: fused pretrain slice parity, CPU vs card")
    slice_parity("pretrain_fused")
    print("phase 14: full-width XFM-base pretrain step, fused LN and MLP")
    fused = full_width("pretrain_fused")
    print(f"  peak memory: fused {fused['max_memory_allocated']} B, "
          f"default {pretrain['max_memory_allocated']} B (phase 4)")

    print("phase 15: K3 and K2 forward parity and times at the eval's "
          "shapes")
    bf16, f32 = torch.bfloat16, torch.float32
    k3g_err = k3_grouped_parity(8, 256, bf16, "ones")
    k3_grouped_parity(8, 256, bf16, "tails", seed=1)
    k3_grouped_parity(8, 256, f32, "tails", seed=2)
    k3_grouped_parity(3, 256, bf16, "ones", seed=3)
    k3_grouped_parity(8, 16, bf16, "tails", seed=4)
    q, _, _, bias = k3_grouped_inputs(8, 256, bf16, "ones", 0)
    k3gw = k3_work(8, q.shape[1], 577, 12, 64, bf16, bias)
    del q, bias
    k3g_t = k3_grouped_times(8, 256, bf16)
    print("  K3 grouped times (ms): " + json.dumps(k3g_t))
    print("  K3 grouped bound (k3_work): " + json.dumps(k3gw))
    k2e_err = k2_fwd_parity(64, bf16)
    k2_fwd_parity(64, f32, seed=1)
    k2ew = k2_work(B=64, N=577, H=12, D=64, window=(24, 24), dtype=bf16)
    k2e_t = k2_fwd_times(64, bf16)
    print("  K2 B=64 times (ms): " + json.dumps(k2e_t))
    print("  K2 B=64 bound (k2_work): " + json.dumps(k2ew))
    print("phase 16: eval slice parity, CPU vs card, BEiT-2 and CLIP-ViT")
    eval_slice_parity(clip=False)
    eval_slice_parity(clip=True)
    print("phase 17: the full-width retrieval eval, 384 px")
    ev = full_eval()
    cli_eval()
    print("phase 18: the full-width retrieval fine-tune, 384 px, and its "
          "resume")
    ft = full_finetune()
    print("  fine-tune: " + json.dumps(ft))

    entries = (kernel_entries("packed_attention",
                              "xfm_tpu/ops/flash_attention.py", 983, 1007,
                              "xfm_tpu_torch/csrc/packed_attention.cu",
                              k1_err, ("dqkv", "db"), k1_t, k1w,
                              pretrain["launches"])
               + kernel_entries("relpos_attention",
                                "xfm_tpu/ops/flash_attention.py", 689, 717,
                                "xfm_tpu_torch/csrc/relpos_attention.cu",
                                k2_err, ("dqkv", "dcr", "dcls"), k2_t, k2w,
                                retrieval["launches"])
               + kernel_entries("flash_attention",
                                "xfm_tpu/ops/flash_attention.py", 71, 334,
                                "xfm_tpu_torch/csrc/flash_attention.cu",
                                k3_err, ("dq", "dk", "dv"), k3_t, k3w,
                                clip["launches"], also_bwd=227)
               + kernel_entries("fused_ln", "xfm_tpu/ops/fused_ln.py", 91,
                                108, "xfm_tpu_torch/csrc/fused_ln.cu",
                                k4_err, ("dx", "dgamma", "dbeta"), k4_t, k4w,
                                fused["launches"])
               + kernel_entries("fused_mlp", "xfm_tpu/ops/fused_mlp.py", 75,
                                84, "xfm_tpu_torch/csrc/fused_mlp.cu",
                                k5_err, ("dh", "dW", "db"), k5_t, k5w,
                                fused["launches"], also_bwd=99)
               + eval_kernel_entries(k2e_err, k2e_t, k2ew, k3g_err, k3g_t,
                                     k3gw, ev["launches"]))
    print(f"chip_smoke: 18 phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
