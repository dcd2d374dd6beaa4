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
     a seeded corpus of 256 images and 512 captions (2 each, 8-40
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
 19. the pretrain task: K1 forward and backward against the plain version
     at its new caller shapes, qkv [192, 197, 2304] (the image-text and
     ImageNet pair passes at the YAML's batch of 96) and [80, 197, 2304]
     (the region stream's 80 images), in bf16 and f32, with the times,
     the bound and SDPA with the bias as a mask; the four streams' losses
     and sampled gradients at full width, depth 2, f32, on the CPU and on
     the card (the region stream again with both fused routes); then
     `run.main` (the entry point of `python3 -m xfm_tpu_torch.run --task
     pretrain_DIY`) on `Pretrain_base_4m.yaml`'s keys over seeded JSONL
     shards of the four streams (48 image-text pairs, 24 region records,
     48 ImageNet images, 96 texts; PNGs of 256-400 px), `--bs 24`, 3
     steps with a checkpoint at step 2 and at the end, `resume: true`:
     each step's seconds, losses (finite, non-zero where the stream's
     flags ask) and launches (K1 12 + 12 for each image-bearing stream,
     36 + 36 a step, nothing else), the peak memory; then `ckpt/3`
     deleted and the command again: the restored state bit-equal to
     `ckpt/2` on disk, its lr the one the first run took at that count,
     one step more; the output directory deleted; then `profile_step
     pretrain_streams` (the step at the YAML's batch sizes on device
     batches: busy time by group, idle share, peak memory under 80 GB,
     K1 36 + 36 a step and each stream's own launches);
 20. VQA at 480 px: K2 forward and backward against the plain version at
     the VQA step's shape, qkv [16, 901, 2304] (window 30 x 30), in bf16
     and f32, the bf16 backward bit-equal over two runs, the times, the
     bound and SDPA with the bias as a mask; `XFMForVQA`'s loss, sampled
     gradients and `rank` (the top 128 of 3,129 answers) at full width,
     depth 2, f32, on the CPU and on the card (K2 2 + 2 in the loss and 2
     in the rank); then `run.main` (the entry point of `python3 -m
     xfm_tpu_torch.run --task vqa`) on `VQA.yaml`'s keys over seeded PNGs
     of 400-640 px (32 train rows of VQA and Visual Genome, 16 test
     questions with answers, a 3,129-answer list), `--bs 16 --epoch 2`,
     `start_eval: 0`, `resume: true`: each step's seconds, loss (finite)
     and launches (K2 12 + 12, nothing else), each eval's (K2 12 a batch
     of 16, nothing else) and its result file (one answer a question);
     `ckpt/1` deleted and the command again (the restored state bit-equal
     to `ckpt/0`, the first loss bit-equal to the first run's); then
     `--evaluate --checkpoint` from the run's own checkpoint and from a
     pretrain-format state dict (the decoder from the fusion encoder),
     each with its accuracies; the directory deleted; then `profile_step`
     `vqa_rank` and `vqa_train` at the YAML's sizes (busy time by group,
     idle share, peak memory under 80 GB, K2 12 a rank and 12 + 12 a
     step);
 21. COCO captioning: K2 forward and backward against the plain version
     at the caption step's shape, qkv [16, 577, 2304], and K1 at the
     domain pretrain's, [64, 197, 2304], in bf16 and f32, the bf16
     backward bit-equal over two runs, the times, the bounds and SDPA
     with the bias as a mask; `XFMForCaptioning`'s loss and sampled
     gradients, greedy and beam-3 decoding (the prompt forced, `min_len`
     5) and SCST's loss and gradients for fixed sequences, at full width,
     depth 2, 384 px, f32, on the CPU and on the card (the sequences
     token for token; K2 2 + 2 in the loss and SCST's pass, 2 a decode);
     then `run.main` for `--task coco_captioning` on `Captioning.yaml`'s
     keys over seeded PNGs (16 train images with 2 captions each, 16 val
     images with 5), `--bs 16 --epoch 2`, `resume: true`: each step's
     seconds, loss (finite) and launches (K2 12 + 12, nothing else), each
     decode batch's (K2 12 forward, beam 3 over `max_length` 20);
     `ckpt/1` deleted and the command again (the restored state bit-equal
     to `ckpt/0`, the first loss bit-equal); `--evaluate --checkpoint`
     from the run's own checkpoint (the same captions); `scst: true` from
     `--load_ckpt_from` that checkpoint (K2 36 + 12 a step, the greedy
     baseline); `Captioning_pretrain.yaml`'s keys over a JSONL of 64
     pairs, 3 steps at its batch of 64, 224 px (K1 12 + 12 a step);
     `--task infer_caption` over 8 PNGs; one caption an image, the
     metrics with SPICE None; the directory deleted; then `profile_step`
     `caption_train`, `caption_beam`, `caption_scst` and
     `caption_pretrain` at the YAMLs' sizes (busy time by group, idle
     share, peak memory under 80 GB, the launches as above);
 22. NLVR2 and RefCOCO grounding: K2 forward and backward against the
     plain version at the NLVR step's shape, qkv [48, 577, 2304] (24
     pairs, one tower pass), and its forward at the GradCAM batch's,
     [8, 577, 2304], in bf16 and f32, the bf16 backward bit-equal over two
     runs, the times, the bounds and SDPA with the bias as a mask;
     `XFMForNLVR`'s loss, logits and sampled gradients, `XFMForGrounding`'s
     boxes, L1, GIoU and sampled gradients, and `itm_gradcam`'s cam at
     fusion layer 1 with the box it ranks first among 6, at full width,
     depth 2, 384 px, f32, on the CPU and on the card (K2 2 + 2 in each
     loss, 2 forward in the logits, the boxes and the cam; the same boxes;
     no parameter left with a `.grad`), and the bf16 cam's distance from
     the f32 one; then `run.main` over seeded PNGs of 400-640 px: `--task
     nlvr` on `NLVR.yaml`'s keys (48 train pairs, 8 val, 8 test), `--bs
     24 --epoch 2`, `resume: true` (K2 12 + 12 a step, 12 an eval batch),
     `ckpt/1` deleted and the command again (the restored state bit-equal,
     the first loss bit-equal), `--evaluate --checkpoint` from it (the
     last epoch's accuracy); `--task refcoco_bbox` on
     `Grounding_bbox.yaml`'s keys with `domain_pretrain_config` naming
     `Grounding_bbox_pretrain.yaml`'s keys over 32 region images: stage 1
     3 steps at its batch (96 regions over 80 image rows at 224 px, K1
     12 + 12 a step), stage 2 2 epochs at `--bs 24` from its weights, each
     of the 12 rel-pos tables [2212, 12] the interpolation of stage 1's
     [732, 12] (K2 12 + 12 a step, 12 an eval batch), `--evaluate
     --checkpoint` from it (the last epoch's accuracy); then
     `tasks.grounding.main_weakly_supervised` over 16 rows with 5
     candidate boxes (K2 12 a GradCAM batch of 8 at fusion layer 8);
     accuracies in [0, 1], peak memory under 80 GB; the directory
     deleted; then `profile_step` `nlvr_train`, `grounding_train` and
     `gradcam` at the YAMLs' sizes (busy time by group, idle share, peak
     memory under 80 GB, the launches as above);
 23. ImageNet, the linear probe, GLUE and classify: K1 forward and
     backward against the plain version at the ImageNet fine-tune's shape,
     qkv [128, 197, 2304], and at the linear probe's, [512, 197, 2304], in
     bf16 and f32, the bf16 forward and backward bit-equal over two runs,
     the times, the bounds and SDPA with the bias as a mask;
     `XFMForClassification`'s fine-tune soft-target loss and sampled
     gradients, the probe's loss and head gradients (the tower taking
     none), one LARS step, GLUE's and STS-B's losses and gradients and the
     fused logits, at full width, depth 2, 224 px and T = 128, f32, on the
     CPU and on the card (K1 2 + 2 in the fine-tune, 2 forward in the
     probe and the fused logits, nothing in GLUE's); then `run.main` over
     seeded PNGs of 64-112 px: `--task imagenet` on `imagenet1k.yaml`'s
     keys (128 train images in 8 class folders, 32 val rows whose labels
     are the initial weights' predictions), 2 epochs of one 128-image step
     (K1 12 + 12 a step, 12 an eval batch), a checkpoint where the top-1
     improved, `--evaluate --checkpoint` from it (1.0); on
     `imagenet1k_lp.yaml`'s keys, 2 epochs of one 512-image step (K1 12 a
     step; the tower bit-equal across each epoch, the head moved); `--task
     glue` on `glue_mrpc.yaml`'s keys over 64 + 16 JSONL pairs, 2 epochs of
     2 steps at its batch of 32 (no K1, K2 or K3), `resume: true`, `ckpt/1`
     deleted and the command again (the restored state bit-equal, the first
     loss bit-equal), `--evaluate --checkpoint` (the last epoch's metrics);
     `--task classify` on 16 + 8 image + text rows at 224 px (the fused
     classifier; K1 12 + 12 a step, 12 an eval batch); accuracies in
     [0, 1], peak memory under 80 GB; the directory deleted; then
     `profile_step` `imagenet_train`, `imagenet_lp` and `glue_train` at
     the YAMLs' sizes (busy time, idle share, peak memory under 80 GB,
     MFU over busy time, the launches as above);
 24. the pretrain task's optional branches: at depth 2, f32, CPU vs card,
     the frozen VQ-KD tokenizer's projections and code ids (an id may
     differ only at a near-tie of its two best distances, within 1e-5;
     the count reported), the image, region and ImageNet streams with
     MIM's cross-entropy over 8,192 codes and region attention in the last
     block (losses, sampled gradients; K1 2 + 2, 1 + 1, 2 + 2), the shared
     rel-pos table through K1, CLIP-ViT's region mode in both forms, one
     VQ-KD training step with the CLIP teacher from injected k-means means
     (losses, the EMA's codebook, gradients), three HF-AdamW steps under
     master weights (bf16 parameters, f32 masters, live == rounded
     master) and the fused route under bf16 parameters (K4 and K5
     launched); `run.main` for `--task pretrain_DIY` on
     `Pretrain_base_4m.yaml`'s keys with the tokenizer, `local_attn_depth:
     3`, `bf16_params` and `bench_redispatch: 2` over a trimmed
     `_pretrain_corpus`, `--bs 24`, 3 steps, `resume: true` (K1 12 + 12 in
     the image-text and ImageNet streams, 9 + 9 in the region stream, no
     other kernel; finite losses; the first step's MIM CE within 0.5 of
     ln 8192 + 1/2; bf16 parameters and f32 masters saved; the resume bit
     for bit; the `### redispatch` line; peak memory under 80 GB); one
     full-width VQ-KD training step at 224 px with the CLIP ViT-B/16
     teacher (f32); then `profile_step` `pretrain_vqkd` and
     `pretrain_bf16` at the YAML's sizes (K1 33 + 33 and 36 + 36 a step,
     peak memory under 80 GB, MFU over busy time);
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


def _device_randn(g, *shape, scale=1.0):
    """Normal draws made on the generator's device (seeded inputs of the
    kernel checks; drawing them on the host took seconds at B = 512)."""
    return torch.randn(*shape, generator=g, device=g.device) * scale


def make_k1_inputs(B, N, H, dtype, seed, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    C = H * 64
    qkv = _device_randn(g, B, N, 3 * C)
    bias = _device_randn(g, 1, H, N, N, scale=0.5)
    dout = _device_randn(g, B, N, C)
    return qkv.to(dtype), bias, dout.to(dtype)


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
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = _device_randn(g, B, N, 3 * H * 64)
    table = _device_randn(g, (2 * wh - 1) * (2 * ww - 1) + 3, H, scale=0.5)
    dout = _device_randn(g, B, N, H * 64)
    cr, cls3 = compact_rel_pos(table, wh, ww)
    cr = cr.to(dtype).reshape(H, ww, (2 * wh - 1) * ww)
    return qkv.to(dtype), cr, cls3.to(dtype).float(), dout.to(dtype)


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

    g = torch.Generator(device=device).manual_seed(seed)
    q = _device_randn(g, B, Nq, H, 64)
    k, v = (_device_randn(g, B, Nk, H, 64) for _ in range(2))
    dout = _device_randn(g, B, Nq, H, 64)
    bias = None
    if bias_kind in ("relpos", "relpos_bf16"):
        bias = _device_randn(g, 1, H, Nq, Nk, scale=0.5)
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

    g = torch.Generator(device="cuda").manual_seed(seed)
    proj = _device_randn(g, U * gs, T, H * 64).to(dtype)
    q = proj.view(U, gs * T, H, 64)
    assert q.data_ptr() == proj.data_ptr()
    k, v = (_device_randn(g, U, Nk, H, 64).to(dtype) for _ in range(2))
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


def full_eval(n_img=256, per_image=2, k_test=256, seed=0) -> dict:
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


# --- phase 19: the pretrain task --------------------------------------------

def pretrain_slice_parity() -> None:
    """f32, full width, depth 2: each of the four streams' losses and
    sampled gradients (`XFMForPretrain.loss` under the YAML's flags at step
    0, fixed hard negatives, dropout off) on the CPU and on the card, from
    the same weights and batches; the region stream once more with both
    fused routes. On the card K1 runs depth + depth times for each
    image-bearing stream and never for the text stream; K2 and K3 never;
    K4 and K5 only on the fused run."""
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.models import XFMForPretrain
    from xfm_tpu_torch.models.task_models import LOSS_KEYS
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks.pretrain import stream_flags

    yaml_cfg = configs.pretrain_yaml()
    sizes = dict(configs.stream_batch_sizes(yaml_cfg), image=4, imagenet=4,
                 regions=4, max_images=6, text=4)
    sample = {
        "vision_encoder.blocks.0.attn.qkv.weight": ("image", "region",
                                                    "imagenet"),
        "vision_encoder.blocks.1.attn.relative_position_bias_table":
            ("image", "region", "imagenet"),
        "vision_encoder.patch_embed.proj.weight": ("image", "region",
                                                   "imagenet"),
        "text_encoder.roberta.encoder.layer.0.attention.self.query.weight":
            ("image", "region", "text"),
        "text_encoder.lm_head.dense.weight": ("text",),
        "fusion_encoder.roberta.encoder.layer.1.crossattention.self."
        "key.weight": ("image", "region"),
        "itm_head.0.weight": ("image", "region"),
        "bbox_head.3.weight": ("region",), "temp": ("image", "region")}
    for fused in (False, True):
        cfg = configs.xfm_base_pretrain_config(
            layers=2, dtype=torch.float32, fused_ln=fused, fused_mlp=fused)
        nb = configs.make_stream_batches(sizes, cfg.vision.image_res,
                                         cfg.text.vocab_size, seed=1)
        cpu = build_model(XFMForPretrain, cfg, "cpu", seed=3)
        gpu = build_model(XFMForPretrain, cfg, "cpu", seed=3).to("cuda")
        for name in (("region",) if fused else sorted(nb)):
            flags = stream_flags(name, 0, yaml_cfg)
            results = {}
            for tag, model, dev in (("cpu", cpu, "cpu"),
                                    ("cuda", gpu, "cuda")):
                model.zero_grad(set_to_none=True)
                batch = configs.batch_to_torch(nb[name], dev)
                neg = (torch.tensor([1, 2, 3, 0], device=dev),
                       torch.tensor([2, 3, 0, 1], device=dev))
                kernels.reset_launch_counts()
                out = model.loss(**batch, **flags, hard_negatives=neg)
                sum(out[k] for k in LOSS_KEYS).backward()
                results[tag] = ({k: v.item() for k, v in out.items()},
                                dict(model.named_parameters()),
                                dict(kernels.LAUNCHES))
            (lc, pc, _), (lg, pg, launches) = results["cpu"], results["cuda"]
            tag = f"{name}{' fused' if fused else ''}"
            k1 = 0 if name == "text" else 2
            print(f"  pretrain slice {tag} launches {json.dumps(launches)}")
            if (launches["packed_attention_fwd"], launches[
                    "packed_attention_bwd"]) != (k1, k1) or any(
                    launches[k] for k in launches
                    if k.startswith(("relpos", "flash"))):
                raise AssertionError(f"pretrain slice {tag}: launches")
            if fused != bool(launches["fused_ln_fwd"]
                             and launches["fused_mlp_fwd"]):
                raise AssertionError(f"pretrain slice {tag}: K4/K5 launches")
            for k in LOSS_KEYS:
                ok = math.isclose(lc[k], lg[k], rel_tol=SLICE_LOSS_RTOL,
                                  abs_tol=1e-7)
                print(f"  pretrain slice {tag} {k}: cpu={lc[k]:.6f} "
                      f"cuda={lg[k]:.6f} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"pretrain slice {tag}: {k}")
            for n, used_by in sample.items():
                if name not in used_by:
                    continue
                a, b = pc[n].grad.float(), pg[n].grad.float().cpu()
                err = (a - b).abs().max().item()
                tol = SLICE_GRAD_RTOL * a.abs().max().item()
                print(f"  pretrain slice {tag} grad {n}: max_abs_err="
                      f"{err:.3e} tol={tol:.3e}")
                if not err <= tol:
                    raise AssertionError(f"pretrain slice {tag}: grad {n}")
        del cpu, gpu
        torch.cuda.empty_cache()


def _pretrain_corpus(root, seed=0, n_pairs=48, n_regions=24, n_texts=96):
    """Seeded JSONL shards of the four streams under `root`, images as
    base64 PNGs of 256-400 px (a colour and a wave under noise), captions
    from a small vocabulary, texts of 40-150 words → {stream: path}."""
    import base64
    import io

    from PIL import Image

    r = np.random.RandomState(seed)
    words = ["a", "photo", "of", "the", "red", "blue", "dog", "cat", "on",
             "left", "grass", "with", "sky", "man", "riding", "street",
             "right", "near", "small", "big", "tree", "car", "house"]

    def png():
        h, w = r.randint(256, 401, 2)
        yy, xx = np.mgrid[0:h, 0:w]
        wave = np.sin(xx * r.uniform(0.01, 0.1) + yy * r.uniform(0.01, 0.1))
        arr = (r.randint(0, 256, 3) + 60 * wave[..., None]
               * r.uniform(-1, 1, 3) + r.normal(0, 12, (h, w, 3)))
        buf = io.BytesIO()
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(buf,
                                                                   "PNG")
        return base64.b64encode(buf.getvalue()).decode(), w, h

    def cap(k):
        return " ".join(r.choice(words, k))

    rows = {"pairs": [], "regions": [], "imagenet": [], "texts": []}
    for _ in range(n_pairs):
        rows["pairs"].append({"binary": png()[0], "desc": cap(8)})
        rows["imagenet"].append({"binary": png()[0]})
    for _ in range(n_regions):
        b64, w, h = png()
        elems = []
        for _ in range(6):
            bw, bh = r.randint(16, w // 2), r.randint(16, h // 2)
            elems.append({"bb": [int(r.randint(0, w - bw)),
                                 int(r.randint(0, h - bh)), int(bw),
                                 int(bh)], "caption": cap(5)})
        rows["regions"].append({"binary": b64, "elems": elems})
    for _ in range(n_texts):
        rows["texts"].append({"desc": cap(r.randint(40, 151))})
    paths = {}
    for kind, items in rows.items():
        paths[kind] = os.path.join(root, f"{kind}.jsonl")
        with open(paths[kind], "w") as f:
            for item in items:
                f.write(json.dumps(item) + "\n")
    return paths


def pretrain_task_runs(root, bs=24, steps=3, ckpt_every=2,
                       device="cuda") -> dict:
    """`python3 -m xfm_tpu_torch.run --task pretrain_DIY` (`run.main`) on
    `Pretrain_base_4m.yaml`'s keys over `_pretrain_corpus`, `--bs`, with
    `max_steps` `steps` and `ckpt_frequent_step` `ckpt_every`, `resume:
    true`; then the newest checkpoint deleted and the command again. Each
    step's seconds, launches and losses are recorded, and the restored
    state against the file it came from."""
    import yaml

    from xfm_tpu_torch import configs, run
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks import pretrain

    files = _pretrain_corpus(root)
    cfg = {k: v for k, v in configs.pretrain_yaml().items()
           if not k.startswith("_")}
    cfg.update(train_file=[files["pairs"]],
               train_file_regions=[files["regions"]],
               train_file_imagenet=[files["imagenet"]],
               train_file_text=[files["texts"]], max_steps=steps,
               ckpt_frequent_step=ckpt_every, print_freq=1, resume=True)
    cfg_path = os.path.join(root, "pt.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = os.path.join(root, "out")
    argv = ["--task", "pretrain_DIY", "--config", cfg_path, "--output_dir",
            out, "--bs", str(bs), "--device", device]
    real_step, real_resume = pretrain.make_stream_step, \
        pretrain.restore_latest
    rec = {}

    def make_stream_step(loss_fn):
        step_fn = real_step(loss_fn)

        def step(state, batches, gens):
            opt = state.optimizer
            lr = opt.lr(opt.count)
            _sync()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batches, gens)
            vals = {k: v.item() for k, v in metrics.items()}
            rec["steps"].append(dict(s=time.perf_counter() - t0,
                                     streams=sorted(batches),
                                     launches=dict(kernels.LAUNCHES),
                                     losses=vals, lr=lr))
            return state, metrics

        return step

    def restore_latest(ctx, state):
        state, step = real_resume(ctx, state)
        if step is not None:
            saved = torch.load(os.path.join(out, "ckpt", str(step),
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
            rec["restored"] = dict(step=step, bit_equal=bool(equal),
                                   count=opt.count, lr=opt.lr(opt.count))
            del saved
        return state, step

    runs = {}
    pretrain.make_stream_step = make_stream_step
    pretrain.restore_latest = restore_latest
    try:
        for name in ("full", "resumed"):
            if name == "resumed":
                runs["layout"] = sorted(os.listdir(os.path.join(out,
                                                                "ckpt")))
                shutil.rmtree(os.path.join(out, "ckpt", str(steps)))
            rec = dict(steps=[])
            _sync()
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rec["result"] = run.main(argv)
            rec["s"] = time.perf_counter() - t0
            rec["max_memory_allocated"] = (torch.cuda.max_memory_allocated()
                                           if device == "cuda" else None)
            with open(os.path.join(out, "log.txt")) as f:
                rec["log"] = [json.loads(x) for x in f.read().splitlines()]
            runs[name] = rec
    finally:
        pretrain.make_stream_step = real_step
        pretrain.restore_latest = real_resume
    runs["checkpoint_bytes"] = os.path.getsize(os.path.join(
        out, "ckpt", str(ckpt_every), "state.pt"))
    with open(os.path.join(out, "config.yaml")) as f:
        runs["batch_sizes"] = configs.stream_batch_sizes(yaml.safe_load(f))
    return runs


def full_pretrain_task(bs=24, steps=3, ckpt_every=2) -> dict:
    """Phase 19's task runs at full width on the card, checked: every
    step's losses finite and non-zero where the stream's flags ask; K1
    depth + depth launches for each image-bearing stream (three: 36 + 36
    a step) and no other kernel; `ckpt/` holding the saved steps; the
    resumed state bit-equal to its file, taking the lr the first run took
    at that count, going on at the step after it. The output directory is
    deleted at the end."""
    import tempfile

    from xfm_tpu_torch import configs

    root = tempfile.mkdtemp(prefix="xfm_pt_")
    try:
        runs = pretrain_task_runs(root, bs=bs, steps=steps,
                                  ckpt_every=ckpt_every)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    depth = configs.xfm_base_pretrain_config().vision.depth
    on = {"image": {"itc", "itm", "mlm", "mim"},
          "region": {"itc", "itm", "mlm", "bbox", "giou"},
          "imagenet": {"mim"}, "text": {"mlm"}}
    for name in ("full", "resumed"):
        r = runs[name]
        print(f"  {name}: {r['s']:.1f} s, peak memory "
              f"{r['max_memory_allocated']} B, step s "
              f"{[round(x['s'], 4) for x in r['steps']]}")
        for i, st in enumerate(r["steps"]):
            print(f"    step {i}: {json.dumps(st['launches'])} "
                  f"{json.dumps(st['losses'])}")
            want = {k: 0 for k in st["launches"]}
            n_img = sum(1 for n in st["streams"] if n != "text")
            want.update(packed_attention_fwd=depth * n_img,
                        packed_attention_bwd=depth * n_img)
            if st["launches"] != want or n_img != 3:
                raise AssertionError(f"{name} step {i}: launches "
                                     f"{st['launches']}, expected {want}")
            for stream, losses in on.items():
                for k in ("itc", "itm", "mlm", "mim", "bbox", "giou"):
                    v = st["losses"][f"{stream}_loss_{k}"]
                    if not math.isfinite(v) or (v != 0.0) != (k in losses):
                        raise AssertionError(f"{name} step {i}: "
                                             f"{stream}_loss_{k} = {v}")
        print(f"    result {json.dumps(r['result'])}")
    full, resumed = runs["full"], runs["resumed"]
    want_layout = sorted({str(s) for s in range(ckpt_every, steps + 1,
                                                 ckpt_every)}
                         | {str(steps)})
    restored = resumed.get("restored", {})
    last_saved = int(want_layout[-2]) if len(want_layout) > 1 else 0
    lr_then = full["steps"][last_saved]["lr"]
    print(f"  checkpoints {runs['layout']} (expected {want_layout}), "
          f"{runs['checkpoint_bytes']} B each; resume "
          f"{json.dumps(restored)}, the first run's lr at that count "
          f"{lr_then}")
    if (runs["layout"] != want_layout or len(full["steps"]) != steps
            or not restored.get("bit_equal")
            or restored["step"] != last_saved
            or not restored["lr"] == lr_then
            == resumed["steps"][0]["lr"]
            or len(resumed["steps"]) != steps - last_saved):
        raise AssertionError("the pretrain run's checkpoints or its resume")
    return dict(step_s=[x["s"] for x in full["steps"]],
                resumed_step_s=[x["s"] for x in resumed["steps"]],
                run_s=[full["s"], resumed["s"]],
                max_memory_allocated=full["max_memory_allocated"],
                checkpoint_bytes=runs["checkpoint_bytes"],
                batch_sizes=runs["batch_sizes"],
                throughput={k: full["result"].get(k) for k in (
                    "samples_per_sec", "device_samples_per_sec")},
                launches_per_step=full["steps"][0]["launches"])


def text_attention_times(B=256, T=128, H=12, rate=0.1) -> dict:
    """The text stream's plain self-attention (`attention_reference`, which
    computes in f32) at q/k/v [B, T, H, 64] bf16 with a padding mask:
    forward and forward + backward, at dropout 0 and `rate` (the YAML's,
    live in the task), and SDPA with the mask for comparison (ms a
    call)."""
    import torch.nn.functional as F

    from xfm_tpu_torch.ops.attention import attention_reference, mask_to_bias
    from xfm_tpu_torch.ops.dropout import dropout_generator

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, dout = (torch.randn(B, T, H, 64, generator=g, device="cuda")
                     .to(torch.bfloat16) for _ in range(4))
    lens = torch.randint(4, T + 1, (B,), generator=g, device="cuda")
    bias = mask_to_bias((torch.arange(T, device="cuda")[None]
                         < lens[:, None]).long())
    t = {}
    for tag, r in (("", 0.0), ("_dropout", rate)):
        with torch.no_grad(), dropout_generator(g):
            t[f"plain{tag}_fwd_ms"] = cuda_ms(lambda: attention_reference(
                q, k, v, bias, 0.125, r), 10)
        qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))

        def fwd_bwd():
            with dropout_generator(g):
                attention_reference(qg, kg, vg, bias, 0.125, r).backward(
                    dout)

        t[f"plain{tag}_fwd_bwd_ms"] = cuda_ms(fwd_bwd, 10)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    mask = bias.to(torch.bfloat16)
    dt = dout.transpose(1, 2).contiguous()
    t["library_fwd_bwd_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=0.125).backward(dt), 10)
    return t


def pretrain_kernel_entries(err192, t192, w192, err80, t80, w80,
                            launches) -> list:
    """The `kernels` entries of K1 at the pretrain task's caller shapes:
    the image-text and ImageNet pair passes at the YAML's batch (qkv
    [192, 197, 2304]) and the region stream's 80 images, with their
    launches a step from `profile_step pretrain_streams`."""
    out = []
    for tag, err, t, w, streams in (
            ("b192", err192, t192, w192, ("image", "imagenet")),
            ("b80", err80, t80, w80, ("region",))):
        n = {k: sum(launches[s][k] for s in streams)
             for k in launches[streams[0]]}
        for d, bwd_keys in (("fwd", ("out",)), ("bwd", ("dqkv", "db"))):
            out.append(dict(
                name=f"packed_attention_{d}_pretrain_{tag}", route="cuda",
                source="xfm_tpu_torch/csrc/packed_attention.cu",
                replaces="xfm_tpu/ops/flash_attention.py:"
                         f"{983 if d == 'fwd' else 1007}",
                launches=n[f"packed_attention_{d}"],
                max_abs_err=max(err[k][0] for k in bwd_keys),
                ms=t[f"{d}_ms"], plain_ms=t[f"plain_{d}_ms"],
                bound_ms=w[d]["bound_ms"], bound_by=w[d]["bound_by"],
                library_ms=t[f"library_{d}_ms"]))
    return out


# --- phase 20: VQA -----------------------------------------------------------

# phase-20 tolerance of the rank's probabilities, CPU vs card (f32)
RANK_PROB_ATOL = 1e-4
VQA_WINDOW = (30, 30)  # 480 px / 16


def vqa_slice_parity(B=2, k=128, n_answers=3129) -> None:
    """f32, full width, depth 2 (2 BEiT, 2 text, 2 fusion and 2 decoder
    layers), 480 px, the full vocabulary: `XFMForVQA.loss` and sampled
    gradients and `rank` (k of a seeded `n_answers` list) on the CPU and on
    the card from the same weights and batch: losses within
    SLICE_LOSS_RTOL, gradients within SLICE_GRAD_RTOL of their max, the
    top-k ids equal and their probabilities within RANK_PROB_ATOL. On the
    card K2 runs 2 + 2 times in the loss and 2 in the rank, nothing else of
    K1-K5."""
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.models import XFMForVQA
    from xfm_tpu_torch.ops import kernels

    cfg = configs.vqa_yaml(layers=2, compute_dtype="float32")
    cpu = build_model(XFMForVQA.from_yaml, cfg, "cpu", seed=3)
    gpu = build_model(XFMForVQA.from_yaml, cfg, "cpu", seed=3).to("cuda")
    vocab = cpu.config.text.vocab_size
    nb = configs.make_vqa_batch(B, 40, 4, 10, 480, vocab, seed=1)
    ans = configs.make_answer_list(n_answers, 10, vocab, seed=2)
    sample = ["vision_encoder.blocks.0.attn.qkv.weight",
              "vision_encoder.blocks.1.attn.relative_position_bias_table",
              "vision_encoder.patch_embed.proj.weight",
              "text_encoder.roberta.encoder.layer.0.attention.self.query."
              "weight",
              "fusion_encoder.roberta.encoder.layer.1.crossattention.self."
              "key.weight",
              "text_decoder.roberta.encoder.layer.0.attention.self.query."
              "weight",
              "text_decoder.roberta.encoder.layer.1.crossattention.self."
              "value.weight",
              "text_decoder.lm_head.dense.weight",
              "text_decoder.roberta.embeddings.word_embeddings.weight"]
    res = {}
    for tag, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        batch = configs.batch_to_torch(nb, dev)
        kernels.reset_launch_counts()
        loss = model.loss(**batch)
        loss.backward()
        train_launches = dict(kernels.LAUNCHES)
        kernels.reset_launch_counts()
        ids, probs = model.rank(batch["images"], batch["q_ids"],
                                batch["q_atts"],
                                *(torch.from_numpy(a).long().to(dev)
                                  for a in ans), k)
        res[tag] = (loss.item(), dict(model.named_parameters()), ids.cpu(),
                    probs.cpu(), train_launches, dict(kernels.LAUNCHES))
    (lc, pc, ic, qc, _, _), (lg, pg, ig, qg, tl, rl) = res["cpu"], res["cuda"]
    print(f"  vqa slice launches: loss {json.dumps(tl)}, rank "
          f"{json.dumps(rl)}")
    want = {n: 0 for n in tl}
    want.update(relpos_attention_fwd=2, relpos_attention_bwd=2)
    if tl != want or rl != dict(want, relpos_attention_bwd=0):
        raise AssertionError("vqa slice: launches")
    ok = math.isclose(lc, lg, rel_tol=SLICE_LOSS_RTOL)
    print(f"  vqa slice loss: cpu={lc:.6f} cuda={lg:.6f} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("vqa slice: loss")
    for n in sample:
        a, b = pc[n].grad.float(), pg[n].grad.float().cpu()
        err = (a - b).abs().max().item()
        tol = SLICE_GRAD_RTOL * a.abs().max().item()
        print(f"  vqa slice grad {n}: max_abs_err={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"vqa slice: grad {n}")
    perr = (qc - qg).abs().max().item()
    same = torch.equal(ic, ig)
    print(f"  vqa slice rank (k {k} of {n_answers}): ids equal {same}, "
          f"probabilities max_abs_err={perr:.3e} tol={RANK_PROB_ATOL:.0e}; "
          f"top-1 {ig[:, 0].tolist()} at {qg[:, 0].tolist()}")
    if not (same and perr <= RANK_PROB_ATOL):
        raise AssertionError("vqa slice: rank_answer")
    del cpu, gpu
    torch.cuda.empty_cache()


def _vqa_corpus(root, n_train=32, n_test=16, n_answers=3129, seed=0):
    """Seeded PNGs of 400-640 px a side under root/coco and root/vg; train
    rows of both datasets (VQA rows with 10 human answers from a few, VG
    rows one answer), test rows with question ids (half a list of human
    answers, half one answer); an answer list of `n_answers`: the answers
    used, then two-word answers → {train, test, answers, vqa_root,
    vg_root}."""
    from PIL import Image

    r = np.random.RandomState(seed)
    words = ["what", "is", "the", "man", "dog", "cat", "holding", "color",
             "of", "how", "many", "are", "there", "on", "left", "right",
             "sky", "car", "street", "wearing"]
    vocab = ["yes", "no", "red", "blue", "two", "three", "white", "black",
             "green", "frisbee", "pizza", "left", "right", "tennis", "dog",
             "cat", "grass", "water", "snow", "table", "umbrella", "kite",
             "bus", "train", "horse", "bike", "phone", "hat", "shirt",
             "wood"]
    answers = vocab[:12]
    pairs = [f"{a} {b}" for a in vocab for b in vocab if a != b]
    answer_list = answers + [p for p in pairs][: n_answers - len(answers)]
    paths = {"vqa_root": os.path.join(root, "coco"),
             "vg_root": os.path.join(root, "vg")}
    for d in ("vqa_root", "vg_root"):
        os.makedirs(paths[d], exist_ok=True)
    train, test = [], []
    for i in range(n_train + n_test):
        ds = "vg" if (i % 3 == 2 and i < n_train) else "vqa"
        h, w = r.randint(400, 641, 2)
        yy, xx = np.mgrid[0:h, 0:w]
        wave = np.sin(xx * r.uniform(0.01, 0.1) + yy * r.uniform(0.01, 0.1))
        arr = (r.randint(0, 256, 3) + 60 * wave[..., None]
               * r.uniform(-1, 1, 3) + r.normal(0, 12, (h, w, 3)))
        name = f"img{i}.png"
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
            os.path.join(paths["vg_root" if ds == "vg" else "vqa_root"],
                         name))
        q = " ".join(r.choice(words, 4 + i % 6)) + "?"
        if i < n_train:
            ans = (str(r.choice(answers)) if ds == "vg" else
                   [str(a) for a in r.choice(answers[:2 + i % 6], 10)])
            train.append({"image": name, "question": q, "answer": ans,
                          "dataset": ds})
        else:
            ans = ([str(a) for a in r.choice(answers, 10)] if i % 2
                   else str(r.choice(answers)))
            test.append({"image": name, "question": q, "answer": ans,
                         "question_id": 10_000 + i, "dataset": "vqa"})
    for name, obj in (("train", train), ("test", test),
                      ("answers", answer_list)):
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    return paths


def vqa_task_runs(root, bs=16, epochs=2, seed=0) -> dict:
    """Phase 20's runs of `run.main` for `--task vqa` in `root` on
    `VQA.yaml`'s keys over `_vqa_corpus` (`start_eval: 0`, `resume:
    true`): the fine-tune; after deleting ckpt/<last>, the resumed one;
    `--evaluate --checkpoint` from the run's own checkpoint; and from a
    pretrain-format state dict (its params without `text_decoder.*`).
    Each eval, epoch and step is recorded: seconds, launches, losses, the
    lr each step took, the restored state against its file."""
    import yaml

    from xfm_tpu_torch import configs, run
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks import vqa

    files = _vqa_corpus(root)
    cfg = dict(configs.VQA, train_file=[files["train"]],
               test_file=[files["test"]], answer_list=files["answers"],
               vqa_root=files["vqa_root"], vg_root=files["vg_root"],
               start_eval=0, resume=True)
    cfg_path = os.path.join(root, "vqa.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = os.path.join(root, "out")
    base = ["--task", "vqa", "--config", cfg_path, "--seed", str(seed)]
    real = (vqa.evaluate, vqa.train_epoch, vqa.maybe_resume_epochs)
    rec = {}

    def evaluate(model, data, k, out_dir, tag=""):
        _sync()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        path = real[0](model, data, k, out_dir, tag)
        _sync()
        with open(path) as f:
            rows = json.load(f)
        rec["evals"].append(dict(s=time.perf_counter() - t0, tag=tag,
                                 launches=dict(kernels.LAUNCHES),
                                 rows=len(rows),
                                 questions=len({r["question_id"]
                                                for r in rows})))
        return path

    def train_epoch(ctx, state, step_fn, loader, generator, epoch, sched,
                    **kw):
        steps = []

        def step(state, batch, gen):
            lr = state.optimizer.lr(state.optimizer.count)
            _sync()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch, gen)
            loss = metrics["loss"].item()
            steps.append(dict(s=time.perf_counter() - t0, loss=loss, lr=lr,
                              launches=dict(kernels.LAUNCHES)))
            return state, metrics

        _sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, stats = real[1](ctx, state, step, loader, generator, epoch,
                               sched, **kw)
        _sync()
        rec["epochs"].append(dict(
            epoch=epoch, s=time.perf_counter() - t0, steps=steps,
            max_memory_allocated=torch.cuda.max_memory_allocated()))
        return state, stats

    def maybe_resume_epochs(ctx, state):
        state, start = real[2](ctx, state)
        if start:
            saved = torch.load(os.path.join(out, "ckpt", str(start - 1),
                                            "state.pt"),
                               map_location="cuda", weights_only=True)
            opt = state.optimizer
            equal = (state.step == saved["step"]
                     and opt.count == saved["optimizer"]["count"])
            for name, p in zip(opt.names, opt.params):
                equal &= torch.equal(p, saved["params"][name])
            for key in ("mu", "nu"):
                for name, t in zip(opt.names, getattr(opt, key)):
                    equal &= torch.equal(t, saved["optimizer"][key][name])
            rec["restored"] = dict(start=start, bit_equal=bool(equal),
                                   count=opt.count)
            del saved
        return state, start

    runs = {}
    vqa.evaluate, vqa.train_epoch, vqa.maybe_resume_epochs = (
        evaluate, train_epoch, maybe_resume_epochs)
    last = os.path.join(out, "ckpt", str(epochs - 1), "state.pt")
    pretrain_sd = os.path.join(root, "pretrain_format.pth")
    try:
        for name, argv in (
                ("full", ["--output_dir", out, "--bs", str(bs), "--epoch",
                          str(epochs)]),
                ("resumed", ["--output_dir", out, "--bs", str(bs),
                             "--epoch", str(epochs)]),
                ("evaluate_vqa", ["--output_dir", out + "_ev1",
                                  "--evaluate", "--checkpoint", last]),
                ("evaluate_pretrain", ["--output_dir", out + "_ev2",
                                       "--evaluate", "--checkpoint",
                                       pretrain_sd])):
            if name == "resumed":
                runs["layout"] = sorted(os.listdir(os.path.join(out,
                                                                "ckpt")))
                runs["checkpoint_bytes"] = os.path.getsize(last)
                shutil.rmtree(os.path.dirname(last))
            if name == "evaluate_pretrain":
                params = torch.load(last, map_location="cpu",
                                    weights_only=True)["params"]
                torch.save({"model": {k: v for k, v in params.items()
                                      if not k.startswith("text_decoder.")}},
                           pretrain_sd)
                del params
            rec = dict(evals=[], epochs=[])
            t0 = time.perf_counter()
            rec["result"] = run.main(base + argv)
            rec["s"] = time.perf_counter() - t0
            runs[name] = rec
    finally:
        vqa.evaluate, vqa.train_epoch, vqa.maybe_resume_epochs = real
    runs["n_test"] = len(json.load(open(files["test"])))
    runs["steps_per_epoch"] = len(json.load(open(files["train"]))) // bs
    return runs


def full_vqa_task(epochs=2) -> dict:
    """Phase 20's task runs at full width on the card, checked: finite
    losses; K2 12 + 12 a step and 12 an eval batch, nothing else; both
    checkpoints written; the resume bit-equal to its file and its first
    loss bit-equal to the first run's; every result file one answer a test
    question; the accuracies reported. The directory is deleted at the
    end."""
    import tempfile

    root = tempfile.mkdtemp(prefix="xfm_vqa_")
    try:
        runs = vqa_task_runs(root, epochs=epochs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    depth, n_test, spe = 12, runs["n_test"], runs["steps_per_epoch"]
    names = list(runs["full"]["evals"][0]["launches"])
    want_step = dict({n: 0 for n in names}, relpos_attention_fwd=depth,
                     relpos_attention_bwd=depth)
    want_eval = dict({n: 0 for n in names},
                     relpos_attention_fwd=depth * -(-n_test // 16))
    for name in ("full", "resumed", "evaluate_vqa", "evaluate_pretrain"):
        r = runs[name]
        print(f"  {name}: {r['s']:.1f} s, result {json.dumps(r['result'])}")
        for e in r["evals"]:
            print(f"    eval {e['tag'] or 'final'}: {e['s']:.2f} s, "
                  f"{e['rows']} answers, launches {json.dumps(e['launches'])}")
            if (e["launches"] != want_eval or e["rows"] != n_test
                    or e["questions"] != n_test):
                raise AssertionError(f"{name} eval: launches or rows")
        for e in r["epochs"]:
            print(f"    epoch {e['epoch']}: {e['s']:.2f} s, peak memory "
                  f"{e['max_memory_allocated']} B, step s "
                  f"{[round(x['s'], 4) for x in e['steps']]}, losses "
                  f"{[x['loss'] for x in e['steps']]}")
            if len(e["steps"]) != spe or any(
                    x["launches"] != want_step or not math.isfinite(
                        x["loss"]) for x in e["steps"]):
                raise AssertionError(f"{name} epoch {e['epoch']}: steps, "
                                     f"launches or losses")
        if not {"vqa_acc_exact", "vqa_acc_official"} <= set(r["result"]):
            raise AssertionError(f"{name}: no accuracies")
    full, resumed = runs["full"], runs["resumed"]
    restored = resumed.get("restored", {})
    print(f"  checkpoints {runs['layout']}, {runs['checkpoint_bytes']} B "
          f"each; resume {json.dumps(restored)}")
    a = [x["loss"] for x in full["epochs"][-1]["steps"]]
    b = [x["loss"] for x in resumed["epochs"][0]["steps"]]
    print(f"  last epoch's losses, first run {a}, resumed {b}")
    if (runs["layout"] != [str(i) for i in range(epochs)]
            or len(full["epochs"]) != epochs
            or [e["tag"] for e in full["evals"]]
            != [f"epoch{i}" for i in range(epochs - 1)] + [""]
            or not restored.get("bit_equal")
            or restored["start"] != epochs - 1
            or [e["epoch"] for e in resumed["epochs"]] != [epochs - 1]
            or a[0] != b[0]
            or full["epochs"][-1]["steps"][0]["lr"]
            != resumed["epochs"][0]["steps"][0]["lr"]):
        raise AssertionError("the VQA run's checkpoints, evals or resume")
    return dict(step_s=[x["s"] for e in full["epochs"] for x in e["steps"]],
                epoch_s=[e["s"] for e in full["epochs"]],
                eval_s=[e["s"] for n in ("full", "evaluate_vqa",
                                         "evaluate_pretrain")
                        for e in runs[n]["evals"]],
                run_s={n: runs[n]["s"] for n in ("full", "resumed",
                                                  "evaluate_vqa",
                                                  "evaluate_pretrain")},
                max_memory_allocated=max(e["max_memory_allocated"]
                                         for e in full["epochs"]),
                checkpoint_bytes=runs["checkpoint_bytes"],
                accuracy={n: runs[n]["result"] for n in (
                    "full", "evaluate_vqa", "evaluate_pretrain")})


def vqa_phase():
    """Phase 20 → (K2's errors, times and bound at qkv [16, 901, 2304],
    `profile_step.profile_vqa`'s units)."""
    from xfm_tpu_torch import profile_step

    bf16, f32 = torch.bfloat16, torch.float32
    k2v_shape = dict(B=16, window=VQA_WINDOW, H=12)
    k2vw = k2_work(B=16, N=901, H=12, D=64, window=VQA_WINDOW, dtype=bf16)
    k2v_err = k2_parity(**k2v_shape, dtype=bf16, seed=50)
    k2_parity(**k2v_shape, dtype=f32, seed=51)
    k2_deterministic(**k2v_shape, dtype=bf16, seed=52)
    k2v_t = k2_times(**k2v_shape, dtype=bf16)
    print("  K2 B=16 N=901 times (ms): " + json.dumps(k2v_t))
    print("  K2 B=16 N=901 bound (k2_work): " + json.dumps(k2vw))
    vqa_slice_parity()
    vt = full_vqa_task()
    print("  vqa task: " + json.dumps(vt))
    vprof = profile_step.profile_vqa(os.path.join(
        REPO, "build", "xfm_tpu_torch", "profile_vqa.json"))
    for unit, r in vprof.items():
        top = r.pop("top")
        print(f"  {unit} profile: " + json.dumps(r))
        for name, ms, n in top[:10]:
            print(f"    {ms:9.3f} ms/call {n:6d} calls/call  {name}")
        want = dict({k: 0 for k in r["launches"]}, relpos_attention_fwd=12,
                    relpos_attention_bwd=12 if unit == "vqa_train" else 0)
        if (r["launches"] != want or r["max_memory_allocated"] >= 80e9
                or not math.isfinite(r.get("loss", 0.0))):
            raise AssertionError(f"{unit}: launches, peak memory or loss")
    return k2v_err, k2v_t, k2vw, vprof


def vqa_kernel_entries(err, times, work, launches) -> list:
    """K2's `kernels` entries at the VQA step's shape (qkv [16, 901, 2304]
    bf16), their launches a step from `profile_step vqa_train`."""
    return [dict(e, name=e["name"] + "_vqa_b16_480px")
            for e in kernel_entries(
                "relpos_attention", "xfm_tpu/ops/flash_attention.py", 689,
                717, "xfm_tpu_torch/csrc/relpos_attention.cu", err,
                ("dqkv", "dcr", "dcls"), times, work, launches)]


# --- phase 21: COCO captioning ----------------------------------------------

# phase-21 tolerance of the greedy log-probabilities, CPU vs card (f32)
CAPTION_LOGP_ATOL = 1e-4
CAPTION_PROMPT = (10, 11, 12, 13)


def _grads_close(tag: str, cpu: dict, gpu: dict) -> None:
    """Each sampled gradient of the card ({name: tensor}) within
    SLICE_GRAD_RTOL of the CPU's largest value, or raise."""
    for n in cpu:
        a, b = cpu[n].float(), gpu[n].float().cpu()
        err = (a - b).abs().max().item()
        tol = SLICE_GRAD_RTOL * a.abs().max().item()
        print(f"  {tag} grad {n}: max_abs_err={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"{tag}: grad {n}")


def caption_slice_parity(B=2, n=3) -> None:
    """f32, full width, depth 2 (2 BEiT blocks and 2 decoder layers), 384
    px, the full vocabulary: `XFMForCaptioning.loss` and sampled gradients
    (prompt_length 4), `generate` (greedy, the prompt forced, `min_len` 5,
    `max_len` 20) and `beam_generate` (K = 3, the same), and SCST's loss
    and sampled gradients for fixed sequences (n a image) and advantages,
    on the CPU and on the card from the same weights and inputs: losses
    within SLICE_LOSS_RTOL, gradients within SLICE_GRAD_RTOL of their
    max, every sequence token for token, the greedy log-probabilities
    within CAPTION_LOGP_ATOL. On the card K2 runs 2 + 2 times in the loss
    and in SCST's pass, 2 forward in each decode, nothing else of
    K1-K5."""
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.models import (XFMForCaptioning, beam_generate,
                                      generate)
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks.captioning import scst_loss

    cfg = configs.caption_yaml(layers=2, compute_dtype="float32")
    cpu = build_model(XFMForCaptioning.from_yaml, cfg, "cpu", seed=3)
    gpu = build_model(XFMForCaptioning.from_yaml, cfg, "cpu",
                      seed=3).to("cuda")
    vocab = cpu.config.text.vocab_size
    nb = configs.make_caption_batch(B, 30, 384, vocab, CAPTION_PROMPT, seed=1)
    r = np.random.RandomState(2)
    seqs = r.randint(5, vocab - 1, (B * n, 20))
    seqs[:, :4] = CAPTION_PROMPT
    seqs[0, 9], seqs[0, 10:] = 2, 1
    adv = r.randn(B * n).astype(np.float32)
    kw = dict(bos_id=0, eos_id=2, pad_id=1, max_len=20, min_len=5,
              prompt_ids=CAPTION_PROMPT)
    sample = ["vision_encoder.blocks.0.attn.qkv.weight",
              "vision_encoder.blocks.1.attn.relative_position_bias_table",
              "vision_encoder.patch_embed.proj.weight",
              "text_decoder.roberta.encoder.layer.0.attention.self.query."
              "weight",
              "text_decoder.roberta.encoder.layer.1.crossattention.self."
              "key.weight",
              "text_decoder.lm_head.dense.weight",
              "text_decoder.roberta.embeddings.word_embeddings.weight"]
    res = {}
    for tag, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        batch = configs.batch_to_torch(nb, dev)
        launches = {}
        kernels.reset_launch_counts()
        loss = model.loss(batch["images"], batch["text_ids"],
                          batch["text_atts"])
        loss.backward()
        launches["loss"] = dict(kernels.LAUNCHES)
        grads = {k: p.grad.clone() for k, p in model.named_parameters()
                 if k in sample}
        model.zero_grad(set_to_none=True)
        kernels.reset_launch_counts()
        greedy, lps = generate(model, batch["images"], **kw)
        launches["greedy"] = dict(kernels.LAUNCHES)
        kernels.reset_launch_counts()
        beams = beam_generate(model, batch["images"], num_beams=3, **kw)
        launches["beam"] = dict(kernels.LAUNCHES)
        kernels.reset_launch_counts()
        sl = scst_loss(model, batch["images"],
                       torch.from_numpy(seqs).to(dev),
                       torch.from_numpy(adv).to(dev), 0, 1, 4, n)
        sl.backward()
        launches["scst"] = dict(kernels.LAUNCHES)
        sgrads = {k: p.grad.clone() for k, p in model.named_parameters()
                  if k in sample}
        res[tag] = dict(loss=loss.item(), grads=grads, greedy=greedy.cpu(),
                        lps=lps.cpu(), beams=beams.cpu(), scst=sl.item(),
                        sgrads=sgrads, launches=launches)
    c, g = res["cpu"], res["cuda"]
    print(f"  caption slice launches: {json.dumps(g['launches'])}")
    none = {k: 0 for k in g["launches"]["loss"]}
    both = dict(none, relpos_attention_fwd=2, relpos_attention_bwd=2)
    fwd = dict(none, relpos_attention_fwd=2)
    if g["launches"] != dict(loss=both, greedy=fwd, beam=fwd, scst=both):
        raise AssertionError("caption slice: launches")
    for name in ("loss", "scst"):
        ok = math.isclose(c[name], g[name], rel_tol=SLICE_LOSS_RTOL)
        print(f"  caption slice {name}: cpu={c[name]:.6f} "
              f"cuda={g[name]:.6f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"caption slice: {name}")
    _grads_close("caption slice", c["grads"], g["grads"])
    _grads_close("caption scst", c["sgrads"], g["sgrads"])
    lerr = (c["lps"] - g["lps"]).abs().max().item()
    same_g = torch.equal(c["greedy"], g["greedy"])
    same_b = torch.equal(c["beams"], g["beams"])
    print(f"  caption slice greedy equal {same_g}, log p max_abs_err="
          f"{lerr:.3e} tol={CAPTION_LOGP_ATOL:.0e}; beam-3 equal {same_b}; "
          f"greedy {g['greedy'][0].tolist()}, beam {g['beams'][0].tolist()}")
    if not (same_g and same_b and lerr <= CAPTION_LOGP_ATOL):
        raise AssertionError("caption slice: sequences")
    del cpu, gpu
    torch.cuda.empty_cache()


def _png_file(path, r, lo=300, hi=500):
    from PIL import Image

    h, w = r.randint(lo, hi + 1, 2)
    yy, xx = np.mgrid[0:h, 0:w]
    wave = np.sin(xx * r.uniform(0.01, 0.1) + yy * r.uniform(0.01, 0.1))
    arr = (r.randint(0, 256, 3) + 60 * wave[..., None] * r.uniform(-1, 1, 3)
           + r.normal(0, 12, (h, w, 3)))
    img = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
    if path is None:
        import base64
        import io

        buf = io.BytesIO()
        img.save(buf, "PNG")
        return base64.b64encode(buf.getvalue()).decode()
    img.save(path)
    return path


def _caption_corpus(root, n_train=16, n_val=16, n_infer=8, n_pairs=64,
                    seed=0):
    """Seeded PNGs of 300-500 px a side: `n_train` images with 2
    Karpathy-style train rows each and `n_val` with a list of 5 captions,
    all with "coco_<n>" image ids; `n_infer` more in a directory of their
    own; a JSONL of `n_pairs` image-text pairs (base64 PNGs) → {train,
    val, image_root, infer_dir, pairs}."""
    r = np.random.RandomState(seed)
    words = ["a", "man", "woman", "dog", "cat", "on", "the", "red", "street",
             "table", "with", "two", "people", "riding", "sitting", "of",
             "blue", "bus", "near", "grass", "holding", "white", "plate",
             "food", "train", "water", "sky", "tree", "standing", "in"]

    def cap():
        return " ".join(r.choice(words, r.randint(5, 13))) + "."

    paths = {"image_root": os.path.join(root, "images"),
             "infer_dir": os.path.join(root, "infer")}
    for d in ("image_root", "infer_dir"):
        os.makedirs(paths[d], exist_ok=True)
    train, val = [], []
    for i in range(n_train + n_val):
        name = f"COCO_{i:06d}.png"
        _png_file(os.path.join(paths["image_root"], name), r)
        if i < n_train:
            train += [{"image": name, "caption": cap(),
                       "image_id": f"coco_{i}"} for _ in range(2)]
        else:
            val.append({"image": name, "caption": [cap() for _ in range(5)],
                        "image_id": f"coco_{i}"})
    for i in range(n_infer):
        _png_file(os.path.join(paths["infer_dir"], f"img{i:03d}.png"), r)
    for name, obj in (("train", train), ("val", val)):
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    paths["pairs"] = os.path.join(root, "pairs.jsonl")
    with open(paths["pairs"], "w") as f:
        for _ in range(n_pairs):
            f.write(json.dumps({"binary": _png_file(None, r, 240, 320),
                                "desc": cap()}) + "\n")
    return paths


def caption_task_runs(root, bs=16, epochs=2, seed=0) -> dict:
    """Phase 21's runs of `run.main` in `root` over `_caption_corpus`:
    `--task coco_captioning` on `Captioning.yaml`'s keys (`resume: true`)
    for `epochs`; after deleting ckpt/<last>, the resumed run;
    `--evaluate --checkpoint` from its own checkpoint; `scst: true` for
    one epoch from `--load_ckpt_from` that checkpoint;
    `Captioning_pretrain.yaml`'s keys for 3 steps; `--task infer_caption`
    from the checkpoint. Every step, decode batch and epoch is recorded:
    seconds, launches, losses, the sequences' widths, the restored state
    against its file."""
    import yaml

    from xfm_tpu_torch import configs, run
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks import captioning

    files = _caption_corpus(root)
    base = dict(configs.CAPTIONING, train_file=[files["train"]],
                val_file=files["val"], image_root=files["image_root"],
                resume=True)
    cfgs = {"ft": base, "scst": dict(base, scst=True),
            "infer": dict(base, image_dir=files["infer_dir"]),
            "pt": dict(configs.CAPTIONING_PRETRAIN,
                       train_file=[files["pairs"]], max_steps=3,
                       print_freq=1)}
    for name, cfg in cfgs.items():
        with open(os.path.join(root, f"{name}.yaml"), "w") as f:
            yaml.safe_dump(cfg, f)
    out = os.path.join(root, "out")
    real = (captioning._captions, captioning.train_epoch,
            captioning.maybe_resume_epochs, captioning.make_scst_step,
            captioning.make_train_step)
    rec = {}

    def timed(kind, fn, *a, **kw):
        _sync()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        _sync()
        return res, dict(kind=kind, s=time.perf_counter() - t0,
                         launches=dict(kernels.LAUNCHES))

    def _captions(model, images, cfg, ids):
        seqs, e = timed("decode", real[0], model, images, cfg, ids)
        e.update(rows=int(seqs.shape[0]), width=int(seqs.shape[1]))
        rec["decodes"].append(e)
        return seqs

    def record_step(step):
        def wrapped(state, *a):
            lr = state.optimizer.lr(state.optimizer.count)
            (state, m), e = timed("step", step, state, *a)
            e.update(loss=float(m["loss"]), lr=lr)
            rec["steps"].append(e)
            return state, m
        return wrapped

    def train_epoch(ctx, state, step_fn, loader, generator, epoch, sched,
                    **kw):
        torch.cuda.reset_peak_memory_stats()
        state, stats = real[1](ctx, state, record_step(step_fn), loader,
                               generator, epoch, sched, **kw)
        rec["epochs"].append(dict(
            epoch=epoch,
            max_memory_allocated=torch.cuda.max_memory_allocated()))
        return state, stats

    def maybe_resume_epochs(ctx, state):
        state, start = real[2](ctx, state)
        if start:
            saved = torch.load(os.path.join(out, "ckpt", str(start - 1),
                                            "state.pt"),
                               map_location="cuda", weights_only=True)
            opt = state.optimizer
            equal = (state.step == saved["step"]
                     and opt.count == saved["optimizer"]["count"])
            for name, p in zip(opt.names, opt.params):
                equal &= torch.equal(p, saved["params"][name])
            for key in ("mu", "nu"):
                for name, t in zip(opt.names, getattr(opt, key)):
                    equal &= torch.equal(t, saved["optimizer"][key][name])
            rec["restored"] = dict(start=start, bit_equal=bool(equal))
            del saved
        return state, start

    captioning._captions = _captions
    captioning.train_epoch = train_epoch
    captioning.maybe_resume_epochs = maybe_resume_epochs
    captioning.make_scst_step = lambda *a: record_step(real[3](*a))
    captioning.make_train_step = lambda *a: record_step(real[4](*a))
    last = os.path.join(out, "ckpt", str(epochs - 1), "state.pt")
    runs = {}
    try:
        for name, argv in (
                ("full", ["--config", "ft", "--output_dir", out, "--bs",
                          str(bs), "--epoch", str(epochs)]),
                ("resumed", ["--config", "ft", "--output_dir", out, "--bs",
                             str(bs), "--epoch", str(epochs)]),
                ("evaluate", ["--config", "ft", "--output_dir", out + "_ev",
                              "--evaluate", "--checkpoint", last]),
                ("scst", ["--config", "scst", "--output_dir", out + "_scst",
                          "--bs", str(bs), "--epoch", "1",
                          "--load_ckpt_from", last]),
                ("pretrain", ["--config", "pt", "--output_dir",
                              out + "_pt"]),
                ("infer", ["--task", "infer_caption", "--config", "infer",
                           "--output_dir", out + "_inf", "--checkpoint",
                           last])):
            if name == "resumed":
                runs["layout"] = sorted(os.listdir(os.path.join(out,
                                                                "ckpt")))
                runs["checkpoint_bytes"] = os.path.getsize(last)
                with open(os.path.join(out, "result",
                                       "caption_result.json")) as f:
                    runs["captions"] = json.load(f)
                shutil.rmtree(os.path.dirname(last))
            argv = list(argv)
            argv[argv.index("--config") + 1] = os.path.join(
                root, argv[argv.index("--config") + 1] + ".yaml")
            if "--task" not in argv:
                argv = ["--task", "coco_captioning"] + argv
            rec = dict(decodes=[], steps=[], epochs=[])
            t0 = time.perf_counter()
            rec["result"] = run.main(argv + ["--seed", str(seed)])
            rec["s"] = time.perf_counter() - t0
            if name in ("resumed", "evaluate"):
                with open(os.path.join(out + ("_ev" if name == "evaluate"
                                              else ""), "result",
                                       "caption_result.json")) as f:
                    rec["captions"] = json.load(f)
            runs[name] = rec
    finally:
        (captioning._captions, captioning.train_epoch,
         captioning.maybe_resume_epochs, captioning.make_scst_step,
         captioning.make_train_step) = real
    runs["n_val"] = len(json.load(open(files["val"])))
    runs["n_infer"] = len(os.listdir(files["infer_dir"]))
    return runs


def full_caption_task(epochs=2) -> dict:
    """Phase 21's task runs at full width on the card, checked: finite
    losses; K2 12 + 12 a fine-tune step, 12 a decode batch and 36 + 12 an
    SCST step (greedy, sampled, the differentiable pass), K1 12 + 12 a
    domain-pretrain step, nothing else; both checkpoints written; the
    resume bit-equal to its file and its first loss bit-equal to the first
    run's; `--evaluate` from the checkpoint captioning as the run did; one
    caption an image of `max_length` tokens at most; the metrics with
    SPICE None; peak memory under 80 GB. The directory is deleted at the
    end."""
    import tempfile

    root = tempfile.mkdtemp(prefix="xfm_caption_")
    try:
        runs = caption_task_runs(root, epochs=epochs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    d = 12
    names = list(runs["full"]["steps"][0]["launches"])
    none = {n: 0 for n in names}
    want = {"ft": dict(none, relpos_attention_fwd=d, relpos_attention_bwd=d),
            "decode": dict(none, relpos_attention_fwd=d),
            "scst": dict(none, relpos_attention_fwd=3 * d,
                         relpos_attention_bwd=d),
            "pt": dict(none, packed_attention_fwd=d,
                       packed_attention_bwd=d)}
    for name in ("full", "resumed", "evaluate", "scst", "pretrain", "infer"):
        r = runs[name]
        print(f"  {name}: {r['s']:.1f} s, result "
              f"{json.dumps(r['result'])[:400]}")
        kind = {"scst": "scst", "pretrain": "pt"}.get(name, "ft")
        for e in r["steps"]:
            print(f"    step {e['s']:.3f} s loss {e['loss']:.4f} "
                  f"launches {json.dumps(e['launches'])}")
            if e["launches"] != want[kind] or not math.isfinite(e["loss"]):
                raise AssertionError(f"{name}: a step's launches or loss")
        for e in r["decodes"]:
            print(f"    decode {e['rows']} x {e['width']}: {e['s']:.3f} s, "
                  f"launches {json.dumps(e['launches'])}")
            if e["launches"] != want["decode"] or e["width"] != 20:
                raise AssertionError(f"{name}: a decode's launches or width")
        for e in r["epochs"]:
            if e["max_memory_allocated"] >= 80e9:
                raise AssertionError(f"{name}: peak memory")
    full, resumed = runs["full"], runs["resumed"]
    caps = runs["captions"]
    n_steps = {n: len(runs[n]["steps"]) for n in ("full", "resumed",
                                                 "scst", "pretrain")}
    print(f"  checkpoints {runs['layout']}, {runs['checkpoint_bytes']} B "
          f"each; resume {json.dumps(resumed.get('restored', {}))}; steps "
          f"{n_steps}; captions {[c['caption'] for c in caps[:4]]}; the "
          f"resumed run's captions equal: {resumed['captions'] == caps}")
    spe = len(full["steps"]) // epochs
    metrics = full["result"]
    if (runs["layout"] != [str(i) for i in range(epochs)]
            or not resumed.get("restored", {}).get("bit_equal")
            or resumed["steps"][0]["loss"] != full["steps"][spe]["loss"]
            or resumed["steps"][0]["lr"] != full["steps"][spe]["lr"]
            or n_steps["resumed"] != spe or n_steps["pretrain"] != 3
            or n_steps["scst"] < 1
            or sorted(c["image_id"] for c in caps) != sorted(
                {c["image_id"] for c in caps})
            or len(caps) != runs["n_val"]
            or runs["evaluate"]["captions"] != caps
            or len(runs["infer"]["result"]) != runs["n_infer"]
            or metrics.get("SPICE", 0) is not None
            or not {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr"} <= set(metrics)
            or any(len(c["caption"].split()) > 20 for c in caps)):
        raise AssertionError("the caption runs' checkpoints, resume, "
                             "captions or metrics")
    return dict(step_s=[e["s"] for e in full["steps"]],
                decode_s=[e["s"] for e in full["decodes"]],
                scst_step_s=[e["s"] for e in runs["scst"]["steps"]],
                pretrain_step_s=[e["s"] for e in runs["pretrain"]["steps"]],
                run_s={n: runs[n]["s"] for n in ("full", "resumed",
                                                  "evaluate", "scst",
                                                  "pretrain", "infer")},
                max_memory_allocated=max(e["max_memory_allocated"]
                                         for e in full["epochs"]),
                checkpoint_bytes=runs["checkpoint_bytes"], metrics=metrics)


def caption_phase():
    """Phase 21 → (K2's and K1's errors, times and bounds at qkv [16, 577,
    2304] and [64, 197, 2304], `profile_step.profile_caption`'s units)."""
    from xfm_tpu_torch import profile_step

    bf16, f32 = torch.bfloat16, torch.float32
    k2c_shape = dict(B=16, window=(24, 24), H=12)
    k2cw = k2_work(B=16, N=577, H=12, D=64, window=(24, 24), dtype=bf16)
    k2c_err = k2_parity(**k2c_shape, dtype=bf16, seed=60)
    k2_parity(**k2c_shape, dtype=f32, seed=61)
    k2_deterministic(**k2c_shape, dtype=bf16, seed=62)
    k2c_t = k2_times(**k2c_shape, dtype=bf16)
    print("  K2 B=16 N=577 times (ms): " + json.dumps(k2c_t))
    print("  K2 B=16 N=577 bound (k2_work): " + json.dumps(k2cw))
    k1c_err = k1_parity(B=64, N=197, H=12, dtype=bf16, seed=63)
    k1_parity(B=64, N=197, H=12, dtype=f32, seed=64)
    k1_deterministic(B=64, N=197, H=12, dtype=bf16, seed=65)
    k1c_t = k1_times(B=64, N=197, H=12, dtype=bf16)
    k1cw = k1_work(B=64, N=197, H=12, D=64, dtype=bf16)
    print("  K1 B=64 N=197 times (ms): " + json.dumps(k1c_t))
    print("  K1 B=64 N=197 bound (k1_work): " + json.dumps(k1cw))
    caption_slice_parity()
    ct = full_caption_task()
    print("  caption task: " + json.dumps(ct))
    cprof = profile_step.profile_caption(os.path.join(
        REPO, "build", "xfm_tpu_torch", "profile_caption.json"))
    d = 12
    want = {"caption_train": dict(relpos_attention_fwd=d,
                                  relpos_attention_bwd=d),
            "caption_beam": dict(relpos_attention_fwd=d),
            "caption_scst": dict(relpos_attention_fwd=3 * d,
                                 relpos_attention_bwd=d),
            "caption_pretrain": dict(packed_attention_fwd=d,
                                     packed_attention_bwd=d)}
    for unit, r in cprof.items():
        top = r.pop("top")
        print(f"  {unit} profile: " + json.dumps(r))
        for name, ms, n in top[:10]:
            print(f"    {ms:9.3f} ms/call {n:6d} calls/call  {name}")
        if (r["launches"] != dict({k: 0 for k in r["launches"]},
                                  **want[unit])
                or r["max_memory_allocated"] >= 80e9
                or not math.isfinite(r.get("loss", 0.0))):
            raise AssertionError(f"{unit}: launches, peak memory or loss")
    return (k2c_err, k2c_t, k2cw), (k1c_err, k1c_t, k1cw), cprof


def caption_kernel_entries(k2c, k1c, k2_main, cprof) -> list:
    """The `kernels` entries of phase 21: K2 at the caption step's shape
    (qkv [16, 577, 2304] bf16) with its launches a step
    (`profile_step caption_train`), K1 at the domain pretrain's ([64, 197,
    2304], `caption_pretrain`), and K2's forward at [32, 577, 2304] (phase
    5's error and times, the main retrieval shape) with its launches a
    beam eval batch (`caption_beam`)."""
    entries = [dict(e, name=e["name"] + "_caption_b16")
               for e in kernel_entries(
                   "relpos_attention", "xfm_tpu/ops/flash_attention.py", 689,
                   717, "xfm_tpu_torch/csrc/relpos_attention.cu", k2c[0],
                   ("dqkv", "dcr", "dcls"), k2c[1], k2c[2],
                   cprof["caption_train"]["launches"])]
    entries += [dict(e, name=e["name"] + "_caption_pretrain_b64")
                for e in kernel_entries(
                    "packed_attention", "xfm_tpu/ops/flash_attention.py",
                    983, 1007, "xfm_tpu_torch/csrc/packed_attention.cu",
                    k1c[0], ("dqkv", "db"), k1c[1], k1c[2],
                    cprof["caption_pretrain"]["launches"])]
    entries += [dict(e, name=e["name"] + "_caption_beam_b32")
                for e in kernel_entries(
                    "relpos_attention", "xfm_tpu/ops/flash_attention.py",
                    689, 717, "xfm_tpu_torch/csrc/relpos_attention.cu",
                    k2_main[0], ("dqkv", "dcr", "dcls"), k2_main[1],
                    k2_main[2], cprof["caption_beam"]["launches"])
                if e["name"].endswith("_fwd")]
    return entries


# --- phase 22: NLVR2 and RefCOCO grounding -----------------------------------

# phase-22 tolerance of GradCAM's cam, CPU vs card (f32): max |card - CPU|
# relative to the CPU cam's largest value
CAM_RTOL = 1e-4
# the bf16 cam on the card against the f32 one, relative to the f32 cam's
# largest value (2.05e-2 measured on an H100). The rounding of the whole
# bf16 model sets this distance, so it does not tell a misplaced gate apart;
# the gate's own gradient does (GATE_GRAD_RTOL).
CAM_BF16_RTOL = 5e-2
# the gated attention's gradient with respect to the gate in bf16, card vs
# CPU, relative to its largest value: both round dP to bf16 at the same
# point, so only the order of f32 sums differs; a gate applied after the
# cast, or P kept in f32 for PV, moves it by more than 2⁻¹⁰
# (tests/test_torch_gradcam.py)
GATE_GRAD_RTOL = 2.0 ** -12
NLVR_WORDS = ["the", "left", "image", "shows", "two", "dogs", "right", "one",
              "has", "more", "birds", "than", "a", "red", "car", "in",
              "both", "images", "there", "are", "exactly", "three"]


def _close(tag: str, cpu, gpu, rtol: float) -> None:
    """max |card − CPU| within rtol of max(1, the CPU's largest |value|),
    or raise."""
    a, b = cpu.float(), gpu.float().cpu()
    err = (a - b).abs().max().item()
    tol = rtol * max(1.0, a.abs().max().item())
    print(f"  {tag}: max_abs_err={err:.3e} tol={tol:.3e}")
    if not err <= tol:
        raise AssertionError(tag)


def nlvr_slice_parity(B=2) -> dict:
    """f32, full width, depth 2 (2 BEiT blocks, 2 text and 2 fusion
    layers), 384 px, the full vocabulary, on the CPU and on the card from
    the same weights and inputs: `XFMForNLVR`'s loss, logits and sampled
    gradients (B pairs: one 2B-image tower pass); `XFMForGrounding`'s
    boxes, L1, GIoU and sampled gradients; the cam of `itm_gradcam` (an
    `XFMForRetrieval`) at fusion layer 1 and the box each sample's 6
    candidates rank first. Losses within SLICE_LOSS_RTOL, logits and
    boxes within SLICE_LOSS_RTOL of max(1, their largest value), gradients
    within SLICE_GRAD_RTOL of their max, the cam within CAM_RTOL of its
    max, the same boxes chosen. On the card K2 runs 2 + 2 in each loss and
    2 forward in the logits, the boxes and the cam; nothing else. Then the
    cam in bf16 compute on the card (GradCAM runs in the compute dtype)
    within CAM_BF16_RTOL of the f32 one's max, choosing the same boxes →
    {the bf16 cam's error relative to the f32 cam's max, the samples
    choosing the same box}."""
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.models import (XFMForGrounding, XFMForNLVR,
                                      XFMForRetrieval, config_from_yaml,
                                      itm_gradcam, rank_boxes_by_cam)
    from xfm_tpu_torch.ops import kernels

    f32 = dict(layers=2, compute_dtype="float32")
    ncfg = config_from_yaml(configs.nlvr_yaml(**f32))
    gcfg = config_from_yaml(configs.grounding_yaml(**f32),
                            use_bbox_loss=True)
    rkw = dict(use_contrastive_loss=True, use_matching_loss=True)
    rcfg = config_from_yaml(configs.grounding_yaml(**f32), **rkw)
    V = ncfg.text.vocab_size
    nb = configs.make_pair_batch(B, 40, 384, V, seed=1)
    gb = configs.make_grounding_batch(B, 30, 384, V, seed=2)
    r = np.random.RandomState(3)
    boxes = r.randint(0, 368, (B, 6, 4))
    boxes[..., 2:] = np.minimum(boxes[..., :2] + r.randint(16, 200, (B, 6, 2)),
                                384)
    common = ["vision_encoder.blocks.0.attn.qkv.weight",
              "vision_encoder.blocks.1.attn.relative_position_bias_table",
              "vision_encoder.patch_embed.proj.weight",
              "text_encoder.roberta.encoder.layer.0.attention.self.query."
              "weight",
              "text_encoder.roberta.embeddings.word_embeddings.weight",
              "fusion_encoder.roberta.encoder.layer.1.crossattention.self."
              "key.weight"]
    res, launches = {}, {}
    for tag, dev in (("cpu", "cpu"), ("cuda", "cuda")):
        out = res[tag] = {}
        for name, cls, cfg, seed in (("nlvr", XFMForNLVR, ncfg, 4),
                                     ("grounding", XFMForGrounding, gcfg, 5)):
            model = build_model(cls, cfg, "cpu", seed=seed).to(dev)
            b = configs.batch_to_torch(nb if name == "nlvr" else gb, dev)
            ins = (b["images"], b["text_ids"].long(), b["text_atts"].long())
            kernels.reset_launch_counts()
            if name == "nlvr":
                loss = model.loss(*ins, b["targets"].long())
                out["nlvr_loss"] = loss.item()
            else:
                lb, lg = model.loss(*ins, b["target_bbox"])
                loss = lb + lg
                out["l1"], out["giou"] = lb.item(), lg.item()
            loss.backward()
            launches[f"{tag}_{name}_loss"] = dict(kernels.LAUNCHES)
            head = "cls_head.0.weight" if name == "nlvr" \
                else "bbox_head.3.weight"
            out[f"{name}_grads"] = {
                k: p.grad.clone() for k, p in model.named_parameters()
                if k in common + [head]}
            kernels.reset_launch_counts()
            with torch.no_grad():
                out[f"{name}_out"] = model.loss(*ins, train=False).cpu()
            launches[f"{tag}_{name}_eval"] = dict(kernels.LAUNCHES)
            del model
        model = build_model(XFMForRetrieval, rcfg, "cpu", seed=6).to(dev)
        b = configs.batch_to_torch(gb, dev)
        ins = (b["images"], b["text_ids"].long(), b["text_atts"].long())
        kernels.reset_launch_counts()
        out["cam"] = itm_gradcam(model, *ins, block_num=1).cpu()
        launches[f"{tag}_cam"] = dict(kernels.LAUNCHES)
        out["no_grad"] = all(p.grad is None for p in model.parameters())
        out["boxes"] = [int(np.argmax(rank_boxes_by_cam(
            out["cam"][i].numpy(), boxes[i], 384, 16))) for i in range(B)]
        if tag == "cuda":
            bf = build_model(XFMForRetrieval, config_from_yaml(
                configs.grounding_yaml(layers=2,
                                       compute_dtype="bfloat16"), **rkw),
                "cpu", seed=6).to(dev)
            out["cam_bf16"] = itm_gradcam(bf, *ins, block_num=1).cpu()
            del bf
        del model
    c, g = res["cpu"], res["cuda"]
    print(f"  nlvr/grounding slice launches: "
          f"{json.dumps({k: v for k, v in launches.items() if 'cuda' in k})}")
    none = {k: 0 for k in launches["cuda_cam"]}
    both = dict(none, relpos_attention_fwd=2, relpos_attention_bwd=2)
    fwd = dict(none, relpos_attention_fwd=2)
    if (launches["cuda_nlvr_loss"] != both
            or launches["cuda_grounding_loss"] != both
            or launches["cuda_nlvr_eval"] != fwd
            or launches["cuda_grounding_eval"] != fwd
            or launches["cuda_cam"] != fwd):
        raise AssertionError("nlvr/grounding slice: launches")
    for name in ("nlvr_loss", "l1", "giou"):
        ok = math.isclose(c[name], g[name], rel_tol=SLICE_LOSS_RTOL)
        print(f"  slice {name}: cpu={c[name]:.6f} cuda={g[name]:.6f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"nlvr/grounding slice: {name}")
    _close("slice nlvr logits", c["nlvr_out"], g["nlvr_out"],
           SLICE_LOSS_RTOL)
    _close("slice grounding boxes", c["grounding_out"], g["grounding_out"],
           SLICE_LOSS_RTOL)
    _grads_close("nlvr slice", c["nlvr_grads"], g["nlvr_grads"])
    _grads_close("grounding slice", c["grounding_grads"],
                 g["grounding_grads"])
    cerr = (c["cam"] - g["cam"]).abs().max().item()
    cmax = c["cam"].abs().max().item()
    print(f"  slice cam [{B}, {c['cam'].shape[1]}]: max_abs_err={cerr:.3e} "
          f"tol={CAM_RTOL * cmax:.3e}; boxes cpu {c['boxes']} cuda "
          f"{g['boxes']}; no parameter .grad: {g['no_grad']}")
    if not (cerr <= CAM_RTOL * cmax and cmax > 0 and c["boxes"] == g["boxes"]
            and c["no_grad"] and g["no_grad"]):
        raise AssertionError("nlvr/grounding slice: the cam")
    berr = (g["cam_bf16"] - g["cam"]).abs().max().item() / cmax
    bboxes = [int(np.argmax(rank_boxes_by_cam(
        g["cam_bf16"][i].numpy(), boxes[i], 384, 16))) for i in range(B)]
    same = sum(int(a == b) for a, b in zip(bboxes, g["boxes"]))
    print(f"  slice cam bf16 vs f32 on the card: max_abs_err / max = "
          f"{berr:.3e}; the same box in {same} of {B}")
    if not (berr <= CAM_BF16_RTOL and bboxes == g["boxes"]):
        raise AssertionError("nlvr/grounding slice: the bf16 cam")
    torch.cuda.empty_cache()
    return dict(cam_bf16_rel_err=berr, cam_bf16_same_boxes=same,
                cam_rel_err=cerr / cmax)


def gate_grad_parity(B=8, Nq=30, Nk=577, H=12, D=64, seed=75) -> dict:
    """The gated attention (`dot_product_attention(..., prob_gate=)`) in
    bf16 at the GradCAM batch's cross-attention shape, on the CPU and on
    the card from the same inputs, for a gate of ones (GradCAM's) and a
    random one: the output within 2⁻⁷ of its largest value (1 bf16 ulp or
    more there, so one rounding that falls the other way passes), the
    gradient with respect to the gate within GATE_GRAD_RTOL of its largest
    value → {gate kind: that gradient's error relative to its max}."""
    from xfm_tpu_torch.ops.attention import dot_product_attention

    r = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(r.randn(B, n, H, D).astype(np.float32))
               .bfloat16() for n in (Nq, Nk, Nk))
    bias = torch.from_numpy((r.randn(B, 1, 1, Nk) * 2).astype(np.float32))
    dout = torch.from_numpy(r.randn(B, Nq, H, D).astype(np.float32))
    res = {}
    for kind, gate in (("ones", torch.ones(B, H, Nq, Nk)), ("random", (
            1 + 0.5 * torch.from_numpy(r.randn(B, H, Nq, Nk)).float()))):
        got = {}
        for dev in ("cpu", "cuda"):
            g = gate.detach().to(dev).requires_grad_()
            out = dot_product_attention(q.to(dev), k.to(dev), v.to(dev),
                                        bias=bias.to(dev), prob_gate=g)
            (out.float() * dout.to(dev)).sum().backward()
            got[dev] = (out.float().cpu(), g.grad.cpu())
        (oc, gc), (og, gg) = got["cpu"], got["cuda"]
        oerr = (oc - og).abs().max().item() / oc.abs().max().item()
        res[kind] = (gc - gg).abs().max().item() / gc.abs().max().item()
        print(f"  gated attention bf16 [{B}, {Nq}, {Nk}] gate={kind}: out "
              f"err/max {oerr:.3e} tol {2.0 ** -7:.3e}; d gate err/max "
              f"{res[kind]:.3e} tol {GATE_GRAD_RTOL:.3e}")
        if not (oerr <= 2.0 ** -7 and res[kind] <= GATE_GRAD_RTOL):
            raise AssertionError(f"the gated attention, gate={kind}")
    return res


def _png_pool(image_root, r, n):
    """`n` seeded PNGs of 400-640 px a side under `image_root` → their
    [(name, width, height)]; the corpora below draw their rows from them
    (16 files in place of one a row: 80 for NLVR, 48 for grounding)."""
    from PIL import Image

    os.makedirs(image_root, exist_ok=True)
    pool = []
    for i in range(n):
        path = _png_file(os.path.join(image_root, f"img{i:03d}.png"), r, 400,
                         640)
        pool.append((os.path.basename(path),) + Image.open(path).size)
    return pool


def _nlvr_corpus(root, n_train=24, n_val=8, n_test=8, n_images=16, seed=0):
    """Seeded 'True' / 'False' labels and sentences over pairs of two
    different PNGs of `_png_pool` → {train, val, test, image_root}."""
    r = np.random.RandomState(seed)
    paths = {"image_root": os.path.join(root, "images")}
    pool = _png_pool(paths["image_root"], r, n_images)
    for split, rows in (("train", n_train), ("val", n_val),
                        ("test", n_test)):
        ann = []
        for _ in range(rows):
            pair = r.choice(n_images, 2, replace=False)
            ann.append({"images": [pool[i][0] for i in pair],
                        "label": str(r.choice(["True", "False"])),
                        "sentence": " ".join(r.choice(NLVR_WORDS,
                                                      r.randint(6, 16)))})
        paths[split] = os.path.join(root, f"{split}.json")
        with open(paths[split], "w") as f:
            json.dump(ann, f)
    return paths


def _grounding_corpus(root, n_train=24, n_test=8, n_weak=16, n_images=16,
                      seed=1):
    """A phrase and a pixel box on a PNG of `_png_pool` a row (train,
    test); weakly supervised rows with 5 candidate boxes on the 384 px
    frame and a `gt` index; a JSONL of 32 region images for stage 1 →
    {train, test, weak, image_root, regions}."""
    r = np.random.RandomState(seed)
    paths = {"image_root": os.path.join(root, "images")}
    pool = _png_pool(paths["image_root"], r, n_images)
    n = 0
    for split, rows in (("train", n_train), ("test", n_test),
                        ("weak", n_weak)):
        ann = []
        for _ in range(rows):
            name, W, H = pool[r.randint(n_images)]
            n += 1
            row = {"image": name, "ref_id": n, "text": " ".join(
                r.choice(NLVR_WORDS, r.randint(3, 10)))}
            if split == "weak":
                xy = r.randint(0, 300, (5, 2))
                row["boxes"] = np.concatenate(
                    [xy, xy + r.randint(32, 84, (5, 2))], 1).tolist()
                row["gt"] = int(r.randint(0, 5))
            else:
                w, h = r.uniform(40, W / 2), r.uniform(40, H / 2)
                row["bbox"] = [float(r.uniform(0, W - w)),
                               float(r.uniform(0, H - h)), float(w),
                               float(h)]
            ann.append(row)
        paths[split] = os.path.join(root, f"{split}.json")
        with open(paths[split], "w") as f:
            json.dump(ann, f)
    os.makedirs(os.path.join(root, "pt"), exist_ok=True)
    paths["regions"] = _pretrain_corpus(os.path.join(root, "pt"), seed,
                                        n_pairs=0, n_regions=32,
                                        n_texts=0)["regions"]
    return paths


def _restored_bit_equal(ckpt, state) -> bool:
    """The restored train state against the file it came from."""
    opt = state.optimizer
    saved = torch.load(ckpt, map_location=opt.params[0].device,
                       weights_only=True)
    equal = (state.step == saved["step"]
             and opt.count == saved["optimizer"]["count"])
    for name, p in zip(opt.names, opt.params):
        equal &= torch.equal(p, saved["params"][name])
    for key in ("mu", "nu"):
        for name, t in zip(opt.names, getattr(opt, key)):
            equal &= torch.equal(t, saved["optimizer"][key][name])
    return bool(equal)


def nlvr_task_runs(root, bs=24, epochs=2, seed=0) -> dict:
    """Phase 22's runs of `run.main` in `root` over `_nlvr_corpus` and
    `_grounding_corpus`: `--task nlvr` on `NLVR.yaml`'s keys (`resume:
    true`), the run again after ckpt/<last> is deleted, `--evaluate
    --checkpoint` from its checkpoint; `--task refcoco_bbox` on
    `Grounding_bbox.yaml`'s keys with `domain_pretrain_config` naming
    `Grounding_bbox_pretrain.yaml`'s keys over the region JSONL (3 steps
    at its batch), then `--evaluate --checkpoint`;
    `tasks.grounding.main_weakly_supervised` over the weakly supervised
    rows. Each step, eval, stage-1 step, GradCAM batch and epoch is
    recorded (seconds, launches, losses), and each run's checkpoint
    writes (seconds), the restored state against its file, and stage 2's
    tables against the interpolation of stage 1's."""
    import types

    import yaml

    from xfm_tpu_torch import configs, run
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks import common, grounding, nlvr, pretrain
    from xfm_tpu_torch.train.checkpoint import (
        interpolate_rel_pos_bias_table, load_params_from_checkpoint)

    t0 = time.perf_counter()
    nf = _nlvr_corpus(os.path.join(root, "nlvr"))
    gf = _grounding_corpus(os.path.join(root, "ref"))
    runs = {"corpus_s": time.perf_counter() - t0}
    cfgs = {
        "nlvr": dict(configs.NLVR, train_file=[nf["train"]],
                     val_file=nf["val"], test_file=nf["test"],
                     image_root=nf["image_root"], resume=True),
        "stage1": dict(configs.GROUNDING_PRETRAIN,
                       train_file_regions=[gf["regions"]], max_steps=3,
                       print_freq=1),
        "weak": dict(configs.GROUNDING, test_file=gf["weak"],
                     image_root=gf["image_root"], batch_size=8)}
    for name in ("nlvr", "stage1", "weak"):
        with open(os.path.join(root, f"{name}.yaml"), "w") as f:
            yaml.safe_dump(cfgs[name], f)
    cfgs["ref"] = dict(configs.GROUNDING, train_file=[gf["train"]],
                       test_file=gf["test"], image_root=gf["image_root"],
                       domain_pretrain_config=os.path.join(root,
                                                           "stage1.yaml"))
    with open(os.path.join(root, "ref.yaml"), "w") as f:
        yaml.safe_dump(cfgs["ref"], f)
    real = dict(n_ev=nlvr.evaluate, g_ev=grounding.evaluate,
                te=common.train_epoch, re=common.maybe_resume_epochs,
                save=common.save_task_checkpoint,
                g_ld=grounding._load_stage1, g_cam=grounding.itm_gradcam,
                p_step=pretrain.make_stream_step)
    rec = {}

    def timed(kind, fn, *a, **kw):
        _sync()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        _sync()
        return res, dict(kind=kind, s=time.perf_counter() - t0,
                         launches=dict(kernels.LAUNCHES))

    def evaluate(key):
        def wrapped(model, data):
            res, e = timed("eval", real[key], model, data)
            e.update(batches=-(-len(data) // data.batch_size), **res)
            rec["evals"].append(e)
            return res
        return wrapped

    def train_epoch(ctx, state, step_fn, loader, generator, epoch, sched,
                    **kw):
        def step(state, batch, gen):
            lr = state.optimizer.lr(state.optimizer.count)
            (state, m), e = timed("step", step_fn, state, batch, gen)
            e.update(loss=m["loss"].item(), lr=lr)
            rec["steps"].append(e)
            return state, m

        torch.cuda.reset_peak_memory_stats()
        state, stats = real["te"](ctx, state, step, loader, generator,
                                  epoch, sched, **kw)
        rec["epochs"].append(dict(
            epoch=epoch,
            max_memory_allocated=torch.cuda.max_memory_allocated()))
        return state, stats

    def save_task_checkpoint(*a, **kw):
        t0 = time.perf_counter()
        real["save"](*a, **kw)
        rec["save_s"].append(time.perf_counter() - t0)

    def maybe_resume_epochs(ctx, state):
        state, start = real["re"](ctx, state)
        if start:
            rec["restored"] = dict(start=start, bit_equal=_restored_bit_equal(
                os.path.join(ctx.out_dir, "ckpt", str(start - 1),
                             "state.pt"), state))
        return state, start

    def load_stage1(model, path):
        real["g_ld"](model, path)
        s1 = load_params_from_checkpoint(path)
        sd = model.state_dict()
        g = model.config.vision.grid_size
        keys = [k for k in s1 if k.endswith("relative_position_bias_table")]
        rec["tables"] = dict(n=len(keys), shapes=sorted({
            (tuple(s1[k].shape), tuple(sd[k].shape)) for k in keys}),
            equal=all(np.array_equal(
                interpolate_rel_pos_bias_table(
                    s1[k].detach().float().cpu().numpy(), (g, g)),
                sd[k].cpu().numpy()) for k in keys))
        del s1

    def stream_step(loss_fn):
        step = real["p_step"](loss_fn)

        def wrapped(state, batches, gens):
            (state, m), e = timed("stage1", step, state, batches, gens)
            e.update(loss=m["loss"].item(),
                     rows=int(batches["region"]["images"].shape[0]))
            rec["stage1"].append(e)
            return state, m
        return wrapped

    def gradcam(*a, **kw):
        cam, e = timed("gradcam", real["g_cam"], *a, **kw)
        e.update(rows=int(cam.shape[0]), block_num=kw.get("block_num"))
        rec["cams"].append(e)
        return cam

    nlvr.evaluate, grounding.evaluate = evaluate("n_ev"), evaluate("g_ev")
    common.train_epoch = train_epoch
    common.maybe_resume_epochs = maybe_resume_epochs
    common.save_task_checkpoint = save_task_checkpoint
    grounding._load_stage1, grounding.itm_gradcam = load_stage1, gradcam
    pretrain.make_stream_step = stream_step
    out = os.path.join(root, "out")
    last = os.path.join(out, "ckpt", str(epochs - 1), "state.pt")
    gout = os.path.join(root, "ref_out")
    glast = os.path.join(gout, "ckpt", str(epochs - 1), "state.pt")
    seed_arg = ["--seed", str(seed)]
    try:
        for name, argv in (
                ("full", ["--task", "nlvr", "--config", "nlvr",
                          "--output_dir", out, "--bs", str(bs), "--epoch",
                          str(epochs)]),
                ("resumed", ["--task", "nlvr", "--config", "nlvr",
                             "--output_dir", out, "--bs", str(bs),
                             "--epoch", str(epochs)]),
                ("evaluate", ["--task", "nlvr", "--config", "nlvr",
                              "--output_dir", out + "_ev", "--evaluate",
                              "--checkpoint", last]),
                ("pipeline", ["--task", "refcoco_bbox", "--config", "ref",
                              "--output_dir", gout, "--bs", str(bs),
                              "--epoch", str(epochs)]),
                ("ref_evaluate", ["--task", "refcoco_bbox", "--config",
                                  "ref", "--output_dir", gout + "_ev",
                                  "--evaluate", "--checkpoint", glast]),
                ("weak", None)):
            if name == "resumed":
                runs["layout"] = sorted(os.listdir(os.path.join(out,
                                                                "ckpt")))
                runs["checkpoint_bytes"] = os.path.getsize(last)
                shutil.rmtree(os.path.dirname(last))
            if name == "pipeline":  # the NLVR checkpoints are done with
                for d in (out, out + "_ev"):
                    shutil.rmtree(d, ignore_errors=True)
            rec = dict(evals=[], steps=[], epochs=[], stage1=[], cams=[],
                       save_s=[])
            t0 = time.perf_counter()
            if argv is None:
                rec["result"] = grounding.main_weakly_supervised(
                    types.SimpleNamespace(
                        config=os.path.join(root, "weak.yaml"),
                        output_dir=os.path.join(root, "weak_out"),
                        checkpoint=None, seed=seed, device="cuda"))
            else:
                argv = list(argv)
                i = argv.index("--config") + 1
                argv[i] = os.path.join(root, argv[i] + ".yaml")
                rec["result"] = run.main(argv + seed_arg)
            rec["s"] = time.perf_counter() - t0
            if name == "ref_evaluate":
                runs["stage1_layout"] = sorted(os.listdir(os.path.join(
                    gout, "bbox_pretrain", "ckpt")))
            runs[name] = rec
    finally:
        nlvr.evaluate, grounding.evaluate = real["n_ev"], real["g_ev"]
        common.train_epoch = real["te"]
        common.maybe_resume_epochs = real["re"]
        common.save_task_checkpoint = real["save"]
        grounding._load_stage1 = real["g_ld"]
        grounding.itm_gradcam = real["g_cam"]
        pretrain.make_stream_step = real["p_step"]
    return runs


def full_nlvr_task(epochs=2) -> dict:
    """Phase 22's task runs at full width on the card, checked: finite
    losses; K2 12 + 12 a fine-tune step (NLVR and grounding) and 12 an eval
    batch, K1 12 + 12 a stage-1 step, K2 12 a GradCAM batch, nothing else;
    the checkpoints written; the NLVR resume bit-equal to its file, its
    first loss bit-equal to the first run's; `--evaluate` giving the last
    epoch's accuracy; stage 2's 12 tables [2212, 12] each the
    interpolation of stage 1's [732, 12]; accuracies in [0, 1]; peak
    memory under 80 GB. The directory is deleted at the end."""
    import tempfile

    root = tempfile.mkdtemp(prefix="xfm_nlvr_")
    try:
        runs = nlvr_task_runs(root, epochs=epochs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    d = 12
    names = list(runs["full"]["steps"][0]["launches"])
    none = {n: 0 for n in names}
    want = {"step": dict(none, relpos_attention_fwd=d,
                         relpos_attention_bwd=d),
            "stage1": dict(none, packed_attention_fwd=d,
                           packed_attention_bwd=d),
            "gradcam": dict(none, relpos_attention_fwd=d)}
    for name in ("full", "resumed", "evaluate", "pipeline", "ref_evaluate",
                 "weak"):
        r = runs[name]
        print(f"  {name}: {r['s']:.1f} s ({sum(r['save_s']):.1f} s in "
              f"{len(r['save_s'])} checkpoint writes), result "
              f"{json.dumps(r['result'])}")
        for e in r["steps"] + r["stage1"] + r["cams"]:
            print(f"    {e['kind']} {e['s']:.3f} s loss "
                  f"{e.get('loss', float('nan')):.4f} launches "
                  f"{json.dumps(e['launches'])}")
            if (e["launches"] != want[e["kind"]]
                    or not math.isfinite(e.get("loss", 0.0))):
                raise AssertionError(f"{name}: a {e['kind']}'s launches or "
                                     f"loss")
        for e in r["evals"]:
            print(f"    eval {e['batches']} batches {e['s']:.3f} s "
                  f"{json.dumps({k: v for k, v in e.items() if 'acc' in k})}"
                  f" launches {json.dumps(e['launches'])}")
            acc = [v for k, v in e.items() if "acc" in k]
            if (e["launches"] != dict(none, relpos_attention_fwd=d
                                      * e["batches"])
                    or not all(0 <= a <= 1 for a in acc)):
                raise AssertionError(f"{name}: an eval's launches or "
                                     f"accuracy")
        for e in r["epochs"]:
            if e["max_memory_allocated"] >= 80e9:
                raise AssertionError(f"{name}: peak memory")
    full, resumed, pipe = runs["full"], runs["resumed"], runs["pipeline"]
    spe = len(full["steps"]) // epochs
    tables = pipe.get("tables", {})
    print(f"  corpora {runs['corpus_s']:.1f} s; nlvr checkpoints "
          f"{runs['layout']}, {runs['checkpoint_bytes']} B each; resume "
          f"{json.dumps(resumed.get('restored', {}))}; stage "
          f"1 {runs['stage1_layout']}, its {len(pipe['stage1'])} steps of "
          f"{[e['rows'] for e in pipe['stage1']]} image rows; tables "
          f"{json.dumps(tables)}; weak {json.dumps(runs['weak']['result'])}")
    nlvr_last = full["evals"][-1]["acc"]
    ref_last = pipe["evals"][-1]["iou50_acc"]
    if (runs["layout"] != [str(i) for i in range(epochs)]
            or not resumed.get("restored", {}).get("bit_equal")
            or resumed["steps"][0]["loss"] != full["steps"][spe]["loss"]
            or resumed["steps"][0]["lr"] != full["steps"][spe]["lr"]
            or len(resumed["steps"]) != spe
            or len(full["evals"]) != 2 * epochs
            or runs["evaluate"]["result"] != {"acc": nlvr_last}
            or runs["stage1_layout"] != ["3"] or len(pipe["stage1"]) != 3
            or any(e["rows"] != 80 for e in pipe["stage1"])
            or tables.get("n") != 12 or not tables.get("equal")
            or tables.get("shapes") != [((732, 12), (2212, 12))]
            or len(pipe["steps"]) != epochs * spe
            or len(pipe["evals"]) != epochs
            or runs["ref_evaluate"]["result"] != {"iou50_acc": ref_last}
            or not 0 <= runs["weak"]["result"]["gradcam_acc"] <= 1
            or [e["rows"] for e in runs["weak"]["cams"]] != [8, 8]
            or {e["block_num"] for e in runs["weak"]["cams"]} != {8}):
        raise AssertionError("the NLVR and grounding runs' checkpoints, "
                             "resume, stage hand-off or evals")
    return dict(nlvr_step_s=[e["s"] for e in full["steps"]],
                ref_step_s=[e["s"] for e in pipe["steps"]],
                stage1_step_s=[e["s"] for e in pipe["stage1"]],
                gradcam_s=[e["s"] for e in runs["weak"]["cams"]],
                run_s={n: runs[n]["s"] for n in (
                    "full", "resumed", "evaluate", "pipeline",
                    "ref_evaluate", "weak")},
                save_s={n: runs[n]["save_s"] for n in (
                    "full", "resumed", "pipeline")},
                corpus_s=runs["corpus_s"],
                max_memory_allocated=max(
                    e["max_memory_allocated"]
                    for e in full["epochs"] + pipe["epochs"]),
                checkpoint_bytes=runs["checkpoint_bytes"],
                nlvr=full["result"], ref=pipe["result"],
                weak=runs["weak"]["result"])


def nlvr_phase():
    """Phase 22 → (K2's errors, times and bounds at qkv [48, 577, 2304]
    and [24, 577, 2304] (forward and backward) and [8, 577, 2304]
    (forward), the slice's bf16 cam readings, `profile_step.profile_nlvr`'s
    units)."""
    from xfm_tpu_torch import profile_step

    bf16, f32 = torch.bfloat16, torch.float32
    t0 = time.perf_counter()
    shape = dict(B=48, window=(24, 24), H=12)
    k2nw = k2_work(B=48, N=577, H=12, D=64, window=(24, 24), dtype=bf16)
    k2n_err = k2_parity(**shape, dtype=bf16, seed=70)
    k2_parity(**shape, dtype=f32, seed=71)
    k2_deterministic(**shape, dtype=bf16, seed=72)
    k2n_t = k2_times(**shape, dtype=bf16)
    print("  K2 B=48 N=577 times (ms): " + json.dumps(k2n_t))
    print("  K2 B=48 N=577 bound (k2_work): " + json.dumps(k2nw))
    gshape = dict(B=24, window=(24, 24), H=12)
    k2bw = k2_work(B=24, N=577, H=12, D=64, window=(24, 24), dtype=bf16)
    k2b_err = k2_parity(**gshape, dtype=bf16, seed=76)
    k2_parity(**gshape, dtype=f32, seed=77)
    k2_deterministic(**gshape, dtype=bf16, seed=78)
    k2b_t = k2_times(**gshape, dtype=bf16)
    print("  K2 B=24 N=577 times (ms): " + json.dumps(k2b_t))
    print("  K2 B=24 N=577 bound (k2_work): " + json.dumps(k2bw))
    k2g_err = k2_fwd_parity(8, bf16, seed=73)
    k2_fwd_parity(8, f32, seed=74)
    k2g_t = k2_fwd_times(8, bf16)
    k2gw = k2_work(B=8, N=577, H=12, D=64, window=(24, 24), dtype=bf16)
    print("  K2 B=8 N=577 forward times (ms): " + json.dumps(k2g_t))
    print("  K2 B=8 N=577 bound (k2_work): " + json.dumps(k2gw))
    t1 = time.perf_counter()
    gate_grad_parity()
    sp = nlvr_slice_parity()
    t2 = time.perf_counter()
    nt = full_nlvr_task()
    t3 = time.perf_counter()
    print("  nlvr and grounding tasks: " + json.dumps(nt))
    nprof = profile_step.profile_nlvr(os.path.join(
        REPO, "build", "xfm_tpu_torch", "profile_nlvr.json"))
    print(f"  phase 22 seconds: kernels {t1 - t0:.1f}, slice {t2 - t1:.1f}, "
          f"tasks {t3 - t2:.1f}, profiles {time.perf_counter() - t3:.1f}")
    want = {"nlvr_train": dict(relpos_attention_fwd=12,
                               relpos_attention_bwd=12),
            "grounding_train": dict(relpos_attention_fwd=12,
                                    relpos_attention_bwd=12),
            "gradcam": dict(relpos_attention_fwd=12)}
    for unit, r in nprof.items():
        top = r.pop("top")
        print(f"  {unit} profile: " + json.dumps(r))
        for name, ms, n in top[:10]:
            print(f"    {ms:9.3f} ms/call {n:6d} calls/call  {name}")
        if (r["launches"] != dict({k: 0 for k in r["launches"]},
                                  **want[unit])
                or r["max_memory_allocated"] >= 80e9
                or not math.isfinite(r.get("loss", r.get("cam_max")))):
            raise AssertionError(f"{unit}: launches, peak memory or loss")
    return ((k2n_err, k2n_t, k2nw), (k2b_err, k2b_t, k2bw),
            (k2g_err, k2g_t, k2gw), sp, nprof)


def nlvr_kernel_entries(k2n, k2b, k2g, nprof) -> list:
    """The `kernels` entries of phase 22: K2 at the NLVR step's shape (qkv
    [48, 577, 2304] bf16, forward and backward) with its launches a step
    (`profile_step nlvr_train`), at the grounding step's ([24, 577, 2304])
    with its launches a step (`grounding_train`), and K2's forward at the
    GradCAM batch ([8, 577, 2304]) with its launches a batch
    (`gradcam`)."""
    entries = []
    for (err, t, w), tag, unit in ((k2n, "nlvr_b48", "nlvr_train"),
                                   (k2b, "grounding_b24", "grounding_train")):
        entries += [dict(e, name=f"{e['name']}_{tag}")
                    for e in kernel_entries(
                        "relpos_attention", "xfm_tpu/ops/flash_attention.py",
                        689, 717, "xfm_tpu_torch/csrc/relpos_attention.cu",
                        err, ("dqkv", "dcr", "dcls"), t, w,
                        nprof[unit]["launches"])]
    err, t, w = k2g
    entries.append(dict(
        name="relpos_attention_fwd_gradcam_b8", route="cuda",
        source="xfm_tpu_torch/csrc/relpos_attention.cu",
        replaces="xfm_tpu/ops/flash_attention.py:689",
        launches=nprof["gradcam"]["launches"]["relpos_attention_fwd"],
        max_abs_err=err["out"][0], ms=t["fwd_ms"],
        plain_ms=t["plain_fwd_ms"], bound_ms=w["fwd"]["bound_ms"],
        bound_by=w["fwd"]["bound_by"], library_ms=t["library_fwd_ms"]))
    return entries


# --- phase 23: ImageNet, the linear probe, GLUE and classify -----------------

CLS_SAMPLED = {
    "image": ["vision_encoder.blocks.0.attn.qkv.weight",
              "vision_encoder.blocks.1.attn.relative_position_bias_table",
              "vision_encoder.patch_embed.proj.weight", "cls_head.0.weight",
              "cls_head.12.weight"],
    "text": ["text_encoder.roberta.encoder.layer.0.attention.self.query."
             "weight", "text_encoder.roberta.embeddings.word_embeddings."
             "weight", "cls_head.0.weight", "cls_head.3.weight"]}


def classify_slice_parity(B=2, T=128) -> None:
    """f32, full width, depth 2 (2 BEiT blocks at 224 px; 2 text layers at
    T = 128; the fused classifier with 2 fusion layers too), the full
    vocabulary and 1,000 labels, on the CPU and on the card from the same
    weights and inputs: the ImageNet fine-tune's soft-target CE (targets
    from `mixup_cutmix`) and sampled gradients; the linear probe's hard CE
    and the head's gradients, the tower's absent on both; one LARS step
    from them (the head's change); GLUE's CE (2 labels) and STS-B's MSE (1
    output) with sampled gradients; the fused classifier's logits. Losses
    within SLICE_LOSS_RTOL, logits of max(1, their largest value),
    gradients and the LARS step within SLICE_GRAD_RTOL of their max. On the
    card K1 runs 2 + 2 in the fine-tune's loss, 2 forward in the probe's
    and the fused logits, nothing in GLUE's."""
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.models import XFMForClassification, config_from_yaml
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks import imagenet
    from xfm_tpu_torch.train.checkpoint import init_weights
    from xfm_tpu_torch.train.optim import LARS, trained_parameters
    from xfm_tpu_torch.train.schedules import half_cosine

    f32 = dict(layers=2, compute_dtype="float32")
    fused_yaml = configs.glue_yaml(**f32, image_res=224, vision_depth=2,
                                   fusion_num_hidden_layers=2)
    specs = {  # name: (yaml, task_name, is_lp, num_labels, seed)
        "ft": (configs.imagenet_yaml(**f32), "imagenet", False, 1000, 1),
        "lp": (configs.imagenet_yaml(lp=True, **f32), "imagenet", True,
               1000, 1),
        "glue": (configs.glue_yaml(**f32), "glue", False, 2, 2),
        "stsb": (configs.glue_yaml(**f32), "glue", False, 1, 3),
        "fused": (fused_yaml, "fused", False, 2, 4)}
    r = np.random.RandomState(5)
    images = r.randn(B, 224, 224, 3).astype(np.float32)
    labels = r.randint(0, 1000, B)
    mixed, soft = imagenet.mixup_cutmix(np.random.default_rng(6), images,
                                        labels, 1000)
    ids, atts = configs._token_rows(r, B, T, 50265, 16)
    host = dict(images=images, mixed=mixed.astype(np.float32),
                soft=soft.astype(np.float32), labels=labels.astype(np.int64),
                ids=ids.astype(np.int64), atts=atts.astype(np.int64),
                glue=r.randint(0, 2, B).astype(np.int64),
                stsb=r.uniform(0, 5, B).astype(np.float32))
    res, launches = {}, {}
    for tag, dev in (("cpu", "cpu"), ("cuda", "cuda")):
        out = res[tag] = {}
        b = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        for name, (ycfg, task, is_lp, nl, seed) in specs.items():
            model = XFMForClassification(config_from_yaml(ycfg),
                                         num_labels=nl, task_name=task,
                                         is_lp=is_lp)
            init_weights(model, seed)
            model.to(dev)
            kernels.reset_launch_counts()
            if name == "fused":
                with torch.no_grad():
                    out["fused_logits"] = model.loss(
                        b["images"], b["ids"], b["atts"], train=False).cpu()
                launches[f"{tag}_{name}"] = dict(kernels.LAUNCHES)
                continue
            if name == "ft":
                loss = imagenet.soft_ce(model.loss(images=b["mixed"],
                                                   train=False), b["soft"])
            elif name == "lp":
                loss = model.loss(images=b["images"], targets=b["labels"])
            else:
                loss = model.loss(text_ids=b["ids"], text_atts=b["atts"],
                                  targets=b[name])
            loss.backward()
            launches[f"{tag}_{name}"] = dict(kernels.LAUNCHES)
            out[f"{name}_loss"] = loss.item()
            sampled = CLS_SAMPLED["text" if task == "glue" else "image"]
            out[f"{name}_grads"] = {
                k: p.grad.clone() for k, p in model.named_parameters()
                if k in sampled and p.grad is not None}
            if name == "lp":
                out["lp_tower_grads"] = sum(
                    p.grad is not None
                    for p in model.vision_encoder.parameters())
                head = dict(model.cls_head.named_parameters())
                before = {k: v.detach().clone() for k, v in head.items()}
                LARS(trained_parameters(model),
                     half_cosine(0.4, 1e-6, 50, 2, 4)).step()
                out["lars_step"] = {k: (head[k].detach() - before[k]).cpu()
                                    for k in ("0.weight", "12.weight",
                                              "12.bias")}
            del model
    c, g = res["cpu"], res["cuda"]
    print(f"  classify slice launches: "
          f"{json.dumps({k: v for k, v in launches.items() if 'cuda' in k})}")
    none = {k: 0 for k in launches["cuda_ft"]}
    fwd = dict(none, packed_attention_fwd=2)
    if (launches["cuda_ft"] != dict(fwd, packed_attention_bwd=2)
            or launches["cuda_lp"] != fwd or launches["cuda_fused"] != fwd
            or launches["cuda_glue"] != none
            or launches["cuda_stsb"] != none):
        raise AssertionError("classify slice: launches")
    for name in ("ft", "lp", "glue", "stsb"):
        ok = math.isclose(c[f"{name}_loss"], g[f"{name}_loss"],
                          rel_tol=SLICE_LOSS_RTOL)
        print(f"  slice {name} loss: cpu={c[f'{name}_loss']:.6f} "
              f"cuda={g[f'{name}_loss']:.6f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"classify slice: {name} loss")
        _grads_close(f"{name} slice", c[f"{name}_grads"],
                     g[f"{name}_grads"])
    if not (set(c["lp_grads"]) == set(g["lp_grads"]) == {
            "cls_head.0.weight", "cls_head.12.weight"}
            and c["lp_tower_grads"] == g["lp_tower_grads"] == 0):
        raise AssertionError("classify slice: the probe's tower took "
                             "gradients")
    _grads_close("LARS step", c["lars_step"], g["lars_step"])
    _close("slice fused logits", c["fused_logits"], g["fused_logits"],
           SLICE_LOSS_RTOL)
    torch.cuda.empty_cache()


def _classify_corpus(root, n_classes=8, per_class=16, n_val=32,
                     n_lp=512, n_glue=64, n_glue_val=16, n_cls=16,
                     n_cls_val=8, seed=0):
    """Seeded PNGs of 64-112 px a side in `n_classes` class folders
    (`per_class` each: the fine-tune's `train_root`), a JSONL manifest of
    `n_lp` rows over them (the probe's 512-image batch), `n_val` more PNGs
    for the val rows (their manifest is written by the caller), GLUE MRPC
    pairs (`n_glue` train, `n_glue_val` validation) and classify's image +
    text rows over the val PNGs → {train_root, lp_manifest, val_pngs,
    glue_train, glue_val, cls_train, cls_val, image_root}."""
    r = np.random.RandomState(seed)
    paths = {"train_root": os.path.join(root, "train"),
             "image_root": os.path.join(root, "val")}
    files = []
    for c in range(n_classes):
        d = os.path.join(paths["train_root"], f"n{c:08d}")
        os.makedirs(d)
        files += [(_png_file(os.path.join(d, f"{i}.png"), r, 64, 112), c)
                  for i in range(per_class)]
    paths["lp_manifest"] = os.path.join(root, "lp_train.jsonl")
    with open(paths["lp_manifest"], "w") as f:
        for i in range(n_lp):
            path, label = files[i % len(files)]
            f.write(json.dumps({"image": path, "label": label}) + "\n")
    os.makedirs(paths["image_root"])
    paths["val_pngs"] = [_png_file(os.path.join(paths["image_root"],
                                                f"{i}.png"), r, 64, 112)
                         for i in range(n_val)]

    def sentence():
        return " ".join(r.choice(NLVR_WORDS, r.randint(4, 14)))

    for key, n, row in (
            ("glue_train", n_glue, lambda i: {"sentence1": sentence(),
                                               "sentence2": sentence()}),
            ("glue_val", n_glue_val, lambda i: {"sentence1": sentence(),
                                                 "sentence2": sentence()}),
            ("cls_train", n_cls, lambda i: {"image": f"{i % n_val}.png",
                                             "text": sentence()}),
            ("cls_val", n_cls_val, lambda i: {
                "image": f"{(i + n_cls) % n_val}.png", "text": sentence()})):
        paths[key] = os.path.join(root, f"{key}.jsonl")
        with open(paths[key], "w") as f:
            for i in range(n):
                f.write(json.dumps(dict(row(i), label=int(r.randint(2))))
                        + "\n")
    return paths


def _initial_predictions(cfg, pngs, seed) -> list:
    """The class `run.main --task imagenet` with `--seed seed` predicts for
    each PNG before its first update (the model built, moved to the card
    and initialized as the task does, the eval transform, bf16)."""
    from xfm_tpu_torch.data.timm_aug import ImagenetEvalTransform
    from xfm_tpu_torch.data.transforms import decode_image
    from xfm_tpu_torch.models import XFMForClassification, config_from_yaml
    from xfm_tpu_torch.train.checkpoint import init_weights

    model = XFMForClassification(
        config_from_yaml(cfg), num_labels=cfg["num_labels"],
        task_name="imagenet", is_lp=cfg["is_lp"]).to("cuda")
    init_weights(model, seed)
    tf = ImagenetEvalTransform(cfg["image_res"])
    images = torch.from_numpy(np.stack([tf(decode_image(p)) for p in pngs]))
    with torch.no_grad():
        pred = model.loss(images=images.cuda(), train=False).argmax(-1)
    del model
    return pred.cpu().tolist()


def classify_task_runs(root, seed=0) -> dict:
    """Phase 23's runs of `run.main` in `root` over `_classify_corpus`:
    `--task imagenet` on `imagenet1k.yaml`'s keys (2 epochs of one
    128-image step), `--evaluate --checkpoint` from its checkpoint; on
    `imagenet1k_lp.yaml`'s (2 epochs of one 512-image step); `--task
    glue` on `glue_mrpc.yaml`'s with the JSONL files (2 epochs of 2 steps
    at its batch of 32, `resume: true`), the run again after ckpt/1 is
    deleted, `--evaluate --checkpoint`; `--task classify` on image + text
    rows at 224 px (the fused classifier, 12 layers a tower, 1 epoch of a
    16-row step). The val rows' labels are the classes the initial weights
    predict, so that the first eval (after a step at the warm-up's lr of
    0) scores 1 and writes a checkpoint. Each step, eval and epoch is
    recorded (seconds, launches, losses, peak memory), the probe's tower
    before and after each epoch, each checkpoint write (seconds), and the
    restored state against its file."""
    import yaml

    from xfm_tpu_torch import configs, run
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks import classify, glue, imagenet
    from xfm_tpu_torch.train.optim import LARS

    t0 = time.perf_counter()
    cp = _classify_corpus(root, seed=seed)
    pred = _initial_predictions(configs.IMAGENET, cp["val_pngs"], seed)
    val = os.path.join(root, "val.jsonl")
    with open(val, "w") as f:
        for path, label in zip(cp["val_pngs"], pred):
            f.write(json.dumps({"image": path, "label": label}) + "\n")
    runs = {"corpus_s": time.perf_counter() - t0, "val_labels": pred}
    cfgs = {
        "ft": dict(configs.IMAGENET, train_root=cp["train_root"],
                   val_root=val),
        "lp": dict(configs.IMAGENET_LP, train_root=cp["lp_manifest"],
                   val_root=val),
        "glue": dict(configs.GLUE_MRPC, train_file=cp["glue_train"],
                     validation_file=cp["glue_val"], num_train_epochs=2,
                     resume=True),
        "cls": dict(configs._FT_COMMON, image_res=224, num_labels=2,
                    train_file=cp["cls_train"], val_file=cp["cls_val"],
                    image_root=cp["image_root"], max_tokens=40,
                    batch_size=16),
    }
    cfgs["cls"]["schedular"] = dict(cfgs["cls"]["schedular"], epochs=1)
    for name, cfg in cfgs.items():
        with open(os.path.join(root, f"{name}.yaml"), "w") as f:
            yaml.safe_dump(cfg, f)
    real = dict(i_te=imagenet.train_epoch, g_te=glue.train_epoch,
                c_te=classify.train_epoch, i_ev=imagenet.evaluate,
                g_ev=glue.evaluate, c_ev=classify.evaluate,
                i_save=imagenet.save_checkpoint,
                g_save=glue.save_task_checkpoint,
                g_re=glue.maybe_resume_epochs)
    rec = {}

    def timed(kind, fn, *a, **kw):
        _sync()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        _sync()
        return res, dict(kind=kind, s=time.perf_counter() - t0,
                         launches=dict(kernels.LAUNCHES))

    def train_epoch(key):
        def wrapped(ctx, state, step_fn, loader, generator, epoch, sched,
                    **kw):
            def step(state, batch, gen):
                opt = state.optimizer  # LARS reads lr(count + 1)
                lr = opt.lr(opt.count + isinstance(opt, LARS))
                (state, m), e = timed("step", step_fn, state, batch, gen)
                e.update(loss=m["loss"].item(), lr=lr,
                         rows=int(next(iter(batch.values())).shape[0]))
                rec["steps"].append(e)
                return state, m

            model = state.model
            tower = (None if not getattr(model, "frozen_tower", False) else
                     [p.detach().clone()
                      for p in model.vision_encoder.parameters()])
            head = [p.detach().clone() for p in model.cls_head.parameters()]
            torch.cuda.reset_peak_memory_stats()
            state, stats = real[key](ctx, state, step, loader, generator,
                                     epoch, sched, **kw)
            e = dict(epoch=epoch,
                     max_memory_allocated=torch.cuda.max_memory_allocated(),
                     head_moved=any(not torch.equal(a, b) for a, b in zip(
                         head, model.cls_head.parameters())))
            if tower is not None:
                e["tower_bit_equal"] = all(torch.equal(a, b) for a, b in zip(
                    tower, model.vision_encoder.parameters()))
            rec["epochs"].append(e)
            return state, stats
        return wrapped

    def evaluate(key, batches_of):
        def wrapped(*a):
            res, e = timed("eval", real[key], *a)
            e.update(batches=batches_of(*a), **res)
            rec["evals"].append(e)
            return res
        return wrapped

    def saver(key):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            real[key](*a, **kw)
            rec["save_s"].append(time.perf_counter() - t0)
        return wrapped

    def maybe_resume_epochs(ctx, state):
        state, start = real["g_re"](ctx, state)
        if start:
            rec["restored"] = dict(start=start, bit_equal=_restored_bit_equal(
                os.path.join(ctx.out_dir, "ckpt", str(start - 1),
                             "state.pt"), state))
        return state, start

    def cls_evaluate(model, loader):
        n = [0]

        def counted():
            for b in loader:
                n[0] += 1
                yield b

        res, e = timed("eval", real["c_ev"], model, counted())
        e.update(batches=n[0], **res)
        rec["evals"].append(e)
        return res

    imagenet.train_epoch = train_epoch("i_te")
    glue.train_epoch = train_epoch("g_te")
    classify.train_epoch = train_epoch("c_te")
    imagenet.evaluate = evaluate("i_ev", lambda m, rows, tf, root, bs:
                                 -(-len(rows) // bs))
    glue.evaluate = evaluate("g_ev", lambda m, ex, tok, task, bs:
                             -(-len(ex) // bs))
    classify.evaluate = cls_evaluate
    imagenet.save_checkpoint = saver("i_save")
    glue.save_task_checkpoint = saver("g_save")
    glue.maybe_resume_epochs = maybe_resume_epochs
    out = {n: os.path.join(root, f"out_{n}") for n in cfgs}
    seed_arg = ["--seed", str(seed)]
    try:
        for name, argv in (
                ("ft", ["--task", "imagenet", "--config", "ft", "--epoch",
                        "2"]),
                ("ft_evaluate", ["--task", "imagenet", "--config", "ft",
                                 "--evaluate", "--checkpoint",
                                 os.path.join(out["ft"], "ckpt", "0",
                                              "state.pt")]),
                ("lp", ["--task", "imagenet", "--config", "lp", "--epoch",
                        "2"]),
                ("glue", ["--task", "glue", "--config", "glue"]),
                ("glue_resumed", ["--task", "glue", "--config", "glue"]),
                ("glue_evaluate", ["--task", "glue", "--config", "glue",
                                   "--evaluate", "--checkpoint",
                                   os.path.join(out["glue"], "ckpt", "1",
                                                "state.pt")]),
                ("cls", ["--task", "classify", "--config", "cls"])):
            key = argv[argv.index("--config") + 1]
            argv = list(argv)
            argv[argv.index("--config") + 1] = os.path.join(root,
                                                            f"{key}.yaml")
            o = out[key] + ("_ev" if name.endswith("evaluate") else "")
            if name == "glue_resumed":
                runs["glue_layout"] = sorted(os.listdir(os.path.join(
                    out["glue"], "ckpt")))
                runs["glue_best"] = sorted(os.listdir(os.path.join(
                    out["glue"], "ckpt_best")))
                shutil.rmtree(os.path.join(out["glue"], "ckpt", "1"))
            if name == "lp":  # the fine-tune's checkpoints are done with
                runs["ft_layout"] = sorted(os.listdir(os.path.join(
                    out["ft"], "ckpt")))
                shutil.rmtree(out["ft"])
            rec = dict(evals=[], steps=[], epochs=[], save_s=[])
            t0 = time.perf_counter()
            rec["result"] = run.main(argv + ["--output_dir", o] + seed_arg)
            rec["s"] = time.perf_counter() - t0
            if name == "lp":
                runs["lp_layout"] = sorted(os.listdir(os.path.join(
                    out["lp"], "ckpt")))
                shutil.rmtree(out["lp"])
            runs[name] = rec
    finally:
        imagenet.train_epoch, glue.train_epoch = real["i_te"], real["g_te"]
        classify.train_epoch = real["c_te"]
        imagenet.evaluate, glue.evaluate = real["i_ev"], real["g_ev"]
        classify.evaluate = real["c_ev"]
        imagenet.save_checkpoint = real["i_save"]
        glue.save_task_checkpoint = real["g_save"]
        glue.maybe_resume_epochs = real["g_re"]
    return runs


def full_classify_task(seed=0) -> dict:
    """Phase 23's task runs at full width on the card, checked: finite
    losses; K1 12 + 12 a fine-tune step (ImageNet, classify), 12 a probe
    step and an eval batch of the image classifiers, and nothing at all
    (no K1, K2 or K3) in a GLUE step or eval batch; the rows of each step
    (128, 512, 32, 16); a checkpoint for each epoch whose top-1 improved,
    the fine-tune's first top-1 1.0 and `--evaluate` from its checkpoint
    giving 1.0; the probe's tower
    bit-equal across each epoch while its head moved; the GLUE
    checkpoints and ckpt_best, the resume bit-equal to its file and its
    first loss to the first run's, `--evaluate` giving the last epoch's
    metrics; accuracies in [0, 1]; peak memory under 80 GB. The directory
    is deleted at the end."""
    import tempfile

    root = tempfile.mkdtemp(prefix="xfm_classify_")
    try:
        runs = classify_task_runs(root, seed=seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    names = list(runs["ft"]["steps"][0]["launches"])
    none = {n: 0 for n in names}
    k1 = dict(none, packed_attention_fwd=12)
    want_step = {"ft": dict(k1, packed_attention_bwd=12), "lp": k1,
                 "glue": none, "glue_resumed": none,
                 "cls": dict(k1, packed_attention_bwd=12)}
    want_rows = {"ft": 128, "lp": 512, "glue": 32, "glue_resumed": 32,
                 "cls": 16}
    for name in ("ft", "ft_evaluate", "lp", "glue", "glue_resumed",
                 "glue_evaluate", "cls"):
        r = runs[name]
        print(f"  {name}: {r['s']:.1f} s ({sum(r['save_s']):.1f} s in "
              f"{len(r['save_s'])} checkpoint writes), result "
              f"{json.dumps(r['result'])}")
        for e in r["steps"]:
            print(f"    step {e['s']:.3f} s {e['rows']} rows loss "
                  f"{e['loss']:.4f} lr {e['lr']:.3g} launches "
                  f"{json.dumps(e['launches'])}")
            if (e["launches"] != want_step[name] or e["rows"] !=
                    want_rows[name] or not math.isfinite(e["loss"])):
                raise AssertionError(f"{name}: a step's launches, rows or "
                                     f"loss")
        for e in r["evals"]:
            acc = {k: v for k, v in e.items()
                   if k in ("acc1", "acc", "accuracy", "f1")}
            print(f"    eval {e['batches']} batches {e['s']:.3f} s "
                  f"{json.dumps(acc)} launches {json.dumps(e['launches'])}")
            per = none if name.startswith("glue") else k1
            want = {k: v * e["batches"] for k, v in per.items()}
            if e["launches"] != want or not all(
                    0 <= v <= 1 for v in acc.values()):
                raise AssertionError(f"{name}: an eval's launches or "
                                     f"accuracy")
        for e in r["epochs"]:
            print(f"    epoch {json.dumps(e)}")
            if (e["max_memory_allocated"] >= 80e9
                    or e.get("tower_bit_equal") is False):
                raise AssertionError(f"{name}: peak memory or the tower")
    ft, lp, gl, gr = (runs[n] for n in ("ft", "lp", "glue", "glue_resumed"))
    spe = len(gl["steps"]) // 2
    print(f"  corpora {runs['corpus_s']:.1f} s; val labels (the initial "
          f"predictions) {runs['val_labels'][:8]}...; checkpoints: ft "
          f"{runs['ft_layout']}, lp {runs['lp_layout']}, glue "
          f"{runs['glue_layout']} best {runs['glue_best']}; resume "
          f"{json.dumps(gr.get('restored', {}))}")
    def improved(evals):  # the epochs whose top-1 beat every earlier one
        best, out = 0.0, []
        for i, e in enumerate(evals):
            if e["acc1"] > best:
                best, out = e["acc1"], out + [str(i)]
        return out

    if (len(ft["steps"]) != 2 or len(lp["steps"]) != 2
            or ft["evals"][0]["acc1"] != 1.0
            or runs["ft_layout"] != improved(ft["evals"]) != []
            or runs["lp_layout"] != improved(lp["evals"])
            or runs["ft_evaluate"]["result"] != {"acc1": 1.0}
            or [e.get("tower_bit_equal") for e in lp["epochs"]]
            != [True, True] or not lp["epochs"][-1]["head_moved"]
            or runs["glue_layout"] != ["0", "1"]
            or len(runs["glue_best"]) != 1
            or not gr.get("restored", {}).get("bit_equal")
            or gr["steps"][0]["loss"] != gl["steps"][spe]["loss"]
            or gr["steps"][0]["lr"] != gl["steps"][spe]["lr"]
            or len(gr["steps"]) != spe or len(gl["evals"]) != 2
            or gr["result"] != gl["result"]
            or runs["glue_evaluate"]["result"] != gl["result"]
            or len(runs["cls"]["steps"]) != 1):
        raise AssertionError("the classification runs' checkpoints, "
                             "resume, probe or evals")
    return dict(
        ft_step_s=[e["s"] for e in ft["steps"]],
        lp_step_s=[e["s"] for e in lp["steps"]],
        glue_step_s=[e["s"] for e in gl["steps"]],
        cls_step_s=[e["s"] for e in runs["cls"]["steps"]],
        eval_s={n: [e["s"] for e in runs[n]["evals"]]
                for n in ("ft", "lp", "glue", "cls")},
        run_s={n: runs[n]["s"] for n in (
            "ft", "ft_evaluate", "lp", "glue", "glue_resumed",
            "glue_evaluate", "cls")},
        save_s={n: runs[n]["save_s"] for n in ("ft", "lp", "glue",
                                               "glue_resumed")},
        corpus_s=runs["corpus_s"],
        max_memory_allocated={n: max(e["max_memory_allocated"]
                                     for e in runs[n]["epochs"])
                              for n in ("ft", "lp", "glue", "cls")},
        results={n: runs[n]["result"] for n in ("ft", "lp", "glue", "cls")})


def classify_phase():
    """Phase 23 → (K1's errors, times and bounds at qkv [128, 197, 2304]
    (forward and backward) and [512, 197, 2304] (forward),
    `profile_step.profile_classify`'s units)."""
    from xfm_tpu_torch import profile_step

    bf16, f32 = torch.bfloat16, torch.float32
    t0 = time.perf_counter()
    k1 = {}
    for B, seeds in ((128, (80, 81, 82)), (512, (83, 84, 85))):
        err = k1_parity(B=B, N=197, H=12, dtype=bf16, seed=seeds[0])
        k1_parity(B=B, N=197, H=12, dtype=f32, seed=seeds[1])
        k1_deterministic(B=B, N=197, H=12, dtype=bf16, seed=seeds[2])
        t = k1_times(B=B, N=197, H=12, dtype=bf16)
        w = k1_work(B=B, N=197, H=12, D=64, dtype=bf16)
        print(f"  K1 B={B} N=197 times (ms): " + json.dumps(t))
        print(f"  K1 B={B} N=197 bound (k1_work): " + json.dumps(w))
        k1[B] = (err, t, w)
    t1 = time.perf_counter()
    classify_slice_parity()
    t2 = time.perf_counter()
    ct = full_classify_task()
    t3 = time.perf_counter()
    print("  classification tasks: " + json.dumps(ct))
    cprof = profile_step.profile_classify(os.path.join(
        REPO, "build", "xfm_tpu_torch", "profile_classify.json"))
    print(f"  phase 23 seconds: kernels {t1 - t0:.1f}, slice {t2 - t1:.1f}, "
          f"tasks {t3 - t2:.1f}, profiles {time.perf_counter() - t3:.1f}")
    want = {"imagenet_train": dict(packed_attention_fwd=12,
                                   packed_attention_bwd=12),
            "imagenet_lp": dict(packed_attention_fwd=12),
            "glue_train": {}}
    for unit, r in cprof.items():
        top = r.pop("top")
        print(f"  {unit} profile: " + json.dumps(r))
        for name, ms, n in top[:10]:
            print(f"    {ms:9.3f} ms/call {n:6d} calls/call  {name}")
        if (r["launches"] != dict({k: 0 for k in r["launches"]},
                                  **want[unit])
                or r["max_memory_allocated"] >= 80e9
                or not math.isfinite(r["loss"])):
            raise AssertionError(f"{unit}: launches, peak memory or loss")
    return k1[128], k1[512], cprof


def classify_kernel_entries(k1ft, k1lp, cprof) -> list:
    """The `kernels` entries of phase 23: K1 at the ImageNet fine-tune
    step's shape (qkv [128, 197, 2304] bf16, forward and backward) with
    its launches a step (`profile_step imagenet_train`), and K1's forward
    at the linear probe's ([512, 197, 2304]) with its launches a step
    (`imagenet_lp`)."""
    entries = [dict(e, name=e["name"] + "_imagenet_b128")
               for e in kernel_entries(
                   "packed_attention", "xfm_tpu/ops/flash_attention.py",
                   983, 1007, "xfm_tpu_torch/csrc/packed_attention.cu",
                   k1ft[0], ("dqkv", "db"), k1ft[1], k1ft[2],
                   cprof["imagenet_train"]["launches"])]
    entries += [dict(e, name=e["name"] + "_imagenet_lp_b512")
                for e in kernel_entries(
                    "packed_attention", "xfm_tpu/ops/flash_attention.py",
                    983, 1007, "xfm_tpu_torch/csrc/packed_attention.cu",
                    k1lp[0], ("dqkv", "db"), k1lp[1], k1lp[2],
                    cprof["imagenet_lp"]["launches"])
                if e["name"].endswith("_fwd")]
    return entries


# --- phase 24: the pretrain task's optional branches ------------------------

# phase-24 near-tie rule: a code id of the tokenizer may differ between the
# card and the CPU only where the CPU's two smallest f32 distances to the
# codebook are this close (argmin over f32 sums in other orders)
CODE_TIE_ATOL = 1e-5
# phase-24 bound for gradients kept in bf16 (bf16 parameters): the f32
# bound plus one bf16 rounding of each side at the tensor's largest value
BF16_GRAD_RTOL = SLICE_GRAD_RTOL + 2.0 ** -8
# phase-24 bound for the losses of the 2nd and 3rd master-weight steps: the
# first update's elements of near-zero gradient take Adam's ±lr either way
# on the two devices, so later losses move apart by more than f32's noise
MASTER_LOSS_RTOL = 1e-3


def _code_ids_close(tag, vq_cpu, z_cpu, ids_cpu, ids_gpu) -> int:
    """The card's code ids against the CPU's under the near-tie rule →
    how many differ; raise where one differs away from a near-tie."""
    from xfm_tpu_torch.models.vqkd import l2norm

    cb = vq_cpu.quantize.embedding.weight
    flat = l2norm(z_cpu.float()).reshape(-1, cb.shape[1])
    d = ((flat ** 2).sum(-1, keepdim=True) - 2 * flat @ cb.T
         + (cb ** 2).sum(-1)[None])
    two = d.topk(2, dim=-1, largest=False).values
    gap = two[:, 1] - two[:, 0]
    differ = ids_cpu.reshape(-1) != ids_gpu.cpu().reshape(-1)
    bad = differ & (gap > CODE_TIE_ATOL)
    print(f"  {tag}: {int(differ.sum())} of {differ.numel()} ids differ, "
          f"{int(bad.sum())} away from a near-tie (gap > {CODE_TIE_ATOL})")
    if bad.any():
        raise AssertionError(f"{tag}: code ids")
    return int(differ.sum())


def _vqkd_slice_model(**vision):
    """XFM-base at depth 2, f32, with the tokenizer's code head (8,192
    codes) and the vision config's `vision` fields."""
    import dataclasses

    from xfm_tpu_torch import configs

    cfg = configs.xfm_base_pretrain_config(layers=2, dtype=torch.float32)
    return dataclasses.replace(
        cfg, use_vision_tokenizer=True, codebook_size=8192,
        vision=dataclasses.replace(cfg.vision, **vision))


def vqkd_slice_parity(B=4) -> dict:
    """f32, full width, depth 2, CPU vs card: the tokenizer's projections
    and code ids (near-tie rule); the pretrain streams with MIM's CE and
    region attention in the last block (losses, sampled gradients; K1 2 + 2
    in the image and ImageNet streams, 1 + 1 in the region stream); the
    shared rel-pos table through K1 (tower outputs and gradients, K1 2 + 2);
    CLIP-ViT's region mode in both forms; one VQ-KD training step with the
    CLIP teacher from injected k-means means (losses, the EMA's codebook,
    sampled gradients); three steps of HF-AdamW under master weights; the
    fused route (K4, K5) under bf16 parameters. → {check: ids differing}."""
    import copy
    import dataclasses

    from xfm_tpu_torch import configs
    from xfm_tpu_torch.models import XFMForPretrain
    from xfm_tpu_torch.models.beit2 import (BeitVisionTransformer,
                                            VisionConfig)
    from xfm_tpu_torch.models.clip_vit import (ClipVisionConfig,
                                               ClipVisionTransformer)
    from xfm_tpu_torch.models.task_models import LOSS_KEYS
    from xfm_tpu_torch.models.teachers import CLIPTeacher, teacher_features
    from xfm_tpu_torch.models.vqkd import (VQKD, kmeans_init_vq_stats,
                                           l2norm, vqkd_config_from_yaml)
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks.pretrain import frozen_tokenizer, stream_flags
    from xfm_tpu_torch.train.optim import HFAdamW, with_master_weights

    out = {}
    yaml_cfg = configs.pretrain_yaml(**configs.PRETRAIN_VQKD_KEYS)
    sizes = dict(configs.stream_batch_sizes(yaml_cfg), image=B, imagenet=B,
                 regions=B, max_images=B + 2, text=B)
    nb = configs.make_stream_batches(sizes, 224, 50265, seed=24)
    # the tokenizer at depth 2: projections, code ids
    vq_cpu, _ = frozen_tokenizer(dict(configs.PRETRAIN_VQKD_KEYS,
                                      tokenizer_depth=2), "cpu")
    vq_gpu = copy.deepcopy(vq_cpu).to("cuda")
    images = torch.from_numpy(nb["image"]["images"])
    with torch.no_grad():
        zc, zg = vq_cpu._encode_z(images), vq_gpu._encode_z(images.cuda())
        idc = vq_cpu.quantize.indices(zc)
        idg = vq_gpu.quantize.indices(zg)
    _close("tokenizer z", zc, zg, SLICE_LOSS_RTOL)
    out["tokenizer_ids"] = _code_ids_close("tokenizer ids", vq_cpu, zc, idc,
                                           idg)
    codes = {"image": idc}
    with torch.no_grad():
        codes["imagenet"] = vq_cpu.get_codebook_indices(
            torch.from_numpy(nb["imagenet"]["images"]))
    del vq_cpu, vq_gpu

    # the pretrain streams: MIM's CE, region attention in the last block
    cfg = _vqkd_slice_model(local_attn_depth=1)
    cpu = build_model(XFMForPretrain, cfg, "cpu", seed=3)
    gpu = copy.deepcopy(cpu).to("cuda")
    sample = {"lm_head.weight": ("image", "imagenet"),
              "vision_encoder.blocks.0.attn.qkv.weight": ("image", "region",
                                                          "imagenet"),
              "vision_encoder.blocks.1.attn.relative_position_bias_table":
                  ("image", "region", "imagenet"),
              "vision_encoder.blocks.1.mlp.fc2.weight": ("region",),
              "fusion_encoder.roberta.encoder.layer.1.crossattention.self."
              "key.weight": ("image", "region"),
              "bbox_head.3.weight": ("region",)}
    want_k1 = {"image": 2, "imagenet": 2, "region": 1}
    for name in ("image", "region", "imagenet"):
        flags = stream_flags(name, 0, yaml_cfg)
        res = {}
        for tag, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
            model.zero_grad(set_to_none=True)
            batch = configs.batch_to_torch(nb[name], dev)
            if name in codes:
                batch["vqkd_code_ids"] = codes[name].to(dev)
            n = batch["images"].shape[0] if name != "region" else B
            neg = (torch.roll(torch.arange(n, device=dev), 1),
                   torch.roll(torch.arange(n, device=dev), 2))
            kernels.reset_launch_counts()
            o = model.loss(**batch, **flags, hard_negatives=neg)
            sum(o[k] for k in LOSS_KEYS).backward()
            res[tag] = ({k: v.item() for k, v in o.items()},
                        dict(model.named_parameters()),
                        dict(kernels.LAUNCHES))
        (lc, pc, _), (lg, pg, launches) = res["cpu"], res["cuda"]
        k1 = want_k1[name]
        print(f"  vqkd slice {name} launches {json.dumps(launches)}")
        if launches != dict({k: 0 for k in launches},
                            packed_attention_fwd=k1, packed_attention_bwd=k1):
            raise AssertionError(f"vqkd slice {name}: launches")
        for k in LOSS_KEYS:
            ok = math.isclose(lc[k], lg[k], rel_tol=SLICE_LOSS_RTOL,
                              abs_tol=1e-7)
            print(f"  vqkd slice {name} {k}: cpu={lc[k]:.6f} "
                  f"cuda={lg[k]:.6f} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"vqkd slice {name}: {k}")
        _grads_close(f"vqkd slice {name}",
                     {n: pc[n].grad for n, s in sample.items() if name in s},
                     {n: pg[n].grad for n, s in sample.items() if name in s})
    del cpu, gpu

    # the shared table through K1 (a tower with per-block tables too)
    vcfg = VisionConfig(image_res=224, depth=2, drop_path_rate=0.0,
                        use_shared_rel_pos_bias=True)
    cpu = build_model(BeitVisionTransformer, vcfg, "cpu", seed=5)
    with torch.no_grad():
        t = cpu.rel_pos_bias.relative_position_bias_table
        t.copy_(torch.randn(t.shape, generator=torch.Generator()
                            .manual_seed(6)))
    gpu = copy.deepcopy(cpu).to("cuda")
    g = torch.randn(B, 197, 768, generator=torch.Generator().manual_seed(7))
    grads = {}
    for tag, m, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        kernels.reset_launch_counts()
        y = m(images.to(dev))
        (y * g.to(dev)).sum().backward()
        grads[tag] = (y.detach(), {n: p.grad for n, p in
                                   m.named_parameters()})
        launches = dict(kernels.LAUNCHES)
    print(f"  shared table launches {json.dumps(launches)}")
    if (launches["packed_attention_fwd"], launches["packed_attention_bwd"]) \
            != (2, 2):
        raise AssertionError("shared table: K1 launches")
    _close("shared table tower out", grads["cpu"][0], grads["cuda"][0],
           SLICE_LOSS_RTOL)
    _grads_close("shared table", {n: grads["cpu"][1][n] for n in (
        "rel_pos_bias.relative_position_bias_table",
        "blocks.1.attn.relative_position_bias_table",
        "blocks.0.attn.qkv.weight")}, {n: grads["cuda"][1][n] for n in (
            "rel_pos_bias.relative_position_bias_table",
            "blocks.1.attn.relative_position_bias_table",
            "blocks.0.attn.qkv.weight")})
    del cpu, gpu

    # CLIP-ViT region mode, both forms
    reg = nb["region"]
    gen = torch.Generator().manual_seed(16)
    n_img = reg["images"].shape[0]
    g_r = torch.randn(len(reg["idx_to_group_img"]), 197, 768, generator=gen)
    g_f = torch.randn(n_img, 197, 768, generator=gen)
    for local in (1, 0):
        ccfg = ClipVisionConfig(image_res=224, num_hidden_layers=2,
                                local_attn_depth=local)
        cpu = build_model(ClipVisionTransformer, ccfg, "cpu", seed=8)
        gpu = copy.deepcopy(cpu).to("cuda")
        outs = {}
        for tag, m, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
            r_, f_ = m(torch.from_numpy(reg["images"]).to(dev),
                       idx_to_group_img=torch.from_numpy(
                           reg["idx_to_group_img"]).to(dev),
                       image_atts=torch.from_numpy(reg["image_atts"]).to(dev))
            ((r_ * g_r.to(dev)).sum() + (f_ * g_f.to(dev)).sum()).backward()
            outs[tag] = (r_.detach(), f_.detach(),
                         {n: p.grad for n, p in m.named_parameters()})
        _close(f"clip region local={local} rows", outs["cpu"][0],
               outs["cuda"][0], SLICE_LOSS_RTOL)
        _close(f"clip region local={local} image rows", outs["cpu"][1],
               outs["cuda"][1], SLICE_LOSS_RTOL)
        names = ("encoder.layers.1.self_attn.q_proj.weight",
                 "encoder.layers.0.mlp.fc1.weight")
        _grads_close(f"clip region local={local}",
                     {n: outs["cpu"][2][n] for n in names},
                     {n: outs["cuda"][2][n] for n in names})
        del cpu, gpu

    # one VQ-KD training step with the CLIP teacher, from injected means
    vq_cfg = vqkd_config_from_yaml({
        "tokenizer_model": "vqkd_encoder_base_decoder_1x768x12_clip",
        "tokenizer_depth": 2, "codebook_size": 512, "codebook_dim": 32})
    vq_cpu = build_model(VQKD, vq_cfg, "cpu", seed=9)
    teacher = build_model(CLIPTeacher, ClipVisionConfig(num_hidden_layers=2),
                          "cpu", seed=10)
    with torch.no_grad():
        z = vq_cpu._encode_z(images)
        gen = torch.Generator().manual_seed(11)
        flat = l2norm(z.reshape(-1, 32))
        means0 = flat[torch.randperm(flat.shape[0], generator=gen)[:512]]
        vq_cpu.load_vq_stats(kmeans_init_vq_stats(gen, z, 512,
                                                  means=means0))
    vq_gpu = copy.deepcopy(vq_cpu).to("cuda")
    teacher_gpu = copy.deepcopy(teacher).to("cuda")
    res = {}
    for tag, m, t, dev in (("cpu", vq_cpu, teacher, "cpu"),
                           ("cuda", vq_gpu, teacher_gpu, "cuda")):
        feats = teacher_features(t, images.to(dev))
        loss, aux = m(images.to(dev), feats)
        loss.backward()
        res[tag] = (feats, {k: v.detach() for k, v in aux.items()},
                    dict(m.named_parameters()),
                    m.quantize.embedding.weight.detach().clone())
    (fc, ac, pc, cbc), (fg, ag, pg, cbg) = res["cpu"], res["cuda"]
    _close("clip teacher features", fc, fg, SLICE_LOSS_RTOL)
    for k in ("rec_loss", "vq_loss"):
        if not math.isclose(ac[k].item(), ag[k].item(),
                            rel_tol=SLICE_LOSS_RTOL, abs_tol=1e-7):
            raise AssertionError(f"vqkd step {k}")
        print(f"  vqkd step {k}: cpu={ac[k].item():.6f} "
              f"cuda={ag[k].item():.6f} ok")
    n_diff = _code_ids_close("vqkd step ids", vq_cpu, z, ac["ids"],
                             ag["ids"])
    out["vqkd_step_ids"] = n_diff
    differ = ac["ids"].reshape(-1) != ag["ids"].cpu().reshape(-1)
    moved = set(ac["ids"].reshape(-1)[differ].tolist()) | set(
        ag["ids"].cpu().reshape(-1)[differ].tolist())
    keep = torch.tensor([i not in moved for i in range(512)])
    _close("vqkd step EMA codebook", cbc[keep], cbg[keep], SLICE_LOSS_RTOL)
    _grads_close("vqkd step", {n: pc[n].grad for n in (
        "encoder.blocks.0.attn.qkv.weight", "decoder.blocks.0.mlp.fc1.weight",
        "decode_task_layer.2.weight", "encode_task_layer.0.weight")},
        {n: pg[n].grad for n in (
            "encoder.blocks.0.attn.qkv.weight",
            "decoder.blocks.0.mlp.fc1.weight", "decode_task_layer.2.weight",
            "encode_task_layer.0.weight")})
    del vq_cpu, vq_gpu, teacher, teacher_gpu

    # three HF-AdamW steps under master weights (bf16 parameters, f32
    # compute), then the fused route (K4, K5) under bf16 parameters
    for fused in (False, True):
        mcfg = _vqkd_slice_model()
        if fused:
            mcfg = dataclasses.replace(
                mcfg, vision=dataclasses.replace(mcfg.vision, fused_ln=True,
                                                 fused_mlp=True))
        cpu = build_model(XFMForPretrain, mcfg, "cpu", seed=12)
        gpu = copy.deepcopy(cpu).to("cuda")
        flags = stream_flags("image", 0, yaml_cfg)
        res = {}
        for tag, m, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
            opt = with_master_weights(
                list(m.named_parameters()),
                lambda named: HFAdamW(named, 1e-4, weight_decay=0.01,
                                      lr_mult=2.0))
            with torch.no_grad():
                for p in m.parameters():
                    p.data = p.data.to(torch.bfloat16)
            batch = configs.batch_to_torch(nb["image"], dev)
            batch["vqkd_code_ids"] = codes["image"].to(dev)
            neg = (torch.tensor([1, 2, 3, 0], device=dev),
                   torch.tensor([2, 3, 0, 1], device=dev))
            losses, launches = [], []
            for _ in range(1 if fused else 3):
                m.zero_grad(set_to_none=True)
                kernels.reset_launch_counts()
                o = m.loss(**batch, **flags, hard_negatives=neg)
                total = sum(o[k] for k in LOSS_KEYS)
                total.backward()
                launches.append(dict(kernels.LAUNCHES))
                losses.append(total.item())
                grads = {n: p.grad.detach().clone()
                         for n, p in m.named_parameters()
                         if p.grad is not None}
                if not fused:
                    opt.step()
            for p, mm in zip(opt.params, opt.masters):
                if p.dtype != torch.bfloat16 or mm.dtype != torch.float32 \
                        or not torch.equal(p.detach(),
                                           mm.to(torch.bfloat16)):
                    raise AssertionError("master weights: live != master")
            res[tag] = (losses, grads, launches[-1])
        (lc, gc, _), (lg, gg, launches) = res["cpu"], res["cuda"]
        tag = "bf16 params fused" if fused else "master weights"
        print(f"  {tag} losses cpu={lc} cuda={lg}; launches "
              f"{json.dumps(launches)}")
        for i, (a, b) in enumerate(zip(lc, lg)):
            rtol = SLICE_LOSS_RTOL if i == 0 else MASTER_LOSS_RTOL
            if not math.isclose(a, b, rel_tol=rtol):
                raise AssertionError(f"{tag}: loss of step {i}")
        if fused and not (launches["fused_ln_fwd"] and launches[
                "fused_ln_bwd"] and launches["fused_mlp_fwd"]
                and launches["fused_mlp_bwd"]):
            raise AssertionError("bf16 params fused: K4/K5 launches")
        if fused:
            for n in ("vision_encoder.blocks.0.norm2.weight",
                      "vision_encoder.blocks.1.mlp.fc2.weight",
                      "vision_encoder.blocks.0.attn.qkv.weight"):
                a, b = gc[n].float(), gg[n].float().cpu()
                err = (a - b).abs().max().item()
                tol = BF16_GRAD_RTOL * a.abs().max().item()
                print(f"  {tag} grad {n} ({gg[n].dtype}): max_abs_err="
                      f"{err:.3e} tol={tol:.3e}")
                if not err <= tol:
                    raise AssertionError(f"{tag}: grad {n}")
        del cpu, gpu
    torch.cuda.empty_cache()
    return out


class _Tee:
    """stdout copied into a list of lines as it is written."""

    def __init__(self, stream):
        self.stream, self.lines = stream, []

    def write(self, s):
        self.lines.append(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def _state_equal(a, b) -> bool:
    """Nested dicts of tensors and numbers, bit for bit."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_state_equal(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b.to(a.device))
    return a == b


def vqkd_task_runs(root, bs=24, steps=3, ckpt_every=2) -> dict:
    """`run.main` for `--task pretrain_DIY` on `Pretrain_base_4m.yaml`'s
    keys with `configs.PRETRAIN_VQKD_KEYS`, `bf16_params` and
    `bench_redispatch: 2` over `_pretrain_corpus` (trimmed), `--bs`, with
    `max_steps` `steps` and `ckpt_frequent_step` `ckpt_every`, `resume:
    true`; then the newest checkpoint deleted and the command again. Each
    step's seconds, launches by stream and losses are recorded, the
    restored state (parameters, masters, moments, count) against the file
    it came from, the printed lines."""
    import yaml

    from xfm_tpu_torch import configs, run
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks import pretrain

    files = _pretrain_corpus(root, n_pairs=24, n_regions=12, n_texts=48)
    cfg = {k: v for k, v in configs.pretrain_yaml().items()
           if not k.startswith("_")}
    cfg.update(configs.PRETRAIN_VQKD_KEYS, bf16_params=True,
               bench_redispatch=2, train_file=[files["pairs"]],
               train_file_regions=[files["regions"]],
               train_file_imagenet=[files["imagenet"]],
               train_file_text=[files["texts"]], max_steps=steps,
               ckpt_frequent_step=ckpt_every, print_freq=1, resume=True)
    cfg_path = os.path.join(root, "pt_vqkd.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = os.path.join(root, "out")
    argv = ["--task", "pretrain_DIY", "--config", cfg_path, "--output_dir",
            out, "--bs", str(bs), "--device", "cuda"]
    real_loss_fn, real_resume = pretrain.stream_loss_fn, \
        pretrain.restore_latest
    rec = {}

    def stream_loss_fn(*a, **k):
        loss_fn = real_loss_fn(*a, **k)

        def counted(model, name, batch, generator):
            # the step runs each stream's forward and then its backward
            # before the next stream's loss: the counts read here are the
            # previous stream's whole
            if rec.get("pending"):
                rec["by_stream"].append((rec["pending"],
                                         dict(kernels.LAUNCHES)))
            kernels.reset_launch_counts()
            rec["pending"] = name
            return loss_fn(model, name, batch, generator)

        return counted

    def restore_latest(ctx, state):
        state, step = real_resume(ctx, state)
        if step is not None:
            saved = torch.load(os.path.join(out, "ckpt", str(step),
                                            "state.pt"),
                               map_location="cuda", weights_only=True)
            opt = state.optimizer
            equal = state.step == saved["step"] and _state_equal(
                opt.state_dict(), saved["optimizer"])
            for name, p in zip(opt.names, opt.params):
                equal &= torch.equal(p, saved["params"][name])
            rec["restored"] = dict(
                step=step, bit_equal=bool(equal), count=opt.count,
                live=sorted({str(p.dtype) for p in opt.params}),
                masters=sorted({str(t.dtype) for t in
                                opt.state_dict()["master"].values()}))
            del saved
        return state, step

    runs = {}
    real_step = pretrain.make_stream_step

    def make_stream_step(loss_fn):
        step_fn = real_step(loss_fn)

        def step(state, batches, gens):
            _sync()
            t0 = time.perf_counter()
            rec.update(by_stream=[], pending=None)
            state, metrics = step_fn(state, batches, gens)
            vals = {k: v.item() for k, v in metrics.items()}
            rec["by_stream"].append((rec.pop("pending"),
                                     dict(kernels.LAUNCHES)))
            rec["steps"].append(dict(s=time.perf_counter() - t0,
                                     by_stream=rec.pop("by_stream"),
                                     losses=vals))
            return state, metrics

        return step

    pretrain.make_stream_step = make_stream_step
    pretrain.restore_latest = restore_latest
    pretrain.stream_loss_fn = stream_loss_fn
    tee = _Tee(sys.stdout)
    try:
        for name in ("full", "resumed"):
            if name == "resumed":
                runs["layout"] = sorted(os.listdir(os.path.join(out,
                                                                "ckpt")))
                shutil.rmtree(os.path.join(out, "ckpt", str(steps)))
            rec = dict(steps=[])
            _sync()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sys.stdout = tee
            try:
                rec["result"] = run.main(argv)
            finally:
                sys.stdout = tee.stream
            rec["s"] = time.perf_counter() - t0
            rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            runs[name] = rec
    finally:
        pretrain.make_stream_step = real_step
        pretrain.restore_latest = real_resume
        pretrain.stream_loss_fn = real_loss_fn
        sys.stdout = tee.stream
    runs["printed"] = "".join(tee.lines).splitlines()
    saved = torch.load(os.path.join(out, "ckpt", str(ckpt_every),
                                    "state.pt"), map_location="cpu",
                       weights_only=True)
    runs["saved_dtypes"] = dict(
        params=sorted({str(t.dtype) for t in saved["params"].values()}),
        masters=sorted({str(t.dtype) for t in
                        saved["optimizer"]["master"].values()}))
    runs["checkpoint_bytes"] = os.path.getsize(os.path.join(
        out, "ckpt", str(ckpt_every), "state.pt"))
    return runs


def full_vqkd_task(bs=24, steps=3, ckpt_every=2) -> dict:
    """Phase 24's task runs at full width on the card, checked: every
    step's losses finite and non-zero where the stream's flags ask; K1 12 +
    12 in the image-text and ImageNet streams and 9 + 9 in the region
    stream (the 12 − 3 blocks before region attention), nothing else; the
    first step's MIM CE within 0.5 of ln 8192 + 1/2 (unit-variance logits
    from the random head); the saved parameters bf16 and masters f32; the
    resumed state bit-equal to its file; the `### redispatch` line and its
    rate; peak memory under 80 GB."""
    import tempfile

    from xfm_tpu_torch import configs

    root = tempfile.mkdtemp(prefix="xfm_vqkd_")
    try:
        runs = vqkd_task_runs(root, bs=bs, steps=steps, ckpt_every=ckpt_every)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    depth = configs.xfm_base_pretrain_config().vision.depth
    k = configs.PRETRAIN_VQKD_KEYS["local_attn_depth"]
    k1 = {"image": depth, "imagenet": depth, "region": depth - k, "text": 0}
    on = {"image": {"itc", "itm", "mlm", "mim"},
          "region": {"itc", "itm", "mlm", "bbox", "giou"},
          "imagenet": {"mim"}, "text": {"mlm"}}
    for name in ("full", "resumed"):
        r = runs[name]
        print(f"  {name}: {r['s']:.1f} s, peak memory "
              f"{r['max_memory_allocated']} B, step s "
              f"{[round(x['s'], 4) for x in r['steps']]}")
        for i, st in enumerate(r["steps"]):
            print(f"    step {i}: {json.dumps(st['by_stream'])} "
                  f"{json.dumps(st['losses'])}")
            for stream, launches in st["by_stream"]:
                want = dict({x: 0 for x in launches},
                            packed_attention_fwd=k1[stream],
                            packed_attention_bwd=k1[stream])
                if launches != want:
                    raise AssertionError(f"{name} step {i} {stream}: "
                                         f"launches {launches}")
            for stream, losses in on.items():
                for key in ("itc", "itm", "mlm", "mim", "bbox", "giou"):
                    v = st["losses"][f"{stream}_loss_{key}"]
                    if not math.isfinite(v) or (v != 0.0) != (key in losses):
                        raise AssertionError(f"{name} step {i}: "
                                             f"{stream}_loss_{key} = {v}")
        if r["max_memory_allocated"] >= 80e9:
            raise AssertionError(f"{name}: peak memory")
        print(f"    result {json.dumps(r['result'])}")
    full, resumed = runs["full"], runs["resumed"]
    expect = math.log(8192) + 0.5
    first = {s: full["steps"][0]["losses"][f"{s}_loss_mim"]
             for s in ("image", "imagenet")}
    printed = [x for x in runs["printed"] if x.startswith("### redispatch")]
    restored = resumed.get("restored", {})
    print(f"  first-step MIM CE {json.dumps(first)} (ln 8192 + 1/2 = "
          f"{expect:.4f}); saved {json.dumps(runs['saved_dtypes'])}, "
          f"{runs['checkpoint_bytes']} B; resume {json.dumps(restored)}; "
          f"{printed}")
    if (any(abs(v - expect) > 0.5 for v in first.values())
            or runs["saved_dtypes"] != dict(params=["torch.bfloat16"],
                                            masters=["torch.float32"])
            or not restored.get("bit_equal")
            or restored.get("live") != ["torch.bfloat16"]
            or restored.get("masters") != ["torch.float32"]
            or runs["layout"] != [str(ckpt_every), str(steps)]
            or len(full["steps"]) != steps + 2  # + 2 redispatched steps
            or len(resumed["steps"]) != steps - ckpt_every
            or len(printed) != 1
            or not full["result"].get("redispatch_samples_per_sec", 0) > 0):
        raise AssertionError("the tokenizer path's run: MIM CE, dtypes, "
                             "resume or redispatch")
    return dict(step_s=[x["s"] for x in full["steps"]],
                resumed_step_s=[x["s"] for x in resumed["steps"]],
                run_s=[full["s"], resumed["s"]],
                max_memory_allocated=full["max_memory_allocated"],
                checkpoint_bytes=runs["checkpoint_bytes"],
                first_step_loss_mim=first,
                throughput={k: full["result"].get(k) for k in (
                    "samples_per_sec", "device_samples_per_sec",
                    "redispatch_samples_per_sec")})


def vqkd_full_step(B=16) -> dict:
    """One full-width VQ-KD training step at 224 px on the card: the
    tokenizer of `vqkd_encoder_base_decoder_3x768x12_clip` (12-block f32
    encoder, 8,192 codes of 32, 3-block decoder) regressing the CLIP
    ViT-B/16 teacher's projected features (f32, random weights), the EMA
    step of the codebook and one HF-AdamW update: seconds, peak memory,
    finite losses, ids in range, the codebook moved."""
    from xfm_tpu_torch.models.clip_vit import ClipVisionConfig
    from xfm_tpu_torch.models.teachers import CLIPTeacher, teacher_features
    from xfm_tpu_torch.models.vqkd import VQKD, vqkd_config_from_yaml
    from xfm_tpu_torch.train.optim import HFAdamW

    cfg = vqkd_config_from_yaml({})
    vq = build_model(VQKD, cfg, "cuda", seed=13)
    teacher = build_model(CLIPTeacher, ClipVisionConfig(), "cuda", seed=14)
    opt = HFAdamW(list(vq.named_parameters()), 1e-4)
    images = torch.randn(B, 224, 224, 3, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(15))
    cb0 = vq.quantize.embedding.weight.clone()
    res = {}
    for i in range(2):  # the first builds and warms up
        _sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        vq.zero_grad(set_to_none=True)
        loss, aux = vq(images, teacher_features(teacher, images))
        loss.backward()
        opt.step()
        _sync()
        res[f"step{i}_s"] = time.perf_counter() - t0
    res.update(loss=loss.item(), rec_loss=aux["rec_loss"].item(),
               teacher_norm=teacher_features(teacher, images).norm().item(),
               vq_loss=aux["vq_loss"].item(),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               ids_max=int(aux["ids"].max()),
               codes_used=int(aux["ids"].unique().numel()),
               codebook_moved=bool(not torch.equal(
                   cb0, vq.quantize.embedding.weight)))
    print("  full-width VQ-KD step: " + json.dumps(res))
    if (not all(math.isfinite(res[k]) for k in ("loss", "rec_loss",
                                                  "vq_loss"))
            or not 0 < res["rec_loss"] < 2 or not res["teacher_norm"] > 0
            or not 0 <= res["ids_max"] < 8192 or not res["codebook_moved"]
            or res["max_memory_allocated"] >= 80e9):
        raise AssertionError("full-width VQ-KD step")
    del vq, teacher, opt
    torch.cuda.empty_cache()
    return res


def vqkd_phase():
    """Phase 24 → the `profile_step` units `pretrain_vqkd` and
    `pretrain_bf16`: the slice, the task, the full-width tokenizer step,
    the two units (K1 33 + 33 and 36 + 36 a step, nothing else; peak
    memory under 80 GB; finite losses)."""
    from xfm_tpu_torch import configs, profile_step

    t0 = time.perf_counter()
    ties = vqkd_slice_parity()
    t1 = time.perf_counter()
    vt = full_vqkd_task()
    print("  tokenizer path task: " + json.dumps(vt))
    t2 = time.perf_counter()
    vqkd_full_step()
    t3 = time.perf_counter()
    profs = {}
    depth = configs.xfm_base_pretrain_config().vision.depth
    k = configs.PRETRAIN_VQKD_KEYS["local_attn_depth"]
    for unit, n in (("pretrain_vqkd", 3 * depth - k),
                    ("pretrain_bf16", 3 * depth)):
        r = profile_step.profile_pretrain_streams(
            None, **profile_step.STREAM_UNITS[unit])
        top = r.pop("top")
        print(f"  {unit} profile: " + json.dumps(r))
        for name, ms, calls in top[:10]:
            print(f"    {ms:9.3f} ms/step {calls:6d} calls/step  {name}")
        want = dict({x: 0 for x in r["launches_per_step"]},
                    packed_attention_fwd=n, packed_attention_bwd=n)
        if (r["launches_per_step"] != want
                or r["max_memory_allocated"] >= 80e9
                or not all(math.isfinite(v) for v in r["losses"].values())):
            raise AssertionError(f"{unit}: launches, peak memory or losses")
        profs[unit] = r
    print(f"  phase 24 seconds: slice {t1 - t0:.1f}, task {t2 - t1:.1f}, "
          f"tokenizer step {t3 - t2:.1f}, profiles "
          f"{time.perf_counter() - t3:.1f}; near-tie ids {json.dumps(ties)}")
    return profs


def vqkd_kernel_entries(k1_192, k1_80, vprof) -> list:
    """The `kernels` entries of phase 24: K1 at the tokenizer path's caller
    shapes (the image-text and ImageNet pair passes at [192, 197, 2304],
    the region stream's 9 blocks at [80, 197, 2304]; phase 19's times)
    with their launches a step in `profile_step pretrain_vqkd`."""
    return [dict(e, name=e["name"].replace("_pretrain_", "_pretrain_vqkd_"))
            for e in pretrain_kernel_entries(*k1_192, *k1_80,
                                             vprof["launches_by_stream"])]


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


PHASE_T = []  # when each phase began (time.perf_counter)


def phase(header: str) -> None:
    """Print a phase's header and note when the phase began."""
    PHASE_T.append(time.perf_counter())
    print(header, flush=True)


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
    phase(f"phase 1: device {smi}; torch {torch.__version__} "
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
    phase("phase 2: K1 parity and times")
    print_ptxas("K1", "packed_attention")
    k1_err = k1_parity(**k1_shape, dtype=torch.bfloat16)
    k1_parity(B=3, N=50, H=4, dtype=torch.bfloat16, seed=1)
    k1_parity(B=3, N=50, H=4, dtype=torch.float32, seed=2)
    k1_parity(B=4, N=197, H=12, dtype=torch.float32, seed=3)
    k1_deterministic(**k1_shape, dtype=torch.bfloat16)
    k1_t = k1_times(**k1_shape, dtype=torch.bfloat16)
    print("  K1 times (ms): " + json.dumps(k1_t))
    print("  K1 bound: " + json.dumps(k1w))
    phase("phase 3: pretrain slice parity, CPU vs card")
    slice_parity("pretrain")
    phase("phase 4: full-width XFM-base pretrain step")
    pretrain = full_width("pretrain")

    k2_shape = dict(B=32, window=(24, 24), H=12)
    k2w = k2_work(B=32, N=577, H=12, D=64, window=(24, 24),
                  dtype=torch.bfloat16)
    phase("phase 5: K2 parity and times")
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
    phase("phase 6: retrieval slice parity, CPU vs card")
    slice_parity("retrieval")
    phase("phase 7: full-width XFM-base retrieval step, 384 px")
    retrieval = full_width("retrieval")

    k3_shape = dict(B=32, N=577, H=12)
    k3w = k3_work(B=32, Nq=577, Nk=577, H=12, D=64, dtype=torch.bfloat16)
    phase("phase 8: K3 parity and times")
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
    phase("phase 9: CLIP retrieval slice parity, CPU vs card, default and "
          "fused routes")
    slice_parity("clip_retrieval")
    slice_parity("clip_retrieval_fused")
    phase("phase 10: full-width CLIP-ViT-B/16 retrieval step, 384 px")
    clip = full_width("clip_retrieval")

    phase("phase 11: K4 parity and times")
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
    phase("phase 12: K5 parity and times")
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
    phase("phase 13: fused pretrain slice parity, CPU vs card")
    slice_parity("pretrain_fused")
    phase("phase 14: full-width XFM-base pretrain step, fused LN and MLP")
    fused = full_width("pretrain_fused")
    print(f"  peak memory: fused {fused['max_memory_allocated']} B, "
          f"default {pretrain['max_memory_allocated']} B (phase 4)")

    phase("phase 15: K3 and K2 forward parity and times at the eval's "
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
    phase("phase 16: eval slice parity, CPU vs card, BEiT-2 and CLIP-ViT")
    eval_slice_parity(clip=False)
    eval_slice_parity(clip=True)
    phase("phase 17: the full-width retrieval eval, 384 px")
    ev = full_eval()
    cli_eval()
    phase("phase 18: the full-width retrieval fine-tune, 384 px, and its "
          "resume")
    ft = full_finetune()
    print("  fine-tune: " + json.dumps(ft))

    phase("phase 19: the pretrain task, its four streams and K1 at their "
          "shapes")
    k1_new = {}
    for B in (192, 80):
        err = k1_parity(B=B, N=197, H=12, dtype=torch.bfloat16, seed=30 + B)
        k1_parity(B=B, N=197, H=12, dtype=torch.float32, seed=31 + B)
        t = k1_times(B=B, N=197, H=12, dtype=torch.bfloat16)
        w = k1_work(B=B, N=197, H=12, D=64, dtype=torch.bfloat16)
        print(f"  K1 B={B} times (ms): " + json.dumps(t))
        print(f"  K1 B={B} bound (k1_work): " + json.dumps(w))
        k1_new[B] = (err, t, w)
    pretrain_slice_parity()
    print("  text stream plain attention [256, 128, 12, 64] bf16 (ms a "
          "call, 12 a step): " + json.dumps(text_attention_times()))
    pt = full_pretrain_task()
    print("  pretrain task: " + json.dumps(pt))
    from xfm_tpu_torch import profile_step

    prof = profile_step.profile_pretrain_streams(
        os.path.join(REPO, "build", "xfm_tpu_torch",
                     "profile_pretrain_streams.json"))
    top = prof.pop("top")
    print("  pretrain_streams profile: " + json.dumps(prof))
    for name, ms, n in top[:12]:
        print(f"    {ms:9.3f} ms/step {n:6d} calls/step  {name}")
    k1_step = prof["launches_per_step"]
    depth = 12  # XFM-base's BEiT blocks; three image-bearing streams
    want = {k: 0 for k in k1_step}
    want.update(packed_attention_fwd=3 * depth, packed_attention_bwd=3 * depth)
    if k1_step != want or prof["max_memory_allocated"] >= 80e9 or not all(
            math.isfinite(v) for v in prof["losses"].values()):
        raise AssertionError("pretrain_streams: launches, peak memory or "
                             "losses")

    phase("phase 20: VQA at 480 px: K2 at the step's shape, the slice, "
          "the task and its profile")
    k2v_err, k2v_t, k2vw, vprof = vqa_phase()
    phase("phase 21: COCO captioning: K2 and K1 at the new batches, the "
          "slice, the task and its profile")
    k2c, k1c, cprof = caption_phase()
    phase("phase 22: NLVR2 and RefCOCO grounding: K2 at the new batches, "
          "the slice, the tasks and their profiles")
    k2n, k2b, k2g, _, nprof = nlvr_phase()
    phase("phase 23: ImageNet, the linear probe, GLUE and classify: K1 at "
          "the new batches, the slice, the tasks and their profiles")
    k1ft, k1lp, clprof = classify_phase()
    phase("phase 24: the pretrain task's optional branches: the VQ-KD "
          "tokenizer, region attention, the shared table, bf16 parameters")
    qprof = vqkd_phase()

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
                                     k3gw, ev["launches"])
               + pretrain_kernel_entries(*k1_new[192], *k1_new[80],
                                         prof["launches_by_stream"])
               + vqa_kernel_entries(k2v_err, k2v_t, k2vw,
                                    vprof["vqa_train"]["launches"])
               + caption_kernel_entries(k2c, k1c, (k2_err, k2_t, k2w),
                                        cprof)
               + nlvr_kernel_entries(k2n, k2b, k2g, nprof)
               + classify_kernel_entries(k1ft, k1lp, clprof)
               + vqkd_kernel_entries(k1_new[192], k1_new[80],
                                     qprof["pretrain_vqkd"]))
    ends = PHASE_T[1:] + [time.perf_counter()]
    by_phase = [round(b - a, 1) for a, b in zip(PHASE_T, ends)]
    print(f"chip_smoke: 24 phases in {ends[-1] - t_start:.1f} s; seconds "
          f"by phase {json.dumps(by_phase)}")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
