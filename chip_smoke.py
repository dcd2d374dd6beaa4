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
     a seeded corpus of 256 images and 256 captions (1 each, 8-40
     tokens; 2 each in PRs 17-18, 5 before), k_test = 256, batch_size_test = 64: stage 1's images/s and
     texts/s, stage 2's ITM rows/s each way, the total seconds, the peak
     memory and R@K; K2 forward 48 and K3 forward 384 launches, nothing
     else (`python3 -m xfm_tpu_torch.run --task itr_coco --evaluate` in a
     process of its own is phase 27's eval launch);
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
     one step at its batch (96 regions over 80 image rows at 224 px, K1
     12 + 12 a step), stage 2 2 epochs at `--bs 24` from its weights, each
     of the 12 rel-pos tables [2212, 12] the interpolation of stage 1's
     [732, 12] (K2 12 + 12 a step, 12 an eval batch), `--evaluate
     --checkpoint` from it (the last epoch's accuracy); then
     `tasks.grounding.main_weakly_supervised` over 16 rows with 5
     candidate boxes (K2 12 a GradCAM batch of 8 at fusion layer 8);
     accuracies in [0, 1], peak memory under 80 GB; the runs' outputs
     deleted (the corpora kept for phase 28); then `profile_step`
     `nlvr_train`, `grounding_train` and
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
     [0, 1], peak memory under 80 GB; the runs' outputs deleted (the
     corpora kept for phase 28); then
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
 25. the pretrain task's input path: the host's CPU count and g++, the
     probe for libjpeg's and libpng's headers and the C++ loader's build
     (`xfm_tpu_torch/native`; a failed build with the headers present
     fails the phase, their absence prints `native_loader: unavailable
     (<reason>)` and skips what needs the loader); over 64 seeded photos
     of 300-1,600 px (JPEGs, 4 PNGs) and a JPEG cut before its scan: PIL's
     decode + `TrainTransform` (images/s) and RandAugment (ms an image) on
     one thread, and where the loader builds `decode_batch` at 224 px with
     crops and flips on the YAML's 4 threads and on one (images/s; status
     1 on the cut JPEG alone) and C++ RandAugment on one thread; device
     RandAugment's ops on [96, 224, 224, 3] uint8 on the card and on the
     CPU with the same signs, and two rounds from the same draws (each
     within 1 level; the share apart), its time per two rounds; where the
     loader builds, `run.main` for `--task pretrain_DIY` on
     `Pretrain_base_4m.yaml`'s keys (its `num_workers`) over JPEGs of
     300-1,600 px, `--bs 24`, 3 steps, without and with `device_randaug`
     (the loader's batches counted, uint8 images reaching the model, K1
     36 + 36 a step and nothing else, finite losses, the rates); then
     `profile_step pretrain_randaug` (uint8 images, RandAugment on the card
     before the loss: K1 36 + 36, the RandAugment's busy ms and share)
     beside phase 19's `pretrain_streams`;
 26. the Swin-B and DeiT towers and the BERT text encoder: K3 with no
     bias at DeiT's shape, q/k/v [32, 577, 12, 64] bf16 as views of the
     qkv projection: forward and backward (out, dq, dk, dv) bit-equal over
     two runs and against the plain version within phase 8's gate, the
     times, the bound and SDPA; the retrieval losses and sampled gradients
     with Swin-B (window 12, depths cut to 2, 2, 2, 2) + BERT-base at
     depth 2 and with DeiT-B/16 + RoBERTa-base at depth 2, 384 px, B = 4,
     f32, on the CPU and on the card (K3 2 + 2 in the DeiT slice, no
     kernel in the Swin one); the full-width Swin-B + BERT-base retrieval
     fine-tune step at 384 px, B = 32, T = 40, bf16, dropout and drop-path
     live, 5 steps on one batch with the same draws (finite losses, the
     last below the first, no kernel launched, the peak memory), then a
     seeded Swin-B
     tower at 224 px, window 7, in the reference's names loaded into it
     through `load_xfm_checkpoint` (each table interpolated 13² → 23²);
     the DeiT-B/16 step likewise (K3 12 + 12 a step, nothing else);
     `run.main` for `--task itr_coco` on `Retrieval_coco.yaml`'s keys with
     `use_swin: true`, `config_swinB_384.json` and
     `data/bert-base-uncased` over 16 seeded PNGs (2 steps at `--bs 16`,
     one epoch; no kernel launched), then `--evaluate --checkpoint` from
     its own `ckpt/0` (the epoch's R@K); then `profile_step`
     `swin_retrieval_train` and `deit_retrieval_train` (busy time, idle
     share, MFU over busy time, the launches as above);
 27. data parallelism under `torchrun --standalone --nproc_per_node=<the
     card count>` (NCCL; `NCCL_SOCKET_IFNAME=lo`): `python3 -m
     xfm_tpu_torch.run --task pretrain_DIY` on `Pretrain_base_4m.yaml`'s
     keys over phase 19's corpora, full width and depth, 2 steps at
     `--bs` 24 a card (its rank 0 printing the backend, the world size and
     every rank's launches: K1 72 + 72 and nothing else; each step's
     reduced loss from its log), at the same time as (with two cards or
     more) `--task itr_coco` (phase 18's corpus and keys, one epoch at
     `--bs 24`) and, in
     this process, the pretrain run without `torchrun`; with one card the
     torchrun run is held to it (the first loss bit-equal, the second
     within DP_LOSS_RTOL; the gap between the two runs' saved parameters
     within DP_UPDATE_RTOL of the plain run's second update over all
     parameters, and within DP_TENSOR_UPDATE_RTOL in each tensor, that
     update read from the plain run's save at step 1); with two cards or
     more the fine-tune's zero-shot R_mean equals phase 18's, then
     `--evaluate --checkpoint` its `ckpt/0` under `torchrun` equals the
     epoch's eval (with one card phase 18 ran that epoch in this process);
     with two cards or more also the bf16 pretrain step on a fixed global
     batch of 32 on two processes against one (`python3 chip_smoke.py
     --dp-step`), else a line saying it could not run;
 28. data parallelism for the other fine-tunes, the same way: `python3
     chip_smoke.py --dp-task` (`run.main` with each train step's reduced
     loss recorded) under `torchrun --standalone --nproc_per_node=<the
     card count>`, four launches at a time (with one card only
     `DP_TASKS_ONE_CARD`: the others ran without torchrun in phases 22
     and 23), over phases 22's and 23's
     corpora and YAMLs at full width and depth: `--task nlvr` (one epoch
     of 2 steps at `--bs 24`, on phase 22's schedule of 4 steps),
     `refcoco_bbox` (stage 1 one step, stage 2 one epoch at `--bs 24`;
     with two cards or more the region JSONL in a shard a rank),
     `imagenet` (one epoch at `--bs 128`) and its probe (`--bs 512`),
     `glue` (one epoch of 2 steps at `--bs 32`, on phase 23's horizon of
     4 steps) and `classify` (one epoch at `--bs 16`); each rank's
     launches (K2 12 + 12 a step for NLVR and stage 2, K1 12 + 12 for
     stage 1, ImageNet and classify, K1 12 for the probe, none for GLUE,
     and K2 or K1 12 an eval batch of the rank's); with one card each run
     held to phase 22's or 23's without torchrun (the first loss
     bit-equal, epoch 0's eval metrics equal); with two cards or more the
     `--evaluate` of each run's `ckpt/0` under torchrun held to one
     process's at the rank's batch, else a line saying it could not run;
     phases 22's and 23's directories deleted;
 29. activation checkpointing (`remat_phase`): K1 at H = 16 (BEiT-2-large)
     against its plain version at qkv [192, 197, 3072] and [80, 197, 3072]
     in bf16 and f32, times, bound (`k1_work`), SDPA; K4 (add) at R =
     37,824, C = 1024 and K5 (tanh-GELU) at M = 37,824, K = 4096, N = 1024
     in both dtypes, times, bounds; the large pretrain slice (width 1024,
     16 heads, depth 2, f32, `gradient_checkpointing` on; the image-text
     and region streams) CPU vs card, K1 4 + 2 a tower pass; checkpointing on against off on the card
     (`remat_on_off`: bf16, depth 2, dropout live; the plain step's
     run-to-run gradient gap printed, then under deterministic algorithms
     the loss and every gradient bit-equal, each policy); `run.main` for
     `--task pretrain_DIY` on the large YAML (`configs.PRETRAIN_LARGE_KEYS`)
     over `_pretrain_corpus`, `--bs 24`, 2 steps, K1 144 + 72 a step;
     `profile_step.profile_pretrain_streams` with the large tower under
     `full` at the YAML's 96 (busy ms, idle share, peak memory, K1
     launches 144 + 72; at `--bs 24` off and under each policy of
     `REMAT_PROFILED`, none by default);
 30. FSDP (`fsdp_phase`): a one-process NCCL group and the pretrain task
     with its `place_state` made to shard (`core/partitioning.shard_model`
     on the one-rank mesh: FSDP2 units, DTensor shards, the registered
     root methods, the reduce-scatter, the optimizer over the shards, the
     gathered checkpoint; a config cannot ask for `fsdp` > 1 on one
     process): `run.main` for `--task pretrain_DIY` as phase 27's plain
     run (its corpus and YAML, `--bs 24`, 2 steps) held to that run by
     phase 27's gates, K1 72 + 72 over the two steps; the saved state
     resumed by the task on the unsharded model for a third step; `python
     -m xfm_tpu_torch.convert_checkpoint to-torch` of the sharded run's
     checkpoint; with two cards or more `--dp-step` at `parallel: {fsdp:
     W}` (and `{data: 2, fsdp: 2}` on four) on phase 27's fixed global
     batch against one process, `pretrain_DIY` and `itr_coco` under
     torchrun at those layouts (the eval of `itr_coco`'s `ckpt/0` on one
     process equal to the epoch's), and on four the BEiT-2-large pretrain
     step under `full` at the YAML's 96 a rank (`--fsdp-peak`): the peak
     memory of each rank at `fsdp: 4` and at `data: 4`; else a line saying
     it could not run;
 31. tensor parallelism (`tensor_phase`): full-width BEiT-2-base blocks
     (C 768, H 12) cut at T = 2 and 4 (`core/partitioning.
     tensor_shards`), each shard's forward and backward on the card and
     the row partials summed by hand (`shard_beit_block` and its kin),
     against the
     whole block in its output and every gradient (f32 within phase 3's
     gates; bf16 against the block run in f32, at most twice the whole
     bf16 block's error or within phase 2's): at N = 197, B = 96 (K1 at qkv
     [96, 197, 3·H/T·64]), with both fused routes (K4 and K5 at K =
     3072/T), and at N = 577, B = 32 (K2 with the table's H/T columns);
     a fusion layer (self- and cross-attention, the MLP) the same way;
     the grouped rerank's cross-attention (K3 at H/T heads, U = 8, gs =
     256); then K1, K2, K5 and K3's grouped forward against their plain
     versions at those shapes in bf16 and f32, times beside the
     unsharded shapes', bounds (K5 as the row layer runs it: no bias, its
     partial written in f32); before them (started with phase 30 on one
     card), on any card count, `--dp-step ... one-card` in bf16 on phase
     27's fixed global batch at `{tensor: 2}` (the models' own forward and the
     tensor group's all-reduces) and at `{data: 2}` (the control of that
     harness), each two processes on card 0 over gloo, against the
     one-process step in bf16 and f32 (`TP_ONE_CARD`: the control within
     phase 27's gates of the bf16 step, the cut within TP_BUDGET times
     the bf16 step's own distance from the f32 step); with two cards or
     more `--dp-step` at
     `{tensor: 2}` (and `{data: 2, tensor: 2}`, `{fsdp: 2, tensor: 2}`
     on four) on phase 27's fixed global batch, `pretrain_DIY` and
     `itr_coco` under torchrun at those layouts, and `--tp-decode` (VQA's
     `rank` and the beam decode at full width) at `{tensor: 2}` against
     one process; else a line saying they could not run; phase 27's
     directory deleted; the `{tensor: 2}` processes on one card then take
     the same batch at `{tensor: 2, seq_shard: true}` as it is (held as
     the cut; each process's peak memory printed at both layouts) and on
     both fused routes (held as the cut to the fused one-process step),
     then the CLIP-ViT-B/16 and DeiT-B/16 retrieval steps at 384 px, B =
     32, at `{tensor: 2}` (`tower_step`, held as the cut to the one-process
     steps in bf16 and f32), and phase 32's blocks; each step's kernel
     launches counted;
 32. sequence parallelism and the tower cuts (`seq_tower_phase`): in
     phase 31's two processes on the card, each block cut for its rank
     and run under the group (`seq_tower_group_checks`,
     `cut_block_run`): the full-width BEiT-2-base block under `seq_shard`
     (N = 197, B = 96 with both fused routes, K4 at 96·⌈197/2⌉ rows;
     N = 577, B = 32 with K2), a text layer and a fusion layer the same
     way, CLIP-ViT-B/16 and DeiT-B/16 blocks at 384 px, B = 32 (K3
     forward and backward at [32, 577, 6, 64]) and a Swin-B block of each
     stage, each held to the whole module as phase 31 holds its blocks;
     then K3 at [32, 577, 6 | 3, 64] (no bias) and K4 (add) at the
     seq-shard rows of T = 2 and 4 against their plain versions in bf16
     and f32, times, bounds, library times; the launches at T = 2 from
     phase 31's DeiT step (K3) and fused `seq_shard` step (K4);
then the sum of phases 1-26's seconds (the host's speed), a JSON line of
the kernels, the device line and the result line.
Phases 4, 7 and 10 also check that no kernel but their own (K4 and K5
included) is launched there. All five libraries build together in
phase 1.
Needs one CUDA card; imports nothing of JAX or of the xfm_tpu package.
"""
from __future__ import annotations

import atexit
import base64
import dataclasses
import json
import math
import os
import shutil
import signal
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
# the synthetic corpora's PNGs: zlib's fastest level (PIL's default, 6,
# spends seconds on noisy pixels that it hardly shrinks); lossless either way
PNG_LEVEL = 1
# the profiles' windows here: one step each after the warm-up (their
# launches, peak memory and losses are what the phases check; `python3 -m
# xfm_tpu_torch.profile_step UNIT` times profile_step.STEPS steps a window)
PROFILE_STEPS = 1
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
# phase-27 tolerances. One process under torchrun against the same run
# without it: the first step's loss is bit-equal (the same weights, data
# and draws). The backward's atomics (index_add_ of the shared cross-k/v
# gather, as in phase 18) leave the states apart in the last bits, so the
# second step's loss is held to DP_LOSS_RTOL (bit-equal in both H100 runs
# that measured it) and the saved parameters a to the plain run's b
# relative to the plain run's second update: |a - b| / |b - b1| (l2 norms,
# b1 the plain run's parameters after step 1) within DP_UPDATE_RTOL over
# all parameters (0.0019 and 0.0020 measured) and within
# DP_TENSOR_UPDATE_RTOL in each tensor (0.016 and 0.064 measured: an
# element whose gradient is ~0 takes an Adam step of either sign, which in
# a 768-wide LayerNorm tensor alone reads ~0.07), so that a skipped,
# doubled or lost update (~0.5 or more, the warm-up's lr rising linearly)
# fails. Two cards on a fixed global batch of 32 against one, the bf16
# step: the losses within DP_LOSS_RTOL
# (1.1e-7 measured, ITC and MLM bit-equal), the gradient norm within
# DP_GRAD_NORM_RTOL (2.7e-5 measured, each rank's rows through its own
# bf16 matmuls); a per-rank mean over unequal counts moves the loss by
# far more.
DP_LOSS_RTOL = 1e-5
DP_UPDATE_RTOL = 0.02
DP_TENSOR_UPDATE_RTOL = 0.3
DP_GRAD_NORM_RTOL = 2e-4


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


def k3_times(B, N, H, dtype, inputs=None) -> dict:
    """Kernel, plain and library times (ms) at one shape, no bias; on
    `inputs` (q, k, v, dout) where given, else `make_k3_inputs`'."""
    import torch.nn.functional as F

    from xfm_tpu_torch.ops import flash_attention as fa

    q, k, v, dout = inputs or make_k3_inputs(B, N, N, H, dtype, None, 1)[:4]
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


def k3_grouped_parity(U, gs, dtype, bias_kind="ones", seed=0, H=12
                      ) -> dict:
    from xfm_tpu_torch.ops import flash_attention as fa

    q, k, v, bias = k3_grouped_inputs(U, gs, dtype, bias_kind, seed, H=H)
    out, _ = fa.flash_attention_fwd(q, k, v, bias, 64 ** -0.5)
    ref = fa.flash_attention_reference(q, k, v, bias, 64 ** -0.5)
    torch.cuda.synchronize()
    return _compare(f"K3 grouped fwd U={U} gs={gs} q={list(q.shape)} "
                    f"{str(dtype)[6:]} bias={bias_kind}", [("out", out, ref)],
                    dtype)


def k3_grouped_times(U, gs, dtype, H=12) -> dict:
    """Forward times (ms) at the grouped shape with its all-ones mask bias:
    kernel, plain, and SDPA with no mask; and the kernel with no bias."""
    import torch.nn.functional as F

    from xfm_tpu_torch.ops import flash_attention as fa

    q, k, v, bias = k3_grouped_inputs(U, gs, dtype, "ones", 1, H=H)
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
    cpu, gpu = twin_models(XFMForRetrieval, cfg, seed=3)
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


def full_eval(n_img=256, per_image=1, k_test=256, seed=0) -> dict:
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
            os.path.join(root, f"img{i}.png"), compress_level=PNG_LEVEL)
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
                               map_location=device, weights_only=True,
                               mmap=True)
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

    yaml_cfg = configs.pretrain_yaml()
    for fused in (False, True):
        cfg = configs.xfm_base_pretrain_config(
            layers=2, dtype=torch.float32, fused_ln=fused, fused_mlp=fused)
        stream_slice_parity(cfg, yaml_cfg, ("region",) if fused else
                            ("image", "imagenet", "region", "text"), (2, 2),
                            " fused" if fused else "")


def stream_slice_parity(cfg, yaml_cfg, names, k1, tag="") -> None:
    """The streams `names` of `pretrain_slice_parity` at model config
    `cfg` (f32), on the CPU and on the card from the same weights: losses
    within SLICE_LOSS_RTOL, sampled gradients within SLICE_GRAD_RTOL of
    their max; on the card K1's (forward, backward) launches `k1` for an
    image-bearing stream and none for the text stream, no K2 or K3, K4 and
    K5 as `cfg.vision.fused_ln` says."""
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.models import XFMForPretrain
    from xfm_tpu_torch.models.task_models import LOSS_KEYS
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks.pretrain import stream_flags

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
    fused = cfg.vision.fused_ln
    nb = configs.make_stream_batches(sizes, cfg.vision.image_res,
                                     cfg.text.vocab_size, seed=1)
    cpu, gpu = twin_models(XFMForPretrain, cfg, seed=3)
    for name in names:
        flags = stream_flags(name, 0, yaml_cfg)
        results = {}
        for dev_tag, model, dev in (("cpu", cpu, "cpu"),
                                    ("cuda", gpu, "cuda")):
            model.zero_grad(set_to_none=True)
            batch = configs.batch_to_torch(nb[name], dev)
            neg = (torch.tensor([1, 2, 3, 0], device=dev),
                   torch.tensor([2, 3, 0, 1], device=dev))
            kernels.reset_launch_counts()
            out = model.loss(**batch, **flags, hard_negatives=neg)
            sum(out[k] for k in LOSS_KEYS).backward()
            results[dev_tag] = ({k: v.item() for k, v in out.items()},
                                dict(model.named_parameters()),
                                dict(kernels.LAUNCHES))
        (lc, pc, _), (lg, pg, launches) = results["cpu"], results["cuda"]
        stag = f"{name}{tag}"
        want = (0, 0) if name == "text" else tuple(k1)
        print(f"  pretrain slice {stag} launches {json.dumps(launches)}")
        if (launches["packed_attention_fwd"], launches[
                "packed_attention_bwd"]) != want or any(
                launches[k] for k in launches
                if k.startswith(("relpos", "flash"))):
            raise AssertionError(f"pretrain slice {stag}: launches")
        if fused != bool(launches["fused_ln_fwd"]
                         and launches["fused_mlp_fwd"]):
            raise AssertionError(f"pretrain slice {stag}: K4/K5 launches")
        for k in LOSS_KEYS:
            ok = math.isclose(lc[k], lg[k], rel_tol=SLICE_LOSS_RTOL,
                              abs_tol=1e-7)
            print(f"  pretrain slice {stag} {k}: cpu={lc[k]:.6f} "
                  f"cuda={lg[k]:.6f} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"pretrain slice {stag}: {k}")
        for n, used_by in sample.items():
            if name not in used_by:
                continue
            a, b = pc[n].grad.float(), pg[n].grad.float().cpu()
            err = (a - b).abs().max().item()
            tol = SLICE_GRAD_RTOL * a.abs().max().item()
            print(f"  pretrain slice {stag} grad {n}: max_abs_err="
                  f"{err:.3e} tol={tol:.3e}")
            if not err <= tol:
                raise AssertionError(f"pretrain slice {stag}: grad {n}")
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
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
            buf, "PNG", compress_level=PNG_LEVEL)
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
                       device="cuda", keys=None, resume=True) -> dict:
    """`python3 -m xfm_tpu_torch.run --task pretrain_DIY` (`run.main`) on
    `Pretrain_base_4m.yaml`'s keys (`keys` on top) over `_pretrain_corpus`,
    `--bs`, with `max_steps` `steps` and `ckpt_frequent_step` `ckpt_every`,
    `resume: true`; then, with `resume`, the newest checkpoint deleted and
    the command again. Each step's seconds, launches and losses are
    recorded, and the restored state against the file it came from."""
    import yaml

    from xfm_tpu_torch import configs, run
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks import pretrain

    files = _pretrain_corpus(root)
    cfg = {k: v for k, v in configs.pretrain_yaml(**(keys or {})).items()
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
                               map_location=device, weights_only=True,
                               mmap=True)
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
        for name in ("full", "resumed") if resume else ("full",):
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
                            launches, label="pretrain") -> list:
    """The `kernels` entries of K1 at the pretrain task's caller shapes:
    the image-text and ImageNet pair passes at the YAML's batch (qkv
    [192, 197, 2304]; [192, 197, 3072] with the large tower, `label`
    "large") and the region stream's 80 images, with their launches a step
    from `profile_step pretrain_streams` (`pretrain_large_remat`)."""
    out = []
    for tag, err, t, w, streams in (
            ("b192", err192, t192, w192, ("image", "imagenet")),
            ("b80", err80, t80, w80, ("region",))):
        n = {k: sum(launches[s][k] for s in streams)
             for k in launches[streams[0]]}
        for d, bwd_keys in (("fwd", ("out",)), ("bwd", ("dqkv", "db"))):
            out.append(dict(
                name=f"packed_attention_{d}_{label}_{tag}", route="cuda",
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
    cpu, gpu = twin_models(XFMForVQA.from_yaml, cfg, seed=3)
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
                         name), compress_level=PNG_LEVEL)
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
                               map_location="cuda", weights_only=True,
                               mmap=True)
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
                                    weights_only=True, mmap=True)["params"]
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
    vprof = profile_step.profile_vqa(None, steps=PROFILE_STEPS)
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
    cpu, gpu = twin_models(XFMForCaptioning.from_yaml, cfg, seed=3)
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
        img.save(buf, "PNG", compress_level=PNG_LEVEL)
        return base64.b64encode(buf.getvalue()).decode()
    img.save(path, compress_level=PNG_LEVEL)
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
                               map_location="cuda", weights_only=True,
                               mmap=True)
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
    cprof = profile_step.profile_caption(None, steps=PROFILE_STEPS)
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
    res, launches, twins = {}, {}, {}

    def twin(name, cls, cfg, seed):  # the host's copy, then the card's
        if name not in twins:
            twins[name] = list(twin_models(cls, cfg, seed=seed))
        return twins[name].pop(0)

    for tag, dev in (("cpu", "cpu"), ("cuda", "cuda")):
        out = res[tag] = {}
        for name, cls, cfg, seed in (("nlvr", XFMForNLVR, ncfg, 4),
                                     ("grounding", XFMForGrounding, gcfg, 5)):
            model = twin(name, cls, cfg, seed)
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
        model = twin("cam", XFMForRetrieval, rcfg, 6)
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
                "cuda", seed=6)
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


def _nlvr_corpus(root, n_train=48, n_val=8, n_test=8, n_images=16, seed=0):
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
                       weights_only=True, mmap=True)
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
    `Grounding_bbox_pretrain.yaml`'s keys over the region JSONL (one step
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
                       train_file_regions=[gf["regions"]], max_steps=1,
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


def full_nlvr_task(epochs=2, keep_corpora=False) -> dict:
    """Phase 22's task runs at full width on the card, checked: finite
    losses; K2 12 + 12 a fine-tune step (NLVR and grounding) and 12 an eval
    batch, K1 12 + 12 a stage-1 step, K2 12 a GradCAM batch, nothing else;
    the checkpoints written; the NLVR resume bit-equal to its file, its
    first loss bit-equal to the first run's; `--evaluate` giving the last
    epoch's accuracy; stage 2's 12 tables [2212, 12] each the
    interpolation of stage 1's [732, 12]; accuracies in [0, 1]; peak
    memory under 80 GB. The directory is deleted at the end, but with
    `keep_corpora` its corpora and YAMLs, which stay for phase 28
    (`corpus_root` of the result; `dp_ref`: the first step's loss and
    epoch 0's eval of the NLVR run and of stage 2), which deletes them."""
    import tempfile

    root = tempfile.mkdtemp(prefix="xfm_nlvr_")
    keep = False
    try:
        out = _checked_nlvr_runs(root, epochs)
        if keep_corpora:  # and gone at the latest when the script ends
            keep = bool(atexit.register(shutil.rmtree, root, True))
        return out
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)


def _checked_nlvr_runs(root, epochs) -> dict:
    runs = nlvr_task_runs(root, epochs=epochs)
    for name in ("out", "out_ev", "ref_out", "ref_out_ev", "weak_out"):
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)
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
            or runs["stage1_layout"] != ["1"] or len(pipe["stage1"]) != 1
            or any(e["rows"] != 80 for e in pipe["stage1"])
            or tables.get("n") != 12 or not tables.get("equal")
            or tables.get("shapes") != [((732, 12), (2212, 12))]
            or len(pipe["steps"]) != epochs  # 24 rows at --bs 24
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
                weak=runs["weak"]["result"], corpus_root=root,
                dp_ref={"nlvr": dict(
                    loss=full["steps"][0]["loss"], steps=len(full["steps"]),
                    metrics={"val_acc": full["evals"][0]["acc"],
                             "test_acc": full["evals"][1]["acc"]}),
                        "refcoco_bbox": dict(
                    loss=pipe["steps"][0]["loss"],
                    metrics={"iou50_acc": pipe["evals"][0]["iou50_acc"]})})


def nlvr_phase(keep_corpora=False):
    """Phase 22 → (K2's errors, times and bounds at qkv [48, 577, 2304]
    and [24, 577, 2304] (forward and backward) and [8, 577, 2304]
    (forward), the slice's bf16 cam readings, `profile_step.profile_nlvr`'s
    units, `full_nlvr_task`'s result)."""
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
    nt = full_nlvr_task(keep_corpora=keep_corpora)
    t3 = time.perf_counter()
    print("  nlvr and grounding tasks: " + json.dumps(nt))
    nprof = profile_step.profile_nlvr(None, steps=PROFILE_STEPS)
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
            (k2g_err, k2g_t, k2gw), sp, nprof, nt)


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
                i_save=imagenet.save_task_checkpoint,
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
    imagenet.save_task_checkpoint = saver("i_save")
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
        imagenet.save_task_checkpoint = real["i_save"]
        glue.save_task_checkpoint = real["g_save"]
        glue.maybe_resume_epochs = real["g_re"]
    return runs


def full_classify_task(seed=0, keep_corpora=False) -> dict:
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
    is deleted at the end, but with `keep_corpora` its corpora and YAMLs,
    which stay for phase 28 (`corpus_root` of the result; `dp_ref`: each
    run's first step loss and epoch 0's eval), which deletes them."""
    import tempfile

    root = tempfile.mkdtemp(prefix="xfm_classify_")
    keep = False
    try:
        out = _checked_classify_runs(root, seed)
        if keep_corpora:  # and gone at the latest when the script ends
            keep = bool(atexit.register(shutil.rmtree, root, True))
        return out
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)


def _checked_classify_runs(root, seed) -> dict:
    runs = classify_task_runs(root, seed=seed)
    for name in os.listdir(root):
        if name.startswith("out_"):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
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
        results={n: runs[n]["result"] for n in ("ft", "lp", "glue", "cls")},
        corpus_root=root,
        dp_ref={task: dict(
            loss=runs[n]["steps"][0]["loss"], steps=len(runs[n]["steps"]),
            metrics={k: v for k, v in runs[n]["evals"][0].items()
                     if k in keys}) for task, n, keys in (
            ("imagenet", "ft", ("acc1",)), ("probe", "lp", ("acc1",)),
            ("glue", "glue", ("accuracy", "f1")),
            ("classify", "cls", ("acc",)))})


def classify_phase(keep_corpora=False):
    """Phase 23 → (K1's errors, times and bounds at qkv [128, 197, 2304]
    (forward and backward) and [512, 197, 2304] (forward),
    `profile_step.profile_classify`'s units, `full_classify_task`'s
    result)."""
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
    ct = full_classify_task(keep_corpora=keep_corpora)
    t3 = time.perf_counter()
    print("  classification tasks: " + json.dumps(ct))
    cprof = profile_step.profile_classify(None, steps=PROFILE_STEPS)
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
    return k1[128], k1[512], cprof, ct


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
    cpu, gpu = twin_models(XFMForPretrain, cfg, seed=3)
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
        cpu, gpu = twin_models(ClipVisionTransformer, ccfg, seed=8)
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
        cpu, gpu = twin_models(XFMForPretrain, mcfg, seed=12)
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
                               map_location="cuda", weights_only=True,
                               mmap=True)
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
                       weights_only=True, mmap=True)
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
        # only the tokenizer unit's launches by stream are read (its
        # kernel entries); the bf16 unit skips the streams taken alone
        r = profile_step.profile_pretrain_streams(
            None, steps=PROFILE_STEPS, by_stream=unit == "pretrain_vqkd",
            **profile_step.STREAM_UNITS[unit])
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


def k5_work(M: int, K: int, N: int, dtype: torch.dtype,
            bias: bool = True) -> dict:
    """As `k1_work`, for K5: h, W, b in, y out; backward h, W, g in, dh,
    dW, db out; 2·M·K·N operations a product, one forward, two backward.
    Without `bias` (a row layer's partial): no b, y in f32, no db."""
    isz = torch.tensor([], dtype=dtype).element_size()
    b = N if bias else 0
    fwd_bytes = (M * K + N * K + b) * isz + M * N * (isz if bias else 4)
    bwd_bytes = (M * K + N * K + M * N + M * K + N * K + b) * isz
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


def k5_parity(act: str, M: int, dtype, K=3072, N=768, seed=0,
              bias: bool = True) -> dict:
    """Kernel vs plain version on the same inputs → max abs errors.
    Without `bias`: the row layer's partial (no b, y in f32, no db)."""
    from xfm_tpu_torch.ops import fused_mlp as fm

    h, w, b, g = make_k5_inputs(M, K, N, dtype, seed)
    b = b if bias else None
    y = fm.act_matmul_fwd(h, w, b, act)
    dh, dw, db = fm.act_matmul_bwd(h, w, g, act, bias)
    ry = fm.act_matmul_reference(h, w, b, act)
    rdh, rdw, rdb = fm.act_matmul_bwd_reference(h, w, g, act, bias)
    torch.cuda.synchronize()
    if y.dtype != (dtype if bias else torch.float32):
        raise AssertionError(f"K5 forward returned {y.dtype}")
    pairs = [("out", y, ry), ("dh", dh, rdh), ("dW", dw, rdw)]
    return _compare(f"K5 {act} M={M} K={K} N={N} {str(dtype)[6:]}"
                    f"{'' if bias else ' no bias, f32 out'}",
                    pairs + ([("db", db, rdb)] if bias else []), dtype)


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


def k5_times(M: int, dtype, act="gelu_tanh", K=3072, N=768,
             bias: bool = True) -> dict:
    """Kernel, plain and library times (ms) at one shape. The library
    yardstick is the default route's two calls, F.linear(act(h), W, b)
    (without `bias`, the row layer's partial: F.linear(act(h), W), its
    output in h's dtype)."""
    import torch.nn.functional as F

    from xfm_tpu_torch.ops import fused_mlp as fm
    from xfm_tpu_torch.ops.activations import ACT

    h, w, b, g = make_k5_inputs(M, K, N, dtype, 1)
    b = b if bias else None
    t = {}
    t["fwd_ms"] = cuda_ms(lambda: fm.act_matmul_fwd(h, w, b, act))
    t["bwd_ms"] = cuda_ms(lambda: fm.act_matmul_bwd(h, w, g, act, bias))
    t["plain_fwd_ms"] = cuda_ms(lambda: fm.act_matmul_reference(
        h, w, b, act), 5)
    t["plain_bwd_ms"] = cuda_ms(lambda: fm.act_matmul_bwd_reference(
        h, w, g, act, bias), 5)
    with torch.no_grad():
        t["library_fwd_ms"] = cuda_ms(lambda: F.linear(ACT[act](h), w, b))
    hl, wl = (v.clone().requires_grad_(True) for v in (h, w))
    bl = None if b is None else b.clone().requires_grad_(True)

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
    """`cls(cfg)` built on `device` with `init_weights(model, seed)`."""
    from xfm_tpu_torch import configs

    return configs.new_model(lambda: cls(cfg), device, seed)


def twin_models(cls, cfg, seed=0):
    """One set of weights on the card and on the host: `build_model` on
    the card (its initializers run there) and its copy → (cpu, gpu)."""
    import copy

    gpu = build_model(cls, cfg, "cuda", seed)
    return copy.deepcopy(gpu).to("cpu"), gpu


def slice_parity(path: str) -> None:
    """f32, full width, depth 2: the same weights and batch on the CPU and
    on the card → losses and sampled gradients agree. `path`: "pretrain"
    (224 px), "pretrain_fused" (the same with K4 and K5, whose launches on
    the card are checked), "retrieval" (384 px, so K2 on the card) or
    "clip_retrieval" (384 px with the CLIP-ViT tower, so K3 on the card)
    or "clip_retrieval_fused" (the same with K4 and K5 in the text and
    fusion encoders, their launches checked), "swin_retrieval" (Swin-B,
    window 12, its stages cut to depths 2, 2, 2, 2, and BERT-base at depth
    2; no kernel on the card) or "deit_retrieval" (DeiT-B/16 and
    RoBERTa-base at depth 2; K3 2 + 2 on the card, checked)."""
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
        elif path == "swin_retrieval":
            cfg = configs.xfm_swin_retrieval_config(
                depths=(2, 2, 2, 2), layers=2, dtype=torch.float32)
            vision_sample = [
                "vision_encoder.layers.0.blocks.1.attn."
                "relative_position_bias_table",
                "vision_encoder.layers.2.blocks.0.attn.qkv.weight",
                "vision_encoder.layers.0.downsample.reduction.weight",
                "vision_encoder.patch_embed.proj.weight"]
        elif path == "deit_retrieval":
            cfg = configs.xfm_deit_retrieval_config(layers=2,
                                                    dtype=torch.float32)
            vision_sample = ["vision_encoder.blocks.0.attn.qkv.weight",
                             "vision_encoder.blocks.1.attn.proj.weight",
                             "vision_encoder.pos_embed",
                             "vision_encoder.patch_embed.proj.weight"]
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
    cpu, gpu = twin_models(cls, cfg, seed=3)
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
                    "clip_retrieval_fused": clip_fused_launches_per_step,
                    "swin_retrieval": lambda c: {"flash_attention": (0, 0)},
                    "deit_retrieval": lambda c: {"flash_attention": (2, 2)}}
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


def _jpeg_blobs(r, n, lo=300, hi=1600, n_png=4):
    """n seeded encoded photos (a colour, a wave, noise) of lo-hi px a
    side: JPEGs (quality 80-95), the last `n_png` of them PNGs, and one
    JPEG more cut before its scan (its header reads, its body does not
    decode) → list of bytes."""
    import io

    from PIL import Image

    out = []
    noise = r.randint(-10, 11, (hi, hi, 3)).astype(np.float32)
    for i in range(n):
        h, w = r.randint(lo, hi + 1, 2)
        yy, xx = np.mgrid[0:h, 0:w]
        wave = np.sin(xx * r.uniform(0.005, 0.05) + yy * r.uniform(0.005,
                                                                   0.05))
        arr = np.clip(r.randint(0, 256, 3) + 60 * wave[..., None]
                      * r.uniform(-1, 1, 3) + noise[:h, :w], 0,
                      255).astype(np.uint8)
        buf = io.BytesIO()
        if i >= n - n_png:
            Image.fromarray(arr).save(buf, "PNG", compress_level=PNG_LEVEL)
        else:
            Image.fromarray(arr).save(buf, "JPEG",
                                      quality=int(r.randint(80, 96)))
        out.append(buf.getvalue())
    out.append(out[0][:out[0].index(b"\xff\xda")])
    return out


def _rate(fn, n_items, reps=2) -> float:
    """Items/s of fn(), the best of `reps` runs on the host's clock."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return n_items / best


def host_rates(blobs, threads=4, size=224) -> dict:
    """The pretrain stream's host work on `blobs` (the last one broken
    past its header): where the loader builds, `decode_batch` at `size`
    with `crop_box` crops (scale 0.2-1) and flips on `threads` threads
    (images/s), its status on the broken slot, and C++ RandAugment on one
    thread (ms an image); on every host, PIL's path on one thread: decode +
    `TrainTransform` (images/s) and RandAugment's `apply_plan` alone (ms
    an image)."""
    from xfm_tpu_torch import native
    from xfm_tpu_torch.data.transforms import (TrainTransform, crop_box,
                                               decode_image)

    r = np.random.default_rng(0)
    t = TrainTransform(size, scale=(0.2, 1.0), seed=0)
    good = blobs[:-1]
    plans = [t.randaug.plan(r) for _ in good]
    out = {}
    pil = [np.asarray(decode_image(b).resize((size, size)), np.uint8)
           for b in good]
    out["pil_train_transform_images_per_s"] = _rate(
        lambda: [t(decode_image(b)) for b in good], len(good))
    out["pil_randaug_ms_per_image"] = 1e3 / _rate(
        lambda: [t.randaug.apply_plan(p, plan)
                 for p, plan in zip(pil, plans)], len(good))
    if not native.available():
        return out
    dims = [native.image_dims(b, fast=True) for b in blobs]
    crops = np.asarray([crop_box(w, h, (0.2, 1.0), rng=r) for w, h in dims],
                       np.int32)
    flips = (r.random(len(blobs)) < 0.5).astype(np.int32)
    images, status = native.decode_batch(blobs, size, crops, flips,
                                         threads=threads)
    out["status"] = status.tolist()
    if status[-1] != 1 or status[:-1].any():
        raise AssertionError(f"decode status {status.tolist()}")
    out[f"decode_images_per_s_{threads}_threads"] = _rate(
        lambda: native.decode_batch(blobs, size, crops, flips,
                                    threads=threads), len(blobs))
    out["decode_images_per_s_1_thread"] = _rate(
        lambda: native.decode_batch(blobs, size, crops, flips, threads=1),
        len(blobs))
    aug = images[:-1].copy()
    out["cpp_randaug_ms_per_image"] = 1e3 / _rate(
        lambda: native.randaugment_batch(aug, plans, 7, threads=1),
        len(good))
    return out


def device_randaug_check(B=96, S=224, seed=0) -> dict:
    """`device_aug`'s ops on a seeded uint8 batch [B, S, S, 3] on the card
    and on the CPU with the same signs (alternating): each within 1 level,
    the share of values apart; two rounds from the same injected draws
    (within 1 level a round); then `randaugment_batch` (draws from a card
    generator) timed with CUDA events, ms per two rounds."""
    from xfm_tpu_torch.data import device_aug as da

    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:S, 0:S]
    u8 = np.empty((B, S, S, 3), np.uint8)
    for b in range(B):
        wave = np.sin(xx * r.uniform(0.02, 0.1) + yy * r.uniform(0.02, 0.1))
        u8[b] = np.clip(r.randint(0, 256, 3) + 60 * wave[..., None]
                        * r.uniform(-1, 1, 3) + r.normal(0, 10, (S, S, 3)),
                        0, 255)
    cpu = torch.from_numpy(u8).float()
    gpu = cpu.cuda()
    sign = torch.tensor([1.0, -1.0] * (B // 2) + [1.0] * (B % 2))
    res = {}
    for name in da.RANDAUG_DEFAULT[1:]:
        a = torch.round(torch.clamp(da.apply_op(name, gpu, 7, sign.cuda()),
                                    0, 255)).cpu()
        c = torch.round(torch.clamp(da.apply_op(name, cpu, 7, sign), 0,
                                    255))
        d = (a - c).abs()
        res[name] = dict(max=float(d.max()), share_apart=float(
            (d > 0).float().mean()))
        if d.max() > 1.0:
            raise AssertionError(f"device RandAugment {name}: card vs CPU "
                                 f"{float(d.max())} levels apart")
    g = torch.Generator().manual_seed(seed)
    x_cpu, x_gpu = cpu, gpu
    for k in range(2):
        op, applied, neg = da.randaug_draws(B, len(da.RANDAUG_DEFAULT), g)
        x_cpu = da.randaug_round(x_cpu, op, applied, neg)
        x_gpu = da.randaug_round(x_gpu, op.cuda(), applied.cuda(),
                                 neg.cuda())
        d = (x_gpu.cpu() - x_cpu).abs()
        res[f"round_{k}"] = dict(max=float(d.max()), share_apart=float(
            (d > 0).float().mean()))
        if d.max() > 1.0:
            raise AssertionError(f"device RandAugment round {k}: card vs "
                                 f"CPU {float(d.max())} levels apart")
        x_cpu = x_gpu.cpu()
    images = torch.from_numpy(u8).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    res["ms_two_rounds"] = cuda_ms(
        lambda: da.randaugment_batch(images, gen), iters=10)
    return res


def input_task_runs(root, device_randaug: bool, bs=24, steps=3) -> dict:
    """`run.main` for `--task pretrain_DIY` on `Pretrain_base_4m.yaml`'s
    keys (its `num_workers` included) over `_pretrain_corpus` with the
    image-text and ImageNet images JPEGs of 300-1,600 px, `--bs`, `steps`
    steps, `device_randaug` on both blocks or off: each step's launches
    and losses, the dtype of the images each stream fed the model, the
    loader's batches, the result's rates."""
    import yaml

    from xfm_tpu_torch import configs, native, run
    from xfm_tpu_torch.models import XFMForPretrain
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks import pretrain

    files = _pretrain_corpus(root, n_pairs=48, n_regions=12, n_texts=48)
    r = np.random.RandomState(7)
    for kind in ("pairs", "imagenet"):
        with open(files[kind]) as f:
            rows = [json.loads(x) for x in f]
        blobs = _jpeg_blobs(r, len(rows), n_png=0)[:len(rows)]
        with open(files[kind], "w") as f:
            for row, blob in zip(rows, blobs):
                row["binary"] = base64.b64encode(blob).decode()
                f.write(json.dumps(row) + "\n")
    cfg = {k: v for k, v in configs.pretrain_yaml().items()
           if not k.startswith("_")}
    for block in ("images", "images_imagenet"):
        cfg[block] = dict(cfg[block], device_randaug=device_randaug)
    cfg.update(train_file=[files["pairs"]],
               train_file_regions=[files["regions"]],
               train_file_imagenet=[files["imagenet"]],
               train_file_text=[files["texts"]], max_steps=steps,
               ckpt_frequent_step=10 ** 6, print_freq=1)
    cfg_path = os.path.join(root, "in.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    rec = dict(steps=[], fed={})
    real_step, real_loss = pretrain.make_stream_step, XFMForPretrain.loss

    def make_stream_step(loss_fn):
        step_fn = real_step(loss_fn)

        def step(state, batches, gens):
            _sync()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batches, gens)
            rec["steps"].append(dict(
                s=time.perf_counter() - t0,
                launches=dict(kernels.LAUNCHES),
                losses={k: v.item() for k, v in metrics.items()}))
            return state, metrics

        return step

    def loss(self, images=None, **kw):
        if images is not None:
            rec["fed"][kw.get("data_source")] = str(images.dtype)
        return real_loss(self, images=images, **kw)

    before = native.DECODED["batches"]
    pretrain.make_stream_step = make_stream_step
    XFMForPretrain.loss = loss
    try:
        rec["result"] = run.main(["--task", "pretrain_DIY", "--config",
                                  cfg_path, "--output_dir",
                                  os.path.join(root, "out"), "--bs",
                                  str(bs), "--device", "cuda"])
    finally:
        pretrain.make_stream_step = real_step
        XFMForPretrain.loss = real_loss
    rec["loader_batches"] = native.DECODED["batches"] - before
    return rec


def input_phase(pt_throughput: dict, streams_prof: dict) -> dict:
    """Phase 25: the toolchain and the header probe, the loader's build;
    the host rates (`host_rates`); device RandAugment card vs CPU and its
    time (`device_randaug_check`); the task through the loader, off and
    with `device_randaug`, where the loader builds; `profile_step
    pretrain_randaug` beside phase 19's `pretrain_streams`
    (`streams_prof`, the same step without the RandAugment)."""
    import tempfile

    from xfm_tpu_torch import native, profile_step

    smi = nvidia_smi_line()
    gxx = shutil.which("g++")
    version = (subprocess.run([gxx, "--version"], capture_output=True,
                              text=True).stdout.splitlines()[0]
               if gxx else "g++ not found")
    t0 = time.perf_counter()
    reason = native.unavailable_reason()
    print(f"  host: {os.cpu_count()} CPUs; {version}; card {smi}")
    if reason is None:
        print(f"  header probe: jpeglib.h and png.h found; loader "
              f"{native.library_path()} ready in "
              f"{time.perf_counter() - t0:.1f} s")
    else:
        print(f"  native_loader: unavailable ({reason})")
    out = {"native_loader": reason or "built"}
    t0 = time.perf_counter()
    r = np.random.RandomState(25)
    blobs = _jpeg_blobs(r, 64)
    rates = host_rates(blobs)
    print(f"  host rates ({os.cpu_count()} CPUs, {smi}; "
          f"{time.perf_counter() - t0:.1f} s): " + json.dumps(rates))
    out["host_rates"] = rates
    t0 = time.perf_counter()
    aug = device_randaug_check()
    print(f"  device RandAugment [96, 224, 224, 3] ({smi}; "
          f"{time.perf_counter() - t0:.1f} s): " + json.dumps(aug))
    out["device_randaug"] = aug
    if reason is None:
        depth = 12
        want = dict(packed_attention_fwd=3 * depth,
                    packed_attention_bwd=3 * depth)
        for on in (False, True):
            root = tempfile.mkdtemp(prefix="xfm_in_")
            try:
                rec = input_task_runs(root, device_randaug=on)
            finally:
                shutil.rmtree(root, ignore_errors=True)
            for i, st in enumerate(rec["steps"]):
                got = {k: v for k, v in st["launches"].items() if v}
                if got != want or not all(math.isfinite(v) for v in
                                          st["losses"].values()):
                    raise AssertionError(f"device_randaug {on} step {i}: "
                                         f"{got} {st['losses']}")
            if (rec["loader_batches"] <= 0
                    or rec["fed"].get("image") != "torch.uint8"
                    or rec["fed"].get("imagenet") != "torch.uint8"):
                raise AssertionError(f"the loader's batches: "
                                     f"{rec['loader_batches']} {rec['fed']}")
            tp = {k: rec["result"].get(k) for k in (
                "samples_per_sec", "device_samples_per_sec")}
            print(f"  task device_randaug={on}: loader batches "
                  f"{rec['loader_batches']}, fed {json.dumps(rec['fed'])}, "
                  f"step s {[round(x['s'], 4) for x in rec['steps']]}, "
                  f"{json.dumps(tp)} ({os.cpu_count()} CPUs, {smi})")
            out[f"task_device_randaug_{on}"] = tp
    else:
        print("  task through the loader skipped (no loader); phase 19's "
              "run of the same keys decoded with PIL: "
              + json.dumps(pt_throughput))
    t0 = time.perf_counter()
    prof = profile_step.profile_pretrain_streams(
        None, steps=PROFILE_STEPS, by_stream=False,
        **profile_step.STREAM_UNITS["pretrain_randaug"])
    prof.pop("top")
    want = {k: 0 for k in prof["launches_per_step"]}
    want.update(packed_attention_fwd=36, packed_attention_bwd=36)
    if (prof["launches_per_step"] != want
            or prof["max_memory_allocated"] >= 80e9
            or not all(math.isfinite(v) for v in prof["losses"].values())):
        raise AssertionError("pretrain_randaug: launches, peak memory or "
                             "losses")
    keys = ("device_busy_ms", "idle_share", "device_span_ms", "host_ms",
            "randaug_busy_ms", "randaug_share", "max_memory_allocated",
            "mfu_busy")
    for unit, p in (("pretrain_randaug", prof),
                    ("pretrain_streams", streams_prof)):
        out[unit] = {k: p[k] for k in keys if k in p}
        print(f"  {unit} ({smi}): " + json.dumps(out[unit]))
    print(f"  profile {time.perf_counter() - t0:.1f} s")
    return out


PHASE_T = []  # when each phase began (time.perf_counter)
# the launches of phases 27 and 28 are killed where they would carry the
# run past this many seconds from its start (the run's limit is 1,200 s),
# so that a hung process group ends the run with its output rather than at
# the limit
DEADLINE_S = 1140.0


# --- phase 26: the Swin-B and DeiT towers and the BERT text encoder ---------

def k3_deit_inputs(B, N, H, dtype, seed):
    """q, k, v as a DeiT block hands them to K3: [B, N, H, 64] views of the
    qkv projection [B, N, 3·H·64], read in place; dout [B, N, H, 64]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    C = H * 64
    qkv = _device_randn(g, B, N, 3 * C).to(dtype)
    q, k, v = (t.reshape(B, N, H, 64) for t in qkv.split(C, -1))
    return q, k, v, _device_randn(g, B, N, H, 64).to(dtype)


def k3_deit_check(B=32, N=577, H=12, dtype=torch.bfloat16, seed=60) -> dict:
    """K3 with no bias at DeiT's shape: the forward and backward twice on
    the same inputs → the same bits, or raise; (out, dq, dk, dv) against
    the plain version within TOL (phase 8's gate) → the errors."""
    from xfm_tpu_torch.ops import flash_attention as fa

    q, k, v, dout = k3_deit_inputs(B, N, H, dtype, seed)
    scale = 64 ** -0.5
    runs = []
    for _ in range(2):
        out, stats = fa.flash_attention_fwd(q, k, v, None, scale)
        dq, dk, dv, db = fa.flash_attention_bwd(q, k, v, None, out, stats,
                                                dout, scale)
        if db is not None:
            raise AssertionError("K3 computed a db with no bias")
        runs.append((out, dq, dk, dv))
    torch.cuda.synchronize()
    names = ("out", "dq", "dk", "dv")
    for name, a, b in zip(names, *runs):
        if not torch.equal(a, b):
            raise AssertionError(f"K3 DeiT shape: {name} differs between "
                                 "two runs")
    print(f"  K3 B={B} N={N} H={H} no bias: out, dq, dk, dv bit-equal over "
          "two runs")
    refs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    ref = fa.flash_attention_reference(*refs, None, scale)
    ref.backward(dout)
    torch.cuda.synchronize()
    return _compare(f"K3 parity (DeiT's views) B={B} N={N} H={H} "
                    f"{str(dtype)[6:]} no bias",
                    list(zip(names, runs[0], [ref] + [r.grad for r in refs])),
                    dtype)


def tower_full_width(kind: str, steps: int = 5) -> dict:
    """The full-width retrieval fine-tune step of `kind` ("swin": Swin-B,
    window 12, + BERT-base; "deit": DeiT-B/16 + RoBERTa-base) at 384 px,
    B = 32, T = 40, bf16, dropout and drop-path live, the YAML's optimizer
    with its schedule over one step an epoch (lr 0 at the first step, 3e-5
    at the second, then down): `steps` steps on one batch, each read back;
    launches counted over them. Each step draws its masks and hard
    negatives from the generator reseeded to 0, so the loss depends on the
    weights alone (with a new draw a step, the draws' spread, ~0.05, hides
    what 3e-5 moves in 5 steps): finite, and the last below the first.
    → the times, losses, launches, peak memory, MFU and the state (for the
    checkpoint round trip)."""
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.ops import kernels

    make = (configs.make_swin_retrieval_train_run if kind == "swin"
            else configs.make_deit_retrieval_train_run)
    state, batch, step = make(32, 40, steps_per_epoch=1)
    cfg = state.model.config
    gen = torch.Generator(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen.manual_seed(0))
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    dt = float(np.median(times[1:]))
    flops = configs.tower_retrieval_step_flops(cfg, 32, 40)
    res = dict(step_ms=dt * 1e3, samples_per_s=32 / dt,
               mfu=flops / dt / PEAK_FLOPS[torch.bfloat16],
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               losses=losses, step_s=times, launches=launches,
               params=sum(p.numel() for p in state.model.parameters()))
    print(f"  {kind} full width: " + json.dumps(res))
    if not all(math.isfinite(v) for v in losses) or not (
            losses[-1] < losses[0]):
        raise AssertionError(f"{kind} full width: losses {losses}")
    depth = 0 if kind == "swin" else cfg.vision.depth
    want = {name: 0 for name in kernels.LAUNCHES}
    want.update(flash_attention_fwd=depth * steps,
                flash_attention_bwd=depth * steps)
    if launches != want:
        raise AssertionError(f"{kind} full width: launches {launches}, "
                             f"expected {want}")
    res["state"] = state
    return res


def swin_checkpoint_round_trip(model) -> dict:
    """A seeded Swin-B tower at 224 px, window 7, under the reference's
    names (Conv2d patch weight, the `relative_position_index` and
    `attn_mask` buffers a released checkpoint holds) loaded through
    `load_xfm_checkpoint` into `model` (window 12): each table [169, H]
    the port's `_interp_swin_table` of its source to [529, H], every other
    tower weight as it was, nothing unexpected, only non-tower entries
    missing."""
    import dataclasses

    from xfm_tpu_torch.models.swin import SwinTransformer
    from xfm_tpu_torch.ops.patch_embed import patch_kernel_from_conv
    from xfm_tpu_torch.train import checkpoint as ck

    src = SwinTransformer(dataclasses.replace(
        model.config.vision, image_res=224, window_size=7,
        dtype=torch.float32))
    ck.init_weights(src, 5)
    sd = {f"vision_encoder.{k}": v
          for k, v in ck.reference_state_dict(src).items()}
    sd.update({f"vision_encoder.{k}": b for k, b in src.named_buffers()})
    t0 = time.perf_counter()
    missing, unexpected = ck.load_xfm_checkpoint(model, sd)
    _sync()
    secs = time.perf_counter() - t0
    got = model.state_dict()
    n_tables = 0
    for k, v in sd.items():
        if k.endswith(("relative_position_index", "attn_mask")):
            continue
        if k.endswith("relative_position_bias_table"):
            want = torch.from_numpy(ck._interp_swin_table(v.numpy(), 529))
            n_tables += 1
        elif k.endswith("patch_embed.proj.weight"):
            want = patch_kernel_from_conv(v)
        else:
            want = v
        if not torch.equal(got[k].float().cpu(), want.float()):
            raise AssertionError(f"Swin round trip: {k}")
    tower_missing = [k for k in missing if k.startswith("vision_encoder.")]
    res = dict(s=secs, tables=n_tables, entries=len(sd),
               missing_outside_tower=len(missing), unexpected=unexpected)
    print("  Swin-B window 7 → 12 checkpoint: " + json.dumps(res))
    if unexpected or tower_missing or n_tables != sum(
            model.config.vision.depths):
        raise AssertionError(f"Swin round trip: unexpected {unexpected}, "
                             f"tower entries missing {tower_missing}")
    return res


def swin_task_runs(root, n_train=16, n_test=8, bs=16, seed=0,
                   device="cuda") -> dict:
    """`run.main` for `--task itr_coco` on `Retrieval_coco.yaml`'s keys with
    `use_swin: true`, `vision_config: configs/model/config_swinB_384.json`
    and `text_encoder: data/bert-base-uncased` (absent: the tokenizer falls
    back to the captions' words) over `_finetune_corpus`, `--bs` 16,
    `--epoch 1`: the zero-shot and the epoch's evals, each step's loss;
    then `--evaluate --checkpoint` from its own `ckpt/0/state.pt`, whose
    R@K must be the epoch's. No kernel is launched: the windows hold 144
    tokens, and the grouped rerank's keys are the 145 image rows."""
    import yaml

    from xfm_tpu_torch import configs, run
    from xfm_tpu_torch.ops import kernels

    train, test = _finetune_corpus(root, n_train, n_test, seed)
    cfg = {k: v for k, v in configs.swin_retrieval_yaml().items()
           if k not in ("val_file", "_vision")}
    cfg.update(train_file=[train], test_file=test, image_root=root)
    cfg_path = os.path.join(root, "Retrieval_coco.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = os.path.join(root, "out")
    argv = ["--task", "itr_coco", "--config", cfg_path, "--output_dir", out,
            "--bs", str(bs), "--epoch", "1", "--seed", str(seed),
            "--device", device]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = run.main(argv)
    _sync()
    train_s = time.perf_counter() - t0
    with open(os.path.join(out, "log.txt")) as f:
        log = [json.loads(x) for x in f.read().splitlines()]
    ckpt = os.path.join(out, "ckpt", "0", "state.pt")
    t0 = time.perf_counter()
    metrics = run.main(argv + ["--evaluate", "--checkpoint", ckpt])
    _sync()
    eval_s = time.perf_counter() - t0
    res = dict(train_s=train_s, evaluate_s=eval_s, result=result,
               log=log, evaluate=metrics, launches=dict(kernels.LAUNCHES),
               checkpoint_bytes=os.path.getsize(ckpt))
    print("  itr_coco with use_swin: " + json.dumps(res, default=float))
    epoch = [e for e in log if e["epoch"] == 0]
    if ([e["epoch"] for e in log] != [-1, 0] or not all(
            math.isfinite(epoch[0][k]) for k in ("loss_itc", "loss_itm"))
            or any(res["launches"].values())):
        raise AssertionError("itr_coco with use_swin: log or launches")
    for k in ("txt_r1", "txt_r5", "img_r1", "img_r5", "r_mean"):
        if float(metrics[k]) != float(epoch[0][k]):
            raise AssertionError(f"--evaluate from ckpt/0: {k} "
                                 f"{metrics[k]} vs the epoch's "
                                 f"{epoch[0][k]}")
    return res


def tower_phase() -> dict:
    """Phase 26 → (K3's errors, times and bound at DeiT's shape, the DeiT
    step's launches, the profiles)."""
    import tempfile

    from xfm_tpu_torch import profile_step

    smi = nvidia_smi_line()
    k3d_err = k3_deit_check()
    q, k, v, dout = k3_deit_inputs(32, 577, 12, torch.bfloat16, 61)
    k3d_t = k3_times(32, 577, 12, torch.bfloat16, inputs=(q, k, v, dout))
    del q, k, v, dout
    k3d_w = k3_work(32, 577, 577, 12, 64, torch.bfloat16)
    print(f"  K3 DeiT shape times (ms, {smi}): " + json.dumps(k3d_t))
    print("  K3 DeiT shape bound (k3_work): " + json.dumps(k3d_w))
    slice_parity("swin_retrieval")
    slice_parity("deit_retrieval")
    swin = tower_full_width("swin")
    swin_checkpoint_round_trip(swin.pop("state").model)
    torch.cuda.empty_cache()
    deit = tower_full_width("deit")
    del deit["state"]
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="xfm_swin_")
    try:
        swin_task_runs(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    prof = profile_step.profile_tower_retrieval(None,
                                                 steps=PROFILE_STEPS)
    for unit, res in prof.items():
        top = res.pop("top")
        print(f"  {unit} profile ({smi}): " + json.dumps(res))
        for name, ms, n in top[:8]:
            print(f"    {ms:9.3f} ms/step {n:6d} calls/step  {name}")
        depth = 12 if unit == "deit_retrieval_train" else 0
        want = {name: 0 for name in res["launches"]}
        want.update(flash_attention_fwd=depth, flash_attention_bwd=depth)
        if res["launches"] != want or res["max_memory_allocated"] >= 80e9:
            raise AssertionError(f"{unit}: launches or peak memory")
    print(f"  peak memory (B): Swin-B + BERT step "
          f"{swin['max_memory_allocated']}, DeiT-B step "
          f"{deit['max_memory_allocated']}")
    return dict(k3=(k3d_err, k3d_t, k3d_w), deit_launches=deit["launches"],
                prof=prof)


def tower_kernel_entries(k3d_err, k3d_t, k3d_w, launches) -> list:
    """The `kernels` entries of K3 at DeiT's shape, q/k/v [32, 577, 12, 64]
    with no bias, forward and backward, their launches from phase 26's
    DeiT steps."""
    out = kernel_entries("flash_attention", "xfm_tpu/ops/flash_attention.py",
                         71, 334, "xfm_tpu_torch/csrc/flash_attention.cu",
                         k3d_err, ("dq", "dk", "dv"), k3d_t, k3d_w,
                         launches, also_bwd=227)
    for e in out:
        e["name"] += "_deit_b577"
    return out


# --- phase 29: activation checkpointing; the BEiT-2-large pretrain task ------

# the --bs at which the plain step and every policy are compared (each
# stream's batch; the region stream keeps the YAML's 80 images): the plain
# step fits there beside the checkpointed ones
REMAT_BS = 24
# the large step profiled at `--bs REMAT_BS` (None: checkpointing off),
# beside `full` at the YAML's batches: none, for the script's clock (every
# policy is held bit-equal to the plain step by `remat_on_off`, and
# `profile_step pretrain_large_remat` profiles each at 24)
REMAT_PROFILED = ()
REMAT_POLICIES = ("full", "dots", "except_attn", "attn_out")
# checkpointing on against off on the card (bf16, live dropout and
# drop-path from one seeded generator) is held bit for bit, loss and every
# gradient, under `torch.use_deterministic_algorithms`: the recompute is
# the forward's arithmetic on the forward's values and masks, K1's bf16
# kernels are deterministic, and the mode swaps PyTorch's atomic
# accumulations (index_add_, index_put_) for ordered ones. Without it the
# plain step against itself already differs (its relative l2 gap printed)


def large_yaml(depth=None, **keys) -> dict:
    """`configs.pretrain_large_yaml(**keys)` with every tower cut to
    `depth` blocks or layers where given."""
    from xfm_tpu_torch import configs

    if depth:
        keys = dict(vision_depth=depth, text_num_hidden_layers=depth,
                    text_fusion_start_at=depth,
                    fusion_num_hidden_layers=depth, **keys)
    return configs.pretrain_large_yaml(**keys)


def large_model_config(yaml_cfg, dtype=None):
    """The pretrain task's model config of `yaml_cfg` (every head on)."""
    from xfm_tpu_torch.models.xfm import config_from_yaml

    return config_from_yaml(yaml_cfg, use_contrastive_loss=True,
                            use_matching_loss=True, use_mlm_loss=True,
                            use_bbox_loss=True, dtype=dtype)


def k1_launches_per_pass(depth: int, policy) -> tuple:
    """K1's (forward, backward) launches of one image-bearing stream's
    tower pass under `policy` (None: checkpointing off): a block
    checkpoint reruns the block's forward before its backward, so its K1
    forward twice; `except_attn` checkpoints no block."""
    again = policy not in (None, "except_attn")
    return (depth * (2 if again else 1), depth)


def remat_on_off(B=8) -> dict:
    """bf16 at the large tower's width (1024, 16 heads) and the text
    side's, depth 2, on the card: the image-text stream's loss
    (`XFMForPretrain.loss` under the YAML's flags, dropout and drop-path
    live from one seeded generator) and every gradient. The plain step
    twice in the default mode (→ their relative l2 gradient gap), then,
    under deterministic algorithms, the plain step and the step under each
    policy from the same weights → the loss and every gradient bit-equal,
    the generator's end state equal, K1's launches as
    `k1_launches_per_pass` says. → {"off_vs_off": that gap, policy: K1's
    (forward, backward) launches}."""
    import dataclasses

    from xfm_tpu_torch import configs
    from xfm_tpu_torch.models import XFMForPretrain
    from xfm_tpu_torch.models.task_models import LOSS_KEYS
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks.pretrain import stream_flags

    yaml_cfg = large_yaml(depth=2, gradient_checkpointing=False)
    cfg = large_model_config(yaml_cfg, torch.bfloat16)
    sizes = dict(configs.stream_batch_sizes(yaml_cfg), image=B)
    nb = configs.make_stream_batches(sizes, cfg.vision.image_res,
                                     cfg.text.vocab_size, seed=4)
    batch = configs.batch_to_torch(nb["image"], "cuda")
    flags = stream_flags("image", 0, yaml_cfg)
    base = build_model(XFMForPretrain, cfg, "cuda", seed=7)
    weights = base.state_dict()

    def run(model):
        model.zero_grad(set_to_none=True)
        kernels.reset_launch_counts()
        g = torch.Generator(device="cuda").manual_seed(11)
        out = model.loss(**batch, **flags, generator=g, deterministic=False)
        loss = sum(out[k] for k in LOSS_KEYS)
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.float() for n, p in model.named_parameters()
                 if p.grad is not None}
        return (loss.item(), grads, dict(kernels.LAUNCHES),
                g.get_state().clone())

    a, b = run(base)[1], run(base)[1]
    noise = math.sqrt(sum(((b[n] - a[n]) ** 2).sum().item() for n in a)
                      / sum((a[n] ** 2).sum().item() for n in a))
    print(f"  remat on/off (bf16, depth 2, B={B}): the plain step against "
          f"itself in the default mode, relative l2 gradient gap "
          f"{noise:.3e}")
    res = {"off_vs_off": noise}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref = run(base)
        for policy in REMAT_POLICIES:
            on = dict(remat=True, remat_policy=policy)
            pcfg = dataclasses.replace(
                cfg, vision=dataclasses.replace(cfg.vision, **on),
                text=dataclasses.replace(cfg.text, **on),
                fusion=dataclasses.replace(cfg.fusion, **on))
            with torch.device("cuda"):
                model = XFMForPretrain(pcfg)
            model.load_state_dict(weights)
            loss, grads, launches, state = run(model)
            same = sum(1 for n in ref[1] if n in grads
                       and torch.equal(grads[n], ref[1][n]))
            k1 = (launches["packed_attention_fwd"],
                  launches["packed_attention_bwd"])
            want = k1_launches_per_pass(2, policy)
            print(f"  remat {policy} (deterministic algorithms): loss "
                  f"{loss!r} (off {ref[0]!r}), gradients bit-equal "
                  f"{same}/{len(ref[1])}, K1 {k1} (expected {want}), "
                  f"generator state equal {torch.equal(state, ref[3])}")
            if (loss != ref[0] or set(grads) != set(ref[1])
                    or same != len(ref[1]) or k1 != want
                    or not torch.equal(state, ref[3])):
                raise AssertionError(f"remat {policy} on the card differs "
                                     f"from the plain step")
            res[policy] = k1
            del model, grads
    finally:
        torch.use_deterministic_algorithms(False)
    del base
    torch.cuda.empty_cache()
    return res


def remat_task(bs=REMAT_BS, steps=2) -> dict:
    """`run.main` for `--task pretrain_DIY` with the large YAML
    (`configs.PRETRAIN_LARGE_KEYS`: BEiT-2-large, `gradient_checkpointing:
    true`, policy `full`) over `_pretrain_corpus`, `--bs`, `steps` steps:
    finite losses, non-zero where the streams' flags ask; K1 (2·24) + 24
    launches a step for each of the three image-bearing streams and no
    other kernel. The output directory is deleted at the end."""
    import tempfile

    from xfm_tpu_torch import configs

    root = tempfile.mkdtemp(prefix="xfm_large_")
    try:
        runs = pretrain_task_runs(root, bs=bs, steps=steps, ckpt_every=steps,
                                  keys=configs.PRETRAIN_LARGE_KEYS,
                                  resume=False)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r = runs["full"]
    fwd, bwd = k1_launches_per_pass(24, "full")
    print(f"  large task: {r['s']:.1f} s, peak memory "
          f"{r['max_memory_allocated']} B, step s "
          f"{[round(x['s'], 4) for x in r['steps']]}, checkpoint "
          f"{runs['checkpoint_bytes']} B")
    for i, st in enumerate(r["steps"]):
        print(f"    step {i}: {json.dumps(st['launches'])} "
              f"{json.dumps(st['losses'])}")
        want = {k: 0 for k in st["launches"]}
        want.update(packed_attention_fwd=3 * fwd,
                    packed_attention_bwd=3 * bwd)
        if st["launches"] != want or len(st["streams"]) != 4:
            raise AssertionError(f"large task step {i}: launches "
                                 f"{st['launches']}, expected {want}")
        if not all(math.isfinite(v) for v in st["losses"].values()) or any(
                st["losses"][f"{n}_loss_{k}"] == 0.0 for n, k in (
                    ("image", "itc"), ("image", "mim"), ("region", "bbox"),
                    ("imagenet", "mim"), ("text", "mlm"))):
            raise AssertionError(f"large task step {i}: losses")
    if len(r["steps"]) != steps:
        raise AssertionError("large task: steps")
    return dict(step_s=[x["s"] for x in r["steps"]], run_s=r["s"],
                max_memory_allocated=r["max_memory_allocated"],
                launches_per_step=r["steps"][0]["launches"])


def remat_profiles(bs=REMAT_BS) -> dict:
    """`profile_step.profile_pretrain_streams` with the large tower at
    `--bs` `bs` for each entry of `REMAT_PROFILED` (None: checkpointing
    off; one model each, one warm-up step, streams not taken alone), then
    under `full` at the YAML's batches (96 a stream; 2 warm-up steps,
    each stream alone too)
    → {"off" | policy | "full_yaml":
    {busy ms, span ms, idle share, peak bytes, K1 launches a step, MFU
    over busy}, "full_yaml_by_stream": launches by stream}. Each run's K1
    launches as `k1_launches_per_pass` says for three streams, peak
    memory under 80 GB, finite losses."""
    from xfm_tpu_torch import configs, profile_step

    out = {}
    runs = [(p, bs) for p in REMAT_PROFILED] + [("full", None)]
    for policy, b in runs:
        keys = dict(configs.PRETRAIN_LARGE_KEYS,
                    gradient_checkpointing=policy is not None,
                    remat_policy=policy or "full")
        res = profile_step.profile_pretrain_streams(
            None, steps=PROFILE_STEPS, bs=b, by_stream=b is None,
            warmup=2 if b is None else 1, **keys)
        tag = "full_yaml" if b is None else (policy or "off")
        fwd, bwd = k1_launches_per_pass(24, policy)
        want = {k: 0 for k in res["launches_per_step"]}
        want.update(packed_attention_fwd=3 * fwd,
                    packed_attention_bwd=3 * bwd)
        row = dict(device_busy_ms=res["device_busy_ms"],
                   device_span_ms=res["device_span_ms"],
                   idle_share=res["idle_share"],
                   max_memory_allocated=res["max_memory_allocated"],
                   k1_launches=[res["launches_per_step"][
                       "packed_attention_fwd"], res["launches_per_step"][
                       "packed_attention_bwd"]],
                   mfu_busy=res["mfu_busy"])
        print(f"  pretrain_large {tag} (--bs {b or 'the YAML'}): "
              + json.dumps(row))
        if (res["launches_per_step"] != want
                or res["max_memory_allocated"] >= 80e9
                or not all(math.isfinite(v)
                           for v in res["losses"].values())):
            raise AssertionError(f"pretrain_large {tag}: launches, peak "
                                 f"memory or losses")
        out[tag] = row
        if b is None:
            out["full_yaml_by_stream"] = res["launches_by_stream"]
        del res
        torch.cuda.empty_cache()
    return out


def remat_phase() -> dict:
    """Phase 29 → (K1's errors, times and bounds at the large tower's two
    shapes, the profiles)."""
    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    k1_large = {}
    for B in (192, 80):
        err = k1_parity(B=B, N=197, H=16, dtype=torch.bfloat16, seed=40 + B)
        k1_parity(B=B, N=197, H=16, dtype=torch.float32, seed=41 + B)
        t = k1_times(B=B, N=197, H=16, dtype=torch.bfloat16)
        w = k1_work(B=B, N=197, H=16, D=64, dtype=torch.bfloat16)
        print(f"  K1 H=16 B={B} times (ms, {smi}): " + json.dumps(t))
        print(f"  K1 H=16 B={B} bound (k1_work): " + json.dumps(w))
        k1_large[B] = (err, t, w)
    R = 192 * 197  # the pair pass's rows at the YAML's 96
    for dtype in (torch.bfloat16, torch.float32):
        k4_parity("add", R, 1024, dtype, seed=70)
        k5_parity("gelu_tanh", R, dtype, K=4096, N=1024, seed=71)
    k4 = dict(times=k4_times(R, 1024, torch.bfloat16),
              work=k4_work(R, 1024, torch.bfloat16))
    k5 = dict(times=k5_times(R, torch.bfloat16, K=4096, N=1024),
              work=k5_work(R, 4096, 1024, torch.bfloat16))
    print(f"  K4 add R={R} C=1024 ({smi}): " + json.dumps(k4))
    print(f"  K5 gelu_tanh M={R} K=4096 N=1024 ({smi}): " + json.dumps(k5))
    cfg = large_model_config(large_yaml(depth=2), torch.float32)
    if not (cfg.vision.remat and cfg.text.remat and cfg.fusion.remat):
        raise AssertionError("the large YAML does not checkpoint")
    t1 = time.perf_counter()
    # the image-text stream runs the tower's pair pass and the text and
    # fusion stacks, the region stream the tower over its images
    stream_slice_parity(cfg, large_yaml(depth=2), ("image", "region"),
                        k1_launches_per_pass(2, "full"), " large remat")
    t2 = time.perf_counter()
    print("  remat on/off: " + json.dumps(remat_on_off()))
    t3 = time.perf_counter()
    task = remat_task()
    print("  large task: " + json.dumps(task))
    t4 = time.perf_counter()
    prof = remat_profiles()
    print(f"  phase 29 seconds: kernels {t1 - t0:.1f}, slice {t2 - t1:.1f}, "
          f"on/off {t3 - t2:.1f}, task {t4 - t3:.1f}, profiles "
          f"{time.perf_counter() - t4:.1f}")
    return dict(k1=k1_large, prof=prof, task=task)


def _dp_env() -> dict:
    """The environment of phase 27's launches: NCCL bootstraps over the
    loopback interface (the card's machine has no network)."""
    env = dict(os.environ, NCCL_SOCKET_IFNAME="lo", OMP_NUM_THREADS="4")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep)
                  if x])
    return env


def _torchrun(nproc: int, args: list) -> subprocess.Popen:
    """`torchrun --standalone --nproc_per_node=nproc` of `args`, started."""
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={nproc}", *args], cwd=REPO, env=_dp_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)  # its own group: a kill takes its workers


def _finish(proc: subprocess.Popen, tag: str, timeout: float = 300) -> str:
    """A launch waited for (killed at `timeout` s, or sooner where the run
    would pass DEADLINE_S) → its standard output; a non-zero exit raises
    with the ends of both streams."""
    if PHASE_T:
        left = DEADLINE_S - (time.perf_counter() - PHASE_T[0])
        timeout = max(10.0, min(timeout, left))
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        print(f"{tag}: killed after waiting {timeout:.0f} s", file=sys.stderr)
    if proc.returncode != 0:
        print(out[-3000:], err[-3000:])
        print(err[-3000:], file=sys.stderr)
        raise AssertionError(f"{tag}: exit {proc.returncode}")
    return out


def _processes_line(out: str, tag: str):
    """The launcher's `### processes W backend B launches by rank [...]`
    line → (W, B, [each rank's launches])."""
    for line in out.splitlines():
        if line.startswith("### processes "):
            head, launches = line.split(" launches by rank ", 1)
            words = head.split()
            return int(words[2]), words[4], json.loads(launches)
    raise AssertionError(f"{tag}: no '### processes' line")


def _last_log(out_dir: str) -> list:
    with open(os.path.join(out_dir, "log.txt")) as f:
        return [json.loads(x) for x in f.read().splitlines()]


def _launch_counts(by_rank, want: dict, tag: str) -> None:
    for r, got in enumerate(by_rank):
        print(f"  {tag} rank {r} launches {json.dumps(got)}")
        if got != want:
            raise AssertionError(f"{tag} rank {r}: launches {got}, "
                                 f"expected {want}")


def _layout_tag(parallel) -> str:
    return "_".join(f"{k}{v}" for k, v in sorted((parallel or {}).items()))


def dp_step_worker(out_dir: str, parallel=None, B: int = 32,
                   f32: bool = False, one_card: bool = False,
                   fused: bool = False) -> int:
    """`python3 chip_smoke.py --dp-step OUT [PARALLEL [f32] [one-card]
    [fused]]` under torchrun (or called in this process: one process): the
    full-width bf16 (with `f32`, f32) pretrain step
    (`configs.make_pretrain_run`, weights from seed 0, with `fused` on
    both fused routes; with PARALLEL, a YAML `parallel` block as JSON
    ("{}" for none), the state placed as a task places it: cut where
    `tensor` > 1, sharded where `fsdp` > 1) on rank r's rows of a fixed
    global batch of `B` with fixed hard negatives (the next row of the
    global batch); rank 0 writes the step's reduced losses and gradient
    norm, the kernels it launched and every rank's peak memory to
    OUT/dp_step_<W>[_<layout>][_fused][_f32][_one_card].json. With
    `one_card` every rank computes on card 0 and the group runs on gloo,
    whose collectives take CUDA tensors (NCCL puts one rank on a card);
    there, in the same processes, a layout with `tensor` > 1 is run again
    with `seq_shard` (as it is, and fused), then the CLIP-ViT and DeiT
    retrieval steps under it in bf16 and f32 (`tower_step`; rank 0 writes
    OUT/dp_tower_<W>_<kind>[_f32]_one_card.json), then phase 32's blocks
    (`seq_tower_group_checks`, printed by rank 0)."""
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.core import mesh, partitioning
    from xfm_tpu_torch.ops import kernels

    if one_card:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method="env://",
                                world_size=int(os.environ["WORLD_SIZE"]),
                                rank=int(os.environ["RANK"]))
    dev = mesh.maybe_init_distributed("cuda")
    cut_layout = one_card and int((parallel or {}).get("tensor", 1)) > 1
    layouts = [(parallel, fused)]
    if cut_layout:
        seq = dict(parallel, seq_shard=True)
        layouts += [(seq, False), (seq, True)]

    def peaks() -> list:
        peak = torch.cuda.max_memory_allocated()
        if not dist.is_initialized():
            return [peak]
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, peak)
        return out

    def write(name: str, vals: dict) -> None:
        if mesh.rank() == 0:
            with open(os.path.join(out_dir, name), "w") as f:
                json.dump(vals, f)

    for par, fz in layouts:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, batch, step = configs.make_pretrain_run(
            B=B, device=dev, parallel=par or None,
            fused_ln=fz or None, fused_mlp=fz or None,
            dtype=torch.float32 if f32 else torch.bfloat16)
        roll = torch.roll(torch.arange(B, device=dev), -1)
        batch = mesh.rank_slice(dict(batch, hard_negatives=(roll, roll)))
        kernels.reset_launch_counts()
        state, metrics = step(state, batch, None)
        vals = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
        vals["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        vals["peak_bytes_by_rank"] = peaks()
        del state, batch, step, metrics
        write(f"dp_step_{mesh.world_size()}"
              f"{f'_{_layout_tag(par)}' if par else ''}"
              f"{'_fused' if fz else ''}{'_f32' if f32 else ''}"
              f"{'_one_card' if one_card else ''}.json", vals)
    if cut_layout:
        for kind in TOWER_KINDS:
            for t32 in (False, True):
                vals = tower_step(kind, parallel, f32=t32)
                vals.pop("peak_bytes")
                vals["peak_bytes_by_rank"] = peaks()
                write(f"dp_tower_{mesh.world_size()}_{kind}"
                      f"{'_f32' if t32 else ''}_one_card.json", vals)
        torch.cuda.empty_cache()
        mesh.use_mesh(mesh.mesh_from_config({"parallel": parallel}))
        seq_tower_group_checks(partitioning.model_cut())
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def dp_fixed_batch(root: str) -> dict:
    """Phase 27 on two cards or more: `dp_step_worker` on one process and
    on two, one after the other → the two steps' values, the losses held
    to each other within DP_LOSS_RTOL and the gradient norms within
    DP_GRAD_NORM_RTOL."""
    got = {}
    for n in (1, 2):
        _finish(_torchrun(n, [os.path.join(REPO, "chip_smoke.py"),
                              "--dp-step", root]), f"dp-step W={n}")
        with open(os.path.join(root, f"dp_step_{n}.json")) as f:
            got[n] = json.load(f)
        print(f"  fixed global batch of 32, W = {n}: {json.dumps(got[n])}")
    for k in ("loss", "loss_itc", "loss_itm", "loss_mlm", "loss_mim",
              "grad_norm"):
        a, b = got[1][k], got[2][k]
        tol = DP_GRAD_NORM_RTOL if k == "grad_norm" else DP_LOSS_RTOL
        if not abs(a - b) <= tol * abs(a):
            raise AssertionError(f"fixed global batch: {k} {b} on two "
                                 f"processes, {a} on one")
    return got


def dp_phase(zero_shot_r_mean: float, keep_root: bool = False) -> dict:
    """Phase 27 (see the module docstring); its directory deleted at the
    end, or with `keep_root` left for phase 30 (`result["root"]`), which
    deletes it."""
    import tempfile

    import yaml

    from xfm_tpu_torch import configs, run
    from xfm_tpu_torch.ops import kernels

    W = torch.cuda.device_count()
    depth = configs.xfm_base_pretrain_config().vision.depth
    root = tempfile.mkdtemp(prefix="xfm_dp_")
    try:
        os.makedirs(os.path.join(root, "pt"))
        files = _pretrain_corpus(os.path.join(root, "pt"))
        if W > 1:  # a shard a rank at least (the reader splits by file)
            for kind, path in files.items():
                with open(path) as f:
                    lines = f.read().splitlines()
                files[kind] = []
                for r in range(W):
                    files[kind].append(f"{path[:-6]}_{r}.jsonl")
                    with open(files[kind][-1], "w") as f:
                        f.write("\n".join(lines[r::W]) + "\n")
        shards = {k: v if isinstance(v, list) else [v]
                  for k, v in files.items()}
        cfg = {k: v for k, v in configs.pretrain_yaml().items()
               if not k.startswith("_")}
        cfg.update(train_file=shards["pairs"],
                   train_file_regions=shards["regions"],
                   train_file_imagenet=shards["imagenet"],
                   train_file_text=shards["texts"], max_steps=2,
                   ckpt_frequent_step=2, print_freq=1)
        pt_cfg = os.path.join(root, "pt.yaml")
        with open(pt_cfg, "w") as f:
            yaml.safe_dump(cfg, f)
        # the run without torchrun also saves step 1, whose parameters
        # measure its second update
        plain_cfg = os.path.join(root, "pt_plain.yaml")
        with open(plain_cfg, "w") as f:
            yaml.safe_dump(dict(cfg, ckpt_frequent_step=1), f)
        ft_cfg = os.path.join(root, "ft.yaml")
        if W > 1:
            ft_root = os.path.join(root, "ft")
            os.makedirs(ft_root)
            train, test = _finetune_corpus(ft_root, 36, 16, 0)
            ft = {k: v for k, v in configs.RETRIEVAL_COCO.items()
                  if k != "val_file"}
            ft.update(train_file=[train], test_file=test, image_root=ft_root)
            with open(ft_cfg, "w") as f:
                yaml.safe_dump(ft, f)
        out = {k: os.path.join(root, k) for k in ("pt_tr", "pt_plain",
                                                  "ft_tr", "ft_ev")}
        pt_args = ["--task", "pretrain_DIY", "--config", pt_cfg,
                   "--device", "cuda"]
        ft_args = ["-m", "xfm_tpu_torch.run", "--task", "itr_coco",
                   "--config", ft_cfg, "--device", "cuda", "--seed", "0"]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pt_tr = _torchrun(W, ["-m", "xfm_tpu_torch.run", *pt_args,
                              "--bs", str(24 * W), "--output_dir",
                              out["pt_tr"]])
        # itr_coco under torchrun with two cards or more; with one, phase
        # 18 ran its epoch, eval and checkpoint in this process, and the
        # pretrain launch shows the torchrun path
        ft_tr = (_torchrun(W, [*ft_args, "--bs", "24", "--epoch", "1",
                               "--output_dir", out["ft_tr"]])
                 if W > 1 else None)
        kernels.reset_launch_counts()
        run.main(["--task", "pretrain_DIY", "--config", plain_cfg,
                  "--device", "cuda", "--bs", "24", "--output_dir",
                  out["pt_plain"]])
        plain_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        t_plain = time.perf_counter() - t0
        pt_out = _finish(pt_tr, "pretrain_DIY under torchrun")
        ft_out = (_finish(ft_tr, "itr_coco under torchrun") if ft_tr
                  else None)
        t_both = time.perf_counter() - t0
        ev_launches = None
        if ft_tr is not None:
            torch.cuda.empty_cache()
            ev_args = [*ft_args, "--evaluate", "--checkpoint",
                       os.path.join(out["ft_tr"], "ckpt", "0", "state.pt"),
                       "--output_dir", out["ft_ev"]]
            ev_launches = _processes_line(_finish(
                _torchrun(W, ev_args), "itr_coco --evaluate"),
                "itr_coco --evaluate")[2]
        t_all = time.perf_counter() - t0
        print(f"  seconds: the plain pretrain run {t_plain:.1f} (the "
              f"torchrun runs beside it, all done at {t_both:.1f}), the "
              f"eval {t_all - t_both:.1f}")

        world, backend, by_rank = _processes_line(pt_out, "pretrain_DIY")
        print(f"  pretrain_DIY under torchrun: world {world}, backend "
              f"{backend}")
        if world != W or backend != "nccl":
            raise AssertionError(f"pretrain_DIY: world {world}, backend "
                                 f"{backend}")
        k1 = {"packed_attention_fwd": 2 * 3 * depth,
              "packed_attention_bwd": 2 * 3 * depth}
        _launch_counts(by_rank, k1, "pretrain_DIY")
        _launch_counts([plain_launches], k1, "pretrain_DIY without torchrun")
        tr_losses, plain_losses = (
            [x for e in _last_log(out[k]) for x in e["losses"]]
            for k in ("pt_tr", "pt_plain"))
        print(f"  reduced loss of each step: torchrun {tr_losses}, "
              f"without {plain_losses}")
        if len(tr_losses) != 2 or not all(map(math.isfinite, tr_losses)):
            raise AssertionError(f"pretrain_DIY losses {tr_losses}")
        result = dict(world=world, backend=backend, pretrain_launches=by_rank,
                      pretrain_losses=tr_losses, seconds=t_all)
        if W == 1:
            result.update(held_to_plain(out["pt_tr"], out["pt_plain"],
                                        tr_losses, plain_losses,
                                        "W = 1 under torchrun"))

        if ft_out is None:
            print("  itr_coco under torchrun: not run, this machine has one "
                  "card (phase 18 ran its epoch, eval and resume in this "
                  "process; the pretrain launch above takes the torchrun "
                  "path)")
            return _dp_end(result, W, root, keep_root)
        world, backend, by_rank = _processes_line(ft_out, "itr_coco")
        ft_log = _last_log(out["ft_tr"])
        print(f"  itr_coco under torchrun: world {world}, backend "
              f"{backend}; R_mean zero-shot {ft_log[0]['r_mean']} (phase "
              f"18: {zero_shot_r_mean}), after the epoch "
              f"{ft_log[1]['r_mean']}; losses {ft_log[1]['loss_itc']}, "
              f"{ft_log[1]['loss_itm']}")
        for r, got in enumerate(by_rank):
            print(f"  itr_coco rank {r} launches {json.dumps(got)}")
            if not (got.get("relpos_attention_fwd")
                    and got.get("relpos_attention_bwd")):
                raise AssertionError(f"itr_coco rank {r}: K2 not launched")
        if ([e["epoch"] for e in ft_log] != [-1, 0]
                or backend != "nccl" or world != W
                or (W == 1 and ft_log[0]["r_mean"] != zero_shot_r_mean)):
            raise AssertionError("itr_coco under torchrun: its log, backend "
                                 "or zero-shot R_mean")
        metrics = _last_log(out["ft_ev"])[-1]["eval"]
        how = "under torchrun" if W > 1 else "in this process"
        print(f"  itr_coco --evaluate {how}: {json.dumps(metrics)}; "
              f"launches by rank {json.dumps(ev_launches)}")
        if metrics != {k: ft_log[1][k] for k in metrics}:
            raise AssertionError("the eval of ckpt/0 differs from the "
                                 "epoch's eval")
        result.update(ft_r_mean=[e["r_mean"] for e in ft_log],
                      eval_launches=ev_launches)
        return _dp_end(result, W, root, keep_root)
    finally:
        if not keep_root:
            shutil.rmtree(root, ignore_errors=True)


def _dp_end(result: dict, W: int, root: str, keep_root: bool) -> dict:
    """Phase 27's fixed global batch (two cards or more) and its result."""
    if W >= 2:
        result["fixed_batch"] = dp_fixed_batch(root)
    else:
        print("  two processes on a fixed global batch over NCCL: not "
              "run, this machine has one card (NCCL puts one rank on a "
              "card); phase 31 runs two on one card over gloo, and the "
              "CPU tests two gloo processes")
    if keep_root:
        result["root"] = root
    return result


def _saved_params(run_dir: str, step: int) -> dict:
    return torch.load(os.path.join(run_dir, "ckpt", str(step), "state.pt"),
                      map_location="cpu", weights_only=True,
                      mmap=True)["params"]


def held_to_plain(run_dir: str, plain_dir: str, losses: list,
                  plain_losses: list, tag: str) -> dict:
    """A 2-step pretrain run (its `ckpt/2`) held to the plain run of the
    same YAML and seed (its `ckpt/1` and `ckpt/2`): the first loss
    bit-equal, the second within DP_LOSS_RTOL; the gap between the saved
    parameters within DP_UPDATE_RTOL of the plain run's second update over
    all parameters and DP_TENSOR_UPDATE_RTOL in each tensor → the
    figures."""
    a, b, b1 = (_saved_params(run_dir, 2), _saved_params(plain_dir, 2),
                _saved_params(plain_dir, 1))
    if set(a) != set(b):
        raise AssertionError(f"{tag}: other parameters saved")
    equal, gap2, step2, worst, worst_name = 0, 0.0, 0.0, 0.0, ""
    for n in b:
        x, y, y1 = (t[n].to("cuda", torch.float64) for t in (a, b, b1))
        if x.shape != y.shape:
            raise AssertionError(f"{tag}: {n} saved as {tuple(x.shape)}")
        equal += torch.equal(x, y)
        gap, step = (x - y).norm().item(), (y - y1).norm().item()
        gap2, step2 = gap2 + gap ** 2, step2 + step ** 2
        ratio = (gap / step if step else (0.0 if gap == 0 else math.inf))
        if ratio >= worst:
            worst, worst_name = ratio, n
    rel = abs(losses[1] - plain_losses[1]) / abs(plain_losses[1])
    whole = math.sqrt(gap2 / step2)
    print(f"  {tag} against the plain run: first loss bit-equal "
          f"{losses[0] == plain_losses[0]}, second relative difference "
          f"{rel}; saved parameters bit-equal {equal} of {len(b)}; |a - b| "
          f"/ |second update| over all {whole}, largest of a tensor "
          f"{worst} ({worst_name})")
    if (losses[0] != plain_losses[0] or rel > DP_LOSS_RTOL
            or whole > DP_UPDATE_RTOL or worst > DP_TENSOR_UPDATE_RTOL):
        raise AssertionError(f"{tag}: differs from the plain run")
    return dict(params_bit_equal=f"{equal}/{len(b)}", update_gap_all=whole,
                update_gap_worst=worst, update_gap_worst_name=worst_name,
                second_loss_rel=rel)


def dp_task_worker(out_dir: str, argv: list) -> int:
    """`python3 chip_smoke.py --dp-task OUT ARGS` under torchrun: `run.main
    (ARGS)`, the `python3 -m xfm_tpu_torch.run` entry, with each train
    step's reduced loss recorded (the step functions that the tasks hand
    to `train_epoch` wrapped); each rank writes its losses, the wall
    clock (`time.time`) on entering and on leaving `run.main` and its
    peak device memory to OUT/losses_<rank>.json."""
    entered = time.time()
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from xfm_tpu_torch import run
    from xfm_tpu_torch.tasks import classify, common, glue, imagenet

    losses = []

    def recording(real):
        def train_epoch(ctx, state, step_fn, loader, generator, epoch,
                        sched, **kw):
            def step(state, batch, gen):
                state, m = step_fn(state, batch, gen)
                losses.append(m["loss"].item())
                return state, m
            return real(ctx, state, step, loader, generator, epoch, sched,
                        **kw)
        return train_epoch

    for module in (common, imagenet, glue, classify):
        module.train_epoch = recording(module.train_epoch)
    run.main(argv)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"losses_{os.environ.get('RANK', '0')}"
                           ".json"), "w") as f:
        json.dump(dict(losses=losses, entered=entered, left=time.time(),
                       max_memory_allocated=torch.cuda.max_memory_allocated()),
                  f)
    return 0


# phase 28's launches on the card at once (device memory, host cores)
DP_TASK_CONCURRENCY = 4
# phase 28's launches on one card: imagenet (a step's K1 12 + 12, the
# eval's K1); nlvr, refcoco_bbox, the probe, glue and classify ran without
# torchrun in phases 22 and 23, and all six run under torchrun on two
# cards or more and on two gloo processes in the CPU tests (a launch on
# one card is host-bound: ~22 s of it before the task starts)
DP_TASKS_ONE_CARD = ("imagenet",)


def _rank_eval_batches(n_rows: int, batch: int, rank: int,
                       world: int) -> int:
    """The eval batches of `batch` rows that rank `rank` of `world` takes
    of `n_rows` rows (`core/mesh.rank_batches`)."""
    return len(range(rank, -(-n_rows // batch), world))


def _dp_task_launches(task: str, rank: int, world: int) -> dict:
    """Rank `rank`'s kernel launches in phase 28's run of `task` at
    `world` processes: a step's on each of its train steps (K2 12 + 12 for
    NLVR and stage 2, K1 12 + 12 for ImageNet, stage 1 and classify, K1 12
    for the probe, none for GLUE) and K2 or K1 12 on each of its eval
    batches (`rank_batches` of the val and test rows at its batch)."""
    d, k1f, k1b = 12, "packed_attention_fwd", "packed_attention_bwd"
    k2f, k2b = "relpos_attention_fwd", "relpos_attention_bwd"

    def evals(*splits):
        return sum(_rank_eval_batches(n, bs // world, rank, world)
                   for n, bs in splits)

    if task == "nlvr":  # 2 steps of 24 pairs; val and test 8 pairs each
        return {k2f: d * (2 + evals((8, 24), (8, 24))), k2b: 2 * d}
    if task == "refcoco_bbox":  # stage 1's step, stage 2's step, 8 tests
        return {k1f: d, k1b: d, k2f: d * (1 + evals((8, 24))), k2b: d}
    if task == "imagenet":  # one step of 128; 32 val rows
        return {k1f: d * (1 + evals((32, 128))), k1b: d}
    if task == "probe":  # one step of 512, the tower frozen; 32 val rows
        return {k1f: d * (1 + evals((32, 512)))}
    if task == "classify":  # one step of 16; 8 val rows
        return {k1f: d * (1 + evals((8, 16))), k1b: d}
    return {}


def dp_tasks_phase(nt: dict, ct: dict) -> dict:
    """Phase 28 (see the module docstring) over phases 22's and 23's
    corpora and YAMLs (`nt`, `ct`: their `full_*_task` results), which it
    deletes at the end with its own directory."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import yaml

    W = torch.cuda.device_count()
    n_root, c_root = nt["corpus_root"], ct["corpus_root"]
    ref = dict(nt["dp_ref"], **ct["dp_ref"])
    root = tempfile.mkdtemp(prefix="xfm_dp_tasks_")
    t0 = time.perf_counter()
    try:
        def yaml_of(path, **keys):
            with open(path) as f:
                cfg = yaml.safe_load(f)
            cfg.update(keys)
            out = os.path.join(root, os.path.basename(path))
            with open(out, "w") as f:
                yaml.safe_dump(cfg, f)
            return out

        nlvr_cfg = yaml.safe_load(open(os.path.join(n_root, "nlvr.yaml")))
        # one epoch of phase 22's 2 steps on its schedule of 2 epochs
        sched = dict(nlvr_cfg["schedular"],
                     num_training_steps=ref["nlvr"]["steps"])
        ref_yaml = os.path.join(n_root, "ref.yaml")
        if W > 1:  # stage 1's region JSONL in a shard a rank
            stage1 = yaml.safe_load(open(os.path.join(n_root,
                                                      "stage1.yaml")))
            path = stage1["train_file_regions"][0]
            with open(path) as f:
                lines = f.read().splitlines()
            shards = []
            for r in range(W):
                shards.append(os.path.join(root, f"regions_{r}.jsonl"))
                with open(shards[-1], "w") as f:
                    f.write("\n".join(lines[r::W]) + "\n")
            stage1_dp = yaml_of(os.path.join(n_root, "stage1.yaml"),
                                train_file_regions=shards)
            ref_yaml = yaml_of(ref_yaml, domain_pretrain_config=stage1_dp)
        # started in this order, the two largest with the two smallest
        args = {
            "refcoco_bbox": ["--task", "refcoco_bbox", "--config", ref_yaml,
                             "--bs", "24", "--epoch", "1"],
            "nlvr": ["--task", "nlvr", "--config", yaml_of(
                os.path.join(n_root, "nlvr.yaml"), schedular=sched),
                     "--bs", "24", "--epoch", "1"],
            # one epoch of phase 23's 2 steps on its horizon of 2 epochs
            "glue": ["--task", "glue", "--config", yaml_of(
                os.path.join(c_root, "glue.yaml"), num_train_epochs=1,
                max_train_steps=ref["glue"]["steps"]), "--bs", "32"],
            "probe": ["--task", "imagenet", "--config",
                      os.path.join(c_root, "lp.yaml"), "--bs", "512",
                      "--epoch", "1"],
            "imagenet": ["--task", "imagenet", "--config",
                         os.path.join(c_root, "ft.yaml"), "--bs", "128",
                         "--epoch", "1"],
            "classify": ["--task", "classify", "--config",
                         os.path.join(c_root, "cls.yaml"), "--bs", "16"],
        }
        if W == 1:
            print(f"  on one card only {', '.join(DP_TASKS_ONE_CARD)} under "
                  f"torchrun; {', '.join(t for t in args if t not in
                                         DP_TASKS_ONE_CARD)} ran without "
                  f"it in phases 22 and 23 (all six under torchrun with "
                  f"two cards or more, and in the CPU tests)")
            args = {t: args[t] for t in DP_TASKS_ONE_CARD}
        out = {t: os.path.join(root, t) for t in args}
        seconds = {}

        def launch(tag, nproc, argv, out_dir):
            t = time.time()
            text = _finish(_torchrun(nproc, [
                os.path.join(REPO, "chip_smoke.py"), "--dp-task", out_dir,
                *argv, "--device", "cuda", "--seed", "0", "--output_dir",
                out_dir]), tag)
            seconds[os.path.basename(out_dir)] = (t, time.time())
            return text

        torch.cuda.empty_cache()
        t_wall = time.time()
        with ThreadPoolExecutor(DP_TASK_CONCURRENCY) as pool:
            jobs = {t: pool.submit(launch, f"{t} under torchrun", W, a,
                                   out[t]) for t, a in args.items()}
            stdout = {t: j.result() for t, j in jobs.items()}
        t_runs = time.perf_counter() - t0
        result = dict(world=W)
        for task in args:
            world, backend, by_rank = _processes_line(stdout[task], task)
            log = [e for e in _last_log(out[task]) if "epoch" in e]
            with open(os.path.join(out[task], "losses_0.json")) as f:
                rec = json.load(f)
            losses = rec["losses"]
            metrics = {k: log[0][k] for k in ref[task]["metrics"]}
            start, end = seconds[task]
            times = dict(start=start - t_wall, to_entry=rec["entered"] - start,
                         run_main=rec["left"] - rec["entered"],
                         to_exit=end - rec["left"], total=end - start)
            print(f"  {task}: world {world}, backend {backend}; seconds "
                  f"{json.dumps({k: round(v, 1) for k, v in times.items()})}"
                  f"; peak {rec['max_memory_allocated']} B; step losses "
                  f"{losses}; epoch 0 {json.dumps(metrics)}")
            if (world != W or backend != "nccl" or len(log) != 1
                    or not losses or not all(map(math.isfinite, losses))):
                raise AssertionError(f"{task} under torchrun: its world, "
                                     f"backend, log or losses")
            for r, got in enumerate(by_rank):
                want = _dp_task_launches(task, r, W)
                print(f"  {task} rank {r} launches {json.dumps(got)}")
                if got != want:
                    raise AssertionError(f"{task} rank {r}: launches {got}, "
                                         f"expected {want}")
            if W == 1:
                same = (losses[0] == ref[task]["loss"]
                        and metrics == ref[task]["metrics"])
                print(f"  {task} against phase 22/23's run without torchrun:"
                      f" first loss {losses[0]} / {ref[task]['loss']}, "
                      f"epoch 0 {json.dumps(ref[task]['metrics'])}: "
                      f"{'equal' if same else 'DIFFERENT'}")
                if not same:
                    raise AssertionError(f"{task} under torchrun differs "
                                         f"from phase 22/23's run")
            result[task] = dict(losses=losses, metrics=metrics,
                                launches=by_rank, seconds=times,
                                max_memory_allocated=rec[
                                    "max_memory_allocated"])
        if W >= 2:
            result["evaluate"] = _dp_task_evaluates(args, out, launch, W)
        else:
            print("  --evaluate of a two-process run's checkpoint under "
                  "torchrun against one process: not run, this machine has "
                  "one card (NCCL puts one rank on a card); the CPU tests "
                  "run two gloo processes")
        result.update(seconds=time.perf_counter() - t0, runs_s=t_runs)
        return result
    finally:
        for d in (root, n_root, c_root):
            shutil.rmtree(d, ignore_errors=True)


def _dp_task_evaluates(args, out, launch, W) -> dict:
    """Phase 28 on two cards or more: each run's `ckpt/0` (classify saves
    none; the probe where its top-1 improved) evaluated under torchrun at
    W processes and by one process at the rank's batch → both metrics,
    held equal."""
    from concurrent.futures import ThreadPoolExecutor

    global_bs = {"nlvr": 24, "refcoco_bbox": 24, "imagenet": 128,
                 "probe": 512, "glue": 32}
    jobs, got = {}, {}
    with ThreadPoolExecutor(DP_TASK_CONCURRENCY) as pool:
        for task, bs in global_bs.items():
            ckpt = os.path.join(out[task], "ckpt", "0", "state.pt")
            if not os.path.exists(ckpt):
                print(f"  {task}: no ckpt/0 (its top-1 did not improve)")
                continue
            for n, b in ((W, bs), (1, bs // W)):  # --task T --config C
                argv = args[task][:4] + ["--bs", str(b), "--evaluate",
                                         "--checkpoint", ckpt]
                jobs[task, n] = pool.submit(
                    launch, f"{task} --evaluate W={n}", n, argv,
                    out[task] + f"_ev{n}")
        for (task, n), j in jobs.items():
            j.result()
            got[task, n] = _last_log(out[task] + f"_ev{n}")[-1]["eval"]
    result = {}
    for task in global_bs:
        if (task, W) not in got:
            continue
        a, b = got[task, W], got[task, 1]
        print(f"  {task} --evaluate of ckpt/0: {W} processes "
              f"{json.dumps(a)}, one {json.dumps(b)}")
        if a != b:
            raise AssertionError(f"{task}: the eval on {W} processes "
                                 f"differs from one process's")
        result[task] = a
    return result


# --- phase 30: FSDP -------------------------------------------------------

def _one_rank_group() -> None:
    """A one-process NCCL group (the address given, as nothing on the
    card's machine names a cluster)."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)


def fsdp_peak_worker(out_dir: str, axis: str) -> int:
    """`python3 chip_smoke.py --fsdp-peak OUT AXIS` under torchrun: the
    BEiT-2-large pretrain step (`configs.PRETRAIN_LARGE_KEYS`,
    `gradient_checkpointing: full`) at the YAML's batches on every rank
    (96 a stream), `parallel: {AXIS: W}` (`fsdp`: every parameter, its
    gradient and moments sharded over the W ranks; `data`: replicated),
    two steps; rank 0 writes each rank's peak allocated bytes and the
    losses to OUT/fsdp_peak_<AXIS>.json."""
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.core import mesh

    dev = mesh.maybe_init_distributed("cuda")
    keys = dict(configs.PRETRAIN_LARGE_KEYS, gradient_checkpointing=True,
                remat_policy="full", parallel={axis: mesh.world_size()})
    state, batches, step, gens = configs.make_pretrain_streams_run(
        device=dev, **keys)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(2):
        state, metrics = step(state, batches, gens(i))
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    peaks = mesh.all_gather_numpy(np.asarray(
        [torch.cuda.max_memory_allocated()], np.int64))[:, 0].tolist()
    if mesh.rank() == 0:
        with open(os.path.join(out_dir, f"fsdp_peak_{axis}.json"), "w") as f:
            json.dump(dict(axis=axis, world=mesh.world_size(), peaks=peaks,
                           losses=losses), f)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def fsdp_cards(root: str, dp: dict) -> dict:
    """Phase 30 on two cards or more (W of them): the fixed global batch
    of phase 27 at `fsdp: W` (and `data: 2, fsdp: 2` on four) against its
    one-process step; `pretrain_DIY` and `itr_coco` under torchrun at each
    layout, `itr_coco`'s `ckpt/0` evaluated on one process equal to the
    epoch's eval; on four the large pretrain step's peak memory a rank at
    `fsdp: 4` and at `data: 4`."""
    import yaml

    from xfm_tpu_torch import run

    W = torch.cuda.device_count()
    layouts = [{"fsdp": W}] + ([{"data": 2, "fsdp": 2}] if W == 4 else [])
    one = dp["fixed_batch"][1]
    out = {}
    for par in layouts:
        tag = _layout_tag(par)
        _finish(_torchrun(W, [os.path.join(REPO, "chip_smoke.py"),
                              "--dp-step", root, json.dumps(par)]),
                f"dp-step {tag}")
        with open(os.path.join(root, f"dp_step_{W}_{tag}.json")) as f:
            got = json.load(f)
        print(f"  fixed global batch of 32, {tag}: {json.dumps(got)}")
        for k in ("loss", "loss_itc", "loss_itm", "loss_mlm", "loss_mim",
                  "grad_norm"):
            tol = DP_GRAD_NORM_RTOL if k == "grad_norm" else DP_LOSS_RTOL
            if not abs(got[k] - one[k]) <= tol * abs(one[k]):
                raise AssertionError(f"fixed global batch {tag}: {k} "
                                     f"{got[k]}, one process {one[k]}")
        cfgs = {}
        for name in ("pt", "ft"):
            with open(os.path.join(root, f"{name}.yaml")) as f:
                cfg = dict(yaml.safe_load(f), parallel=par)
            cfgs[name] = os.path.join(root, f"{name}_{tag}.yaml")
            with open(cfgs[name], "w") as f:
                yaml.safe_dump(cfg, f)
        pt_dir, ft_dir = (os.path.join(root, f"{n}_{tag}")
                          for n in ("pt", "ft"))
        pt = _torchrun(W, ["-m", "xfm_tpu_torch.run", "--task",
                           "pretrain_DIY", "--config", cfgs["pt"],
                           "--device", "cuda", "--bs", str(24 * W),
                           "--output_dir", pt_dir])
        pt_out = _finish(pt, f"pretrain_DIY {tag}")
        ft_out = _finish(_torchrun(W, [
            "-m", "xfm_tpu_torch.run", "--task", "itr_coco", "--config",
            cfgs["ft"], "--device", "cuda", "--seed", "0", "--bs", "24",
            "--epoch", "1", "--output_dir", ft_dir]), f"itr_coco {tag}")
        pt_losses = [x for e in _last_log(pt_dir) for x in e["losses"]]
        ft_log = _last_log(ft_dir)
        for run_out, what in ((pt_out, "pretrain_DIY"), (ft_out,
                                                         "itr_coco")):
            world, backend, by_rank = _processes_line(run_out, what)
            print(f"  {what} {tag}: world {world}, backend {backend}, "
                  f"launches by rank {json.dumps(by_rank)}")
            if world != W or backend != "nccl":
                raise AssertionError(f"{what} {tag}: world {world}")
        ev = run.main(["--task", "itr_coco", "--config",
                       os.path.join(root, "ft.yaml"), "--device", "cuda",
                       "--seed", "0", "--evaluate", "--checkpoint",
                       os.path.join(ft_dir, "ckpt", "0", "state.pt"),
                       "--output_dir", ft_dir + "_ev"])
        print(f"  {tag}: pretrain_DIY losses {pt_losses}; itr_coco epoch "
              f"eval {ft_log[1]['r_mean']}, one process's eval of its "
              f"ckpt/0 {ev['r_mean']}")
        if (len(pt_losses) != 2 or not all(map(math.isfinite, pt_losses))
                or ev != {k: ft_log[1][k] for k in ev}):
            raise AssertionError(f"{tag}: the pretrain losses or the eval "
                                 f"of ckpt/0")
        out[tag] = dict(fixed_batch=got, pretrain_losses=pt_losses,
                        r_mean=ft_log[1]["r_mean"])
        for d in (pt_dir, ft_dir):
            shutil.rmtree(d, ignore_errors=True)
    if W == 4:
        for axis in ("data", "fsdp"):
            _finish(_torchrun(4, [os.path.join(REPO, "chip_smoke.py"),
                                  "--fsdp-peak", root, axis]),
                    f"fsdp-peak {axis}", timeout=600)
            with open(os.path.join(root, f"fsdp_peak_{axis}.json")) as f:
                got = json.load(f)
            print(f"  BEiT-2-large pretrain, full, 96 a stream and rank, "
                  f"{axis}: 4: peak bytes by rank {got['peaks']} (max "
                  f"{max(got['peaks']) / 1e9:.2f} GB), losses "
                  f"{got['losses']}")
            if not all(map(math.isfinite, got["losses"])):
                raise AssertionError(f"fsdp-peak {axis}: losses")
            out[f"large_peak_{axis}4"] = got
    else:
        print(f"  the large step's peak at fsdp: 4 and data: 4: not run, "
              f"this machine has {W} cards")
    return out


def fsdp_phase(dp: dict, keep_root: bool = False) -> dict:
    """Phase 30 (see the module docstring); phase 27's directory
    (`dp["root"]`) deleted at the end, or with `keep_root` left for phase
    31, which deletes it."""
    import yaml

    import torch.distributed as dist

    from xfm_tpu_torch import configs, convert_checkpoint, run
    from xfm_tpu_torch.core import partitioning
    from xfm_tpu_torch.ops import kernels

    root = dp["root"]
    W = torch.cuda.device_count()
    try:
        pt_cfg = os.path.join(root, "pt.yaml")
        out = os.path.join(root, "pt_fsdp")
        depth = configs.xfm_base_pretrain_config().vision.depth
        _one_rank_group()
        # the task's place_state takes the sharded route on the one-rank
        # mesh: no config asks for fsdp > 1 on one process
        fsdp_size = partitioning.fsdp_size
        partitioning.fsdp_size = lambda cfg: 2
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            run.main(["--task", "pretrain_DIY", "--config", pt_cfg,
                      "--device", "cuda", "--bs", "24", "--output_dir",
                      out])
            t_run = time.perf_counter() - t0
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            peak = torch.cuda.max_memory_allocated()
        finally:
            partitioning.fsdp_size = fsdp_size
            dist.destroy_process_group()
        k1 = {"packed_attention_fwd": 2 * 3 * depth,
              "packed_attention_bwd": 2 * 3 * depth}
        _launch_counts([launches], k1, "pretrain_DIY sharded")
        losses = [x for e in _last_log(out) for x in e["losses"]]
        plain = [x for e in _last_log(os.path.join(root, "pt_plain"))
                 for x in e["losses"]]
        print(f"  sharded run {t_run:.1f} s, peak {peak / 1e9:.2f} GB; "
              f"losses {losses}, the plain run's {plain}")
        result = dict(seconds=t_run, peak_bytes=peak, losses=losses,
                      launches=launches,
                      **held_to_plain(out, os.path.join(root, "pt_plain"),
                                      losses, plain, "sharded, one rank"))
        # the task resumes the sharded run's checkpoint unsharded
        with open(pt_cfg) as f:
            cfg = dict(yaml.safe_load(f), max_steps=3, resume=True)
        resume_cfg = os.path.join(root, "pt_resume.yaml")
        with open(resume_cfg, "w") as f:
            yaml.safe_dump(cfg, f)
        t0 = time.perf_counter()
        run.main(["--task", "pretrain_DIY", "--config", resume_cfg,
                  "--device", "cuda", "--bs", "24", "--output_dir", out])
        log = _last_log(out)
        steps = [e["step"] for e in log]
        print(f"  resumed unsharded at step 2: steps {steps}, step 3's "
              f"loss {log[-1]['losses']} "
              f"({time.perf_counter() - t0:.1f} s)")
        if steps != [2, 3] or not all(map(math.isfinite,
                                          log[-1]["losses"])):
            raise AssertionError("the unsharded resume of the sharded "
                                 "checkpoint")
        t0 = time.perf_counter()
        th = os.path.join(root, "pt_fsdp.th")
        sd = convert_checkpoint.to_torch(os.path.join(out, "ckpt", "2"), th,
                                         pt_cfg)
        src = _saved_params(out, 2)
        kernel = sd["vision_encoder.patch_embed.proj.weight"]
        want = src["vision_encoder.patch_embed.proj.weight"].float()
        P = 16
        ok = (len(sd) == len(src) and tuple(kernel.shape) == (768, 3, P, P)
              and torch.equal(kernel, want.reshape(P, P, 3, 768).permute(
                  3, 2, 0, 1))
              and all(bool(torch.isfinite(v).all()) for v in sd.values()))
        print(f"  to-torch: {len(sd)} tensors, {os.path.getsize(th) / 1e9:.2f}"
              f" GB, patch kernel {tuple(kernel.shape)} "
              f"({time.perf_counter() - t0:.1f} s)")
        if not ok:
            raise AssertionError("to-torch of the sharded checkpoint")
        result.update(to_torch_tensors=len(sd))
        if W >= 2:
            result["cards"] = fsdp_cards(root, dp)
        else:
            print("  fsdp: W and data: 2 x fsdp: 2 under torchrun, and the "
                  "large step's peak at fsdp: 4 against data: 4: not run, "
                  "this machine has one card; the CPU tests run two gloo "
                  "processes at fsdp: 2")
        return result
    finally:
        if not keep_root:
            shutil.rmtree(root, ignore_errors=True)


# --- phase 31: tensor parallelism -------------------------------------------

TP_SIZES = (2, 4)
# f32: phase 3's gates (outputs within SLICE_LOSS_RTOL, gradients within
# SLICE_GRAD_RTOL of their tensor's largest element). bf16: the shards'
# error against the module run in f32 (the same weights and inputs) at
# most twice the whole bf16 module's, or within phase 2's TOL: the cut
# may round differently, not worse
TP_BUDGET = 2.0


def shard_beit_block(shards, x: torch.Tensor) -> torch.Tensor:
    """`BeitBlock.forward(x)` (per-block tables, no dropout) from its T
    tensor shards held in one process (`core/partitioning.tensor_shards`):
    each shard's attention and MLP partials (`attend` / `proj_partial`,
    `_Mlp.partial`, K1 or K2 at H/T heads, K5 at K = 4C/T), summed by hand
    (`ops/tensor_parallel.row_sum`) where a tensor group's all-reduce sums
    them. The replicated parameters (LayerNorms, row biases, the layer
    scales) are the first shard's."""
    from xfm_tpu_torch.core.precision import add_layer_norm, layer_norm
    from xfm_tpu_torch.ops.tensor_parallel import row_sum

    b = shards[0]
    c = b.c
    h = layer_norm(x, b.norm1, c.dtype)
    a = row_sum([s.attn.proj_partial(s.attn.attend(h, True, None))
                 for s in shards], b.attn.proj.bias, c.dtype)
    if b.use_ls:
        a = b.gamma_1.to(a.dtype) * a
    x, h = add_layer_norm(a, x, b.norm2, c.dtype, c.fused_ln)
    m = row_sum([s.mlp.partial(h) for s in shards], b.mlp.fc2.bias, c.dtype)
    if b.use_ls:
        m = b.gamma_2.to(m.dtype) * m
    return x + m


def shard_attention(atts, x, kv, bias, group_size=None):
    """A text layer's self- or cross-attention sublayer (its post-LN
    included) from its shards, as `shard_beit_block` (`group_size`: the
    grouped rerank's `kv_group_size`, K3 at H/T heads)."""
    from xfm_tpu_torch.core.precision import post_layer_norm
    from xfm_tpu_torch.ops.tensor_parallel import row_sum

    a0 = atts[0]
    c = a0.c
    out = row_sum([a.out_partial(a.context(x, kv, bias,
                                           kv_group_size=group_size))
                   for a in atts], a0.output.dense.bias, c.dtype)
    return post_layer_norm(out, x, a0.output.LayerNorm, c.dtype, c.fused_ln)


def shard_text_layer(shards, hidden, attention_bias=None,
                     encoder_hidden_states=None, encoder_attention_bias=None,
                     encoder_group_size=None) -> torch.Tensor:
    """`TransformerLayer.forward` (self-attention, the cross-attention
    where the layer has one and `encoder_hidden_states` are given, the MLP;
    no dropout) from its shards, as `shard_beit_block`."""
    from xfm_tpu_torch.core.precision import post_layer_norm
    from xfm_tpu_torch.ops.tensor_parallel import row_sum

    layer = shards[0]
    c = layer.c
    x = shard_attention([s.attention for s in shards], hidden, hidden,
                        attention_bias)
    if layer.has_cross_attention and encoder_hidden_states is not None:
        x = shard_attention([s.crossattention for s in shards], x,
                            encoder_hidden_states, encoder_attention_bias,
                            encoder_group_size)
    m = row_sum([s.mlp_partial(x) for s in shards], layer.output.dense.bias,
                c.dtype)
    return post_layer_norm(m, x, layer.output.LayerNorm, c.dtype,
                           c.fused_ln)


def cut_block_run(full, cut, run, x):
    """`run(block, x)` (x the block's input [B, N, C]) for this rank of the
    tensor group of `cut` (a `TensorCut` with its group), the block the
    whole module `full` (the same on every rank) cut for the rank
    (`core/partitioning.cut_model`, on a copy); under its config's
    `seq_shard` on the rank's rows, x scattered before and the rows
    gathered after, as a stack runs its loop over blocks
    (`BeitVisionTransformer._sequence_loop`, `TextTransformer.forward`)
    → (the cut block, its output [B, N, C], whole on every rank)."""
    import copy

    from xfm_tpu_torch.core import partitioning
    from xfm_tpu_torch.ops import tensor_parallel as tp

    block = partitioning.cut_model(copy.deepcopy(full), cut)
    for p in block.parameters():
        p.grad = None
    if not getattr(full.c, "seq_shard", False):
        return block, run(block, x)
    n = x.shape[1]
    with tp.sequence(n):
        rows = run(block, tp.scatter_to_sequence(x, cut))
    return block, tp.gather_from_sequence(rows, cut, n, to_column=False)


def cut_whole_grads(block, cut) -> dict:
    """name → the whole gradient, on every rank, of a block cut and run by
    `cut_block_run` after its backward (each rank of the group calls it):
    the `seq_shard` partials summed over the group as a step sums them
    (`core/partitioning.sum_sequence_gradients`), a cut parameter's
    gathered and joined (`ops/tensor_parallel.gather_tensor`), a whole
    one's as the collectives' backward left it."""
    from xfm_tpu_torch.core import partitioning
    from xfm_tpu_torch.ops import tensor_parallel as tp

    partitioning.sum_sequence_gradients(block)
    plan = block._xfm_tensor_plan
    return {n: tp.gather_tensor(p.grad, plan[n], cut) if n in plan
            else p.grad for n, p in block.named_parameters()
            if p.grad is not None}


def shard_whole_grads(shards) -> dict:
    """name → the whole module's gradient from its shards': a cut
    parameter's joined (`ops/tensor_parallel.join`), a replicated one's
    summed over the shards that have one (a rel-pos table's columns, each
    shard's own)."""
    from xfm_tpu_torch.ops.tensor_parallel import join

    plan = shards[0]._xfm_tensor_plan
    named = [dict(s.named_parameters()) for s in shards]
    out = {}
    for name in named[0]:
        grads = [n[name].grad for n in named]
        if name in plan:
            out[name] = join(grads, plan[name])
        else:
            have = [g for g in grads if g is not None]
            out[name] = sum(have) if have else None
    return out


def _tp_check(tag, full, run_full, run_cut, whole_grads, twin=None, seed=0,
              grad=True, show=True) -> dict:
    """`run_cut()` (the module's cut run: its T shards' partials summed by
    hand in one process, or this rank's cut under a tensor group) against
    `run_full(full)`: the output and, with `grad`, every gradient (the
    cut's whole gradients, `whole_grads()`) for one output gradient;
    a key bias's gradient (RoBERTa's `key`, CLIP's `k_proj`: zero but for
    rounding, softmax is shift-invariant over the keys) on its key
    weight's scale. `twin`: the module in f32, for the bf16 gate; `show`:
    print the result → the launches of the cut run."""
    from xfm_tpu_torch.ops import kernels

    g = torch.Generator(device="cuda").manual_seed(seed)
    y = run_full(full)
    dy = _device_randn(g, *y.shape).to(y.dtype)
    if grad:
        y.backward(dy)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    ys = run_cut()
    if grad:
        ys.backward(dy)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    named = dict(full.named_parameters())
    pairs = [("out", ys, y)]
    if grad:
        joined = whole_grads()
        pairs += [(n, joined[n], p.grad) for n, p in named.items()
                  if p.grad is not None]
    ref = {}
    if twin is not None:
        y32 = run_full(twin)
        if grad:
            y32.backward(dy.float())
        ref = dict(out=y32, **{n: p.grad for n, p in
                               twin.named_parameters()})
    worst = 0.0
    for name, got, want in pairs:
        scale_of = (named[name[:-len("bias")] + "weight"].grad
                    if name.endswith(("key.bias", "k_proj.bias")) else want)
        scale = scale_of.float().abs().max().item()
        got, want = got.float(), want.float()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{tag}: {name} wrong shape or not finite")
        if twin is None:
            err = (got - want).abs().max().item()
            tol = (SLICE_LOSS_RTOL if name == "out"
                   else SLICE_GRAD_RTOL) * scale
        else:
            r = ref[name].float()
            err = (got - r).abs().max().item()
            tol = max(TP_BUDGET * (want - r).abs().max().item(),
                      TOL[torch.bfloat16] * scale)
        if not err <= tol:
            raise AssertionError(f"{tag}: {name} {err:.3e} against "
                                 f"{tol:.3e}")
        worst = max(worst, err / max(tol, 1e-30))
    if show:
        print(f"  {tag}: {len(pairs)} tensors, the worst at {worst:.3f} of "
              f"its gate; launches {json.dumps(launches)}")
    return launches


def _tp_module(make, c, seed):
    """`make(c)` on the card with seeded weights (`init_weights`) moved
    off their zero and one inits, so that every gradient is exercised;
    with a bf16 `c` also its f32 twin (the same weights) → (module,
    twin or None)."""
    from xfm_tpu_torch.train.checkpoint import init_weights

    module = make(c).cuda()
    init_weights(module, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(_device_randn(g, *p.shape, scale=0.02))
    twin = None
    if c.dtype != torch.float32:
        twin = make(dataclasses.replace(c, dtype=torch.float32)).cuda()
        twin.load_state_dict(module.state_dict())
    return module, twin


def tp_block_check(T, dtype, res, B, fused, seed) -> dict:
    """A full-width BEiT-2-base block (C 768, H 12, tanh-GELU; N = 197 at
    224 px through K1, N = 577 at 384 px through K2) cut into T shards
    (`core/partitioning.tensor_shards`), each shard's forward and backward
    on the card with the row partials summed by hand
    (`shard_beit_block`), against the whole block on the same
    input and output gradient (`_tp_check`) → the launches of the shards'
    run."""
    from xfm_tpu_torch.core import partitioning
    from xfm_tpu_torch.models.beit2 import BeitBlock, VisionConfig

    c = VisionConfig(image_res=res, embed_dim=768, depth=1, num_heads=12,
                     drop_path_rate=0.0, hidden_act="gelu_tanh", dtype=dtype,
                     fused_ln=fused, fused_mlp=fused)
    full, twin = _tp_module(BeitBlock, c, seed)
    shards = partitioning.tensor_shards(full, T)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = _device_randn(g, B, c.num_patches + 1, 768).to(dtype)
    tag = (f"BEiT block T={T} N={c.num_patches + 1} B={B} "
           f"{str(dtype)[6:]}{' fused' if fused else ''}")
    return _tp_check(tag, full, lambda m: m(x),
                     lambda: shard_beit_block(shards, x),
                     lambda: shard_whole_grads(shards), twin, seed)


def tp_fusion_check(T, dtype, fused, seed, B=32, Nq=40, Nk=577) -> dict:
    """A full-width fusion layer (self-attention over B x Nq text rows
    with padded tails, cross-attention to B x Nk image rows, the MLP) cut
    into T shards, the shards' sums against the whole layer
    (`_tp_check`) → the launches of the shards' run."""
    from xfm_tpu_torch.core import partitioning
    from xfm_tpu_torch.models.text_encoder import (TextConfig,
                                                   TransformerLayer)
    from xfm_tpu_torch.ops.attention import mask_to_bias

    c = TextConfig.roberta_base(
        fusion_layer=0, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, hidden_act="gelu_tanh",
        dtype=dtype, fused_ln=fused, fused_mlp=fused)
    full, twin = _tp_module(
        lambda cfg: TransformerLayer(cfg, has_cross_attention=True), c, seed)
    shards = partitioning.tensor_shards(full, T)
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = _device_randn(g, B, Nq, 768).to(dtype)
    enc = _device_randn(g, B, Nk, 768).to(dtype)
    m = torch.ones(B, Nq, device="cuda")
    m[:, Nq - 7:] = 0
    bias = mask_to_bias(m)
    tag = (f"fusion layer T={T} [{B}, {Nq}] x [{B}, {Nk}] {str(dtype)[6:]}"
           f"{' fused' if fused else ''}")
    return _tp_check(tag, full, lambda m: m(h, bias, enc, None),
                     lambda: shard_text_layer(shards, h, bias, enc, None),
                     lambda: shard_whole_grads(shards), twin, seed)


def tp_grouped_check(T, dtype, seed, U=8, gs=256, Nq=40, Nk=577) -> dict:
    """The grouped rerank's cross-attention (`kv_group_size` gs: q a view
    [U, gs·Nq, H/T, 64] of each shard's projection, K3 at H/T heads)
    from the T shards of a full-width fusion layer, the output
    projections' partials summed by hand, against the whole layer's
    sublayer (`_tp_check`, no grad: an eval) → the launches of the
    shards' run."""
    from xfm_tpu_torch.core import partitioning
    from xfm_tpu_torch.models.text_encoder import (TextConfig,
                                                   TransformerLayer)
    from xfm_tpu_torch.ops.attention import mask_to_bias

    c = TextConfig.roberta_base(fusion_layer=0, hidden_act="gelu_tanh",
                                dtype=dtype)
    full, twin = _tp_module(
        lambda cfg: TransformerLayer(cfg, has_cross_attention=True), c, seed)
    shards = partitioning.tensor_shards(full, T)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = _device_randn(g, U * gs, Nq, 768).to(dtype)
    enc = _device_randn(g, U, Nk, 768).to(dtype)
    # the rerank's image-mask bias, one row a text row (all ones)
    bias = mask_to_bias(torch.ones(U * gs, Nk, device="cuda"))
    tag = (f"grouped rerank T={T} U={U} gs={gs} q [{U}, {gs * Nq}, "
           f"{12 // T}, 64] {str(dtype)[6:]}")
    with torch.no_grad():
        return _tp_check(
            tag, full,
            lambda m: m.crossattention(x, enc, bias, kv_group_size=gs),
            lambda: shard_attention([m.crossattention for m in shards],
                                    x, enc, bias, gs),
            None, twin, seed, grad=False)


def tensor_phase(unsharded: dict) -> dict:
    """Phase 31 on one card (the module docstring); `unsharded` holds the
    earlier phases' times at the unsharded shapes ("k1", "k2", "k3g",
    "k5"), printed beside the shards' → the new shapes' errors, times,
    bounds and launches."""
    bf16, f32 = torch.bfloat16, torch.float32
    t0 = time.perf_counter()
    launches = {}
    for T in TP_SIZES:
        for dtype in (bf16, f32):
            for fused in (False, True):
                got = tp_block_check(T, dtype, 224, 96, fused, 70 + T)
                if dtype == bf16:
                    launches[("k1", T) if not fused else ("k5", T)] = got
            got = tp_block_check(T, dtype, 384, 32, False, 80 + T)
            if dtype == bf16:
                launches[("k2", T)] = got
        tp_fusion_check(T, bf16, False, 90 + T)
        tp_fusion_check(T, f32, True, 95 + T)
        launches[("k3g", T)] = tp_grouped_check(T, bf16, 100 + T)
    t_blocks = time.perf_counter() - t0
    H, D = 12, 64
    out = {}
    for T in TP_SIZES:
        h, K = H // T, 3072 // T
        e1 = k1_parity(96, 197, h, bf16, seed=110 + T)
        k1_parity(96, 197, h, f32, seed=111 + T)
        e2 = k2_parity(32, (24, 24), h, bf16, seed=112 + T)
        k2_parity(32, (24, 24), h, f32, seed=113 + T)
        e5 = k5_parity("gelu_tanh", 18912, bf16, K=K, seed=114 + T,
                       bias=False)
        k5_parity("gelu_tanh", 18912, f32, K=K, seed=115 + T, bias=False)
        e3 = k3_grouped_parity(8, 256, bf16, "tails", seed=116 + T, H=h)
        k3_grouped_parity(8, 256, f32, "tails", seed=117 + T, H=h)
        q, _, _, bias = k3_grouped_inputs(8, 256, bf16, "ones", 0, H=h)
        w3 = k3_work(8, q.shape[1], 577, h, D, bf16, bias)
        del q, bias
        out[T] = dict(
            k1=(e1, k1_times(96, 197, h, bf16),
                k1_work(96, 197, h, D, bf16), launches[("k1", T)]),
            k2=(e2, k2_times(32, (24, 24), h, bf16),
                k2_work(32, 577, h, D, (24, 24), bf16),
                launches[("k2", T)]),
            k5=(e5, k5_times(18912, bf16, K=K, bias=False),
                k5_work(18912, K, 768, bf16, bias=False),
                launches[("k5", T)]),
            k3g=(e3, k3_grouped_times(8, 256, bf16, H=h), w3,
                 launches[("k3g", T)]))
        for key, label in (("k1", "K1 [96, 197, 3·H/T·64]"),
                           ("k2", "K2 [32, 577, 3·H/T·64]"),
                           ("k5", "K5 M 18912 K 4C/T, no bias, f32 out"),
                           ("k3g", "K3 grouped fwd U 8 gs 256")):
            t = out[T][key][1]
            base = unsharded[key]
            print(f"  {label} T={T}: fwd {t['fwd_ms']:.4f} ms"
                  + (f", bwd {t['bwd_ms']:.4f} ms" if "bwd_ms" in t else "")
                  + f"; unsharded fwd {base['fwd_ms']:.4f} ms"
                  + (f", bwd {base['bwd_ms']:.4f} ms" if "bwd_ms" in base
                     else "")
                  + f"; bound {json.dumps(out[T][key][2])}; launches in "
                  f"the shards' run {json.dumps(out[T][key][3])}")
    print(f"  phase 31 seconds: blocks {t_blocks:.1f}, kernels "
          f"{time.perf_counter() - t0 - t_blocks:.1f}")
    return out


# --- phase 32: sequence parallelism and the tower cuts -----------------------

def tp_group_check(tag, make, c, run, x, cut, seed) -> dict:
    """The whole full-width module `make(c)` (`_tp_module`'s seeded
    weights, the same on every rank) against its cut for this rank run
    under the tensor group of `cut` (`cut_block_run`, `cut_whole_grads`):
    `_tp_check`'s gates, printed by rank 0 → the launches of the cut
    run."""
    full, twin = _tp_module(make, c, seed)
    held = {}

    def run_cut():
        held["block"], y = cut_block_run(full, cut, run, x)
        return y

    return _tp_check(tag, full, lambda m: run(m, x), run_cut,
                     lambda: cut_whole_grads(held["block"], cut), twin, seed,
                     show=cut.rank == 0)


def seq_tower_group_checks(cut) -> None:
    """Phase 32's blocks at full width on this rank of a tensor group (the
    one-card processes of phase 31), each against the whole module, in
    bf16 (held to its f32 twin) and f32 unless said: BEiT-2-base blocks
    under `seq_shard` at N = 197 (B = 96, the fused route: K1, K4 at
    B·⌈N/T⌉ rows, K5) and at N = 577 (B = 32, K2); a text layer (bf16)
    over B × 40 rows with padded tails and a fusion layer (f32) with its
    cross-attention to B × 577 image rows, under `seq_shard`, fused;
    CLIP-ViT-B/16 and DeiT-B/16 blocks at 384 px (B = 32: K3 forward and
    backward at [32, 577, 12/T, 64]); a Swin-B block of each stage (f32,
    and stage 0 in bf16; window 12, nH/T heads). A check that fails
    raises."""
    from xfm_tpu_torch.models.beit2 import BeitBlock, VisionConfig
    from xfm_tpu_torch.models.clip_vit import (ClipEncoderLayer,
                                               ClipVisionConfig)
    from xfm_tpu_torch.models.deit import DeitBlock, DeitConfig
    from xfm_tpu_torch.models.swin import SwinBlock, SwinConfig
    from xfm_tpu_torch.models.text_encoder import (TextConfig,
                                                   TransformerLayer)
    from xfm_tpu_torch.ops.attention import mask_to_bias

    bf16, f32, T = torch.bfloat16, torch.float32, cut.size
    g = torch.Generator(device="cuda").manual_seed(120)

    def whole(m, x):
        return m(x)

    def name(dtype):
        return str(dtype)[6:]

    for res, B, fused in ((224, 96, True), (384, 32, False)):
        for dtype in (bf16, f32):
            c = VisionConfig(image_res=res, embed_dim=768, depth=1,
                             num_heads=12, drop_path_rate=0.0,
                             hidden_act="gelu_tanh", dtype=dtype,
                             fused_ln=fused, fused_mlp=fused, seq_shard=True)
            N = c.num_patches + 1
            tp_group_check(f"BEiT block seq_shard T={T} N={N} B={B} "
                           f"{name(dtype)}{' fused' if fused else ''}",
                           BeitBlock, c, whole,
                           _device_randn(g, B, N, 768).to(dtype), cut, 121)
    B, Nq, Nk = 32, 40, 577
    m = torch.ones(B, Nq, device="cuda")
    m[:, Nq - 7:] = 0
    bias = mask_to_bias(m)
    for cross, dtype in ((False, bf16), (True, f32)):
        c = TextConfig.roberta_base(
            fusion_layer=0, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, hidden_act="gelu_tanh",
            dtype=dtype, fused_ln=True, fused_mlp=True, seq_shard=True)
        enc = _device_randn(g, B, Nk, 768).to(dtype) if cross else None
        tp_group_check(
            f"{'fusion' if cross else 'text'} layer seq_shard T={T} "
            f"[{B}, {Nq}]{f' x [{B}, {Nk}]' if cross else ''} "
            f"{name(dtype)} fused",
            lambda cfg, cross=cross: TransformerLayer(
                cfg, has_cross_attention=cross), c,
            lambda mm, x, enc=enc: mm(x, bias, enc, None),
            _device_randn(g, B, Nq, 768).to(dtype), cut, 124)
    for kind, make, conf in (("clip", ClipEncoderLayer, ClipVisionConfig),
                             ("deit", DeitBlock, DeitConfig)):
        for dtype in (bf16, f32):
            c = conf(image_res=384, dtype=dtype)
            N = c.num_patches + 1
            tp_group_check(f"{kind} block T={T} N={N} B=32 {name(dtype)}",
                           make, c, whole,
                           _device_randn(g, 32, N, 768).to(dtype), cut, 128)
    for stage, dtype in ((0, f32), (1, f32), (2, f32), (3, f32), (0, bf16)):
        c = SwinConfig(image_res=384, embed_dim=128, depths=(2, 2, 18, 2),
                       num_heads=(4, 8, 16, 32), window_size=12, dtype=dtype)
        side = 384 // c.patch_size // 2 ** stage
        dim, heads = c.embed_dim * 2 ** stage, c.num_heads[stage]
        tp_group_check(
            f"Swin-B stage {stage} block T={T} [8, {side * side}, {dim}] "
            f"{heads // T} heads {name(dtype)}",
            lambda cfg, dim=dim, heads=heads, side=side: SwinBlock(
                cfg, dim, heads, (side, side), shift=6), c, whole,
            _device_randn(g, 8, side * side, dim).to(dtype), cut,
            130 + stage)


# the BEiT add site's rows under seq_shard at T: the pretrain pair pass's
# 96 images x ceil(197 / T) rows
SEQ_K4_ROWS = {T: 96 * -(-197 // T) for T in TP_SIZES}


def seq_tower_phase(one_card: dict) -> dict:
    """Phase 32 on one card (the module docstring): the block checks of
    phase 31's one-card processes printed (`seq_tower_group_checks`), then
    K3 at [32, 577, 12/T, 64] and K4 at each T's seq-shard rows against
    their plain versions, timed, with their bounds; their launches at
    T = 2 from those processes' steps (`one_card`, from
    `tensor_one_card_finish`): K3's from the DeiT-B/16 retrieval step at
    `tensor: 2`, K4's from the fused pretrain step at `tensor: 2,
    seq_shard` (one card holds no T = 4 group: None) → T → {"k3", "k4":
    (errors, times, bounds, launches)}."""
    bf16, f32 = torch.bfloat16, torch.float32
    for line in one_card["blocks"]:
        print(line)
    t0 = time.perf_counter()
    fused_seq = one_card[_layout_tag(TP_ONE_CARD_SEQ) + "_fused"]
    launches = {("k3", 2): one_card["tower_deit"]["values"]["launches"],
                ("k4", 2): fused_seq["values"]["launches"]}
    out = {}
    for T in TP_SIZES:
        h, R = 12 // T, SEQ_K4_ROWS[T]
        e3 = k3_parity(32, 577, 577, h, bf16, seed=140 + T)
        k3_parity(32, 577, 577, h, f32, seed=141 + T)
        e4 = k4_parity("add", R, 768, bf16, seed=142 + T)
        k4_parity("add", R, 768, f32, seed=143 + T)
        out[T] = dict(
            k3=(e3, k3_times(32, 577, h, bf16), k3_work(32, 577, 577, h, 64,
                                                       bf16),
                launches.get(("k3", T))),
            k4=(e4, k4_times(R, 768, bf16), k4_work(R, 768, bf16),
                launches.get(("k4", T))))
        for key, label, step in (
                ("k3", f"K3 [32, 577, {h}, 64] no bias", "the DeiT-B/16 "
                 "retrieval step at tensor: 2"),
                ("k4", f"K4 add R {R} C 768", "the fused pretrain step at "
                 "tensor: 2, seq_shard")):
            err, t, w, n = out[T][key]
            print(f"  {label} T={T}: fwd {t['fwd_ms']:.4f} ms, bwd "
                  f"{t['bwd_ms']:.4f} ms; plain {t['plain_fwd_ms']:.4f} / "
                  f"{t['plain_bwd_ms']:.4f}; library "
                  f"{t['library_fwd_ms']:.4f} / {t['library_bwd_ms']:.4f}; "
                  f"bound {json.dumps(w)}; "
                  + (f"launches a rank in {step} {json.dumps(n)}"
                     if n is not None else "launches: no T = 4 group on "
                     "one card"))
    print(f"  phase 32 seconds: kernels {time.perf_counter() - t0:.1f}")
    return out


def seq_tower_kernel_entries(st: dict) -> list:
    """The `kernels` entries of phase 32: K3 forward and backward at the
    towers' shards (q/k/v [32, 577, 12/T, 64], no bias) and K4 (add) at
    the seq-shard rows, at each T whose launches a main-path run counted
    (T = 2, `seq_tower_phase`)."""
    out = []
    for T, rows in st.items():
        err, t, w, n = rows["k3"]
        if n is None:
            continue
        for e in kernel_entries(
                "flash_attention", "xfm_tpu/ops/flash_attention.py", 71, 334,
                "xfm_tpu_torch/csrc/flash_attention.cu", err,
                ("dq", "dk", "dv"), t, w,
                {k: n.get(k, 0) for k in ("flash_attention_fwd",
                                          "flash_attention_bwd")},
                also_bwd=227):
            e["name"] += f"_tensor{T}_h{12 // T}_b577"
            out.append(e)
        err, t, w, n = rows["k4"]
        for e in kernel_entries(
                "fused_ln", "xfm_tpu/ops/fused_ln.py", 91, 108,
                "xfm_tpu_torch/csrc/fused_ln.cu", err,
                ("dx", "dgamma", "dbeta"), t, w,
                {k: n.get(k, 0) for k in ("fused_ln_fwd", "fused_ln_bwd")}):
            e["name"] += f"_seq{T}_r{SEQ_K4_ROWS[T]}"
            out.append(e)
    return out


def tower_step(kind: str, parallel=None, f32: bool = False,
               B: int = 32) -> dict:
    """One deterministic full-width retrieval step at 384 px with the
    CLIP-ViT-B/16 (`kind` "clip") or DeiT-B/16 ("deit") tower
    (`configs.make_clip_retrieval_run` / `make_deit_retrieval_run`,
    weights from seed 0, bf16 or with `f32` f32) on a fixed batch of `B`
    with fixed hard negatives (the next row), the state placed under the
    YAML `parallel` block → its scalar metrics, "launches" (the kernels
    launched in the step) and "peak_bytes"."""
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.core import mesh
    from xfm_tpu_torch.ops import kernels

    make = (configs.make_clip_retrieval_run if kind == "clip"
            else configs.make_deit_retrieval_run)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, batch, step = make(
        B=B, device="cuda", parallel=parallel,
        dtype=torch.float32 if f32 else torch.bfloat16)
    roll = torch.roll(torch.arange(B, device="cuda"), -1)
    batch = mesh.rank_slice(dict(batch, hard_negatives=(roll, roll)))
    kernels.reset_launch_counts()
    state, metrics = step(state, batch, None)
    vals = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
    vals["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    vals["peak_bytes"] = torch.cuda.max_memory_allocated()
    del state, batch, step, metrics
    return vals


# phase 31's fixed batch on one card: two processes on card 0 over gloo at
# each layout. `data: 2` is the control of that harness: its per-row math
# is the one process's, so it is held to the one-process bf16 step at
# phase 27's gates (DP_LOSS_RTOL, DP_GRAD_NORM_RTOL), which the data axis
# meets on separate cards over NCCL. `tensor: 2` in f32 meets those gates
# too (the cut's math is exact), but in bf16 it rounds at other places
# (the column layers' products at 3C/T or 4C/T outputs, the attention at
# H/T heads), ~1e-4 off the one-process bf16 step, as far as that step
# lies from its f32 twin: it is held to that twin, each value within
# TP_BUDGET times the one-process bf16 step's own distance from it (or
# phase 27's gate where that distance is smaller): the cut may round
# differently, not worse, as phase 31's blocks are held
TP_ONE_CARD = (({"tensor": 2}, "cut"), ({"data": 2}, "control"))
# run by the `tensor: 2` processes after that layout, held as the cut: as
# it is, and on both fused routes (held to the fused one-process step)
TP_ONE_CARD_SEQ = {"tensor": 2, "seq_shard": True}
TP_STEP_VALUES = ("loss", "loss_itc", "loss_itm", "loss_mlm", "loss_mim",
                  "grad_norm")
# the towers whose retrieval steps the `tensor: 2` processes run last: in
# f32 held to the one-process f32 step at phase 27's gates (the cut's math
# is exact), in bf16 (the launches) shown against the one-process steps
TOWER_KINDS = ("clip", "deit")
TOWER_STEP_VALUES = ("loss", "loss_itc", "loss_itm", "grad_norm")


def tensor_one_card_start(root: str) -> dict:
    """Phase 31's fixed batch on one card, started: `dp_step_worker` in
    bf16 at each layout of TP_ONE_CARD on two processes on card 0 (gloo)
    → {layout tag: the launch}, while this process goes on."""
    return {_layout_tag(par): _torchrun(2, [
        os.path.join(REPO, "chip_smoke.py"), "--dp-step", root,
        json.dumps(par), "one-card"]) for par, _ in TP_ONE_CARD}


def _cut_share(got: dict, one: dict, f32: dict, keys) -> dict:
    """Each value's distance from the f32 step over its gate: TP_BUDGET
    times the one-process bf16 step's own distance from it, or phase 27's
    gate where that is smaller (the cut may round differently, not
    worse)."""
    def tol(k):
        return DP_GRAD_NORM_RTOL if k == "grad_norm" else DP_LOSS_RTOL

    return {k: abs(got[k] - f32[k]) / (TP_BUDGET * max(
        abs(one[k] - f32[k]), tol(k) * abs(f32[k]))) for k in keys}


def tensor_one_card_finish(root: str, procs: dict) -> dict:
    """The one-process steps on phase 27's fixed global batch (bf16, f32,
    and bf16 on the fused routes) and the towers' in this process, while
    the cut's processes run, then the launches of
    `tensor_one_card_start` waited for and held as TP_ONE_CARD says (the
    `tensor: 2` processes' steps at TP_ONE_CARD_SEQ, as it is and fused,
    as the cut; each process's peak memory printed, with no gate), and
    the processes' tower steps held to the towers' one-process steps
    (`tower_step`, bf16 and f32) as TOWER_KINDS says → {"one", "one_f32",
    "one_fused": their values, tag: {"values", "rel": each value's
    relative distance from the one-process bf16 step, and for the cut
    "share": `_cut_share`}, "tower_<kind>": {"values", "f32_rel",
    "share"}, "blocks": the lines of `seq_tower_group_checks`}."""
    def tol(k):
        return DP_GRAD_NORM_RTOL if k == "grad_norm" else DP_LOSS_RTOL

    # the control's one step ends first; this process's steps then run
    # beside the cut's processes (the card holds both: at most ~28 GB
    # here, ~33 GB there)
    control = _layout_tag(TP_ONE_CARD[1][0])
    stdout = _finish(procs.pop(control), f"dp-step {control} on one card")
    dp_step_worker(root)
    dp_step_worker(root, f32=True)
    dp_step_worker(root, fused=True)
    ones = {kind: (tower_step(kind), tower_step(kind, f32=True))
            for kind in TOWER_KINDS}
    torch.cuda.empty_cache()
    refs = {}
    for name in ("", "_f32", "_fused"):
        with open(os.path.join(root, f"dp_step_1{name}.json")) as f:
            refs[name] = json.load(f)
        refs[name].pop("launches")
    one, f32 = refs[""], refs["_f32"]
    print(f"  fixed global batch of 32, one process: bf16 {json.dumps(one)}"
          f"; f32 {json.dumps(f32)}; bf16 fused "
          f"{json.dumps(refs['_fused'])}")
    out = {"one": one, "one_f32": f32, "one_fused": refs["_fused"]}
    seq = _layout_tag(TP_ONE_CARD_SEQ)
    for tag, role, fz in ([(_layout_tag(p), r, "") for p, r in TP_ONE_CARD]
                          + [(seq, "cut", ""), (seq, "cut", "_fused")]):
        if tag in procs:
            stdout += _finish(procs.pop(tag), f"dp-step {tag} on one card")
        with open(os.path.join(root, f"dp_step_2_{tag}{fz}_one_card.json")
                  ) as f:
            got = json.load(f)
        peak = got.pop("peak_bytes_by_rank")
        print(f"  {tag}{fz} on one card: peak memory by process {peak} B; "
              f"launches a process {json.dumps(got['launches'])}")
        ref = refs[fz]
        rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in TP_STEP_VALUES}
        res = dict(values=got, rel=rel)
        if role == "control":
            bad = [k for k in TP_STEP_VALUES if not rel[k] <= tol(k)]
        else:
            res["share"] = _cut_share(got, ref, f32, TP_STEP_VALUES)
            bad = [k for k in TP_STEP_VALUES if not res["share"][k] <= 1.0]
        print(f"  fixed global batch of 32, bf16{fz.replace('_', ' ')}, "
              f"{tag} on two processes on one card (gloo, the {role}): "
              f"{json.dumps({k: got[k] for k in TP_STEP_VALUES})}; "
              f"relative to one process {json.dumps(rel)}"
              + (f"; distance from the f32 step over its gate "
                 f"{json.dumps(res['share'])}" if role == "cut" else ""))
        if bad:
            raise AssertionError(f"fixed global batch {tag}{fz} on one "
                                 f"card: {bad} beyond the gate")
        out[tag + fz] = res
    for kind in TOWER_KINDS:
        one_k, f32_k = ones[kind]
        got = {}
        for t32 in ("", "_f32"):
            with open(os.path.join(root, f"dp_tower_2_{kind}{t32}"
                                   "_one_card.json")) as f:
                got[t32] = json.load(f)
        rel = {k: abs(got["_f32"][k] - f32_k[k]) / abs(f32_k[k])
               for k in TOWER_STEP_VALUES}
        share = _cut_share(got[""], one_k, f32_k, TOWER_STEP_VALUES)
        vals = {t: {k: got[t][k] for k in TOWER_STEP_VALUES} for t in got}
        print(f"  {kind} retrieval step, 384 px, B = 32, tensor2 on two "
              f"processes on one card (gloo, the cut): f32 "
              f"{json.dumps(vals['_f32'])}, relative to one process "
              f"{json.dumps(rel)}; bf16 {json.dumps(vals[''])}; one "
              f"process bf16 "
              f"{json.dumps({k: one_k[k] for k in TOWER_STEP_VALUES})}, f32 "
              f"{json.dumps({k: f32_k[k] for k in TOWER_STEP_VALUES})}; the "
              f"bf16 cut's distance from the f32 step over TP_BUDGET times "
              f"the one-process bf16 step's (no gate) {json.dumps(share)}; "
              f"peak memory by process bf16 "
              f"{got['']['peak_bytes_by_rank']} B, f32 "
              f"{got['_f32']['peak_bytes_by_rank']} B (one process "
              f"{one_k['peak_bytes']} B, {f32_k['peak_bytes']} B); launches "
              f"a process bf16 {json.dumps(got['']['launches'])}")
        bad = [k for k in TOWER_STEP_VALUES if not rel[k] <= tol(k)]
        bad += [k for k in TOWER_STEP_VALUES if not math.isfinite(got[""][k])]
        if bad:
            raise AssertionError(f"{kind} retrieval step at tensor: 2 on one "
                                 f"card: {bad} beyond the gate")
        out[f"tower_{kind}"] = dict(values=got[""], f32_rel=rel, share=share)
    out["blocks"] = [line for line in stdout.splitlines()
                     if " of its gate; " in line]
    return out


def tensor_kernel_entries(tp: dict) -> list:
    """The `kernels` entries of phase 31: K1, K2, K5 (forward and
    backward) and K3's grouped forward at each T's shard shapes, their
    launches from the shards' runs."""
    out = []
    specs = (("k1", "packed_attention", 983, 1007, "packed_attention.cu",
              ("dqkv", "db"), "h{h}"),
             ("k2", "relpos_attention", 689, 717, "relpos_attention.cu",
              ("dqkv", "dcr", "dcls"), "h{h}"),
             ("k5", "fused_mlp", 75, 84, "fused_mlp.cu", ("dh", "dW"),
              "k{k}_partial"),
             ("k3g", "flash_attention", 71, None, "flash_attention.cu", (),
              "grouped_rerank_h{h}"))
    for T, rows in tp.items():
        for key, prefix, lf, lb, src, bwd_errs, label in specs:
            err, t, w, launches = rows[key]
            tag = label.format(h=12 // T, k=3072 // T)
            dirs = [("fwd", lf)] + ([("bwd", lb)] if lb else [])
            tpu = ("xfm_tpu/ops/fused_mlp.py" if key == "k5"
                   else "xfm_tpu/ops/flash_attention.py")
            for d, line in dirs:
                e = (max(err[k][0] for k in bwd_errs) if d == "bwd" else
                     max(v[0] for k, v in err.items() if k not in bwd_errs))
                entry = dict(
                    name=f"{prefix}_{d}_tensor{T}_{tag}", route="cuda",
                    source=f"xfm_tpu_torch/csrc/{src}",
                    replaces=f"{tpu}:{line}",
                    launches=launches.get(f"{prefix}_{d}", 0),
                    max_abs_err=e, ms=t[f"{d}_ms"],
                    plain_ms=t[f"plain_{d}_ms"],
                    bound_ms=w[d]["bound_ms"], bound_by=w[d]["bound_by"],
                    library_ms=t[f"library_{d}_ms"])
                if key == "k5" and d == "bwd":
                    entry["also_replaces"] = f"{tpu}:99"
                out.append(entry)
    return out


def tp_decode_worker(out_dir: str, parallel=None) -> int:
    """`python3 chip_smoke.py --tp-decode OUT [PARALLEL]` under torchrun:
    the full-width VQA model's `rank` (k 8 of 64 answers) and the caption
    model's beam-3 decode (f32, 384 px, weights from seed 0, cut as an
    `--evaluate` run cuts them under PARALLEL) on 4 fixed images; rank 0
    writes the top-k ids and probabilities and the sequences to
    OUT/tp_decode_<W>[_<layout>].json."""
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.core import mesh
    from xfm_tpu_torch.models import XFMForCaptioning, XFMForVQA
    from xfm_tpu_torch.models.generation import beam_generate
    from xfm_tpu_torch.tasks.common import TaskContext, eval_model

    dev = mesh.maybe_init_distributed("cuda")
    ctx = TaskContext(config={"parallel": parallel or {}}, out_dir=out_dir,
                      seed=0, device=dev)
    g = torch.Generator(device="cpu").manual_seed(3)
    images = torch.randn(4, 384, 384, 3, generator=g).to(dev)
    q = torch.randint(5, 1000, (4, 12), generator=g).to(dev)
    ans = torch.randint(5, 1000, (64, 6), generator=g).to(dev)
    ans[:, 0], ans[:, -1] = 0, 2
    res = {}
    with torch.device(dev):
        vqa = XFMForVQA.from_yaml(configs.vqa_yaml(
            image_res=384, compute_dtype="float32"))
    vqa = eval_model(ctx, vqa).eval()
    with torch.no_grad():
        ids, probs = vqa.rank(images, q, torch.ones_like(q), ans,
                              torch.ones_like(ans), 8)
    res["rank_ids"], res["rank_probs"] = ids.tolist(), probs.float().tolist()
    del vqa
    with torch.device(dev):
        cap = XFMForCaptioning.from_yaml(configs.caption_yaml(
            image_res=384, compute_dtype="float32"))
    cap = eval_model(ctx, cap).eval()
    with torch.no_grad():
        seqs = beam_generate(cap, images, bos_id=0, eos_id=2, pad_id=1,
                             max_len=12, num_beams=3)
    res["beam"] = seqs.tolist()
    if mesh.rank() == 0:
        tag = f"_{_layout_tag(parallel)}" if parallel else ""
        with open(os.path.join(out_dir, f"tp_decode_{mesh.world_size()}"
                               f"{tag}.json"), "w") as f:
            json.dump(res, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def tensor_cards(root: str, dp: dict) -> dict:
    """Phase 31 on two cards or more (W of them): at `tensor: 2` (two
    processes) and on four at `data: 2, tensor: 2` and `fsdp: 2, tensor:
    2`, phase 27's fixed global batch in f32 against its one-process f32
    step (in bf16 `tensor_one_card_finish` holds `tensor: 2` on any card
    count), `pretrain_DIY`
    (bf16) and `itr_coco` (f32) under torchrun (`itr_coco`'s `ckpt/0`
    evaluated on one process equal to the epoch's eval); at `tensor: 2`
    VQA's `rank` and the caption beam decode against one process's."""
    import yaml

    from xfm_tpu_torch import run

    W = torch.cuda.device_count()
    layouts = [({"tensor": 2}, 2)] + ([({"data": 2, "tensor": 2}, 4),
                                       ({"fsdp": 2, "tensor": 2}, 4)]
                                      if W >= 4 else [])
    steps = {}
    for par, n in [({}, 1)] + layouts:
        tag = _layout_tag(par)
        _finish(_torchrun(n, [os.path.join(REPO, "chip_smoke.py"),
                              "--dp-step", root, json.dumps(par), "f32"]),
                f"dp-step {tag or 'one'} f32")
        name = f"dp_step_{n}{'_' + tag if tag else ''}_f32.json"
        with open(os.path.join(root, name)) as f:
            steps[tag] = json.load(f)
        print(f"  fixed global batch of 32, f32, {tag or 'one process'}: "
              f"{json.dumps(steps[tag])}")
    one = steps[""]
    with open(os.path.join(root, "ft.yaml")) as f:
        ft32 = dict(yaml.safe_load(f), compute_dtype="float32")
    ft32_path = os.path.join(root, "ft_f32.yaml")
    with open(ft32_path, "w") as f:
        yaml.safe_dump(ft32, f)
    out = {}
    for par, n in layouts:
        tag = _layout_tag(par)
        got = steps[tag]
        for k in ("loss", "loss_itc", "loss_itm", "loss_mlm", "loss_mim",
                  "grad_norm"):
            tol = DP_GRAD_NORM_RTOL if k == "grad_norm" else DP_LOSS_RTOL
            if not abs(got[k] - one[k]) <= tol * abs(one[k]):
                raise AssertionError(f"fixed global batch {tag}: {k} "
                                     f"{got[k]}, one process {one[k]}")
        cfgs = {}
        for name, path in (("pt", os.path.join(root, "pt.yaml")),
                           ("ft", ft32_path)):
            with open(path) as f:
                cfg = dict(yaml.safe_load(f), parallel=par)
            cfgs[name] = os.path.join(root, f"{name}_{tag}.yaml")
            with open(cfgs[name], "w") as f:
                yaml.safe_dump(cfg, f)
        pt_dir, ft_dir = (os.path.join(root, f"{x}_{tag}")
                          for x in ("pt", "ft"))
        bs = str(24 * (n // 2))  # 24 rows a data × fsdp rank
        _finish(_torchrun(n, ["-m", "xfm_tpu_torch.run", "--task",
                              "pretrain_DIY", "--config", cfgs["pt"],
                              "--device", "cuda", "--bs", bs,
                              "--output_dir", pt_dir]),
                f"pretrain_DIY {tag}")
        _finish(_torchrun(n, [
            "-m", "xfm_tpu_torch.run", "--task", "itr_coco", "--config",
            cfgs["ft"], "--device", "cuda", "--seed", "0", "--bs", bs,
            "--epoch", "1", "--output_dir", ft_dir]), f"itr_coco {tag}")
        pt_losses = [x for e in _last_log(pt_dir) for x in e["losses"]]
        ft_log = _last_log(ft_dir)
        ev = run.main(["--task", "itr_coco", "--config", ft32_path,
                       "--device", "cuda", "--seed", "0", "--evaluate",
                       "--checkpoint",
                       os.path.join(ft_dir, "ckpt", "0", "state.pt"),
                       "--output_dir", ft_dir + "_ev"])
        print(f"  {tag}: pretrain_DIY losses {pt_losses}; itr_coco (f32) "
              f"epoch eval {ft_log[1]['r_mean']}, one process's eval of "
              f"its ckpt/0 {ev['r_mean']}")
        if (len(pt_losses) != 2 or not all(map(math.isfinite, pt_losses))
                or ev != {k: ft_log[1][k] for k in ev}):
            raise AssertionError(f"{tag}: the pretrain losses or the eval "
                                 f"of ckpt/0")
        out[tag] = dict(fixed_batch_f32=got, pretrain_losses=pt_losses,
                        r_mean=ft_log[1]["r_mean"])
        for d in (pt_dir, ft_dir, ft_dir + "_ev"):
            shutil.rmtree(d, ignore_errors=True)
    out["fixed_batch_f32_one"] = one
    dec = {}
    for par, n in ((None, 1), ({"tensor": 2}, 2)):
        _finish(_torchrun(n, [os.path.join(REPO, "chip_smoke.py"),
                              "--tp-decode", root]
                          + ([json.dumps(par)] if par else [])),
                f"tp-decode {_layout_tag(par) or 'one'}")
        tag = f"_{_layout_tag(par)}" if par else ""
        with open(os.path.join(root, f"tp_decode_{n}{tag}.json")) as f:
            dec[n] = json.load(f)
    probs = np.abs(np.asarray(dec[1]["rank_probs"])
                   - np.asarray(dec[2]["rank_probs"])).max()
    same_ids = dec[1]["rank_ids"] == dec[2]["rank_ids"]
    print(f"  tensor2: rank ids equal {same_ids}, probabilities within "
          f"{probs:.2e}; beam sequences equal "
          f"{dec[1]['beam'] == dec[2]['beam']}")
    if (dec[1]["rank_ids"] != dec[2]["rank_ids"] or probs > RANK_PROB_ATOL
            or dec[1]["beam"] != dec[2]["beam"]):
        raise AssertionError("tensor2: rank_answer or the beam decode")
    out["decode"] = dict(rank_prob_err=float(probs))
    return out


def phase(header: str) -> None:
    """Print a phase's header, on standard error too with the seconds since
    the run began, and note when the phase began."""
    PHASE_T.append(time.perf_counter())
    print(header, flush=True)
    print(f"chip_smoke {PHASE_T[-1] - PHASE_T[0]:.1f} s: {header}",
          file=sys.stderr, flush=True)


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

    prof = profile_step.profile_pretrain_streams(None,
                                                steps=PROFILE_STEPS)
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
    k2n, k2b, k2g, _, nprof, nt = nlvr_phase(keep_corpora=True)
    phase("phase 23: ImageNet, the linear probe, GLUE and classify: K1 at "
          "the new batches, the slice, the tasks and their profiles")
    k1ft, k1lp, clprof, ct = classify_phase(keep_corpora=True)
    phase("phase 24: the pretrain task's optional branches: the VQ-KD "
          "tokenizer, region attention, the shared table, bf16 parameters")
    qprof = vqkd_phase()
    phase("phase 25: the pretrain task's input path: the C++ loader, uint8 "
          "batches, device RandAugment")
    inp = input_phase(pt["throughput"], prof)
    print("  input path: " + json.dumps(inp["native_loader"]))
    phase("phase 26: the Swin-B and DeiT towers and the BERT text encoder: "
          "K3 at DeiT's shape, the slices, the steps, the task and the "
          "profiles")
    tw = tower_phase()
    phase("phase 27: data parallelism under torchrun (NCCL): pretrain_DIY "
          "and itr_coco")
    dp = dp_phase(ft["r_mean"][0], keep_root=True)
    print("  data parallel: " + json.dumps(
        {k: v for k, v in dp.items() if k != "root"}))
    phase("phase 28: data parallelism under torchrun (NCCL): nlvr, "
          "refcoco_bbox, imagenet, the probe, glue and classify")
    dpt = dp_tasks_phase(nt, ct)
    print("  data parallel tasks: " + json.dumps(dpt))
    phase("phase 29: activation checkpointing: K1 at H = 16, K4 and K5 at "
          "the large widths, the large slice, checkpointing on against off, "
          "the BEiT-2-large pretrain task and its profiles")
    rm = remat_phase()
    import tempfile

    tp_root = tempfile.mkdtemp(prefix="xfm_tp_")
    launched = {}
    try:
        phase("phase 30: FSDP: the sharded pretrain task on a one-rank mesh "
              "held to the plain run, its checkpoint resumed unsharded and "
              "exported; with more cards the layouts under torchrun")
        one_card = torch.cuda.device_count() == 1
        if one_card:  # phase 31's two-process runs on this card start
            # here: their start-up overlaps phase 30, which times no kernel
            # (with more cards phase 30 fills card 0 itself)
            launched = tensor_one_card_start(tp_root)
        fs = fsdp_phase(dp, keep_root=True)
        print("  fsdp: " + json.dumps(fs))
        phase("phase 31: tensor parallelism: full-width BEiT-2 blocks and "
              "fusion layers cut into T = 2 and 4 shards, summed by hand on "
              "the card against the whole module; K1, K2, K3 and K5 at the "
              "shards' shapes; the fixed batch at tensor: 2 on two processes "
              "on this card; with more cards the layouts under torchrun")
        if not one_card:
            launched = tensor_one_card_start(tp_root)
        # the launches end before the kernels are timed
        tp_one = tensor_one_card_finish(tp_root, launched)
        print("  tensor one card: " + json.dumps(
            {k: v for k, v in tp_one.items() if k != "blocks"}))
        tp = tensor_phase(dict(k1=k1_t, k2=k2_t, k3g=k3g_t, k5=k5_t))
        phase("phase 32: sequence parallelism and the tower cuts: "
              "full-width BEiT-2 blocks, text and fusion layers under "
              "seq_shard, CLIP-ViT and DeiT blocks at 384 px and Swin-B "
              "blocks, each cut and run under phase 31's two-process group "
              "on this card against the whole module; K3 and K4 at the new "
              "shapes")
        st = seq_tower_phase(tp_one)
        if torch.cuda.device_count() >= 2:
            print("  tensor cards: " + json.dumps(
                tensor_cards(dp["root"], dp)))
        else:
            print("  tensor: 2 (and data: 2 x tensor: 2, fsdp: 2 x tensor: 2 "
                  "on four) under torchrun over NCCL, pretrain_DIY, "
                  "itr_coco, rank_answer and the beam decode: not run, this "
                  "machine has one card; the CPU tests run two and four "
                  "gloo processes at those layouts")
    finally:
        for proc in launched.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        shutil.rmtree(dp["root"], ignore_errors=True)
        shutil.rmtree(tp_root, ignore_errors=True)

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
                                     qprof["pretrain_vqkd"])
               + tower_kernel_entries(*tw["k3"], tw["deit_launches"])
               + pretrain_kernel_entries(*rm["k1"][192], *rm["k1"][80],
                                         rm["prof"]["full_yaml_by_stream"],
                                         label="large")
               + tensor_kernel_entries(tp)
               + seq_tower_kernel_entries(st))
    ends = PHASE_T[1:] + [time.perf_counter()]
    by_phase = [round(b - a, 1) for a, b in zip(PHASE_T, ends)]
    print(f"chip_smoke: phases 1-26 in {ends[25] - PHASE_T[0]:.1f} s (the "
          f"host's speed: phases 27-{len(PHASE_T)} add the multi-process "
          f"work)")
    print(f"chip_smoke: {len(PHASE_T)} phases in {ends[-1] - t_start:.1f} "
          f"s; seconds by phase {json.dumps(by_phase)}")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-step"]:
        sys.exit(dp_step_worker(sys.argv[2], json.loads(sys.argv[3])
                                if len(sys.argv) > 3 else None,
                                f32="f32" in sys.argv[4:],
                                one_card="one-card" in sys.argv[4:],
                                fused="fused" in sys.argv[4:]))
    if sys.argv[1:2] == ["--fsdp-peak"]:
        sys.exit(fsdp_peak_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--tp-decode"]:
        sys.exit(tp_decode_worker(sys.argv[2], json.loads(sys.argv[3])
                                  if len(sys.argv) > 3 else None))
    if sys.argv[1:2] == ["--dp-task"]:
        sys.exit(dp_task_worker(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
