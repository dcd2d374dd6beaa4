"""Where the time of one XFM-base train step, or of the retrieval eval, goes
on the card.

    python3 -m xfm_tpu_torch.profile_step
        [pretrain|pretrain_fused|retrieval|retrieval_train|clip_retrieval|
         retrieval_eval|pretrain_streams|vqa_train|vqa_rank|caption_train|
         caption_beam|caption_scst|caption_pretrain|nlvr_train|
         grounding_train|gradcam|imagenet_train|imagenet_lp|glue_train|
         pretrain_vqkd|pretrain_bf16|pretrain_randaug|pretrain_large|
         pretrain_large_remat|swin_retrieval_train|deit_retrieval_train]
        [--trace PATH]

Runs the full-width step of the chosen path as `chip_smoke.py` does
(pretrain: B = 48 at 224 px, the default; pretrain_fused: the same with the
fused LayerNorm K4 and the fused MLP matmul K5; retrieval: the 384 px
fine-tune, B = 32, T = 40, deterministic; retrieval_train: the step
of `run.py --task itr_coco` on `Retrieval_coco.yaml`'s model at the same
B and T, its dropout and drop-path live, the optimizer and schedule from
the YAML; clip_retrieval: the deterministic retrieval step with the
CLIP-ViT-B/16 tower; random weights, bf16 compute), then profiles STEPS
steps
with torch.profiler. It prints the peak memory allocated over the 2
warm-up steps. From that one profiled window it prints the device's
span per step (first kernel start to last kernel end, on the trace's clock),
its busy time per step (sum of kernel times), the idle share of the span,
the host-clock time per step of the same window (profiler overhead
included), kernel time by group (K1–K5, matmuls, the rest) and the TOP
kernels by name. The chrome trace goes to `--trace`
(build/xfm_tpu_torch/profile_<path>.json by default).

retrieval_eval profiles the eval of `chip_smoke.py` phase 17 (XFM-base at
384 px from `configs.RETRIEVAL_COCO`, bf16, random weights) one unit of
work at a time, each in its own window after a warm-up call: a stage-1
batch of 64 images (K2) and one of 64 texts, one grouped image → text
chunk (8 images × k_test 256 candidates, K3) and one text → image chunk in
the repeat form (8 texts × 256). It prints each unit's span, busy time,
idle share and groups, and the busy time by group of the whole eval of
256 images and 1,280 captions (the units × their counts there).

pretrain_streams profiles the step of `run.py --task pretrain_DIY` on
`Pretrain_base_4m.yaml` at its batch sizes (image-text 96, regions 96 over
80 images, ImageNet 96, text 256 × 128 tokens) on seeded device batches:
the four streams' forward and backward one after another, dropout and
drop-path live, one clipped HF-AdamW update. It prints the peak memory,
the span, busy time and idle share a step, the groups, the kernels'
launches a step, each stream's step alone (launches, busy time, groups)
and the streams' losses.

vqa_train profiles the step of `run.py --task vqa` on `VQA.yaml` (XFM-base
with its 12-layer answer decoder at 480 px, bf16, the full vocabulary) at
its batch of 16 questions and 64 answers of 10 tokens on seeded device
batches, dropout and drop-path live; vqa_rank one eval batch of its 16
questions through `XFMForVQA.rank` (the top 128 of a 3,129-answer list,
decoded as 16 groups of 128). Each prints its peak memory, span, busy
time, idle share, groups and the kernels' launches a call.

caption_train profiles the step of `run.py --task coco_captioning` on
`Captioning.yaml` (the BEiT-2 tower at 384 px and a 12-layer decoder
cross-attending to its patches, bf16, the full vocabulary) at its batch of
16 captions of 30 tokens, dropout and drop-path live; caption_beam one
eval batch of 32 images, beam 3, `min_length` 5, `max_length` 20, the
prompt forced; caption_scst one SCST step of 16 images, 5 samples an
image with the greedy baseline and CIDEr-D rewards on the host;
caption_pretrain the domain pretrain's step on `Captioning_pretrain.yaml`
at its batch of 64 at 224 px. Each prints the same numbers as vqa_train.

nlvr_train profiles the step of `run.py --task nlvr` on `NLVR.yaml`
(XFM-base at 384 px, bf16, the full vocabulary) at its batch of 24 pairs
(48 images, one tower pass) of 40 tokens, dropout and drop-path live;
grounding_train the bbox fine-tune's step of `run.py --task refcoco_bbox`
on `Grounding_bbox.yaml` at its batch of 24 phrases of 30 tokens; gradcam
one batch of 8 through `itm_gradcam` at fusion layer 8 (the weakly
supervised grounding). Each prints the same numbers as vqa_train.

imagenet_train profiles the step of `run.py --task imagenet` on
`imagenet1k.yaml` (the BEiT-2 tower at 224 px and the 1,000-way
`DeepMLPHead`, bf16) at its batch of 128 images, soft targets from mixup,
dropout and drop-path live; imagenet_lp the linear probe's step on
`imagenet1k_lp.yaml` at its batch of 512 (the tower frozen, LARS on the
head); glue_train the step of `run.py --task glue` on `glue_mrpc.yaml`
(the 12-layer RoBERTa text encoder and `MLPHead`) at its batch of 32
pairs of 128 tokens. Each prints the same numbers as vqa_train, and the
model FLOPs of its step (`configs.imagenet_step_flops`,
`glue_step_flops`) over its busy time against the card's 989 TFLOP/s
(bf16, dense).
pretrain_vqkd profiles pretrain_streams' step with the pretrain task's
optional branches on (`configs.PRETRAIN_VQKD_KEYS`: the frozen VQ-KD
tokenizer, random weights, whose f32 encoder gives the MIM streams' code
ids, MIM's cross-entropy over 8,192 codes, region attention in the last 3
blocks of the region stream; f32 parameters); pretrain_bf16 the step of
the shipped YAML with `bf16_params` (bf16 parameters, f32 masters in the
optimizer); pretrain_randaug the step of the shipped YAML with
`device_randaug` on the image-text and ImageNet blocks (their images
uint8, as the C++ loader hands them over, and RandAugment(2, 7) on the
card before the loss, `tasks.pretrain.device_randaugment`). Each prints
what pretrain_streams prints, and the model FLOPs of its step
(`configs.pretrain_streams_flops`, the tokenizer's forward counted) over
its busy time against the card's bf16 peak; pretrain_randaug also the
busy time of the RandAugment alone (its own window after the step's) and
its share of the step's.
pretrain_large and pretrain_large_remat profile pretrain_streams' step
with the BEiT-2-large tower (`configs.PRETRAIN_LARGE_KEYS`: 24 blocks of
width 1024, 16 heads) with activation checkpointing off and on
(`gradient_checkpointing`, policy `full`), at the YAML's batches; each
prints what pretrain_streams prints, the FLOPs at the large tower's sizes.
swin_retrieval_train and deit_retrieval_train profile the step of
retrieval_train with the Swin-B tower (window 12, 145 output rows of width
1024) and BERT-base text and fusion encoders, and with the DeiT-B/16 tower
(K3 forward and backward in its 12 blocks) and RoBERTa-base; each prints
the same numbers as imagenet_train (`configs.tower_retrieval_step_flops`).
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
from typing import Optional

import torch

STEPS = 3
BF16_PEAK_FLOPS = 989e12  # H100 SXM, dense (NVIDIA's data sheet)
TOP = 25


def _group(name: str) -> str:
    n = name.lower()
    # K1's f32 kernels (`packed_*`) and its instantiations of the shared
    # attention kernels (`xfm_attn_*<PackedBias>`), before K3's `xfm_attn_`
    if "packed_" in n or "packedbias" in n:
        return "k1_packed_attention"
    # K2's kernels, its instantiations of the shared attention kernels
    # (`xfm_attn_*<RelposBias<...>>`) among them, before K3's `xfm_attn_`
    if "relpos" in n:
        return "k2_relpos_attention"
    if "xfm_attn_" in n:
        return "k3_flash_attention"
    if "xfm_ln_" in n:
        return "k4_fused_ln"
    if "xfm_act_matmul" in n:
        return "k5_fused_mlp"
    if any(k in n for k in ("gemm", "cutlass", "xmma", "nvjet", "sm90_")):
        return "matmul"
    if "foreach" in n or "multi_tensor" in n:
        return "optimizer_foreach"
    if "softmax" in n:
        return "softmax"
    if "layer_norm" in n or "layernorm" in n:
        return "layer_norm"
    return "other"


def _window(fn, reps: int):
    """fn() `reps` times in one profiled window (CUDA activity only:
    recording every host op triples a step) → (profiler, span ms, busy ms,
    host ms, {kernel: [ms, launches]}), times per call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / reps * 1e3
    kernels = {}
    first, last = float("inf"), float("-inf")
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.setdefault(e.name, [0.0, 0])
            kernels[e.name][0] += e.time_range.elapsed_us() / 1e3 / reps
            kernels[e.name][1] += 1
            first = min(first, e.time_range.start)
            last = max(last, e.time_range.end)
    span = (last - first) / 1e3 / reps
    busy = sum(v[0] for v in kernels.values())
    return prof, span, busy, host_ms, kernels


def _groups(kernels) -> dict:
    groups = {}
    for name, (ms, _) in kernels.items():
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + ms
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def retrieval_eval_units(n_img: int = 256, n_txt: int = 1280,
                         k_test: int = 256, batch: int = 64, chunk: int = 8,
                         seed: int = 0) -> dict:
    """The eval's units of work on the card → {unit: (fn, count in an eval
    of n_img images and n_txt captions)}: XFM-base at 384 px from
    `configs.RETRIEVAL_COCO`, bf16, random weights from `seed`, inputs from
    a `SyntheticRetrievalEvalData` of `batch` images and captions."""
    from . import configs
    from .models import XFMForRetrieval
    from .train.checkpoint import init_weights

    cfg = configs.xfm_retrieval_eval_config()
    model = XFMForRetrieval(cfg).to("cuda")
    init_weights(model, seed)
    data = configs.SyntheticRetrievalEvalData(batch, 1, cfg.vision.image_res,
                                              cfg.text.vocab_size, seed=seed)
    images = torch.from_numpy(data.images).cuda()
    ids = torch.from_numpy(data.ids).long().cuda()
    atts = torch.from_numpy(data.atts).long().cuda()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        img_embeds, _ = model.encode_images(images)
        txt_embeds, _ = model.encode_texts(ids, atts)
    rows = torch.randint(0, batch, (chunk * k_test,), generator=g).cuda()

    def unit(fn):
        return torch.no_grad()(fn)

    return {
        "stage1_images": (unit(lambda: model.encode_images(images)),
                          -(-n_img // batch)),
        "stage1_texts": (unit(lambda: model.encode_texts(ids, atts)),
                         -(-n_txt // batch)),
        "i2t_grouped_chunk": (unit(lambda: model.itm_scores(
            img_embeds[:chunk], txt_embeds[rows], atts[rows],
            image_group_size=k_test)), -(-n_img // chunk)),
        "t2i_repeat_chunk": (unit(lambda: model.itm_scores(
            img_embeds[rows], txt_embeds[rows // k_test],
            atts[rows // k_test])), -(-n_txt // chunk)),
    }


def profile_retrieval_eval(trace: str, reps: int = 2) -> int:
    per_eval, by_unit = {}, {}
    for name, (fn, count) in retrieval_eval_units().items():
        fn()
        torch.cuda.synchronize()
        prof, span, busy, host_ms, kernels = _window(fn, reps)
        groups = _groups(kernels)
        print(f"{name}: device_span_ms={span:.3f} device_busy_ms={busy:.3f} "
              f"idle_share={1 - busy / span:.4f} host_ms={host_ms:.3f} "
              f"count_per_eval={count}")
        print(f"  groups_ms_per_call {json.dumps(groups)}")
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
        for kname, (ms, n) in top:
            print(f"  {ms:9.3f} ms/call {n // reps:6d} launches/call  "
                  f"{kname[:100]}")
        for g, ms in groups.items():
            per_eval[g] = per_eval.get(g, 0.0) + ms * count
        by_unit[name] = busy * count
        base, ext = os.path.splitext(trace)
        os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
        prof.export_chrome_trace(f"{base}_{name}{ext}")
    print("eval_busy_ms_by_unit " + json.dumps(by_unit))
    print("eval_busy_ms_by_group " + json.dumps(dict(sorted(
        per_eval.items(), key=lambda kv: -kv[1]))))
    print(torch.cuda.get_device_name(0))
    return 0


def profile_pretrain_streams(trace: str, steps: int = STEPS,
                             bs: Optional[int] = None,
                             by_stream: bool = True, warmup: int = 2,
                             **keys) -> dict:
    """The four-stream step of `run.py --task pretrain_DIY` at
    `Pretrain_base_4m.yaml`'s batch sizes (`keys` set on top), on seeded
    device batches (`configs.make_pretrain_streams_run`; no decode): the
    peak memory of `warmup` steps, then one profiled window of `steps`
    steps (its chrome trace written to `trace` unless that is None) →
    {span, busy, idle share, host ms a step, groups, launches a
    step (K1-K5 counters over the window), and of each stream's step
    taken alone after it its launches, span, busy time and groups; peak
    bytes; the streams' losses of the window's last step; under
    `device_randaug` the RandAugment's busy ms a step and its share}.
    `bs` sets every stream's batch (`--bs`); without `by_stream` the
    streams are not profiled alone."""
    from . import configs
    from .ops import kernels
    from .tasks.common import scale_batch

    state, batches, step, gens = configs.make_pretrain_streams_run(bs=bs,
                                                                   **keys)
    keys.pop("device_randaug", None)
    cfg = configs.pretrain_yaml(**keys)
    if bs:
        scale_batch(cfg, bs, 1)
    flops = configs.pretrain_streams_flops(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    i = 0
    for i in range(warmup):
        state, metrics = step(state, batches, gens(i))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    last = {}

    def one_step():
        nonlocal state, i
        i += 1
        state, m = step(state, batches, gens(i))
        last.update(m)

    kernels.reset_launch_counts()
    prof, span, busy, host_ms, kern = _window(one_step, steps)
    launches = {k: v // steps for k, v in kernels.LAUNCHES.items()}
    launches_by_stream, streams = {}, {}
    for name in sorted(batches) if by_stream else ():  # one at a time
        def stream_step(name=name):
            nonlocal state
            state, _ = step(state, {name: batches[name]}, gens(i + 1))

        kernels.reset_launch_counts()
        _, s_span, s_busy, _, s_kern = _window(stream_step, 1)
        launches_by_stream[name] = dict(kernels.LAUNCHES)
        streams[name] = dict(device_span_ms=s_span, device_busy_ms=s_busy,
                             groups_ms=_groups(s_kern))
    res = dict(device_span_ms=span, device_busy_ms=busy,
               idle_share=1 - busy / span, host_ms=host_ms,
               groups_ms_per_step=_groups(kern),
               launches_per_step=launches,
               launches_by_stream=launches_by_stream,
               streams_alone=streams, max_memory_allocated=peak,
               step_flops=flops,
               mfu_busy=flops / (busy * 1e-3) / BF16_PEAK_FLOPS,
               losses={k: float(v) for k, v in last.items()
                       if k.startswith(tuple(batches))})
    aug = [n for n in configs.RANDAUG_STREAMS if ("randaug", n) in gens(0)]
    if aug:
        from .tasks.pretrain import device_randaugment

        _, _, aug_busy, _, _ = _window(lambda: device_randaugment(
            batches, {n: gens(i)[("randaug", n)] for n in aug}), steps)
        res.update(randaug_busy_ms=aug_busy, randaug_share=aug_busy / busy)
    if trace:
        os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
        prof.export_chrome_trace(trace)
    res["top"] = [(name[:110], ms, n // steps) for name, (ms, n) in
                  sorted(kern.items(), key=lambda kv: -kv[1][0])[:TOP]]
    return res


def profile_vqa(trace: str, units=("vqa_rank", "vqa_train"),
                steps: int = STEPS, **keys) -> dict:
    """`units` of `configs.make_vqa_run` (`keys` on top of `VQA.yaml`'s)
    on one model, in order: "vqa_rank" (`rank()`, the eval of one batch)
    and "vqa_train" (the step, dropout live), each the peak memory of its
    warm-up (2 steps, or 1 rank) and then a profiled window of `steps`
    calls → {unit: {span, busy, idle share, host ms a call, groups,
    launches a call (K1-K5 counters over the window), peak bytes, the
    model's parameter count, and the loss (train) or the top-1 ids
    (rank)}}; the trace to `trace`, or with several units each unit's to
    <trace's base>_<unit>.json (none where `trace` is None)."""
    from . import configs
    from .ops import kernels

    state, batch, step, rank = configs.make_vqa_run(**keys)
    gen = torch.Generator(device="cuda").manual_seed(0)
    last = {}

    def train_call():
        nonlocal state
        state, m = step(state, batch, gen)
        last["loss"] = m["loss"]

    def rank_call():
        last["ids"] = rank()[0]

    out = {}
    for unit in units:
        fn, warm = {"vqa_train": (train_call, 2),
                    "vqa_rank": (rank_call, 1)}[unit]
        for p in state.model.parameters():
            p.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        kernels.reset_launch_counts()
        prof, span, busy, host_ms, kern = _window(fn, steps)
        res = dict(device_span_ms=span, device_busy_ms=busy,
                   idle_share=1 - busy / span, host_ms=host_ms,
                   groups_ms=_groups(kern),
                   launches=({k: v // steps
                              for k, v in kernels.LAUNCHES.items()}),
                   max_memory_allocated=peak,
                   params=sum(p.numel() for p in state.model.parameters()))
        if unit == "vqa_train":
            res["loss"] = float(last["loss"])
        else:
            res["top1"] = last["ids"][:, 0].tolist()
        res["top"] = [(name[:110], ms, n // steps) for name, (ms, n) in
                      sorted(kern.items(), key=lambda kv: -kv[1][0])[:TOP]]
        if trace:
            base, ext = os.path.splitext(trace)
            os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
            prof.export_chrome_trace(trace if len(units) == 1
                                     else f"{base}_{unit}{ext}")
        out[unit] = res
    return out


def _stream_units() -> dict:
    from .configs import PRETRAIN_LARGE_KEYS, PRETRAIN_VQKD_KEYS

    return {"pretrain_vqkd": dict(PRETRAIN_VQKD_KEYS),
            "pretrain_bf16": {"bf16_params": True},
            "pretrain_randaug": {"device_randaug": True},
            "pretrain_large": dict(PRETRAIN_LARGE_KEYS,
                                   gradient_checkpointing=False),
            "pretrain_large_remat": dict(PRETRAIN_LARGE_KEYS)}


# the pretrain task's step with its optional branches: unit → YAML keys
STREAM_UNITS = _stream_units()
CAPTION_UNITS = ("caption_train", "caption_beam", "caption_scst",
                 "caption_pretrain")
NLVR_UNITS = ("nlvr_train", "grounding_train", "gradcam")


def _profile_units(trace: str, units, make, summary, warm,
                   steps: int = STEPS) -> dict:
    """Each unit of `units` on its own model (`make(unit)` → (state,
    call)), in order: the peak memory of its warm-up (`warm(unit)` calls),
    then a profiled window of `steps` calls → {unit: {span, busy, idle
    share, host ms a call, groups, launches a call (K1-K5 counters over
    the window), peak bytes, the model's parameter count, and
    `summary(unit, the last call's output)`}}; each unit's trace to
    <trace's base>_<unit>.json (or `trace` for one unit; none where
    `trace` is None)."""
    from .ops import kernels

    out = {}
    for unit in units:
        state, call = make(unit)
        last = {}
        n = [0]

        def fn():
            n[0] += 1
            last["out"] = call(n[0])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(warm(unit)):
            fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        kernels.reset_launch_counts()
        prof, span, busy, host_ms, kern = _window(fn, steps)
        res = dict(device_span_ms=span, device_busy_ms=busy,
                   idle_share=1 - busy / span, host_ms=host_ms,
                   groups_ms=_groups(kern),
                   launches=({k: v // steps
                              for k, v in kernels.LAUNCHES.items()}),
                   max_memory_allocated=peak,
                   params=sum(p.numel() for p in state.model.parameters()))
        res.update(summary(unit, last["out"]))
        res["top"] = [(name[:110], ms, c // steps) for name, (ms, c) in
                      sorted(kern.items(), key=lambda kv: -kv[1][0])[:TOP]]
        if trace:
            base, ext = os.path.splitext(trace)
            os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
            prof.export_chrome_trace(trace if len(units) == 1
                                     else f"{base}_{unit}{ext}")
        out[unit] = res
        del state, call, last, prof
        torch.cuda.empty_cache()
    return out


def profile_caption(trace: str, units=CAPTION_UNITS, steps: int = STEPS,
                    **keys) -> dict:
    """`_profile_units` over `configs.make_caption_run`'s units (`keys` on
    top of the YAMLs'): 2 warm-up calls of a train step, 1 of the others;
    each with the loss (the reward too in SCST) or the first sequence
    (beam)."""
    from . import configs

    def summary(unit, out):
        if unit == "caption_beam":
            return {"seq0": out[0].tolist()}
        return {"loss": float(out["loss"]),
                **({"reward": out["reward"]} if "reward" in out else {})}

    return _profile_units(
        trace, units, lambda u: configs.make_caption_run(u, **keys),
        summary, lambda u: 2 if u in ("caption_train", "caption_pretrain")
        else 1, steps)


def profile_nlvr(trace: str, units=NLVR_UNITS, steps: int = STEPS,
                 **keys) -> dict:
    """`_profile_units` over NLVR's and grounding's units at the YAMLs'
    sizes (`keys` on top): "nlvr_train" (`configs.make_nlvr_run`'s step,
    24 pairs, 48 images), "grounding_train" and "gradcam"
    (`configs.make_grounding_run`'s: the step at 24 phrases, a GradCAM
    batch of 8 at fusion layer 8); 2 warm-up calls of a step, 1 of
    GradCAM; each with the loss, or the cam's largest value."""
    from . import configs

    def make(unit):
        if unit == "nlvr_train":
            return configs.make_nlvr_run(**keys)
        return configs.make_grounding_run(unit, **keys)

    def summary(unit, out):
        if unit == "gradcam":
            return {"cam_max": float(out.max())}
        return {"loss": float(out["loss"])}

    return _profile_units(trace, units, make, summary,
                          lambda u: 1 if u == "gradcam" else 2, steps)


CLASSIFY_UNITS = ("imagenet_train", "imagenet_lp", "glue_train")


def profile_classify(trace: str, units=CLASSIFY_UNITS, steps: int = STEPS,
                     **keys) -> dict:
    """`_profile_units` over the classification units at the YAMLs' sizes
    (`keys` on top): "imagenet_train" and "imagenet_lp"
    (`configs.make_imagenet_run`: B = 128 and 512 at 224 px) and
    "glue_train" (`configs.make_glue_run`: B = 32, T = 128); 2 warm-up
    calls each; each with its loss, its step's model FLOPs and their rate
    over the busy time as a share of the card's bf16 peak (`mfu_busy`)."""
    from . import configs

    def make(unit):
        if unit == "glue_train":
            return configs.make_glue_run(**keys)
        return configs.make_imagenet_run(unit, **keys)

    out = _profile_units(trace, units, make,
                         lambda u, m: {"loss": float(m["loss"])},
                         lambda u: 2, steps)
    for unit, res in out.items():
        if unit == "glue_train":
            c = configs.GLUE_MRPC
            flops = configs.glue_step_flops(c["per_device_train_batch_size"],
                                            c["max_length"])
        else:
            c = configs.IMAGENET_LP if unit == "imagenet_lp" \
                else configs.IMAGENET
            flops = configs.imagenet_step_flops(
                c["batch_size"], (c["image_res"] // c["patch_size"]) ** 2,
                lp=unit == "imagenet_lp")
        res.update(step_flops=flops, mfu_busy=flops / (
            res["device_busy_ms"] * 1e-3) / BF16_PEAK_FLOPS)
    return out


TOWER_UNITS = ("swin_retrieval_train", "deit_retrieval_train")


def profile_tower_retrieval(trace: str, units=TOWER_UNITS,
                            steps: int = STEPS, **keys) -> dict:
    """`_profile_units` over the retrieval fine-tune's step with the other
    towers, as `make_retrieval_train_run` takes it (B = 32, T = 40, 384 px,
    bf16, dropout and drop-path live; `keys` to the config):
    "swin_retrieval_train" (`configs.make_swin_retrieval_train_run`:
    Swin-B, window 12, and BERT-base) and "deit_retrieval_train"
    (`configs.make_deit_retrieval_train_run`: DeiT-B/16, K3 in its 12
    blocks); 2 warm-up steps each; each with its loss, its step's model
    FLOPs (`configs.tower_retrieval_step_flops`) and their rate over the
    busy time as a share of the card's bf16 peak (`mfu_busy`)."""
    from . import configs

    def make(unit):
        run = (configs.make_swin_retrieval_train_run
               if unit == "swin_retrieval_train"
               else configs.make_deit_retrieval_train_run)
        state, batch, step = run(**keys)
        return configs._stepper(state, step, batch, "cuda", 0)

    out = _profile_units(trace, units, make,
                         lambda u, m: {"loss": float(m["loss"])},
                         lambda u: 2, steps)
    for unit, res in out.items():
        cfg = (configs.xfm_swin_retrieval_config
               if unit == "swin_retrieval_train"
               else configs.xfm_deit_retrieval_config)(**keys)
        flops = configs.tower_retrieval_step_flops(cfg, 32, 40)
        res.update(step_flops=flops, mfu_busy=flops / (
            res["device_busy_ms"] * 1e-3) / BF16_PEAK_FLOPS)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default="pretrain",
                    choices=("pretrain", "pretrain_fused", "retrieval",
                             "retrieval_train", "clip_retrieval",
                             "retrieval_eval", "pretrain_streams",
                             "vqa_train", "vqa_rank") + CAPTION_UNITS
                    + NLVR_UNITS + CLASSIFY_UNITS + TOWER_UNITS
                    + tuple(STREAM_UNITS))
    ap.add_argument("--trace")
    args = ap.parse_args(argv)
    trace = args.trace or f"build/xfm_tpu_torch/profile_{args.path}.json"
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    if args.path == "retrieval_eval":
        return profile_retrieval_eval(trace)
    if args.path in ("vqa_train", "vqa_rank") + CAPTION_UNITS + NLVR_UNITS \
            + CLASSIFY_UNITS + TOWER_UNITS:
        profile = (profile_caption if args.path in CAPTION_UNITS
                   else profile_nlvr if args.path in NLVR_UNITS
                   else profile_classify if args.path in CLASSIFY_UNITS
                   else profile_tower_retrieval if args.path in TOWER_UNITS
                   else profile_vqa)
        res = profile(trace, units=(args.path,))[args.path]
        top = res.pop("top")
        print(f"max_memory_allocated={res.pop('max_memory_allocated')}")
        print(json.dumps(res))
        for name, ms, n in top:
            print(f"  {ms:9.3f} ms/call {n:6d} calls/call  {name}")
        print(torch.cuda.get_device_name(0))
        return 0
    if args.path in ("pretrain_streams",) + tuple(STREAM_UNITS):
        res = profile_pretrain_streams(trace,
                                       **STREAM_UNITS.get(args.path, {}))
        top = res.pop("top")
        print(f"max_memory_allocated={res.pop('max_memory_allocated')}")
        print(json.dumps(res))
        for name, ms, n in top:
            print(f"  {ms:9.3f} ms/step {n:6d} calls/step  {name}")
        print(torch.cuda.get_device_name(0))
        return 0
    from . import configs

    make_run = {"pretrain": functools.partial(configs.make_pretrain_run,
                                              fused_ln=False,
                                              fused_mlp=False),
                "pretrain_fused": functools.partial(
                    configs.make_pretrain_run, fused_ln=True, fused_mlp=True),
                "retrieval": configs.make_retrieval_run,
                "retrieval_train": configs.make_retrieval_train_run,
                "clip_retrieval": configs.make_clip_retrieval_run}[args.path]
    state, batch, step = make_run()
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    print(f"max_memory_allocated={torch.cuda.max_memory_allocated()}")

    def one_step():
        nonlocal state
        state, _ = step(state, batch, gen)

    prof, span, busy, host_ms, kernels = _window(one_step, STEPS)
    print(f"device_span_ms={span:.3f} device_busy_ms={busy:.3f} "
          f"idle_share={1 - busy / span:.4f} host_ms={host_ms:.3f}")
    print("groups_ms_per_step " + json.dumps(_groups(kernels)))
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
