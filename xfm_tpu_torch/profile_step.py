"""Where the time of one XFM-base train step, or of the retrieval eval, goes
on the card.

    python3 -m xfm_tpu_torch.profile_step
        [pretrain|pretrain_fused|retrieval|retrieval_train|clip_retrieval|
         retrieval_eval] [--trace PATH]

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
256 images and 1,280 captions (the units × their counts there). Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import torch

STEPS = 3
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default="pretrain",
                    choices=("pretrain", "pretrain_fused", "retrieval",
                             "retrieval_train", "clip_retrieval",
                             "retrieval_eval"))
    ap.add_argument("--trace")
    args = ap.parse_args(argv)
    trace = args.trace or f"build/xfm_tpu_torch/profile_{args.path}.json"
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    if args.path == "retrieval_eval":
        return profile_retrieval_eval(trace)
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
