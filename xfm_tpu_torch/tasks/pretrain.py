"""Multi-stream pretraining (`xfm_tpu/tasks/pretrain.py`, `run.py --task
pretrain_DIY`).

Each step draws one batch from every configured stream (image-text
`train_file`, `train_file_web`, `train_file_aux`, region
`train_file_regions`, ImageNet `train_file_imagenet`, text-only
`train_file_text`), runs each stream's losses under its flags
(`stream_flags`: the staged schedule of `stop_calc_{itm,mlm,itc,mim}`),
weights each stream by `w<stream>` and takes one HF-AdamW step
(`train_state.make_stream_step`: forward and backward one stream at a
time, the gradients summed, then the clip at `accelerator.CLIP_GRAD_NORM`
and the update). With `text_step_separate: true` the text stream first
takes its own update, so a step makes two and the schedule counts both,
as in the JAX package. `dispatch_steps` (the JAX package's K steps in one
scanned dispatch) is accepted and changes nothing: an eager step has no
dispatch to batch, and the trajectory is that of K = 1, which the scan
computes too (the flags follow each step; the JAX package holds a group's
flags from its first step). With `calc_image_bbox_loss: true` the
region stream's whole-image rows count in the bbox and GIoU losses too
(`is_image` dropped, as in the JAX package). Dropout and drop-path are live; stream i (in the order of the
names) draws its hard negatives from a generator seeded from (`--seed`,
step, i), equal on every rank, and its masks from one with the rank
folded in (`common.step_generator`), and each image stream augments with
its own TrainTransform seeded from (`--seed`, the stream's id, and the
rank where more than one process runs). The state is saved
every `ckpt_frequent_step` steps and at the end (<out>/ckpt/<step>), and
with `resume: true` the newest save is restored and the run goes on from
its step (the streams start anew, as in the JAX package).

Under `torchrun` each of the W processes reads its own part of every
stream's shards (`ShardedLineReader`'s split by rank; its masking
generators seeded from seed + rank), so that a step takes W × each
block's `batch_size` rows (`--bs` is divided over the processes); an
epoch is `train_dataset_size` over that global batch, as the JAX package
counts it; the losses are the global batch's (`core/mesh`) and the
gradients are averaged once a step. The log and the checkpoints are
rank 0's, the logged averages summed over the ranks.

The optional branches: `use_vision_tokenizer` builds the frozen VQ-KD
tokenizer (`frozen_tokenizer`: `tokenizer_model`, `codebook_size`,
`codebook_dim`, the weights of `tokenizer_weight` where given, else a
fixed-seed initialization) whose code ids of the unmasked images are MIM's
cross-entropy targets in every stream with MIM on; `local_attn_depth` > 0
runs the region stream's last blocks as region attention; `bf16_params`
keeps the parameters bf16 with f32 masters in the optimizer
(`common.place_state`, after `--checkpoint` and before the resume);
`parallel: {fsdp: F}` shards the model over F ranks of each replica
(`core/partitioning`);
`bench_redispatch: N` steps N more times on the last batches after the run
and reports their rate (`redispatch_samples_per_sec`, a `### redispatch`
line).

The input path: an image stream whose block sets `num_workers` decodes
through the C++ loader and hands uint8 images to the card, which
normalizes them (`data/pretrain_data`); with the block's `device_randaug`
the loader leaves them un-augmented and each step runs RandAugment(2, 7)
on them on the card before the loss (and before the frozen tokenizer's
code ids), stream i drawing from the rank generator of (`--seed`, step,
`RANDAUG_KEY` + i) (`device_randaugment`).
"""
from __future__ import annotations

import json
import time

import torch

from ..data.device_aug import randaugment_batch
from ..data.prefetch import StreamBatches
from ..data.pretrain_data import (ImageStream, ImageTextStream,
                                  RegionTextStream, TextStream)
from ..data.transforms import TrainTransform
from ..models import XFMForPretrain, config_from_yaml
from ..models.task_models import LOSS_KEYS
from ..core import mesh
from ..train.metrics import MetricLogger, is_main_process
from ..train.train_state import make_stream_step
from .common import (TaskContext, append_log, build_state,
                     global_batches, reference_loader,
                     opt_steps_per_epoch,
                     restore_latest, save_task_checkpoint, step_generator)
from .retrieval import _maybe_shrink_vocab, build_tokenizer_or_fallback

# a fixed id per stream name: the seed of its TrainTransform
STREAM_IDS = {"image": 1, "web": 2, "aux": 3, "text": 4, "imagenet": 5,
              "region": 6}
# the seed of the frozen tokenizer's initialization where no
# `tokenizer_weight` is given (the JAX package's PRNGKey(7))
TOKENIZER_SEED = 7
# stream i's device RandAugment draws from (seed, step, RANDAUG_KEY + i)
# (the JAX step folds 1000 + i into its key)
RANDAUG_KEY = 1000


def _transform(cfg: dict, seed: int, name: str) -> TrainTransform:
    return TrainTransform(cfg.get("image_res", 224), scale=(0.2, 1.0),
                          seed=mesh.rank_seed([seed, STREAM_IDS[name]]))


def build_streams(cfg: dict, tokenizer, seed: int = 42, rank: int = 0,
                  world_size: int = 1) -> dict:
    """The streams the config names ({name: stream}) as process `rank` of
    `world_size` reads them; the image streams each with their own
    TrainTransform seeded from (`seed`, stream id, and this process's rank
    under a process group of more than one)."""
    streams = {}
    if cfg.get("train_file"):
        streams["image"] = ImageTextStream(
            cfg["train_file"], cfg, tokenizer, _transform(cfg, seed, "image"),
            rank, world_size)
    if cfg.get("train_file_web"):
        streams["web"] = ImageTextStream(
            cfg["train_file_web"], cfg, tokenizer,
            _transform(cfg, seed, "web"), rank, world_size,
            config_key="images_web" if cfg.get("images_web") else "images")
    if cfg.get("train_file_aux"):
        streams["aux"] = ImageTextStream(
            cfg["train_file_aux"], cfg, tokenizer,
            _transform(cfg, seed, "aux"), rank, world_size, is_aux=True)
    if cfg.get("train_file_text"):
        streams["text"] = TextStream(cfg["train_file_text"], cfg, tokenizer,
                                     rank, world_size)
    if cfg.get("train_file_imagenet"):
        streams["imagenet"] = ImageStream(
            cfg["train_file_imagenet"], cfg,
            _transform(cfg, seed, "imagenet"), rank, world_size)
    if cfg.get("train_file_regions"):
        streams["region"] = RegionTextStream(cfg["train_file_regions"], cfg,
                                             tokenizer, rank, world_size)
    return streams


def stream_flags(name: str, step: int, cfg: dict) -> dict:
    """A stream's loss flags at `step`: each loss off from its
    `stop_calc_<loss>` step on; MIM on the image-text streams only with
    `use_mm_mim_loss`; the aux stream MLM only; the region stream with the
    bbox losses (`ret_bbox_loss`, `ret_bbox_giou`) and no MIM; ImageNet MIM
    only; the text stream none (its MLM is unconditional)."""
    stop = {k: cfg.get(f"stop_calc_{k}") for k in ("itm", "mlm", "itc",
                                                     "mim", "mm")}

    def on(key):
        return not (stop[key] is not None and step >= stop[key])

    if name == "text":
        return {}
    if name == "imagenet":
        return dict(ret_itc=False, ret_match=False, ret_mlm=False,
                    ret_mim=on("mim"), data_source="imagenet")
    flags = dict(ret_itc=on("itc"), ret_match=on("itm"), ret_mlm=on("mlm"),
                 ret_mim=on("mim") and cfg.get("use_mm_mim_loss", True),
                 data_source=name)
    if name == "aux":
        flags.update(ret_itc=False, ret_match=False, ret_mim=False)
    if name == "region":
        flags.update(ret_mim=False,
                     ret_bbox=cfg.get("ret_bbox_loss", True),
                     ret_bbox_giou=cfg.get("ret_bbox_giou", True))
    return flags


def stream_loss_fn(flags: dict, weights: dict,
                   calc_image_bbox_loss: bool = False, code_ids_fn=None):
    """The loss of `train_state.make_stream_step` for streams under
    `flags` ({name: stream_flags}) and `weights`: `w<stream>` × the sum of
    the stream's losses, dropout and drop-path live → (loss, {<stream>_<loss
    key>: value}). With `calc_image_bbox_loss` the region stream's
    whole-image rows count in its bbox losses (`is_image` dropped). With
    `code_ids_fn` (the frozen tokenizer's) a stream with MIM on and images
    takes the code ids of its images as `vqkd_code_ids`."""
    def loss_fn(model, name, batch, generator):
        if name == "region" and calc_image_bbox_loss:
            batch = dict(batch, is_image=None)
        if (code_ids_fn is not None and flags[name].get("ret_mim")
                and batch.get("images") is not None):
            batch = dict(batch, vqkd_code_ids=code_ids_fn(batch["images"]))
        out = model.loss(**batch, **flags[name], generator=generator,
                         deterministic=False)
        loss = weights[name] * sum(out[k] for k in LOSS_KEYS)
        return loss, {f"{name}_{k}": out[k] for k in LOSS_KEYS}

    return loss_fn


def device_randaugment(batches: dict, generators: dict) -> dict:
    """RandAugment(2, 7) on the device (`device_aug.randaugment_batch`)
    of the uint8 images of each stream in `generators` ({name: its
    generator}) → the batches with those images replaced."""
    out = dict(batches)
    for name, gen in generators.items():
        batch = batches.get(name)
        if (batch is not None and batch.get("images") is not None
                and batch["images"].dtype == torch.uint8):
            out[name] = dict(batch, images=randaugment_batch(batch["images"],
                                                             gen))
    return out


def frozen_tokenizer(cfg: dict, device="cuda"):
    """The YAML's VQ-KD tokenizer (`vqkd_config_from_yaml`), initialized
    on `device` from `TOKENIZER_SEED`, then overlaid with the weights of
    `tokenizer_weight` where the YAML names a file (the encoder, the
    projection and the codebook: `import_vqkd_checkpoint`), frozen, in eval
    mode, on `device` → (tokenizer, code_ids_fn), code_ids_fn(images) its
    code ids under `no_grad`."""
    from ..models.vqkd import VQKD, vqkd_config_from_yaml
    from ..train.checkpoint import (init_weights, load_torch_state_dict,
                                    load_vqkd_checkpoint)

    with torch.device(device):  # built there: no host init, no copy
        vq = VQKD(vqkd_config_from_yaml(cfg)).to(device)
    init_weights(vq, TOKENIZER_SEED)
    if cfg.get("tokenizer_weight"):
        load_vqkd_checkpoint(vq, load_torch_state_dict(
            cfg["tokenizer_weight"]))
    vq = vq.eval().requires_grad_(False)

    @torch.no_grad()
    def code_ids_fn(images):
        return vq.get_codebook_indices(images)

    return vq, code_ids_fn


def corpus_texts(cfg: dict, max_lines: int = 20000) -> list:
    """Captions and texts of the first `max_lines` lines of each stream's
    shards (the words of a fallback tokenizer)."""
    from ..data.jsonl import ShardedLineReader

    keys = {"train_file": ((cfg.get("images") or {}).get("caption_key",
                                                         "desc"),),
            "train_file_text": ((cfg.get("texts") or {}).get("text_key",
                                                             "desc"),),
            "train_file_regions": ("caption", "attributes")}
    texts = []

    def add(v):
        if isinstance(v, str):
            texts.append(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                add(x)
        elif isinstance(v, dict):
            for x in v.values():
                add(x)

    for file_key, fields in keys.items():
        if not cfg.get(file_key):
            continue
        reader = ShardedLineReader(cfg[file_key], shuffle=False,
                                   repeat=False)
        for n, ann in enumerate(reader.iter_json()):
            if n >= max_lines:
                break
            for ann_or_elem in [ann] + list(ann.get("elems", [])):
                for f in fields:
                    add(ann_or_elem.get(f))
    return texts


def main(args, tokenizer=None, overrides=None) -> dict:
    """The YAML with `overrides` set on top. Random weights from `--seed` (overlaid by `--checkpoint`, a
    reference state dict, where given), `resume`, then steps up to
    `max_steps` (default `epochs` × `train_dataset_size` / the image
    batch). Prints every `print_freq` steps, appends the running averages
    (summed over the ranks) and each step's loss since the last line
    (`losses`) to <output_dir>/log.txt at each checkpoint → those averages
    (`<stream>_<loss>`, `loss`, `grad_norm`) with `samples_per_sec` (image
    stream samples over the wall time after two warm-up turns),
    `device_samples_per_sec` (the same with the wait for input taken
    out) and, under `bench_redispatch`, `redispatch_samples_per_sec`.
    `tokenizer` (a pipeline's) replaces the config's."""
    ctx = TaskContext.from_args(args, overrides)
    cfg = ctx.config
    if tokenizer is None:
        tokenizer = build_tokenizer_or_fallback(cfg,
                                                lambda: corpus_texts(cfg))
    mcfg = _maybe_shrink_vocab(config_from_yaml(
        cfg, use_contrastive_loss=True, use_matching_loss=True,
        use_mlm_loss=True, use_bbox_loss=True), tokenizer)
    with torch.device(ctx.device):  # built there: no host init, no copy
        model = XFMForPretrain(mcfg).to(ctx.device)
    code_ids_fn = None
    if cfg.get("use_vision_tokenizer", False):
        _, code_ids_fn = frozen_tokenizer(cfg, ctx.device)
    streams = build_streams(cfg, tokenizer, ctx.seed, mesh.dp_rank(),
                            mesh.dp_size())
    if not streams:
        raise ValueError("no pretraining streams configured")
    order = sorted(streams)
    randaug = [i for i, n in enumerate(order)
               if getattr(streams[n], "device_randaug_active", False)]
    weights = {s: cfg.get(f"w{s}", 1.0) for s in streams}
    bs_main = (cfg.get("images") or {}).get("batch_size", 32)
    steps_per_epoch = global_batches(cfg.get("train_dataset_size", 10000),
                                     bs_main)
    state, sched = build_state(
        ctx, model, opt_steps_per_epoch(cfg, steps_per_epoch),
        load=reference_loader(args.checkpoint))
    state, step = restore_latest(ctx, state)
    if step is None:
        step = state.step
    elif is_main_process():
        print(f"### resumed at step {step}", flush=True)

    text_separate = (bool(cfg.get("text_step_separate", False))
                     and "text" in streams)
    calc_image_bbox = bool(cfg.get("calc_image_bbox_loss", False))
    epochs = int(cfg.get("schedular", {}).get("epochs", 1))
    max_steps = int(cfg.get("max_steps", epochs * steps_per_epoch))
    ckpt_step = cfg.get("ckpt_frequent_step", 50000)
    print_freq = cfg.get("print_freq", 50)

    logger = MetricLogger()
    step_losses = []  # each step's (global) loss since the last log line
    batches_iter = StreamBatches({n: streams[n] for n in order}, ctx.device)
    source = iter(batches_iter)
    perf = {"samples": 0, "secs": 0.0, "input_secs": 0.0, "steps": 0}
    t0 = time.time()
    try:
        while step < max_steps:
            t_step = time.perf_counter()
            batches = next(source)
            t_input = time.perf_counter() - t_step
            if randaug:
                batches = device_randaugment(batches, {
                    order[i]: step_generator(ctx, step, RANDAUG_KEY + i).rank
                    for i in randaug})
            flags = {n: stream_flags(n, step, cfg) for n in order}
            gens = {n: step_generator(ctx, step, i)
                    for i, n in enumerate(order)}
            step_fn = make_stream_step(stream_loss_fn(
                flags, weights, calc_image_bbox, code_ids_fn))
            metrics = {}
            if text_separate:
                state, tm = step_fn(state, {"text": batches.pop("text")},
                                    gens)
                metrics.update({k: v for k, v in tm.items()
                                if k.startswith("text_")})
            state, sm = step_fn(state, batches, gens)
            metrics.update(sm)
            names = [k for k, v in metrics.items() if v.dim() == 0]
            vals = torch.stack([metrics[k].float() for k in names]).tolist()
            logger.update(**dict(zip(names, vals)))
            step_losses.append(vals[names.index("loss")])
            perf["steps"] += 1
            if perf["steps"] > 2:  # the first steps build and warm up
                perf["secs"] += time.perf_counter() - t_step
                perf["input_secs"] += t_input
                perf["samples"] += bs_main
            step += 1
            if (step % print_freq == 0 or perf["steps"] == 1) \
                    and is_main_process():
                print(f"step {step}/{max_steps} "
                      f"lr={sched(state.step):.2e} {logger}", flush=True)
            if step % ckpt_step == 0 or step >= max_steps:
                save_task_checkpoint(ctx, state, step, keep=3)
                append_log(ctx.out_dir, {"step": step,
                                         **logger.synced_global_avg(),
                                         "losses": step_losses,
                                         "elapsed": time.time() - t0})
                step_losses = []
        redispatch = int(cfg.get("bench_redispatch", 0))
        rate_redispatch = None
        if redispatch and perf["steps"] > 2:
            # N more steps on the last batches, already on the device: the
            # step's rate with no input wait and no new copies
            t_r = time.perf_counter()
            for k in range(redispatch):
                gens = {n: step_generator(ctx, step + k, i)
                        for i, n in enumerate(order)}
                state, sm = step_fn(state, batches, gens)
                torch.stack([v.float() for v in sm.values()
                             if v.dim() == 0]).tolist()
            rate_redispatch = bs_main * redispatch / (time.perf_counter()
                                                      - t_r)
            if is_main_process():
                print(f"### redispatch {rate_redispatch:.1f} "
                      "samples/s/process (device-resident input)",
                      flush=True)
    finally:
        batches_iter.close()
    stats = logger.synced_global_avg()
    if rate_redispatch is not None:
        stats["redispatch_samples_per_sec"] = rate_redispatch
    if perf["secs"] > 0:
        stats["samples_per_sec"] = perf["samples"] / perf["secs"]
        dev_secs = perf["secs"] - perf["input_secs"]
        if dev_secs > 0:
            stats["device_samples_per_sec"] = perf["samples"] / dev_secs
        if is_main_process():
            print("### throughput " + json.dumps(
                {k: stats[k] for k in ("samples_per_sec",
                                       "device_samples_per_sec")
                 if k in stats}), flush=True)
    return stats

