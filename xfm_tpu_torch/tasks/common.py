"""What a task's main() shares (`xfm_tpu/tasks/common.py`): the config
(`--bs` as the global batch), the output directory, the seed and the
device; the train state built from the YAML, the step (with gradient
accumulation), one epoch of it over prefetched device batches, the
checkpoints (by epoch or by step) and their resume, the step
generators, the epoch loop of a fine-tune with its evals and
checkpoints, the load of a reference checkpoint, and the log."""
from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Optional

import numpy as np
import torch

from ..core.config import dump_config, load_config, resolve_vision_config
from ..train.metrics import MetricLogger, is_main_process
from ..train.optim import create_optimizer_from_config
from ..train.schedules import schedule_from_config
from ..train.train_state import (TrainState, make_accum_train_step,
                                 make_train_step)

_CONFIG_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "configs", "model")


@dataclasses.dataclass
class TaskContext:
    config: dict
    out_dir: str
    seed: int = 42
    device: str = "cuda"

    @classmethod
    def from_args(cls, args, overrides: Optional[dict] = None
                  ) -> "TaskContext":
        """The task YAML with `overrides`, its vision sub-config read (a
        missing relative path looked up under the repository's
        configs/model), `--bs` (`scale_batch`) and `--epoch` applied, and
        the result dumped to <output_dir>/config.yaml."""
        cfg = load_config(args.config, overrides)
        cfg = resolve_vision_config(cfg, config_root=_CONFIG_ROOT)
        if getattr(args, "bs", None):
            scale_batch(cfg, args.bs)
        if getattr(args, "epoch", None):
            cfg.setdefault("schedular", {})["epochs"] = args.epoch
        out = getattr(args, "output_dir", "output")
        os.makedirs(out, exist_ok=True)
        if is_main_process():
            dump_config(cfg, os.path.join(out, "config.yaml"))
        return cls(config=cfg, out_dir=out, seed=getattr(args, "seed", 42),
                   device=getattr(args, "device", "cuda"))


def world_size() -> int:
    """The process group's size where one is initialized, else 1."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    return dist.get_world_size() if live else 1


def scale_batch(cfg: dict, global_bs: int,
                n_processes: Optional[int] = None) -> None:
    """`--bs` as the global batch (`xfm_tpu/tasks/common.py` `_scale_batch`):
    divided over the processes (one card each; the world size by default)
    into `batch_size_train` and the `batch_size` of the stream blocks
    `images`, `texts`, `regions` and `images_imagenet`, where the YAML has
    them; and where it has no `batch_size_train`, into a top-level
    `batch_size` (NLVR.yaml's, Grounding_bbox.yaml's, imagenet1k.yaml's)
    or GLUE's `per_device_train_batch_size`, which the JAX package leaves
    as they are, so that `--bs` changes nothing there."""
    n = n_processes or world_size()
    for key in ("images", "texts", "regions", "images_imagenet"):
        if isinstance(cfg.get(key), dict) and "batch_size" in cfg[key]:
            cfg[key]["batch_size"] = max(1, global_bs // n)
    for key in ("batch_size_train", "batch_size",
                "per_device_train_batch_size"):
        if key in cfg:
            cfg[key] = max(1, global_bs // n)
            break


def accum_steps_from_config(cfg: dict) -> int:
    """`accumulate_steps` (or `gradient_accumulation_steps`), at least 1."""
    return max(1, int(cfg.get("accumulate_steps",
                              cfg.get("gradient_accumulation_steps", 1))))


def opt_steps_per_epoch(cfg: dict, micro_steps_per_epoch: int) -> int:
    """Optimizer steps an epoch: one per group of K micro-batches, rounded
    up. The schedule counts optimizer steps, so its horizon is this."""
    k = accum_steps_from_config(cfg)
    return max(1, -(-micro_steps_per_epoch // k))


def build_state(ctx: TaskContext, model: torch.nn.Module,
                steps_per_epoch: int):
    """The model's random weights from `ctx.seed`, HF-AdamW and the
    schedule from the YAML's `optimizer`, `accelerator` and `schedular`
    blocks → (TrainState, schedule). `steps_per_epoch` is in
    micro-batches; the schedule's horizon in optimizer steps."""
    from ..train.checkpoint import init_weights

    init_weights(model, ctx.seed)
    sched = schedule_from_config(
        ctx.config, opt_steps_per_epoch(ctx.config, steps_per_epoch))
    opt = create_optimizer_from_config(model, ctx.config, sched)
    return TrainState.create(model, opt), sched


def maybe_bf16_params(ctx: TaskContext, state: TrainState, sched
                      ) -> TrainState:
    """`bf16_params: true` in the YAML: the optimizer rebuilt from the YAML
    over f32 master copies of the trained parameters
    (`optim.with_master_weights`), then every f32 parameter of the model
    made bf16 in place. Call it after any checkpoint import (the f32
    originals seed the masters) and before the resume (whose state has
    this form), as the JAX package orders it."""
    if not ctx.config.get("bf16_params", False):
        return state
    from ..train.optim import trained_parameters, with_master_weights

    model = state.model
    opt = with_master_weights(
        trained_parameters(model),
        lambda masters: create_optimizer_from_config(
            model, ctx.config, sched, named_params=masters))
    with torch.no_grad():
        for p in model.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(torch.bfloat16)
    return TrainState(model=model, optimizer=opt, step=state.step)


def save_task_checkpoint(ctx: TaskContext, state: TrainState, index: int,
                         name: str = "ckpt", keep: int = 2) -> None:
    """The state under <out>/<name>/<index> (an epoch of the fine-tune, a
    step of the pretrain task), the newest `keep` kept."""
    from ..train.checkpoint import save_checkpoint

    if is_main_process():
        save_checkpoint(os.path.join(ctx.out_dir, name), state, step=index,
                        keep=keep)


def restore_latest(ctx: TaskContext, state: TrainState):
    """With `resume: true` in the YAML and a save under <out>/ckpt: the
    newest restored in place → (state, its index); else (state, None)."""
    from ..train.checkpoint import latest_step, restore_checkpoint

    ckpt_dir = os.path.join(ctx.out_dir, "ckpt")
    last = latest_step(ckpt_dir)
    if not ctx.config.get("resume", False) or last is None:
        return state, None
    return restore_checkpoint(ckpt_dir, state, step=last), last


def maybe_resume_epochs(ctx: TaskContext, state: TrainState):
    """`restore_latest` for the fine-tune → (state, the epoch to run
    next: 0 where nothing was restored)."""
    state, last = restore_latest(ctx, state)
    if last is None:
        return state, 0
    if is_main_process():
        print(f"### resumed fine-tune from epoch {last}, continuing at "
              f"{last + 1}", flush=True)
    return state, last + 1


def step_generator(ctx: TaskContext, *key: int) -> torch.Generator:
    """A generator of dropout masks and hard negatives on the task's
    device, seeded from (seed, *key): the fine-tune's from (seed, epoch),
    a pretrain stream's from (seed, step, stream index), so that a resumed
    run draws what the run it replaces drew."""
    seed = int(np.random.SeedSequence([ctx.seed, *key]).generate_state(
        1, np.uint64)[0])
    return torch.Generator(device=ctx.device).manual_seed(seed)


def make_task_step(ctx: TaskContext, loss_fn):
    """→ (step_fn, accum_steps): with accumulation K > 1 the step takes a
    list of K micro-batches and makes one optimizer update."""
    k = accum_steps_from_config(ctx.config)
    if k == 1:
        return make_train_step(loss_fn), 1
    return make_accum_train_step(loss_fn, k), k


def _group_batches(loader, k: int):
    """Lists of k consecutive batches (a last partial group dropped)."""
    buf = []
    for b in loader:
        buf.append(b)
        if len(buf) == k:
            yield buf
            buf = []


def train_epoch(ctx: TaskContext, state: TrainState, step_fn, loader,
                generator: torch.Generator, epoch: int, sched=None,
                accum_steps: int = 1):
    """One epoch of `step_fn(state, batch, generator)` over `loader`'s host
    batches, prefetched and copied to `ctx.device` one batch ahead. Every
    step's scalar metrics are read back in one transfer (with the
    schedule's lr at the new step count), and printed every 50 steps →
    (state, their averages)."""
    from ..data.prefetch import DeviceBatches

    logger = MetricLogger()
    batches = DeviceBatches(loader, ctx.device)
    it = batches if accum_steps == 1 else _group_batches(batches,
                                                         accum_steps)
    try:
        for batch in logger.log_every(it, 50,
                                      header=f"Train epoch {epoch}:"):
            state, metrics = step_fn(state, batch, generator)
            names = [k for k, v in metrics.items() if v.dim() == 0]
            vals = torch.stack([metrics[k].float() for k in names]).tolist()
            host = dict(zip(names, vals))
            if sched is not None:
                host["lr"] = float(sched(state.step))
            logger.update(**host)
    finally:
        batches.close()
    logger.synchronize_between_processes()
    return state, logger.global_avg()


def append_log(out_dir: str, payload: dict) -> None:
    """One JSON line into <out_dir>/log.txt."""
    if is_main_process():
        with open(os.path.join(out_dir, "log.txt"), "a") as f:
            f.write(json.dumps(payload) + "\n")


def device_inputs(batch: dict, dev) -> tuple:
    """A host batch's images, text ids and text mask on `dev`, the ids and
    the mask as int64."""
    return (torch.from_numpy(batch["images"]).to(dev),
            torch.from_numpy(batch["text_ids"]).long().to(dev),
            torch.from_numpy(batch["text_atts"]).long().to(dev))


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> None:
    """A reference state dict (`--checkpoint`) overlaid on `model` by name
    (`load_xfm_checkpoint`), the count of parameters it lacked printed."""
    from ..train.checkpoint import load_torch_state_dict, load_xfm_checkpoint

    missing, _ = load_xfm_checkpoint(model, load_torch_state_dict(path))
    if is_main_process():
        print(f"### loaded {path}: {len(missing)} missing", flush=True)


def log_eval(ctx: TaskContext, metrics: dict) -> dict:
    """`--evaluate`'s metrics printed and logged → them."""
    if is_main_process():
        print(metrics, flush=True)
    append_log(ctx.out_dir, {"eval": metrics})
    return metrics


def finetune(ctx: TaskContext, state: TrainState, sched, train_data,
             loss_fn, evaluate_epoch, best_key: str) -> float:
    """The fine-tune's epochs, after the newest ckpt/ epoch with `resume:
    true`: each trains `loss_fn` (dropout live) over `train_data.epoch`
    (seeded from seed + epoch) with the step generator of (seed, epoch)
    and `accumulate_steps`, then logs and prints `evaluate_epoch()`'s
    metrics, saves ckpt/<epoch> (the two newest kept), and where the
    metric `best_key` improved places that file in ckpt_best/ too, by a
    hard link → its best value."""
    from ..train.checkpoint import link_checkpoint

    step_fn, accum = make_task_step(ctx, functools.partial(
        loss_fn, deterministic=False))
    state, start_epoch = maybe_resume_epochs(ctx, state)
    best = 0.0
    for epoch in range(start_epoch,
                       int(ctx.config.get("schedular", {}).get("epochs", 10))):
        loader = train_data.epoch(epoch_seed=ctx.seed + epoch)
        state, stats = train_epoch(ctx, state, step_fn, loader,
                                   step_generator(ctx, epoch), epoch, sched,
                                   accum_steps=accum)
        metrics = evaluate_epoch()
        append_log(ctx.out_dir, {"epoch": epoch, **stats, **metrics})
        if is_main_process():
            print(f"epoch {epoch}: {metrics}", flush=True)
        save_task_checkpoint(ctx, state, epoch)
        if metrics[best_key] > best:
            best = metrics[best_key]
            if is_main_process():
                link_checkpoint(os.path.join(ctx.out_dir, "ckpt"),
                                os.path.join(ctx.out_dir, "ckpt_best"),
                                epoch, keep=1)
    return best
