"""What a task's main() shares (`xfm_tpu/tasks/common.py`): the config,
the output directory, the seed and the device; the train state built from
the YAML, the step (with gradient accumulation), one epoch of it over
prefetched device batches, the per-epoch checkpoints and their resume, and
the epoch log."""
from __future__ import annotations

import dataclasses
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
        configs/model), `--bs` (the global train batch: one device a
        process, so the batch itself) and `--epoch` applied, and the result
        dumped to <output_dir>/config.yaml."""
        cfg = load_config(args.config, overrides)
        cfg = resolve_vision_config(cfg, config_root=_CONFIG_ROOT)
        if getattr(args, "bs", None) and "batch_size_train" in cfg:
            cfg["batch_size_train"] = args.bs
        if getattr(args, "epoch", None):
            cfg.setdefault("schedular", {})["epochs"] = args.epoch
        out = getattr(args, "output_dir", "output")
        os.makedirs(out, exist_ok=True)
        if is_main_process():
            dump_config(cfg, os.path.join(out, "config.yaml"))
        return cls(config=cfg, out_dir=out, seed=getattr(args, "seed", 42),
                   device=getattr(args, "device", "cuda"))


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


def save_epoch_checkpoint(ctx: TaskContext, state: TrainState, epoch: int,
                          name: str = "ckpt", keep: int = 2) -> None:
    """The state under <out>/<name>/<epoch>, the newest `keep` kept."""
    from ..train.checkpoint import save_checkpoint

    if is_main_process():
        save_checkpoint(os.path.join(ctx.out_dir, name), state, step=epoch,
                        keep=keep)


def maybe_resume_epochs(ctx: TaskContext, state: TrainState):
    """With `resume: true` in the YAML and an epoch saved under <out>/ckpt:
    that state restored in place → (state, the next epoch); else (state,
    0)."""
    from ..train.checkpoint import latest_step, restore_checkpoint

    if not ctx.config.get("resume", False):
        return state, 0
    ckpt_dir = os.path.join(ctx.out_dir, "ckpt")
    last = latest_step(ckpt_dir)
    if last is None:
        return state, 0
    state = restore_checkpoint(ckpt_dir, state, step=last)
    if is_main_process():
        print(f"### resumed fine-tune from epoch {last}, continuing at "
              f"{last + 1}", flush=True)
    return state, last + 1


def step_generator(ctx: TaskContext, epoch: int) -> torch.Generator:
    """The generator of an epoch's steps (dropout masks and hard
    negatives), on the task's device, seeded from (seed, epoch): a resumed
    epoch draws what the epoch it replaces drew."""
    seed = int(np.random.SeedSequence([ctx.seed, epoch]).generate_state(
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
