"""What a task's main() shares (`xfm_tpu/tasks/common.py`): the config
(`--bs` as the global batch, the `parallel` block checked against the
process group), the output directory, the seed and the device; the train
state built from the YAML (the same on every rank; cut over `tensor` and
sharded over `fsdp` where the `parallel` block asks, `place_state`), the
step (with gradient accumulation), one epoch of it over prefetched device
batches, the checkpoints (by epoch or by step, written by rank 0) and
their resume, the step generators, the epoch loop of a fine-tune with its
evals and checkpoints, the load of a reference checkpoint, and the log."""
from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Optional

import torch

from ..core import mesh, partitioning
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
        configs/model), its `parallel` block checked against the process
        group (`mesh_from_config`), `--bs` (`scale_batch`) and `--epoch`
        applied, and the result dumped to <output_dir>/config.yaml. The
        process is placed on the mesh (`mesh.use_mesh`: the tensor and
        data × fsdp groups where `tensor` > 1)."""
        cfg = load_config(args.config, overrides)
        cfg = resolve_vision_config(cfg, config_root=_CONFIG_ROOT)
        mesh.use_mesh(mesh.mesh_from_config(cfg))
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


def scale_batch(cfg: dict, global_bs: int,
                n_processes: Optional[int] = None) -> None:
    """`--bs` as the global batch (`xfm_tpu/tasks/common.py` `_scale_batch`):
    divided over the processes that split the batch (one card each;
    `mesh.dp_size`, data × fsdp, by default: a tensor group shares rows)
    into `batch_size_train` and the `batch_size` of the stream blocks
    `images`, `texts`, `regions` and `images_imagenet`, where the YAML has
    them; and where it has no `batch_size_train`, into a top-level
    `batch_size` (NLVR.yaml's, Grounding_bbox.yaml's, imagenet1k.yaml's)
    or GLUE's `per_device_train_batch_size`, which the JAX package leaves
    as they are, so that `--bs` changes nothing there."""
    n = n_processes or mesh.dp_size()
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


def global_batches(n_rows: int, batch_size: int) -> int:
    """The micro-steps of an epoch over `n_rows` rows at the rank's
    `batch_size` on the W = data × fsdp ranks that split the batch: n_rows
    // (W · batch_size) global batches, at least 1, as
    `core/mesh.rank_rows` deals them."""
    return max(1, n_rows // max(1, mesh.dp_size() * batch_size))


def epoch_opt_steps(cfg: dict, n_rows: int, batch_size: int) -> int:
    """The optimizer steps of an epoch: `global_batches`, then
    `opt_steps_per_epoch`. A schedule's horizon is epochs × this, the same
    on W processes at `--bs B` as on one."""
    return opt_steps_per_epoch(cfg, global_batches(n_rows, batch_size))


def build_state(ctx: TaskContext, model: torch.nn.Module,
                epoch_steps: int, load=None, make_optimizer=None):
    """The model's random weights from `ctx.seed` (rank 0's broadcast to
    the other ranks), `load(model)` where given (a reference import), the
    schedule from the YAML's `schedular` block, then `place_state` →
    (TrainState, schedule). `epoch_steps` is the optimizer steps of an
    epoch (`epoch_opt_steps`)."""
    from ..train.checkpoint import init_weights

    init_weights(model, ctx.seed)
    mesh.broadcast_parameters(model)
    sched = schedule_from_config(ctx.config, epoch_steps)
    if load is not None:
        load(model)
    return place_state(ctx, model, sched, make_optimizer), sched


def place_state(ctx: TaskContext, model: torch.nn.Module, sched,
                make_optimizer=None) -> TrainState:
    """The train state of `model`, whose weights are final on every rank:
    under `parallel.tensor` > 1 the model cut first (`cut_model`), under
    `parallel.fsdp` > 1 then sharded (`shard_model`, with
    the bf16 policy under `bf16_params`); then the optimizer over its
    parameters (the shards), and under `bf16_params` over their f32
    masters (`optim.with_master_weights`: a shard is its own master) with
    every parameter left whole made bf16. `make_optimizer(model,
    named_params)` builds the optimizer (HF-AdamW from the YAML's
    `optimizer` and `accelerator` blocks by default). Call it after any
    reference import and before the resume, whose state has the form it
    gives, as the JAX package orders it."""
    from ..train.optim import trained_parameters

    cfg = ctx.config
    if make_optimizer is None:
        def make_optimizer(m, named):
            return create_optimizer_from_config(m, cfg, sched,
                                                named_params=named)
    bf16 = bool(cfg.get("bf16_params", False))
    _partition(ctx, model, bf16)
    if bf16:
        return _bf16_state(model, make_optimizer)
    return TrainState.create(model, make_optimizer(
        model, trained_parameters(model)))


def eval_model(ctx: TaskContext, model: torch.nn.Module, load=None
               ) -> torch.nn.Module:
    """An `--evaluate` run's model: the random weights from `ctx.seed`,
    `load(model)` where given, then cut and sharded as `place_state` cuts
    and shards it (in the dtype a one-process eval computes in) →
    `model`."""
    from ..train.checkpoint import init_weights

    init_weights(model, ctx.seed)
    if load is not None:
        load(model)
    _partition(ctx, model)
    return model


def _partition(ctx: TaskContext, model: torch.nn.Module,
               bf16: bool = False) -> None:
    """The model cut over the tensor group where `parallel.tensor` > 1
    (`cut_model`), then sharded over `fsdp` where `parallel.fsdp` > 1
    (`shard_model`, under the bf16 policy with `bf16`)."""
    shape = mesh.use_mesh(mesh.mesh_from_config(ctx.config))
    if shape.tensor > 1:
        partitioning.cut_model(model, partitioning.model_cut())
    if partitioning.fsdp_size(ctx.config) > 1:
        partitioning.shard_model(model, mesh.device_mesh(shape, ctx.device),
                                 bf16_params=bf16)


def _bf16_state(model, make_optimizer, step: int = 0) -> TrainState:
    from ..train.optim import trained_parameters, with_master_weights

    opt = with_master_weights(trained_parameters(model),
                              lambda masters: make_optimizer(model, masters))
    with torch.no_grad():
        for p in model.parameters():
            if p.dtype == torch.float32 and not partitioning.is_dtensor(p):
                p.data = p.data.to(torch.bfloat16)
    return TrainState(model=model, optimizer=opt, step=step)


def maybe_bf16_params(ctx: TaskContext, state: TrainState, sched
                      ) -> TrainState:
    """`bf16_params: true` in the YAML: the optimizer rebuilt from the YAML
    over f32 master copies of the trained parameters
    (`optim.with_master_weights`), then every f32 parameter of the model
    made bf16 in place. Call it after any checkpoint import (the f32
    originals seed the masters) and before the resume (whose state has
    this form), as the JAX package orders it. On one process; a task
    reaches it through `place_state`."""
    if not ctx.config.get("bf16_params", False):
        return state
    return _bf16_state(state.model, lambda m, named: (
        create_optimizer_from_config(m, ctx.config, sched,
                                     named_params=named)), state.step)


def save_task_checkpoint(ctx: TaskContext, state: TrainState, index: int,
                         name: str = "ckpt", keep: int = 2) -> None:
    """The state under <out>/<name>/<index> (an epoch of the fine-tune, a
    step of the pretrain task), the newest `keep` kept: every rank takes
    part (the gather of a sharded state), rank 0 writes, and the ranks
    meet at a barrier after it."""
    from ..train.checkpoint import save_checkpoint

    save_checkpoint(os.path.join(ctx.out_dir, name), state, step=index,
                    keep=keep)
    mesh.barrier()


def restore_latest(ctx: TaskContext, state: TrainState):
    """With `resume: true` in the YAML and a save under <out>/ckpt: the
    newest restored in place on every rank → (state, its index); else
    (state, None)."""
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


def step_generator(ctx: TaskContext, *key: int) -> mesh.StepGenerators:
    """The step's generators on the task's device (`mesh.StepGenerators`):
    the hard negatives' (`shared`, equal on every rank) seeded from (seed,
    *key), the dropout masks' (`rank`) from the same entropy spawned at the
    rank: the fine-tune's from (seed, epoch), a pretrain stream's from
    (seed, step, stream index), so that a resumed run draws what the run
    it replaces drew."""
    return mesh.step_generators(ctx.seed, key, ctx.device)


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
                generator: mesh.StepGenerators, epoch: int, sched=None,
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


def reference_loader(path: Optional[str]):
    """`load_reference_checkpoint` of `path` as the `load` of `build_state`
    or `eval_model`; None without a path."""
    if not path:
        return None
    return lambda model: load_reference_checkpoint(model, path)


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
