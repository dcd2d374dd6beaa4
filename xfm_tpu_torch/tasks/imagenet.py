"""ImageNet and the linear probes (`xfm_tpu/tasks/imagenet.py`, `run.py
--task imagenet`).

The fine-tune trains `XFMForClassification`'s image branch ([cls ‖
mean-patch] → `DeepMLPHead`) with HF-AdamW (decay 0.05 by default, clip to
norm 1) on a per-step half-cosine schedule after whole warm-up epochs,
dropout and drop-path live; while mixup or cutmix is on, on the soft
targets `mixup_cutmix` draws on the host (in the loader's prefetch
thread), else on the hard labels. Under `is_lp` (a linear probe) the tower
is frozen and the head alone trains, with LARS where the YAML's
`optimizer.opt` is `lars`. Each epoch ends with the top-1 on `val_root`
and, where it improved, a checkpoint (`ckpt/<epoch>`, the three newest
kept). `--evaluate` computes the top-1 alone. Rows come from a JSONL
manifest or a class-folder tree (`train_root`, `val_root`), or from a
named probe set (`dataset:`, `data/probe_datasets`). The transforms and
mixup draw from generators seeded once from `--seed`, as in the JAX task;
the step's generator from (`--seed`, epoch). A `--checkpoint` (a
reference state dict, or a `state.pt` of this task) is overlaid by name,
its `cls_head` included (the JAX task reads it with `head=None` and so
scores a random head).

Under `torchrun` each of the W processes trains on its rows of every
global batch (`core/mesh.rank_rows`; `--bs` and the YAML's `batch_size`
are per process after `scale_batch`), with its own transform, dropout
and mixup generators (the rank folded into their seeds): mixup and cutmix
pair rows within a rank's batch, each rank drawing its own λ and
permutation, as timm's `Mixup` does under DDP (the JAX package draws one
λ over the global batch). The loss is a mean over the rank's equal rows,
so the averaged gradients (LARS's included) are the global batch's; the
probe's frozen tower is rank 0's on every rank. The eval gives each rank
its batches of the val rows and sums the counts.
"""
from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np
import torch

from ..core import mesh, partitioning
from ..data.prefetch import DeviceBatches
from ..data.timm_aug import ImagenetEvalTransform, ImagenetTrainTransform
from ..data.transforms import decode_image
from ..models import XFMForClassification, config_from_yaml
from ..train.checkpoint import init_weights
from ..train.metrics import is_main_process
from ..train.optim import LARS, create_optimizer, trained_parameters
from ..train.schedules import half_cosine
from ..train.train_state import make_train_step
from .common import (TaskContext, append_log, epoch_opt_steps, eval_model,
                     reference_loader, log_eval, place_state,
                     save_task_checkpoint, step_generator, train_epoch)


def load_manifest(path_or_dir: str):
    """A JSONL manifest of {"image", "label"} or a class-folder tree →
    (rows [(path, label)], num_labels)."""
    if os.path.isfile(path_or_dir):
        rows = []
        with open(path_or_dir) as f:
            for line in f:
                d = json.loads(line)
                rows.append((d["image"], int(d["label"])))
        return rows, 1 + max(label for _, label in rows)
    classes = sorted(d for d in os.listdir(path_or_dir)
                     if os.path.isdir(os.path.join(path_or_dir, d)))
    rows = []
    for ci, c in enumerate(classes):
        cdir = os.path.join(path_or_dir, c)
        rows.extend((os.path.join(cdir, fn), ci)
                    for fn in sorted(os.listdir(cdir)))
    return rows, len(classes)


def mixup_cutmix(rng: np.random.Generator, images, labels, num_labels,
                 mixup_alpha=0.8, cutmix_alpha=1.0, prob=1.0,
                 switch_prob=0.5, cutmix_minmax=None,
                 label_smoothing=0.1):
    """timm's Mixup in 'batch' mode on the host → (images, soft targets
    [B, num_labels] f32): label-smoothed one-hot targets; with probability
    `prob` one λ for the batch and one permutation, cutmix chosen with
    `switch_prob` where both are on, its box from `cutmix_minmax` (side
    ratios uniform in the bounds) or from Beta(cutmix_alpha), λ then the
    box's area share. Every draw from `rng`, in the JAX task's order."""
    B = images.shape[0]
    onehot = np.full((B, num_labels), label_smoothing / num_labels,
                     np.float32)
    onehot[np.arange(B), labels] += 1.0 - label_smoothing
    if rng.random() > prob:
        return images, onehot
    perm = rng.permutation(B)
    cutmix_on = cutmix_alpha > 0 or cutmix_minmax is not None
    if not (mixup_alpha > 0 or cutmix_on):
        return images, onehot
    use_cutmix = cutmix_on and (mixup_alpha <= 0
                                or rng.random() < switch_prob)
    if not use_cutmix:
        lam = rng.beta(mixup_alpha, mixup_alpha)
        images = lam * images + (1 - lam) * images[perm]
    else:
        H, W = images.shape[1:3]
        if cutmix_minmax:
            rh = int(rng.uniform(cutmix_minmax[0] * H, cutmix_minmax[1] * H))
            rw = int(rng.uniform(cutmix_minmax[0] * W, cutmix_minmax[1] * W))
        else:
            lam = rng.beta(cutmix_alpha, cutmix_alpha)
            rh, rw = int(H * np.sqrt(1 - lam)), int(W * np.sqrt(1 - lam))
        cy, cx = rng.integers(0, H), rng.integers(0, W)
        y0, y1 = np.clip(cy - rh // 2, 0, H), np.clip(cy + rh // 2, 0, H)
        x0, x1 = np.clip(cx - rw // 2, 0, W), np.clip(cx + rw // 2, 0, W)
        images = images.copy()
        images[:, y0:y1, x0:x1] = images[perm, y0:y1, x0:x1]
        lam = 1 - (y1 - y0) * (x1 - x0) / (H * W)
    return images, lam * onehot + (1 - lam) * onehot[perm]


def batches(rows, transform, image_root, batch_size, shuffle=True, seed=0,
            drop_last=True) -> Iterator[dict]:
    """Host batches {images [B, H, W, 3] f32, targets [B] int64} over
    `rows` (shuffled from `seed`), under a group of W the rank's rows of
    each global batch of W · `batch_size` (`rank_rows`); a row whose image
    cannot be read or transformed is skipped, as in the JAX task, on one
    process (under a group it raises: the ranks would take unequal
    steps)."""
    idx = np.arange(len(rows))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    if drop_last:
        idx = mesh.rank_rows(idx, batch_size)
    buf_i, buf_l = [], []
    for i in idx:
        path, label = rows[int(i)]
        if isinstance(path, str) and image_root and not os.path.isabs(path):
            path = os.path.join(image_root, path)
        try:
            buf_i.append(transform(decode_image(path)))
        except (OSError, ValueError):
            if mesh.is_distributed():
                raise
            continue
        buf_l.append(label)
        if len(buf_i) == batch_size:
            yield dict(images=np.stack(buf_i),
                       targets=np.asarray(buf_l, np.int64))
            buf_i, buf_l = [], []
    if buf_i and not drop_last:
        yield dict(images=np.stack(buf_i),
                   targets=np.asarray(buf_l, np.int64))


def soft_ce(logits, soft_targets):
    """The mean over rows of −Σ soft_targets · log_softmax(logits), f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(soft_targets * logp, dim=-1))


@partitioning.unsharded_eval
def evaluate(model, rows, transform, image_root, batch_size) -> dict:
    """→ {"acc1": the share of rows whose argmax logit is the label},
    over every row (a last partial batch included), prefetched to the
    model's device; under a group each rank takes its batches of the rows
    (`rank_batches`) and the counts are summed."""
    dev = next(model.parameters()).device
    correct = total = 0
    loader = DeviceBatches(batches(mesh.rank_batches(rows, batch_size),
                                   transform, image_root, batch_size,
                                   shuffle=False, drop_last=False), dev)
    try:
        for b in loader:
            pred = model.loss(images=b["images"], train=False).argmax(-1)
            correct += int((pred == b["targets"]).sum())
            total += len(b["targets"])
    finally:
        loader.close()
    correct, total = mesh.sum_over_ranks(correct, total)
    return {"acc1": correct / max(total, 1)}


def load_rows(cfg: dict):
    """(train rows, val rows, num_labels) from the YAML: a named probe
    set (`dataset`, under `data_root`) or the `train_root` / `val_root`
    manifests; `num_labels` where the YAML sets it."""
    if cfg.get("dataset"):
        from ..data.probe_datasets import PROBE_DATASETS, load_probe_split

        name = cfg["dataset"]
        root = cfg.get("data_root", cfg.get("train_root", "."))
        spec = PROBE_DATASETS[name.lower()]
        train_rows, n1 = load_probe_split(
            name, root, cfg.get("train_split", spec.train_split))
        val_rows, n2 = load_probe_split(
            name, root, cfg.get("val_split", spec.val_split))
    else:
        train_rows, n1 = load_manifest(cfg["train_root"])
        val_rows, n2 = load_manifest(cfg["val_root"])
    return train_rows, val_rows, cfg.get("num_labels", max(n1, n2))


def use_mix(cfg: dict) -> bool:
    """timm's Mixup is on where any of mixup, cutmix, cutmix_minmax is set
    (reference Imagenet.py:592-611), never in a linear probe."""
    return not cfg.get("is_lp", False) and (
        cfg.get("mixup", 0.8) > 0 or cfg.get("cutmix", 1.0) > 0
        or cfg.get("cutmix_minmax") is not None)


def build_optimizer(model, cfg: dict, sched, named_params=None):
    """LARS over the trained parameters (`named_params` where given) where
    `is_lp` and `optimizer.opt: lars`, else HF-AdamW (decay
    `optimizer.weight_decay`, 0.05 by default, `lr_mult`, clip to norm
    1)."""
    opt = cfg.get("optimizer", {}) or {}
    if cfg.get("is_lp", False) and str(opt.get("opt", "")).lower() == "lars":
        return LARS(named_params or trained_parameters(model), sched,
                    weight_decay=opt.get("weight_decay", 0.0))
    return create_optimizer(model, sched,
                            weight_decay=opt.get("weight_decay", 0.05),
                            lr_mult=opt.get("lr_mult", 1.0),
                            named_params=named_params)


def make_loss_fn(cfg: dict):
    """The fine-tune's loss: soft CE on the mixed targets while `use_mix`,
    else the model's cross-entropy on the labels; dropout live."""
    mix = use_mix(cfg)

    def loss_fn(model, batch, generator=None):
        if mix:
            logits = model.loss(images=batch["images"], train=False,
                                generator=generator, deterministic=False)
            return soft_ce(logits, batch["targets"]), {}
        return model.loss(images=batch["images"], targets=batch["targets"],
                          generator=generator, deterministic=False), {}

    return loss_fn


def mix_generator(seed: int) -> np.random.Generator:
    """The host generator of `mixup_cutmix`'s draws: from `seed` on one
    process, from [seed, rank] under a group (`core/mesh.rank_seed`), so
    that each rank draws its own λ and permutation over its own rows."""
    return np.random.default_rng(mesh.rank_seed([seed]))


def mixed(loader, cfg: dict, rng: np.random.Generator, num_labels: int):
    """`loader`'s batches through `mixup_cutmix` (the YAML's alphas,
    probabilities and `smoothing` / `label_smoothing`) where `use_mix`."""
    if not use_mix(cfg):
        yield from loader
        return
    for b in loader:
        images, targets = mixup_cutmix(
            rng, b["images"], b["targets"], num_labels,
            mixup_alpha=cfg.get("mixup", 0.8),
            cutmix_alpha=cfg.get("cutmix", 1.0),
            prob=cfg.get("mixup_prob", 1.0),
            switch_prob=cfg.get("mixup_switch_prob", 0.5),
            cutmix_minmax=cfg.get("cutmix_minmax"),
            label_smoothing=cfg.get("smoothing",
                                    cfg.get("label_smoothing", 0.1)))
        # f32 as the JAX task's device copy leaves them (λ is a float64)
        yield dict(images=images.astype(np.float32),
                   targets=targets.astype(np.float32))


def main(args) -> dict:
    """Random weights from `--seed`, overlaid by `--checkpoint` where
    given. `--evaluate`: the top-1 on the val rows → {"acc1"}. Otherwise
    the fine-tune (or the probe) → {"best_acc1"}."""
    ctx = TaskContext.from_args(args)
    cfg = ctx.config
    if int((cfg.get("parallel", {}) or {}).get("pipe", 1) or 1) > 1:
        raise NotImplementedError(
            "parallel.pipe > 1 (the GPipe-staged tower) is not ported "
            "(ROADMAP.md Queue 1, multi-card past the data axis)")
    if cfg.get("mixup_mode", "batch") != "batch":
        raise NotImplementedError(
            "mixup_mode 'pair'/'elem' not implemented; the reference config "
            "uses 'batch' (configs/xfm-ft/imagenet1k.yaml:38)")
    image_res = cfg.get("image_res", 224)
    train_rows, val_rows, num_labels = load_rows(cfg)
    with torch.device(ctx.device):  # built there: no host init, no copy
        model = XFMForClassification(
            config_from_yaml(cfg), num_labels=num_labels,
            task_name="imagenet",
            is_lp=bool(cfg.get("is_lp", False))).to(ctx.device)
    load = reference_loader(args.checkpoint)
    bsz = cfg.get("batch_size", 64)
    eval_tf = ImagenetEvalTransform(image_res)
    if args.evaluate:
        eval_model(ctx, model, load)
        return log_eval(ctx, evaluate(model, val_rows, eval_tf,
                                      cfg.get("image_root"), bsz))
    init_weights(model, ctx.seed)
    mesh.broadcast_parameters(model)
    if load is not None:
        load(model)
    epochs = int(cfg.get("schedular", {}).get("epochs",
                                              cfg.get("epochs", 30)))
    opt = cfg.get("optimizer", {}) or {}
    sched = half_cosine(opt.get("lr", 1e-3), opt.get("min_lr", 1e-6),
                        epochs, cfg.get("warmup_epochs", 5),
                        epoch_opt_steps(cfg, len(train_rows), bsz))
    state = place_state(ctx, model, sched, lambda m, named: build_optimizer(
        m, cfg, sched, named))
    step_fn = make_train_step(make_loss_fn(cfg))
    host_rng = mix_generator(ctx.seed)
    train_tf = ImagenetTrainTransform(
        image_res, aa=cfg.get("aa", "rand-m9-mstd0.5-inc1"),
        color_jitter=cfg.get("color_jitter"),
        reprob=cfg.get("reprob", 0.25), remode=cfg.get("remode", "pixel"),
        recount=cfg.get("recount", 1), seed=mesh.rank_seed([ctx.seed]))
    best = 0.0
    for epoch in range(epochs):
        loader = mixed(batches(train_rows, train_tf, cfg.get("image_root"),
                               bsz, seed=ctx.seed + epoch),
                       cfg, host_rng, num_labels)
        state, stats = train_epoch(ctx, state, step_fn, loader,
                                   step_generator(ctx, epoch), epoch, sched)
        metrics = evaluate(model, val_rows, eval_tf, cfg.get("image_root"),
                           bsz)
        append_log(ctx.out_dir, {"epoch": epoch, **stats, **metrics})
        if is_main_process():
            print(f"epoch {epoch}: {metrics}", flush=True)
        if metrics["acc1"] > best:
            best = metrics["acc1"]
            save_task_checkpoint(ctx, state, epoch, keep=3)
    return {"best_acc1": best}
