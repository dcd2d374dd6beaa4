"""The generic classifier (`xfm_tpu/tasks/classify.py`, `run.py --task
classify`; the reference's Classify.py, which does not run): JSONL rows of
{"text"} and / or {"image": path} with {"label"}, through
`XFMForClassification`'s text, image or fused branch by what the rows
hold, or `TextClassifier` under `use_text_classifier`.

Each epoch trains on `train_file` (HF-AdamW and the schedule from the
YAML's blocks, dropout live, `TrainTransform` reseeded from `--seed` +
epoch, the step's generator from (`--seed`, epoch)), then the accuracy on
`val_file` (else `train_file`). `--evaluate` computes the accuracy alone;
a `--checkpoint` is overlaid by name. Where the `text_encoder`'s
tokenizer files are missing, the fallback SimpleTokenizer is built over
the rows' texts (the JAX task builds it over none). `parallel.pipe > 1`
(the GPipe text tower) is not ported.

Under `torchrun` each of the W processes trains on its rows of every
global batch (`core/mesh.rank_rows`), its transform reseeded with the
rank folded in; the loss is a mean over the rank's equal rows, so the
averaged gradients are the global batch's. The eval gives each rank its
batches of the val rows (`core/mesh.rank_batches`) and sums the counts.
"""
from __future__ import annotations

import functools
import json
import os

import numpy as np
import torch

from ..core import mesh, partitioning
from ..data.finetune_data import _encode_texts
from ..data.transforms import TestTransform, TrainTransform, decode_image
from ..models import XFMForClassification, config_from_yaml
from ..models.task_models import TextClassifier
from ..train.metrics import is_main_process
from ..train.train_state import make_train_step
from .common import (TaskContext, append_log, build_state, epoch_opt_steps,
                     eval_model, reference_loader, log_eval,
                     step_generator, train_epoch)
from .retrieval import _maybe_shrink_vocab, build_tokenizer_or_fallback

_INPUTS = ("images", "text_ids", "text_atts")


def load_rows(path):
    """The JSONL file's rows."""
    with open(path) as f:
        return [json.loads(line) for line in f]


def _pack(buf, tokenizer, transform, image_root, max_tokens):
    """Rows → a host batch: targets, and the text ids and mask where the
    rows hold text, the images where they hold images and `transform` is
    given."""
    out = {"targets": np.asarray([r["label"] for r in buf], np.int32)}
    if "text" in buf[0]:
        out["text_ids"], out["text_atts"] = _encode_texts(
            tokenizer, [r["text"] for r in buf], max_tokens)
    if "image" in buf[0] and transform is not None:
        out["images"] = np.stack([transform(decode_image(
            os.path.join(image_root, r["image"]) if image_root
            else r["image"])) for r in buf])
    return out


def batches(rows, tokenizer, transform, image_root, max_tokens, batch_size,
            shuffle=True, seed=0, drop_last=True):
    """`_pack`'s batches over `rows` (shuffled from `seed`); with
    `drop_last` under a group of W, the rank's rows of each global batch
    of W · `batch_size` (`rank_rows`)."""
    idx = np.arange(len(rows))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    if drop_last:
        idx = mesh.rank_rows(idx, batch_size)
    for s in range(0, len(idx) - (batch_size - 1 if drop_last else 0),
                   batch_size):
        yield _pack([rows[int(i)] for i in idx[s:s + batch_size]],
                    tokenizer, transform, image_root, max_tokens)


@partitioning.unsharded_eval
def evaluate(model, loader) -> dict:
    """→ {"acc": the share of rows whose argmax logit is the label}, the
    counts summed over the ranks."""
    dev = next(model.parameters()).device
    correct = total = 0
    for b in loader:
        kw = {k: torch.from_numpy(b[k]).to(dev) for k in _INPUTS if k in b}
        for k in ("text_ids", "text_atts"):
            if k in kw:
                kw[k] = kw[k].long()
        pred = model.loss(train=False, **kw).argmax(-1).cpu().numpy()
        correct += int((pred == b["targets"]).sum())
        total += len(b["targets"])
    correct, total = mesh.sum_over_ranks(correct, total)
    return {"acc": correct / max(total, 1)}


def classify_loss_fn(model, batch, generator=None,
                     deterministic: bool = True):
    """The model's loss on whichever of images, text ids and mask the batch
    holds (the fine-tune's with `deterministic=False`)."""
    kw = {k: batch[k] for k in _INPUTS if k in batch}
    return model.loss(targets=batch["targets"], generator=generator,
                      deterministic=deterministic, **kw), {}


def build_model(cfg: dict, tokenizer, rows: list):
    """The classifier the YAML and the rows ask for → (model, whether it
    reads images)."""
    mcfg = _maybe_shrink_vocab(config_from_yaml(cfg), tokenizer)
    num_labels = cfg.get("num_labels", 2)
    if cfg.get("use_text_classifier", False):
        return TextClassifier(mcfg.text, num_labels=num_labels), False
    has_img, has_txt = "image" in rows[0], "text" in rows[0]
    task_name = "fused" if has_img and has_txt else (
        "imagenet" if has_img else "glue")
    return XFMForClassification(mcfg, num_labels=num_labels,
                                task_name=task_name,
                                is_lp=cfg.get("is_lp", False)), has_img


def main(args) -> dict:
    """Random weights from `--seed`, overlaid by `--checkpoint` where
    given. `--evaluate`: the val accuracy alone → {"acc"}. Otherwise the
    fine-tune → {"best_acc"}."""
    ctx = TaskContext.from_args(args)
    cfg = ctx.config
    if int((cfg.get("parallel", {}) or {}).get("pipe", 1) or 1) > 1:
        raise NotImplementedError(
            "parallel.pipe > 1 (the GPipe-staged text tower) is not ported "
            "(ROADMAP.md Queue 1, multi-card past the data axis)")
    image_res = cfg.get("image_res", 224)
    train_rows = load_rows(cfg["train_file"])
    val_rows = load_rows(cfg.get("val_file", cfg["train_file"]))
    tokenizer = build_tokenizer_or_fallback(cfg, lambda: [
        r["text"] for r in train_rows + val_rows if "text" in r])
    with torch.device(ctx.device):  # built there: no host init, no copy
        model, has_img = build_model(cfg, tokenizer, train_rows)
    model = model.to(ctx.device)
    T, bsz = cfg.get("max_tokens", 40), cfg.get("batch_size", 16)
    train_tf = TrainTransform(image_res) if has_img else None
    test_tf = TestTransform(image_res) if has_img else None

    def val_loader():
        return batches(mesh.rank_batches(val_rows, bsz), tokenizer, test_tf,
                       cfg.get("image_root"), T, bsz, shuffle=False,
                       drop_last=False)

    load = reference_loader(args.checkpoint)
    if args.evaluate:
        eval_model(ctx, model, load)
    else:
        state, sched = build_state(ctx, model, epoch_opt_steps(
            cfg, len(train_rows), bsz), load=load)
    if args.evaluate:
        return log_eval(ctx, evaluate(model, val_loader()))
    step_fn = make_train_step(functools.partial(classify_loss_fn,
                                                deterministic=False))
    best = 0.0
    for epoch in range(int(cfg.get("schedular", {}).get("epochs", 10))):
        if train_tf is not None:
            train_tf.reseed(mesh.rank_seed([ctx.seed + epoch]))
        loader = batches(train_rows, tokenizer, train_tf,
                         cfg.get("image_root"), T, bsz,
                         seed=ctx.seed + epoch)
        state, stats = train_epoch(ctx, state, step_fn, loader,
                                   step_generator(ctx, epoch), epoch, sched)
        metrics = evaluate(model, val_loader())
        append_log(ctx.out_dir, {"epoch": epoch, **stats, **metrics})
        if is_main_process():
            print(f"epoch {epoch}: {metrics}", flush=True)
        best = max(best, metrics["acc"])
    return {"best_acc": best}
