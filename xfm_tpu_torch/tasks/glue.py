"""GLUE (`xfm_tpu/tasks/glue.py`, reference run_glue.py, `run.py --task
glue`): `XFMForClassification`'s text branch (the text encoder's cls →
`MLPHead`; STS-B regresses one score under the MSE).

The fine-tune runs HF-AdamW (`weight_decay`, clip to norm 1) on a linear
schedule over optimizer steps (`max_train_steps`, else the epochs' steps
after `gradient_accumulation_steps`), dropout live, the step's generator
from (`--seed`, epoch); after every epoch the task's metrics on the
validation split, a checkpoint (`ckpt/<epoch>`, the two newest kept) and
`ckpt_best/` (a hard link) where the mean of the metrics improved;
`resume: true` continues after the newest `ckpt/` epoch; MNLI ends with
the mismatched validation split. `--evaluate` computes the metrics alone.
Examples come from the YAML's JSONL files (`train_file`,
`validation_file`, `validation_mismatched_file`), or from a directory
`glue_datasets/<task>` that Hugging Face `datasets` saved (read where that
package imports); nothing is downloaded. Where the `text_encoder`'s
tokenizer files are missing, the fallback SimpleTokenizer is built over
the train texts, as in the JAX task. `--bs` is the global train batch,
divided over the processes into `per_device_train_batch_size` (the JAX
task ignores it). A `--checkpoint` is overlaid by name, its `cls_head`
included (the JAX task reads it with `head=None`).

Under `torchrun` every process builds the same global batches of
`per_device_train_batch_size` × W examples and trains on its rows of
each (`core/mesh.rank_slice`); the loss is a mean over the rank's equal
rows, so the averaged gradients are the global batch's. The eval gives
each rank its batches of `per_device_eval_batch_size` examples
(`core/mesh.rank_batches`) and gathers the predictions back into the
one-process order before the metrics, which (MCC, F1, Pearson and
Spearman) are not means over ranks.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Iterator

import numpy as np
import torch

from ..core import mesh, partitioning
from ..eval import glue_metrics
from ..models import XFMForClassification, config_from_yaml
from ..train.checkpoint import init_weights, link_checkpoint
from ..train.metrics import is_main_process
from ..train.optim import create_optimizer
from ..train.schedules import linear_warmup_decay
from .common import (TaskContext, append_log, eval_model,
                     reference_loader, log_eval, make_task_step,
                     maybe_resume_epochs, place_state,
                     opt_steps_per_epoch, save_task_checkpoint,
                     step_generator, train_epoch)
from .retrieval import _maybe_shrink_vocab, build_tokenizer_or_fallback

TASK_KEYS = {
    "cola": ("sentence", None), "sst2": ("sentence", None),
    "mrpc": ("sentence1", "sentence2"), "qqp": ("question1", "question2"),
    "stsb": ("sentence1", "sentence2"),
    "mnli": ("premise", "hypothesis"), "qnli": ("question", "sentence"),
    "rte": ("sentence1", "sentence2"), "wnli": ("sentence1", "sentence2"),
}

TASK_NUM_LABELS = {"cola": 2, "sst2": 2, "mrpc": 2, "qqp": 2, "stsb": 1,
                   "mnli": 3, "qnli": 2, "rte": 2, "wnli": 2}

_FILE_KEYS = {"train": "train_file", "validation": "validation_file",
              "validation_mismatched": "validation_mismatched_file"}


def load_glue_examples(config: dict, split: str):
    """→ [(text_a, text_b or None, label)] of `split` (train, validation,
    validation_mismatched): from the YAML's JSONL file for it, else from
    `glue_datasets/<task>` saved by `datasets` (MNLI's validation is
    validation_matched there). Raises FileNotFoundError, or ImportError
    where `datasets` is missing, naming the JSONL keys."""
    task = config["task_name"]
    k1, k2 = TASK_KEYS[task]
    file_key = _FILE_KEYS[split]
    if config.get(file_key):
        rows = []
        with open(config[file_key]) as f:
            for line in f:
                d = json.loads(line)
                rows.append((d[k1], d.get(k2) if k2 else None, d["label"]))
        return rows
    fields = ", ".join(repr(k) for k in (k1, k2, "label") if k)
    how = (f"set the YAML's {file_key!r} to a JSONL file of {{{fields}}} "
           f"rows, or 'glue_datasets' to a directory holding {task}/ as "
           "datasets' save_to_disk writes it")
    path = os.path.join(str(config.get("glue_datasets") or ""), task)
    if not (config.get("glue_datasets") and os.path.isdir(path)):
        raise FileNotFoundError(f"GLUE {task} {split}: no {path!r}; {how}")
    try:
        import datasets
    except ImportError as e:
        raise ImportError(f"GLUE {task} {split}: reading {path!r} needs the "
                          f"`datasets` package; or {how}") from e
    hf_split = split
    if split == "validation" and task == "mnli":
        hf_split = "validation_matched"
    ds = datasets.load_from_disk(path)[hf_split]
    return [(r[k1], r[k2] if k2 else None, r["label"]) for r in ds]


def make_tokenize_fn(tokenizer, max_length: int):
    """pairs → (ids, atts) int32 [B, max_length]: a Hugging Face tokenizer's
    pair encoding, else the fallback's call on "a </s> b"."""
    def tokenize(pairs):
        if hasattr(tokenizer, "batch_encode_plus"):
            a_list = [a for a, _, _ in pairs]
            b_list = [b for _, b, _ in pairs]
            args = (a_list,) if b_list[0] is None else (a_list, b_list)
            enc = tokenizer(*args, max_length=max_length,
                            padding="max_length", truncation=True)
            return (np.asarray(enc["input_ids"], np.int32),
                    np.asarray(enc["attention_mask"], np.int32))
        enc = tokenizer([a if b is None else
                         a + " " + tokenizer.sep_token + " " + b
                         for a, b, _ in pairs], max_length=max_length)
        return enc["input_ids"], enc["attention_mask"]

    return tokenize


def batches(examples, tokenize, batch_size: int, regression: bool,
            shuffle=True, seed=0, drop_last=True) -> Iterator[dict]:
    """Host batches {text_ids, text_atts, targets (f32 scores or int32
    labels)} over `examples` (shuffled from `seed`)."""
    idx = np.arange(len(examples))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    for s in range(0, len(idx) - (batch_size - 1 if drop_last else 0),
                   batch_size):
        chunk = [examples[i] for i in idx[s:s + batch_size]]
        ids, atts = tokenize(chunk)
        labels = np.asarray([c[2] for c in chunk],
                            np.float32 if regression else np.int32)
        yield dict(text_ids=ids, text_atts=atts, targets=labels)


@partitioning.unsharded_eval
def evaluate(model, examples, tokenize, task: str, batch_size: int) -> dict:
    """The task's metrics (`glue_metrics.compute`) of the model's argmax
    (STS-B: its score) over every example, in batches of `batch_size`;
    under a group each rank predicts its batches (`rank_batches`) and the
    predictions are gathered back into the examples' order on every
    rank."""
    dev = next(model.parameters()).device
    regression = task == "stsb"
    preds = []
    for b in batches(mesh.rank_batches(examples, batch_size), tokenize,
                     batch_size, regression, shuffle=False,
                     drop_last=False):
        ids, atts = (torch.from_numpy(np.asarray(b[k])).long().to(dev)
                     for k in ("text_ids", "text_atts"))
        logits = model.loss(text_ids=ids, text_atts=atts,
                            train=False).float().cpu().numpy()
        preds.append(logits.reshape(-1) if regression
                     else logits.argmax(-1))
    mine = (np.concatenate(preds) if preds else
            np.zeros(0, np.float32 if regression else np.int64))
    preds = mesh.merge_rank_batches(mesh.all_gather_ragged(mine), batch_size)
    labels = np.asarray([e[2] for e in examples],
                        np.float32 if regression else np.int32)
    return glue_metrics.compute(task, preds.tolist(), labels.tolist())


def glue_loss_fn(model, batch, generator=None, deterministic: bool = True):
    """`XFMForClassification.loss` on a text batch (the fine-tune's with
    `deterministic=False`)."""
    return model.loss(text_ids=batch["text_ids"],
                      text_atts=batch["text_atts"],
                      targets=batch["targets"], generator=generator,
                      deterministic=deterministic), {}


def main(args) -> dict:
    """Random weights from `--seed`, overlaid by `--checkpoint` where
    given. `--evaluate`: the validation metrics alone. Otherwise the
    fine-tune → the last epoch's metrics (with MNLI's `mm_*`)."""
    ctx = TaskContext.from_args(args)
    cfg = ctx.config
    task = cfg["task_name"]
    num_labels = TASK_NUM_LABELS.get(task, cfg.get("num_labels", 2))
    regression = task == "stsb"
    train_ex = load_glue_examples(cfg, "train")
    val_ex = load_glue_examples(cfg, "validation")
    tokenizer = build_tokenizer_or_fallback(
        cfg, lambda: [a + " " + (b or "") for a, b, _ in train_ex])
    tokenize = make_tokenize_fn(tokenizer, cfg.get("max_length", 128))
    with torch.device(ctx.device):  # built there: no host init, no copy
        model = XFMForClassification(
            _maybe_shrink_vocab(config_from_yaml(cfg), tokenizer),
            num_labels=num_labels, task_name="glue").to(ctx.device)
    load = reference_loader(args.checkpoint)
    eval_bs = cfg.get("per_device_eval_batch_size", 8)
    if args.evaluate:
        eval_model(ctx, model, load)
        return log_eval(ctx, evaluate(model, val_ex, tokenize, task,
                                      eval_bs))
    init_weights(model, ctx.seed)
    mesh.broadcast_parameters(model)
    if load is not None:
        load(model)
    bsz = cfg.get("per_device_train_batch_size", 32) * mesh.dp_size()
    epochs = int(cfg.get("num_train_epochs", 3))
    total = cfg.get("max_train_steps") or epochs * opt_steps_per_epoch(
        cfg, max(1, len(train_ex) // bsz))
    sched = linear_warmup_decay(float(cfg.get("learning_rate", 5e-5)), total,
                                cfg.get("num_warmup_steps", 0))
    state = place_state(ctx, model, sched, lambda m, named: create_optimizer(
        m, sched, weight_decay=float(cfg.get("weight_decay", 0.0)),
        clip_grad_norm=1.0, named_params=named))
    step_fn, accum = make_task_step(ctx, functools.partial(
        glue_loss_fn, deterministic=False))
    state, start_epoch = maybe_resume_epochs(ctx, state)
    best, metrics = -1e9, {}
    for epoch in range(start_epoch, epochs):
        loader = map(mesh.rank_slice, batches(train_ex, tokenize, bsz,
                                              regression,
                                              seed=ctx.seed + epoch))
        state, stats = train_epoch(ctx, state, step_fn, loader,
                                   step_generator(ctx, epoch), epoch, sched,
                                   accum_steps=accum)
        metrics = evaluate(model, val_ex, tokenize, task, eval_bs)
        append_log(ctx.out_dir, {"epoch": epoch, **stats, **metrics})
        if is_main_process():
            print(f"epoch {epoch}: {stats} {metrics}", flush=True)
        save_task_checkpoint(ctx, state, epoch)
        score = float(np.mean(list(metrics.values())))
        if score > best:
            best = score
            if is_main_process():
                link_checkpoint(os.path.join(ctx.out_dir, "ckpt"),
                                os.path.join(ctx.out_dir, "ckpt_best"),
                                epoch, keep=1)
    if task == "mnli":
        try:
            mm_ex = load_glue_examples(cfg, "validation_mismatched")
        except (KeyError, OSError, ImportError) as e:
            print(f"### mnli-mm eval skipped: {e}", flush=True)
            mm_ex = None
        if mm_ex:
            mm = evaluate(model, mm_ex, tokenize, task, eval_bs)
            metrics.update({f"mm_{k}": v for k, v in mm.items()})
            append_log(ctx.out_dir, {"mnli_mm": mm})
            if is_main_process():
                print(f"mnli-mm: {mm}", flush=True)
    return metrics
