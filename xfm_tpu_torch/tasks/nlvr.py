"""NLVR2: the fine-tune and the accuracy eval (`xfm_tpu/tasks/nlvr.py`,
`run.py --task nlvr`).

The fine-tune trains `XFMForNLVR`'s cross-entropy over each pair's two
images and its sentence, dropout and drop-path live, the masks drawn from
a generator seeded from (seed, epoch), with `accumulate_steps`; after
every epoch the accuracy on `val_file` (else `test_file`) and on
`test_file`, a checkpoint (`ckpt/<epoch>`, the two newest kept) and
`ckpt_best/` where the val accuracy improved; `resume: true` continues
after the newest `ckpt/` epoch. `--evaluate` computes the test accuracy
alone. A `--checkpoint` (a reference state dict) is overlaid by name, its
`cls_head.{0,1,3}` included, as `import_xfm_checkpoint(...,
head="cls_mlp")` reads it. Where the `text_encoder`'s tokenizer files are
missing, the fallback SimpleTokenizer is built over the sentences of the
train, val and test files (the JAX package builds it over no text).
"""
from __future__ import annotations

import torch

from ..data.finetune_data import NLVRData, _load_ann
from ..data.transforms import TestTransform, TrainTransform
from ..models import XFMForNLVR, config_from_yaml
from ..train.checkpoint import init_weights
from ..train.train_state import nlvr_loss_fn
from .common import (TaskContext, build_state, device_inputs, finetune,
                     load_reference_checkpoint, log_eval)
from .retrieval import (_device_of, _maybe_shrink_vocab,
                        build_tokenizer_or_fallback)


@torch.no_grad()
def evaluate(model, data: NLVRData) -> dict:
    """→ {"acc": the share of pairs whose argmax logit is the label}."""
    dev = _device_of(model)
    correct = total = 0
    for batch in data.epoch():
        logits = model.loss(*device_inputs(batch, dev), train=False)
        pred = logits.argmax(-1).cpu().numpy()
        correct += int((pred == batch["targets"]).sum())
        total += len(batch["targets"])
    return {"acc": correct / max(total, 1)}


def nlvr_texts(cfg: dict) -> list:
    """The sentences of the train, val and test files: the words of a
    fallback tokenizer."""
    texts = []
    for key in ("train_file", "val_file", "test_file"):
        if cfg.get(key):
            texts += [a.get("sentence", "") for a in _load_ann(cfg[key])]
    return texts


def main(args) -> dict:
    """Random weights from `--seed`, overlaid by `--checkpoint` where given.
    `--evaluate`: the test accuracy alone → {"acc"}. Otherwise the
    fine-tune → {"best_val_acc"}."""
    ctx = TaskContext.from_args(args)
    cfg = ctx.config
    image_res = cfg.get("image_res", 384)
    tokenizer = build_tokenizer_or_fallback(cfg, lambda: nlvr_texts(cfg))
    model = XFMForNLVR(_maybe_shrink_vocab(config_from_yaml(cfg),
                                           tokenizer)).to(ctx.device)

    def data(ann, train):
        return NLVRData(ann, TrainTransform(image_res) if train
                        else TestTransform(image_res), cfg["image_root"],
                        tokenizer, max_tokens=cfg.get("max_tokens", 40),
                        batch_size=cfg.get("batch_size", 16), train=train)

    test_data = data(cfg["test_file"], False)
    val_data = (data(cfg["val_file"], False) if cfg.get("val_file")
                else test_data)
    if args.evaluate:
        init_weights(model, ctx.seed)
    else:
        train_data = data(cfg["train_file"], True)
        state, sched = build_state(
            ctx, model, max(1, len(train_data) // train_data.batch_size))
    if args.checkpoint:
        load_reference_checkpoint(model, args.checkpoint)
    if args.evaluate:
        return log_eval(ctx, evaluate(model, test_data))
    best = finetune(ctx, state, sched, train_data, nlvr_loss_fn, lambda: {
        "val_acc": evaluate(model, val_data)["acc"],
        "test_acc": evaluate(model, test_data)["acc"]}, "val_acc")
    return {"best_val_acc": best}
