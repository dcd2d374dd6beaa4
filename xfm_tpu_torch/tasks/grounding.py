"""Referring-expression grounding (`xfm_tpu/tasks/grounding.py`, `run.py
--task refcoco_bbox`).

- `main`: the bbox fine-tune of `XFMForGrounding` (L1 + GIoU of the
  sigmoid cxcywh box), dropout and drop-path live, the masks drawn from a
  generator seeded from (seed, epoch); after every epoch the IoU ≥ 0.5
  accuracy on `test_file`, a checkpoint (`ckpt/<epoch>`, the two newest
  kept) and `ckpt_best/` where it improved; `resume: true` continues after
  the newest `ckpt/` epoch; `--evaluate` the accuracy alone. It trains
  through `BoxTrainTransform`, whose crop holds the target box and maps it
  (the JAX package's random resized crop leaves the target where the
  uncropped image had it).
- `main_bbox_pipeline`: stage 1, the region-stream domain pretrain (the
  pretrain task on `domain_pretrain_config`, or on the sibling
  `Grounding_bbox_pretrain.yaml`: ITC, ITM, MLM, bbox and GIoU at 224 px,
  at that YAML's own batch, `--bs` and `--epoch` being the fine-tune's)
  into <out>/bbox_pretrain/ckpt; stage 2, `main` from stage 1's weights,
  read by name through `load_xfm_checkpoint`, which interpolates the BEiT
  rel-pos tables from stage 1's grid to stage 2's (the JAX package's
  `merge_params` refuses the other shape and raises). `--evaluate` or
  `--load_ckpt_from` (a checkpoint directory, or a state dict file) skips
  stage 1.
- `main_weakly_supervised`: GradCAM grounding, a function only (the
  repository's `run.py` has no task for it), on one process: each
  sample's candidate `boxes` ranked by the ITM score's cam at fusion layer
  `block_num`, the accuracy of the top box against `gt`.

Under `torchrun` stage 1 runs as the pretrain task does (each rank its
shards of the region stream); rank 0 writes its checkpoint and every rank
loads it after the barrier that ends stage 1. Stage 2 trains each rank on
its rows of every global batch (`GroundingData`): the L1 and GIoU losses
are means over the rank's equal rows, so their gradients averaged over
the ranks are the global batch's; the eval gives each rank its batches
of the split and sums the IoU@0.5 counts.

Where the `text_encoder`'s tokenizer files are missing, the fallback
SimpleTokenizer is built over the texts of the train and test files, and
in the pipeline also over stage 1's region captions, so that both stages
share one vocabulary (the JAX package builds it over no text).
"""
from __future__ import annotations

import copy
import os
from typing import Optional

import numpy as np
import torch

from ..core import mesh, partitioning
from ..data.finetune_data import GroundingData, _load_ann
from ..data.transforms import BoxTrainTransform, TestTransform
from ..models import (XFMForGrounding, XFMForRetrieval, config_from_yaml,
                      itm_gradcam, rank_boxes_by_cam)
from ..models.losses import box_cxcywh_to_xyxy
from ..train.checkpoint import init_weights
from ..train.train_state import grounding_loss_fn
from .common import (TaskContext, append_log, build_state, device_inputs,
                     epoch_opt_steps, eval_model, finetune,
                     is_main_process, load_reference_checkpoint, log_eval)
from .retrieval import (_device_of, _maybe_shrink_vocab,
                        build_tokenizer_or_fallback)


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise IoU of xyxy boxes [N, 4] × [N, 4] → [N]."""
    lt = np.maximum(a[:, :2], b[:, :2])
    rb = np.minimum(a[:, 2:], b[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    ua = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
          + (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) - inter)
    return inter / np.maximum(ua, 1e-6)


@partitioning.unsharded_eval
def evaluate(model, data: GroundingData) -> dict:
    """→ {"iou50_acc": the share of phrases whose predicted box has IoU ≥
    0.5 with the target, both in normalized coordinates}, the counts
    summed over the ranks."""
    dev = _device_of(model)
    hits = total = 0
    for batch in data.epoch():
        coords = model.loss(*device_inputs(batch, dev), train=False)
        pred = box_cxcywh_to_xyxy(coords.float()).cpu().numpy()
        tgt = box_cxcywh_to_xyxy(
            torch.from_numpy(batch["target_bbox"])).numpy()
        iou = iou_xyxy(pred, tgt)
        hits += int((iou >= 0.5).sum())
        total += len(iou)
    hits, total = mesh.sum_over_ranks(hits, total)
    return {"iou50_acc": hits / max(total, 1)}


def grounding_texts(cfg: dict, stage1_cfg: Optional[dict] = None) -> list:
    """The texts of the train and test files, and the region captions of
    `stage1_cfg`'s files where they exist: the words of a fallback
    tokenizer."""
    texts = []
    for key in ("train_file", "test_file"):
        if cfg.get(key):
            texts += [a.get("text", "") for a in _load_ann(cfg[key])]
    if stage1_cfg:
        from .pretrain import corpus_texts

        files = stage1_cfg.get("train_file_regions") or []
        files = [files] if isinstance(files, str) else files
        if files and all(os.path.exists(f) for f in files):
            texts += corpus_texts(stage1_cfg)
    return texts


def _load_stage1(model, path: str) -> None:
    """Stage 1's parameters (a checkpoint directory, its newest step, or
    a state dict file) overlaid on `model` by name, the rel-pos tables
    interpolated to its grid."""
    from ..train.checkpoint import (load_params_from_checkpoint,
                                    load_torch_state_dict,
                                    load_xfm_checkpoint)

    sd = (load_params_from_checkpoint(path) if os.path.isdir(path)
          else load_torch_state_dict(path))
    missing, _ = load_xfm_checkpoint(model, sd)
    if is_main_process():
        print(f"### loaded domain-pretrain params from {path} "
              f"({len(missing)} fresh)", flush=True)


def main(args, stage1: Optional[str] = None, tokenizer=None) -> dict:
    """Random weights from `--seed`, overlaid by `--checkpoint` and then by
    `stage1` (stage 1's checkpoint) where given. `--evaluate`: the test
    accuracy alone → {"iou50_acc"}. Otherwise the fine-tune →
    {"best_iou50"}. `tokenizer` (the pipeline's) replaces the config's."""
    ctx = TaskContext.from_args(args)
    cfg = ctx.config
    image_res = cfg.get("image_res", 384)
    if tokenizer is None:
        tokenizer = build_tokenizer_or_fallback(
            cfg, lambda: grounding_texts(cfg))
    with torch.device(ctx.device):  # built there: no host init, no copy
        model = XFMForGrounding(_maybe_shrink_vocab(config_from_yaml(
            cfg, use_bbox_loss=True), tokenizer)).to(ctx.device)

    def data(ann, train):
        return GroundingData(ann, BoxTrainTransform(image_res) if train
                             else TestTransform(image_res),
                             cfg["image_root"], tokenizer,
                             max_tokens=cfg.get("max_tokens", 30),
                             batch_size=cfg.get("batch_size", 16),
                             train=train)

    test_data = data(cfg["test_file"], False)

    def load(m):
        if args.checkpoint:
            load_reference_checkpoint(m, args.checkpoint)
        if stage1:
            _load_stage1(m, stage1)

    if args.evaluate:
        eval_model(ctx, model, load)
    else:
        train_data = data(cfg["train_file"], True)
        state, sched = build_state(ctx, model, epoch_opt_steps(
            cfg, len(train_data), train_data.batch_size), load=load)
    if args.evaluate:
        return log_eval(ctx, evaluate(model, test_data))
    best = finetune(ctx, state, sched, train_data, grounding_loss_fn,
                    lambda: evaluate(model, test_data), "iou50_acc")
    return {"best_iou50": best}


def stage1_config(config_path: str) -> Optional[str]:
    """The stage-1 YAML of a fine-tune YAML: its `domain_pretrain_config`
    (relative to its directory), else a sibling
    `Grounding_bbox_pretrain.yaml`; None where neither exists."""
    from ..core.config import load_yaml

    here = os.path.dirname(config_path)
    path = load_yaml(config_path).get("domain_pretrain_config")
    if path and not os.path.isabs(path):
        path = os.path.join(here, path)
    if not path:
        path = os.path.join(here, "Grounding_bbox_pretrain.yaml")
    return path if os.path.exists(path) else None


def main_bbox_pipeline(args) -> dict:
    """`run.py --task refcoco_bbox`: stage 1 (unless `--evaluate` or
    `--load_ckpt_from`, or no stage-1 YAML resolves), then `main` from its
    checkpoint (or from `--load_ckpt_from`)."""
    from ..core.config import load_config

    dp_cfg = stage1_config(args.config)
    cfg = load_config(args.config)
    stage1_yaml = load_config(dp_cfg) if dp_cfg else None
    tokenizer = build_tokenizer_or_fallback(
        cfg, lambda: grounding_texts(cfg, stage1_yaml))
    stage1 = getattr(args, "load_ckpt_from", None)
    if not args.evaluate and not stage1:
        if dp_cfg:
            from . import pretrain

            a1 = copy.copy(args)
            a1.config, a1.bs, a1.epoch, a1.checkpoint = dp_cfg, None, None, \
                None
            a1.output_dir = os.path.join(args.output_dir, "bbox_pretrain")
            if is_main_process():
                print(f"### refcoco_bbox stage 1: domain pretrain "
                      f"({dp_cfg})", flush=True)
            # stage 1 takes the fine-tune's `parallel` block where its own
            # YAML has none: the same processes, sharded the same way
            pretrain.main(a1, tokenizer=tokenizer, overrides=(
                None if "parallel" in stage1_yaml
                else {"parallel": cfg.get("parallel")}))
            stage1 = os.path.join(a1.output_dir, "ckpt")
            args = copy.copy(args)
            args.checkpoint = None  # stage 2 starts from stage 1's weights
        elif is_main_process():
            print("### refcoco_bbox: no domain-pretrain config found, "
                  "running the fine-tune only", flush=True)
    return main(args, stage1=stage1, tokenizer=tokenizer)


def main_weakly_supervised(args) -> dict:
    """GradCAM grounding over `test_file`'s annotations ({image, text,
    boxes: [[x0, y0, x1, y1], ...] in pixels of the image_res frame, gt:
    the right box's index}) in batches of `batch_size` (8), with an
    `XFMForRetrieval` (random weights from `--seed`, overlaid by
    `--checkpoint`): the share of samples whose best-ranked box is `gt` →
    {"gradcam_acc"}, printed and logged. Samples without boxes are
    skipped. One process only: `MultiProcessUnsupported` under a group of
    more."""
    if mesh.world_size() > 1:
        raise mesh.MultiProcessUnsupported(
            "main_weakly_supervised runs on one process")
    ctx = TaskContext.from_args(args)
    cfg = ctx.config
    image_res = cfg.get("image_res", 384)
    tokenizer = build_tokenizer_or_fallback(cfg, lambda: [
        a.get("text", "") for a in _load_ann(cfg["test_file"])])
    with torch.device(ctx.device):  # built there: no host init, no copy
        model = XFMForRetrieval(_maybe_shrink_vocab(config_from_yaml(
            cfg, use_contrastive_loss=True, use_matching_loss=True),
            tokenizer)).to(ctx.device)
    init_weights(model, ctx.seed)
    if args.checkpoint:
        load_reference_checkpoint(model, args.checkpoint)
    data = GroundingData(cfg["test_file"], TestTransform(image_res),
                         cfg["image_root"], tokenizer,
                         max_tokens=cfg.get("max_tokens", 30),
                         batch_size=cfg.get("batch_size", 8), train=False)
    block_num = cfg.get("block_num", 8)
    dev = _device_of(model)
    hits = total = bi = 0
    for batch in data.epoch():
        cam = itm_gradcam(model, *device_inputs(batch, dev),
                          block_num=block_num).cpu().numpy()
        for j in range(cam.shape[0]):
            a = data.ann[bi]
            bi += 1
            if not a.get("boxes"):
                continue
            scores = rank_boxes_by_cam(cam[j], a["boxes"], image_res,
                                       cfg.get("patch_size", 16))
            hits += int(int(np.argmax(scores)) == int(a.get("gt", 0)))
            total += 1
    acc = hits / max(total, 1)
    append_log(ctx.out_dir, {"gradcam_acc": acc})
    if is_main_process():
        print({"gradcam_acc": acc}, flush=True)
    return {"gradcam_acc": acc}
