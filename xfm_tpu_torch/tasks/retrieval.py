"""Image-text retrieval: the fine-tune and the two-stage eval
(`xfm_tpu/tasks/retrieval.py`).

Stage 1 encodes every image (the BEiT-2 tower, through K2 on the card at
384 px) and every text, and takes the ITC similarity matrix on the host in
f32. Stage 2 scores the top-k_test candidates of each row with the ITM head:
image → text grouped (each image's k_test candidates are contiguous rows,
the fusion encoder's cross-attention views them as one query block per
image, through K3 on the card), text → image in the repeat form (each row's
own candidate image). Then R@1/5/10 in both directions. The embeddings stay
on the model's device between the stages; the similarities, the candidate
sets and the score matrices are numpy on the host, as in the JAX package.

The fine-tune trains ITC + ITM with the YAML's dropouts and drop-path
live, its masks and hard negatives drawn from a generator seeded from
(seed, epoch); a zero-shot eval comes first, then an eval and a checkpoint
after every epoch (`ckpt/<epoch>`, the two newest kept, and `ckpt_best/`
where R_mean improved), and `resume: true` continues after the newest
`ckpt/` epoch.

Under a process group each rank trains on its rows of every global batch
(`data/finetune_data`), ITC and the hard negatives run over the global
batch (`models/losses`), and the eval's stage 1 runs on every rank while
stage 2 scores rank r's rows r, r + W, … of each direction; the slices
are merged exactly (`merge_rerank_scores`) and rank 0 computes R@K, which
every rank returns.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..core import mesh, partitioning
from ..data.finetune_data import RetrievalEvalData, RetrievalTrainData
from ..data.transforms import TestTransform, TrainTransform
from ..models import XFMForRetrieval, config_from_yaml
from ..train.train_state import retrieval_loss_fn
from .common import (TaskContext, append_log, build_state,
                     epoch_opt_steps, is_main_process,
                     eval_model, reference_loader,
                     make_task_step, maybe_resume_epochs,
                     save_task_checkpoint, step_generator, train_epoch)


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


@partitioning.unsharded_eval
def encode_corpus(model, eval_data, batch_size: int,
                  text_batch_size: int = 0, timings: Optional[dict] = None):
    """Stage 1 → (image embeds, image feats, text embeds, text feats, text
    atts): the embeds and atts as tensors on the model's device, the feats
    as f32 numpy arrays. Texts go in batches of `text_batch_size` where it
    is set, else `batch_size`. `timings` gets the host seconds of the image
    and the text passes (`images_s`, `texts_s`; each ends on reading its
    features back)."""
    dev = _device_of(model)
    t0 = time.perf_counter()
    text_batch_size = text_batch_size or batch_size
    img_embeds, img_feats = [], []
    for images in eval_data.image_batches(batch_size):
        e, f = model.encode_images(torch.as_tensor(images).to(dev))
        img_embeds.append(e)
        img_feats.append(f.float().cpu().numpy())
    t1 = time.perf_counter()
    txt_embeds, txt_feats, txt_atts = [], [], []
    for ids, atts in eval_data.text_batches(text_batch_size):
        ids = torch.as_tensor(np.asarray(ids, np.int64)).to(dev)
        atts = torch.as_tensor(np.asarray(atts, np.int64)).to(dev)
        e, f = model.encode_texts(ids, atts)
        txt_embeds.append(e)
        txt_feats.append(f.float().cpu().numpy())
        txt_atts.append(atts)
    if timings is not None:
        timings.update(images_s=t1 - t0, texts_s=time.perf_counter() - t1)
    return (torch.cat(img_embeds), np.concatenate(img_feats),
            torch.cat(txt_embeds), np.concatenate(txt_feats),
            torch.cat(txt_atts))


@partitioning.unsharded_eval
def rerank_scores(model, img_embeds, txt_embeds, txt_atts, sims,
                  k_test: int, chunk: int = 8,
                  process_index: Optional[int] = None,
                  process_count: Optional[int] = None,
                  timings: Optional[dict] = None):
    """Stage 2: ITM logits on the top-k_test candidates of each row in both
    directions → (score_i2t [n_img, n_txt], score_t2i [n_txt, n_img]) f32,
    -100 off the candidate sets. A process scores the rows
    process_index, process_index + process_count, ... only (by default
    its rank and the world size of an initialized process group, else all
    rows); `merge_rerank_scores` combines the slices. `XFM_EVAL_GROUPED`
    = "0" scores image → text in the repeat form too. `timings` gets the
    host seconds of each direction (`i2t_s`, `t2i_s`; every chunk ends on
    reading its scores back)."""
    pid = mesh.dp_rank() if process_index is None else process_index
    pcount = mesh.dp_size() if process_count is None else process_count
    t0 = time.perf_counter()
    dev = img_embeds.device

    def idx(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    n_img, n_txt = sims.shape
    score_i2t = np.full((n_img, n_txt), -100.0, np.float32)
    topk_t = np.argsort(-sims, axis=1)[:, :k_test]
    my_img_rows = np.arange(pid, n_img, pcount)
    grouped = os.environ.get("XFM_EVAL_GROUPED", "1") == "1"
    for s in range(0, len(my_img_rows), chunk):
        rows = my_img_rows[s:s + chunk]
        # image-major: row j·k_test + c is candidate c of image rows[j]
        cand = idx(topk_t[rows].reshape(-1))
        if grouped:
            scores = model.itm_scores(img_embeds[idx(rows)], txt_embeds[cand],
                                      txt_atts[cand],
                                      image_group_size=k_test)
        else:
            im = img_embeds[idx(np.repeat(rows, k_test))]
            scores = model.itm_scores(im, txt_embeds[cand], txt_atts[cand])
        scores = scores.float().cpu().numpy().reshape(len(rows), k_test)
        for j, r in enumerate(rows):
            score_i2t[r, topk_t[r]] = scores[j]

    t1 = time.perf_counter()
    score_t2i = np.full((n_txt, n_img), -100.0, np.float32)
    topk_i = np.argsort(-sims.T, axis=1)[:, :k_test]
    my_txt_rows = np.arange(pid, n_txt, pcount)
    for s in range(0, len(my_txt_rows), chunk):
        rows = my_txt_rows[s:s + chunk]
        rep = idx(np.repeat(rows, k_test))
        scores = model.itm_scores(img_embeds[idx(topk_i[rows].reshape(-1))],
                                  txt_embeds[rep], txt_atts[rep])
        scores = scores.float().cpu().numpy().reshape(len(rows), k_test)
        for j, r in enumerate(rows):
            score_t2i[r, topk_i[r]] = scores[j]
    if timings is not None:
        timings.update(i2t_s=t1 - t0, t2i_s=time.perf_counter() - t1)
    return score_i2t, score_t2i


def merge_rerank_scores(score_i2t, score_t2i, chunk: int = 1024):
    """The processes' row slices combined: every row is scored by one
    process and holds the -100 fill on the others, so the sum over the
    processes plus (P − 1)·100 is the owner's value, exactly: the sum runs
    in f64, where the f32 scores and the ±100 steps are exact (an f32 sum
    would round through them; an elementwise max would clamp a logit below
    -100). Gathered in row chunks of `chunk`, so that the host holds
    P × chunk rows at a time. A no-op on one process."""
    pcount = mesh.dp_size()
    if pcount == 1:
        return score_i2t, score_t2i
    shift = 100.0 * (pcount - 1)

    def merge(mat):
        out = np.empty_like(mat)
        for s in range(0, mat.shape[0], chunk):
            part = mesh.all_gather_numpy(mat[s:s + chunk])
            out[s:s + chunk] = (part.astype(np.float64).sum(axis=0)
                                + shift).astype(mat.dtype)
        return out

    return merge(score_i2t), merge(score_t2i)


def itm_eval(score_i2t, score_t2i, img2txt, txt2img) -> dict:
    """R@1/5/10 in both directions, their means and the mean of both."""
    ranks = np.zeros(score_i2t.shape[0])
    for i, row in enumerate(score_i2t):
        order = np.argsort(-row)
        best = 1e20
        for t in img2txt[i]:
            r = np.where(order == t)[0][0]
            best = min(best, r)
        ranks[i] = best
    tr1, tr5, tr10 = [100.0 * np.mean(ranks < k) for k in (1, 5, 10)]

    ranks = np.zeros(score_t2i.shape[0])
    for t, row in enumerate(score_t2i):
        order = np.argsort(-row)
        ranks[t] = np.where(order == txt2img[t])[0][0]
    ir1, ir5, ir10 = [100.0 * np.mean(ranks < k) for k in (1, 5, 10)]

    tr_mean = (tr1 + tr5 + tr10) / 3
    ir_mean = (ir1 + ir5 + ir10) / 3
    return dict(txt_r1=tr1, txt_r5=tr5, txt_r10=tr10, img_r1=ir1,
                img_r5=ir5, img_r10=ir10, txt_r_mean=tr_mean,
                img_r_mean=ir_mean, r_mean=(tr_mean + ir_mean) / 2)


def evaluation(model, eval_data, config: dict,
               timings: Optional[dict] = None) -> dict:
    """The whole eval: stage 1 at `batch_size_test` (texts at
    `batch_size_test_text` where set), the similarities, stage 2 at
    `k_test` (at most the corpus' sizes), R@K. `timings` gets the stages'
    host seconds (`encode_corpus`'s and `rerank_scores`')."""
    img_embeds, img_feats, txt_embeds, txt_feats, txt_atts = encode_corpus(
        model, eval_data, config.get("batch_size_test", 32),
        config.get("batch_size_test_text", 0), timings)
    sims = img_feats @ txt_feats.T
    k_test = min(config.get("k_test", 256), sims.shape[1], sims.shape[0])
    s_i2t, s_t2i = rerank_scores(model, img_embeds, txt_embeds, txt_atts,
                                 sims, k_test, timings=timings)
    s_i2t, s_t2i = merge_rerank_scores(s_i2t, s_t2i)
    metrics = None
    if is_main_process():
        metrics = itm_eval(s_i2t, s_t2i, eval_data.img2txt,
                           eval_data.txt2img)
    return mesh.broadcast_object(metrics)


def build_tokenizer_or_fallback(cfg, texts_fn=None):
    """The config's `text_encoder` tokenizer, or, where it cannot be read, a
    `SimpleTokenizer` over the texts `texts_fn` returns."""
    from ..data.tokenization import SimpleTokenizer, build_tokenizer

    try:
        return build_tokenizer(cfg["text_encoder"])
    except Exception:
        print("### falling back to SimpleTokenizer", flush=True)
        return SimpleTokenizer.from_texts(texts_fn() if texts_fn else [])


def _ann_texts(ann_file):
    if isinstance(ann_file, str):
        ann_file = [ann_file]
    texts = []
    for f in ann_file:
        with open(f) as fh:
            for a in json.load(fh):
                c = a.get("caption", "")
                texts.extend(c if isinstance(c, list) else [c])
    return texts


def _maybe_shrink_vocab(mcfg, tokenizer):
    """The text and fusion vocabularies set to the tokenizer's (at least 16)
    where they differ."""
    vs = getattr(tokenizer, "vocab_size", None)
    if vs and vs != mcfg.text.vocab_size:
        text = dataclasses.replace(mcfg.text, vocab_size=max(vs, 16))
        fusion = dataclasses.replace(mcfg.fusion, vocab_size=max(vs, 16))
        mcfg = dataclasses.replace(mcfg, text=text, fusion=fusion)
    return mcfg


def main(args):
    """Random weights from `--seed`, overlaid by `--checkpoint` where
    given. `--evaluate`: `evaluation` on the config's test (else val)
    annotations → the metrics, printed and appended to
    <output_dir>/log.txt. Otherwise the fine-tune on `train_file`: a
    zero-shot eval, then per epoch a pass over the shuffled pairs, an eval,
    the log line and the checkpoints → {"best_r_mean": ...} (the zero-shot
    metrics with `epochs: 0`)."""
    ctx = TaskContext.from_args(args)
    cfg = ctx.config
    image_res = cfg.get("image_res", 384)
    max_tokens = cfg.get("max_tokens", 40)
    eval_ann = cfg.get("test_file") or cfg.get("val_file")
    train_ann = cfg.get("train_file")
    tokenizer = build_tokenizer_or_fallback(
        cfg, lambda: _ann_texts(train_ann or eval_ann))
    mcfg = config_from_yaml(cfg, use_contrastive_loss=True,
                            use_matching_loss=True)
    mcfg = _maybe_shrink_vocab(mcfg, tokenizer)
    with torch.device(ctx.device):  # built there: no host init, no copy
        model = XFMForRetrieval(mcfg).to(ctx.device)
    test_data = RetrievalEvalData(eval_ann, TestTransform(image_res),
                                  cfg["image_root"], tokenizer,
                                  max_tokens=max_tokens)
    load = reference_loader(args.checkpoint)
    if args.evaluate:
        eval_model(ctx, model, load)
    else:
        bsz = cfg.get("batch_size_train", 32)
        train_data = RetrievalTrainData(
            train_ann, TrainTransform(image_res), cfg["image_root"],
            tokenizer, max_tokens=max_tokens, batch_size=bsz)
        state, sched = build_state(
            ctx, model, epoch_opt_steps(cfg, len(train_data), bsz),
            load=load)
    if args.evaluate:
        metrics = evaluation(model, test_data, cfg)
        if is_main_process():
            print(metrics, flush=True)
            append_log(ctx.out_dir, {"eval": metrics})
        return metrics

    step_fn, accum = make_task_step(ctx, functools.partial(
        retrieval_loss_fn, deterministic=False))
    state, start_epoch = maybe_resume_epochs(ctx, state)
    zs = evaluation(model, test_data, cfg)
    append_log(ctx.out_dir, {"epoch": -1, **zs})
    if is_main_process():
        print(f"zero-shot: {zs}", flush=True)
    best = zs["r_mean"]
    epochs = int(cfg.get("schedular", {}).get("epochs", 5))
    if epochs == 0:
        return zs
    for epoch in range(start_epoch, epochs):
        loader = train_data.epoch(epoch_seed=ctx.seed + epoch)
        state, stats = train_epoch(ctx, state, step_fn, loader,
                                   step_generator(ctx, epoch), epoch, sched,
                                   accum_steps=accum)
        metrics = evaluation(model, test_data, cfg)
        append_log(ctx.out_dir, {"epoch": epoch, **stats, **metrics})
        if is_main_process():
            print(f"epoch {epoch}: {metrics}", flush=True)
        save_task_checkpoint(ctx, state, epoch)
        if metrics["r_mean"] > best:
            best = metrics["r_mean"]
            save_task_checkpoint(ctx, state, epoch, name="ckpt_best",
                                  keep=1)
    return {"best_r_mean": best}
