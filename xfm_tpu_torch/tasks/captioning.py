"""COCO captioning: the fine-tune, SCST, the caption-domain pretrain and
bulk inference (`xfm_tpu/tasks/captioning.py`, `run.py --task
coco_captioning` and `--task infer_caption`).

`main_pipeline` picks the branch from the YAML: `domain_pretrain: true`
runs `main_domain_pretrain` (the LM loss over an image-text JSONL stream at
224 px, the decoder copied from a `--checkpoint`'s text encoder); `scst:
true` runs `train_scst`; otherwise `main`, the fine-tune (captions prefixed
with `prompt`, its first `prompt_length` positions out of the loss,
dropout and drop-path live, a checkpoint each epoch and `resume: true`)
ending in beam-`num_beams` captions of `val_file` scored by BLEU-1..4,
METEOR, ROUGE-L and CIDEr (SPICE None with its note), or with
`--evaluate` the captions and scores alone. In every branch
`--load_ckpt_from` stands for `--checkpoint` where none is given.
`main_infer` captions a directory of images into captions.json.

SCST (`train_scst`): each step decodes the batch greedily (the `greedy`
baseline; `sample` takes the leave-one-out mean of the other samples'
rewards instead) and samples `sc_train_sample_n` captions an image with
top-k / top-p from a generator seeded from (seed, step); CIDEr-D rewards
on the host against the image's train captions; loss = −mean(log p ·
advantage) over the samples' summed log-probabilities (the forced prompt
slots excluded), by a differentiable pass of the samples as contiguous
groups against each image's once-projected k/v.

Where the port differs from the JAX task, on purpose:
- a `--checkpoint` that holds `text_decoder.*` (a caption checkpoint, such
  as this task's own) loads its decoder (`train/checkpoint.
  caption_checkpoint`); the JAX task drops it and decodes with the fusion
  weights or an untrained decoder;
- without the `text_encoder`'s tokenizer files the fallback SimpleTokenizer
  is built over the captions of the train and val files and the prompt
  (the JAX task builds it over no text);
- the special ids are the tokenizer's own (the JAX task's `or` defaults
  turn a pad id of 0 into 1);
- SCST's references are keyed by the parsed image id the batches carry
  (the JAX task keys them by the raw `image_id`, so a "coco_123" id finds
  no reference), and both SCST and the fine-tune save a checkpoint each
  epoch;
- the fine-tune writes its final captions as <output_dir>/result/
  caption_result.json, as `--evaluate` does.

Under a process group each rank trains on its rows of every global batch
(`data/finetune_data`; the domain pretrain on its part of the shards) and
decodes the val images r, r + W, …; rank 0 merges the captions
(`vqa.collect_results`) and scores them. SCST's samples draw from each
rank's own generator. `infer_caption` captions every image on every rank
and rank 0 writes the file.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import mesh, partitioning
from ..data.finetune_data import CaptioningData, _load_ann, caption_image_id
from ..data.transforms import TestTransform, TrainTransform, decode_image
from ..eval.caption_metrics import coco_caption_eval
from ..eval.cider import CiderD
from ..models import XFMForCaptioning, config_from_yaml
from ..models.generation import beam_generate, generate, shift_lm_loss
from ..train.train_state import caption_loss_fn, make_train_step
from .common import (TaskContext, append_log, build_state,
                     epoch_opt_steps, is_main_process,
                     make_task_step, maybe_resume_epochs, eval_model,
                     save_task_checkpoint, step_generator, train_epoch)
from .retrieval import (_device_of, _maybe_shrink_vocab,
                        build_tokenizer_or_fallback)
from .vqa import collect_results


def special_ids(tokenizer):
    """(bos, eos, pad) of the tokenizer: its bos (else cls), eos (else
    sep) and pad ids."""
    def first(*names, default):
        for n in names:
            v = getattr(tokenizer, n, None)
            if v is not None:
                return int(v)
        return default

    return (first("bos_token_id", "cls_token_id", default=0),
            first("eos_token_id", "sep_token_id", default=2),
            first("pad_token_id", default=1))


def prompt_token_ids(tokenizer, prompt: str) -> tuple:
    """The prompt's token ids without specials, as the decoder is seeded
    with them."""
    if not prompt:
        return ()
    try:
        ids = tokenizer(prompt)["input_ids"]
    except Exception:
        ids = tokenizer.encode(prompt)
    ids = np.asarray(ids).reshape(-1).tolist()
    specials = {getattr(tokenizer, a, None) for a in
                ("bos_token_id", "cls_token_id", "sep_token_id",
                 "eos_token_id", "pad_token_id")}
    return tuple(int(i) for i in ids if i not in specials)


def decode_ids(tokenizer, ids, eos_id, pad_id) -> str:
    """The text of `ids` up to the first EOS or pad."""
    toks = []
    for i in ids:
        if i in (eos_id, pad_id):
            break
        toks.append(int(i))
    try:
        return tokenizer.decode(toks, skip_special_tokens=True).strip()
    except Exception:
        return " ".join(map(str, toks))


def caption_texts(cfg: dict) -> list:
    """The captions of the train and val files and the prompt: the words of
    a fallback tokenizer."""
    texts = [cfg.get("prompt", "")]
    for key in ("train_file", "val_file"):
        if not cfg.get(key) or not all(
                os.path.exists(f) for f in ([cfg[key]]
                                            if isinstance(cfg[key], str)
                                            else cfg[key])):
            continue
        for a in _load_ann(cfg[key]):
            c = a.get("caption", "")
            texts.extend(c if isinstance(c, list) else [c])
    return texts


def build_model(cfg: dict, tokenizer, device) -> XFMForCaptioning:
    """`XFMForCaptioning.from_yaml` at the tokenizer's vocabulary and pad
    id, on `device`."""
    mcfg = _maybe_shrink_vocab(config_from_yaml(cfg), tokenizer)
    with torch.device(device):  # built there: no host init, no copy
        return XFMForCaptioning.from_yaml(
            cfg, mcfg, pad_token_id=getattr(tokenizer, "pad_token_id", 1)
        ).to(device)


def load_ckpt_into(model, ckpt_path: str,
                   decoder_from: str = "fusion") -> list:
    """The checkpoint at `ckpt_path` overlaid on `model` through
    `caption_checkpoint` (its own decoder, else the decoder from its
    fusion or text encoder) → the model's entries it did not hold."""
    from ..train.checkpoint import (caption_checkpoint, load_torch_state_dict,
                                    load_xfm_checkpoint)

    missing, _ = load_xfm_checkpoint(model, caption_checkpoint(
        load_torch_state_dict(ckpt_path), decoder_from))
    if is_main_process():
        print(f"### loaded {ckpt_path}: {len(missing)} missing", flush=True)
    return missing


def _captions(model, images: np.ndarray, cfg: dict, ids) -> np.ndarray:
    """Beam search where `num_beams` > 1, greedy otherwise, over one batch
    of host images → the sequences [B, max_length] on the host."""
    bos, eos, pad = ids[:3]
    images = torch.from_numpy(np.ascontiguousarray(images)).to(
        _device_of(model))
    kw = dict(bos_id=bos, eos_id=eos, pad_id=pad,
              max_len=cfg.get("max_length", 20),
              min_len=cfg.get("min_length", 0), prompt_ids=ids[3])
    if cfg.get("num_beams", 1) > 1:
        seqs = beam_generate(model, images, num_beams=cfg["num_beams"], **kw)
    else:
        seqs, _ = generate(model, images, greedy=True, **kw)
    return seqs.cpu().numpy()


@partitioning.unsharded_eval
def generate_captions(model, data: CaptioningData, tokenizer, cfg: dict,
                      prompt_ids: Sequence[int] = ()) -> list:
    """[{image_id, caption}] of every image of `data`, the forced prompt
    slots stripped."""
    ids = special_ids(tokenizer) + (tuple(prompt_ids),)
    results = []
    for batch in data.epoch():
        seqs = _captions(model, batch["images"], cfg, ids)
        for iid, seq in zip(batch["image_id"], seqs):
            results.append({"image_id": int(iid), "caption": decode_ids(
                tokenizer, seq[len(prompt_ids):], ids[1], ids[2])})
    return results


def _score_captions(results: list, cfg: dict) -> dict:
    """`coco_caption_eval` of the results against the captions of
    `val_gt_file` (else `val_file`) of the same image ids."""
    gt_file = cfg.get("val_gt_file") or cfg.get("val_file")
    refs = {}
    for a in _load_ann(gt_file):
        iid = a.get("image_id")
        if iid is None:
            continue
        caps = a["caption"] if isinstance(a["caption"], list) \
            else [a["caption"]]
        refs.setdefault(int(str(iid).split("_")[-1]) if isinstance(iid, str)
                        else int(iid), []).extend(caps)
    hypos = {r["image_id"]: r["caption"] for r in results
             if r["image_id"] in refs}
    refs = {k: v for k, v in refs.items() if k in hypos}
    if not hypos:
        return {"CIDEr": 0.0}
    return coco_caption_eval({str(k): v for k, v in hypos.items()},
                             {str(k): v for k, v in refs.items()})


def _evaluate(ctx: TaskContext, model, data, tokenizer, pids) -> dict:
    """This rank's captions, merged on rank 0 (`collect_results`), which
    scores them → the scores, on every rank."""
    results = generate_captions(model, data, tokenizer, ctx.config, pids)
    path = collect_results(results, os.path.join(ctx.out_dir, "result"),
                           "caption_result")
    metrics = None
    if is_main_process():
        with open(path) as f:
            metrics = _score_captions(json.load(f), ctx.config)
        print("wrote", path, flush=True)
        print(metrics, flush=True)
    return mesh.broadcast_object(metrics)


def main(args, scst: bool = False) -> dict:
    """Random weights from `--seed`, overlaid by `--checkpoint` where given.
    `--evaluate`: the captions of `val_file` and their scores alone.
    Otherwise the fine-tune on `train_file` (or with `scst` `train_scst`)
    with a checkpoint each epoch, then the captions and scores → the
    metrics."""
    ctx = TaskContext.from_args(args)
    cfg = ctx.config
    image_res = cfg.get("image_res", 384)
    tokenizer = build_tokenizer_or_fallback(cfg,
                                            lambda: caption_texts(cfg))
    model = build_model(cfg, tokenizer, ctx.device)
    val_data = CaptioningData(cfg["val_file"], TestTransform(image_res),
                              cfg["image_root"], tokenizer,
                              batch_size=cfg.get("batch_size_test", 16),
                              train=False)
    pids = prompt_token_ids(tokenizer, cfg.get("prompt", ""))
    load = ((lambda m: load_ckpt_into(m, args.checkpoint))
            if args.checkpoint else None)
    if args.evaluate:
        eval_model(ctx, model, load)
    else:
        train_data = CaptioningData(
            cfg["train_file"], TrainTransform(image_res, hflip=False),
            cfg["image_root"], tokenizer,
            max_tokens=cfg.get("max_tokens", 30),
            batch_size=cfg.get("batch_size_train", 16), train=True,
            prompt=cfg.get("prompt", ""))
        state, sched = build_state(ctx, model, epoch_opt_steps(
            cfg, len(train_data), train_data.batch_size), load=load)
    if args.evaluate:
        metrics = _evaluate(ctx, model, val_data, tokenizer, pids)
        append_log(ctx.out_dir, {"final": metrics})
        return metrics
    if scst:
        state = train_scst(ctx, state, train_data, tokenizer)
    else:
        step_fn, accum = make_task_step(ctx, functools.partial(
            caption_loss_fn, deterministic=False))
        state, start_epoch = maybe_resume_epochs(ctx, state)
        for epoch in range(start_epoch,
                           int(cfg.get("schedular", {}).get("epochs", 5))):
            loader = train_data.epoch(epoch_seed=ctx.seed + epoch)
            state, stats = train_epoch(ctx, state, step_fn, loader,
                                       step_generator(ctx, epoch), epoch,
                                       sched, accum_steps=accum)
            append_log(ctx.out_dir, {"epoch": epoch, **stats})
            if is_main_process():
                print(f"epoch {epoch}: {stats}", flush=True)
            save_task_checkpoint(ctx, state, epoch)
    metrics = _evaluate(ctx, model, val_data, tokenizer, pids)
    append_log(ctx.out_dir, {"final": metrics})
    return metrics


def sequence_logp(model, images, seqs, bos_id: int, pad_id: int,
                  prompt_len: int, group_size: int) -> torch.Tensor:
    """Each sequence's summed log-probability [N] (differentiable): BOS
    prepended, pads and the BOS + forced prompt slots out of the sum, the
    image's `group_size` sequences contiguous rows against its
    once-projected k/v, no padding mask (as the JAX task's `logp_fn`)."""
    image_embeds = model.encode_images(images)
    full = torch.cat([torch.full((seqs.shape[0], 1), bos_id,
                                 dtype=seqs.dtype, device=seqs.device),
                      seqs], 1)
    logits = model.decode(full, None, image_embeds,
                          image_group_size=group_size)
    labels = torch.where(full == pad_id, torch.full_like(full, -100), full)
    if prompt_len:
        pos = torch.arange(labels.shape[1], device=labels.device)[None]
        labels = torch.where(pos <= prompt_len,
                             torch.full_like(labels, -100), labels)
    return -shift_lm_loss(logits, labels)


def scst_advantages(rewards: np.ndarray, n: int,
                    greedy_rewards: Optional[np.ndarray] = None
                    ) -> np.ndarray:
    """The samples' rewards [B·n] less their baseline: the image's greedy
    reward, or without one the leave-one-out mean of its other samples'
    rewards → f32 [B·n]."""
    if greedy_rewards is not None:
        return (rewards - np.repeat(greedy_rewards, n)).astype(np.float32)
    sc = rewards.reshape(-1, n)
    base = (sc.sum(1, keepdims=True) - sc) / (n - 1)
    return (sc - base).reshape(-1).astype(np.float32)


def scst_loss(model, images, seqs, advantages, bos_id: int, pad_id: int,
              prompt_len: int, group_size: int) -> torch.Tensor:
    """−mean(log p(sequence) · advantage)."""
    logp = sequence_logp(model, images, seqs, bos_id, pad_id, prompt_len,
                         group_size)
    return -(logp * advantages).mean()


def make_scst_step(cfg: dict, cider: CiderD, tokenizer, ids):
    """SCST's step for the YAML's `sc_train_sample_n` (5), `sc_baseline_type`
    (greedy | sample), `max_length`, `sample_top_k` and `sample_top_p`,
    with `ids` = (bos, eos, pad, prompt ids) → step(state, images, iids,
    generator) -> (state, {loss, reward}): the greedy decode (its rewards
    the baseline), the samples drawn from `generator`, their CIDEr-D
    rewards against `cider`'s references of the images `iids`, and one
    update of `scst_loss`."""
    bos, eos, pad, pids = ids
    P = len(pids)
    n = int(cfg.get("sc_train_sample_n", cfg.get("scst_num_samples", 5)))
    baseline = cfg.get("sc_baseline_type", "greedy")
    if baseline not in ("greedy", "sample"):
        raise ValueError(f"sc_baseline_type {baseline!r}")
    if baseline == "sample" and n < 2:
        raise ValueError("sc_baseline_type: sample needs sc_train_sample_n "
                         ">= 2 (leave-one-out baseline)")
    kw = dict(bos_id=bos, eos_id=eos, pad_id=pad,
              max_len=cfg.get("max_length", 20), prompt_ids=pids)

    def step(state, images, iids, generator):
        model = state.model
        greedy_rew = None
        # the decodes stop when their rows are done: the whole model on
        # every rank for them (`core/partitioning.unsharded`)
        with partitioning.unsharded(model):
            if baseline == "greedy":
                greedy, _ = generate(model, images, greedy=True, **kw)
                greedy_rew = _reward(cider, tokenizer, greedy[:, P:], iids,
                                     eos, pad, 1)
            samples, _ = generate(model, images, greedy=False,
                                  generator=mesh.rank_generator(generator),
                                  top_k=int(cfg.get("sample_top_k", 0)),
                                  top_p=float(cfg.get("sample_top_p", 1.0)),
                                  num_return_sequences=n, **kw)
        rew = _reward(cider, tokenizer, samples[:, P:], iids, eos, pad, n)
        adv = torch.from_numpy(scst_advantages(rew, n, greedy_rew)).to(
            images.device)
        for p in model.parameters():
            p.grad = None
        loss = scst_loss(model, images, samples, adv, bos, pad, P, n)
        loss.backward()
        state.apply_gradients()
        return state, {"loss": loss.detach(), "reward": float(rew.mean())}

    return step


def scst_references(ann: list) -> dict:
    """The train captions of each image, keyed by the parsed image id the
    batches carry (as a string)."""
    refs = {}
    for a in ann:
        refs.setdefault(str(caption_image_id(a)), []).append(a["caption"])
    return refs


def train_scst(ctx: TaskContext, state, train_data: CaptioningData,
               tokenizer):
    """SCST epochs over `train_data` (`schedular.epochs`, 3 by default),
    step i's samples drawn from the generator of (seed, i), a checkpoint
    after each epoch → the state."""
    from ..train.metrics import MetricLogger

    cfg = ctx.config
    pids = prompt_token_ids(tokenizer, cfg.get("prompt", ""))
    step_fn = make_scst_step(cfg, CiderD(scst_references(train_data.ann)),
                             tokenizer,
                             special_ids(tokenizer) + (pids,))
    dev = _device_of(state.model)
    step = 0
    for epoch in range(int(cfg.get("schedular", {}).get("epochs", 3))):
        logger = MetricLogger()
        for batch in train_data.epoch(epoch_seed=ctx.seed + epoch):
            state, m = step_fn(state, torch.from_numpy(batch["images"]).to(
                dev), [str(i) for i in batch["image_id"]],
                step_generator(ctx, step))
            loss = m["loss"].item()
            logger.update(loss=loss, reward=m["reward"])
            if step % 50 == 0 and is_main_process():
                print(f"scst step {step}: loss {loss:.4f} reward "
                      f"{m['reward']:.3f}", flush=True)
            step += 1
        append_log(ctx.out_dir, {"epoch": epoch, "scst": True,
                                 **logger.synced_global_avg()})
        save_task_checkpoint(ctx, state, epoch)
    return state


def _reward(cider: CiderD, tokenizer, seqs, iids, eos, pad,
            n: int) -> np.ndarray:
    """CIDEr-D of each decoded sequence against its image's references
    (row j is image j // n's) → f32 [rows]."""
    per = []
    for j, seq in enumerate(np.asarray(torch.as_tensor(seqs).cpu())):
        per.append(cider.score_one(iids[j // n],
                                   decode_ids(tokenizer, seq, eos, pad)))
    return np.asarray(per, np.float32)


def main_domain_pretrain(args) -> dict:
    """The caption-domain pretrain: the LM loss over `train_file`'s
    image-text JSONL (`ImageTextStream` at `image_res`, 224 by default, no
    flip), dropout live, `max_steps` steps (1,000 by default), printing
    every `print_freq`; the decoder copied from `--checkpoint`'s text
    encoder; the state saved at the end (<out>/ckpt/<max_steps>) → the
    running averages."""
    from ..data.pretrain_data import ImageTextStream
    from ..data.prefetch import StreamBatches
    from ..train.metrics import MetricLogger
    from .pretrain import corpus_texts

    ctx = TaskContext.from_args(args)
    cfg = ctx.config
    image_res = cfg.get("image_res", 224)
    tokenizer = build_tokenizer_or_fallback(cfg, lambda: corpus_texts(cfg))
    model = build_model(cfg, tokenizer, ctx.device)
    rank, world = mesh.dp_rank(), mesh.dp_size()
    stream = ImageTextStream(cfg["train_file"], cfg, tokenizer,
                             TrainTransform(image_res, hflip=False,
                                            seed=mesh.rank_seed([ctx.seed,
                                                                 1])),
                             rank=rank, world_size=world,
                             with_image_mask=False)
    state, sched = build_state(ctx, model, 1, load=(
        (lambda m: load_ckpt_into(m, args.checkpoint, decoder_from="text"))
        if args.checkpoint else None))
    step_fn = make_train_step(functools.partial(caption_loss_fn,
                                                deterministic=False))
    max_steps = int(cfg.get("max_steps", 1000))
    print_freq = cfg.get("print_freq", 50)
    logger = MetricLogger()
    keys = ("images", "text_ids", "text_atts")
    batches = StreamBatches({"image": ({k: b[k] for k in keys}
                                       for b in stream)}, ctx.device)
    source = iter(batches)
    try:
        for step in range(max_steps):
            batch = next(source)["image"]
            state, metrics = step_fn(state, batch, step_generator(ctx, step))
            logger.update(loss=metrics["loss"].item())
            if step % print_freq == 0 and is_main_process():
                print(f"caption-pt step {step}: loss "
                      f"{metrics['loss'].item():.4f}", flush=True)
    finally:
        batches.close()
    save_task_checkpoint(ctx, state, max_steps)
    stats = logger.synced_global_avg()
    append_log(ctx.out_dir, {"step": max_steps, **stats})
    return stats


def main_pipeline(args) -> dict:
    """`run.py --task coco_captioning`: the domain pretrain where the YAML
    sets `domain_pretrain`, else the fine-tune (SCST where it sets
    `scst`); `--load_ckpt_from` read as `--checkpoint` where none is
    given."""
    from ..core.config import load_config

    cfg = load_config(args.config)
    if getattr(args, "load_ckpt_from", None) and not args.checkpoint:
        args.checkpoint = args.load_ckpt_from
    if cfg.get("domain_pretrain", False):
        return main_domain_pretrain(args)
    return main(args, scst=bool(cfg.get("scst", False)))


def main_infer(args) -> list:
    """`run.py --task infer_caption`: a caption for every image of
    `image_dir` (or `img_rdir`), in the order of the file names, in
    batches of `batch_size_test` → [{image, caption}], also written to
    <output_dir>/captions.json."""
    ctx = TaskContext.from_args(args)
    cfg = ctx.config
    if getattr(args, "load_ckpt_from", None) and not args.checkpoint:
        args.checkpoint = args.load_ckpt_from
    tokenizer = build_tokenizer_or_fallback(cfg,
                                            lambda: caption_texts(cfg))
    model = build_model(cfg, tokenizer, ctx.device)
    eval_model(ctx, model, (lambda m: load_ckpt_into(m, args.checkpoint))
               if args.checkpoint else None)
    tt = TestTransform(cfg.get("image_res", 384))
    img_dir = cfg.get("image_dir") or cfg["img_rdir"]
    files = sorted(os.listdir(img_dir))
    pids = prompt_token_ids(tokenizer, cfg.get("prompt", ""))
    ids = special_ids(tokenizer) + (pids,)
    bs = cfg.get("batch_size_test", 16)
    results = []
    with partitioning.unsharded(model):
        for s in range(0, len(files), bs):
            chunk = files[s:s + bs]
            imgs = np.stack([tt(decode_image(os.path.join(img_dir, f)))
                             for f in chunk])
            for f, seq in zip(chunk, _captions(model, imgs, cfg, ids)):
                results.append({"image": f, "caption": decode_ids(
                    tokenizer, seq[len(pids):], ids[1], ids[2])})
    out = os.path.join(ctx.out_dir, "captions.json")
    if is_main_process():
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
        print("wrote", out, flush=True)
    return results
