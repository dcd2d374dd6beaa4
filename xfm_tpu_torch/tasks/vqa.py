"""VQA: the fine-tune and the answer-ranking eval (`xfm_tpu/tasks/vqa.py`,
`run.py --task vqa`).

The fine-tune trains `XFMForVQA`'s weighted causal answer loss over
`VQAData`'s flat answer layout, dropout and drop-path live, its masks
drawn from a generator seeded from (seed, epoch); a checkpoint after
every epoch (`ckpt/<epoch>`, the two newest kept), the test split ranked
after every epoch from `start_eval` on but the last, and always at the end;
`resume: true` continues after the newest `ckpt/` epoch. The eval ranks
the YAML's `answer_list` for every test question (`XFMForVQA.rank`, the
top `k_test` first tokens, then the chain-rule re-rank) and writes
<output_dir>/result/vqa_result.json; where the test annotations hold
answers, the exact-match accuracy (one answer a question) and the official
accuracy (a list of human answers) are printed and logged.

A `--checkpoint` is imported as the JAX package does: its own decoder
where it has one and the run evaluates (or the YAML sets
`load_vqa_pretrain`), otherwise the decoder copied from its fusion encoder
(`train/checkpoint.vqa_checkpoint`). Where the `text_encoder`'s tokenizer
files are missing, the fallback SimpleTokenizer is built over the
questions and answers of the train and test files and the answer list
(the JAX package builds it over no text at all).

Under a process group each rank trains on its rows of every global batch
(`data/finetune_data`) and ranks the test questions r, r + W, …;
`collect_results` merges the ranks' results on rank 0, which computes the
accuracies that every rank returns.
"""
from __future__ import annotations

import functools
import json
import os

import numpy as np
import torch

from ..core import mesh, partitioning
from ..data.finetune_data import VQAData, _load_ann
from ..data.transforms import TestTransform, TrainTransform
from ..eval.vqa_eval import vqa_accuracy
from ..models import XFMForVQA, config_from_yaml
from ..train.train_state import vqa_loss_fn
from .common import (TaskContext, append_log, build_state,
                     epoch_opt_steps, is_main_process,
                     make_task_step, maybe_resume_epochs, eval_model,
                     save_task_checkpoint, step_generator, train_epoch)
from .retrieval import (_device_of, _maybe_shrink_vocab,
                        build_tokenizer_or_fallback)


def collect_results(result: list, out_dir: str, filename: str) -> str:
    """This process's results written as its shard
    (<out_dir>/<filename>_rank<r>.json); after a barrier rank 0 merges the
    shards into <out_dir>/<filename>.json → the merged file's path, which
    every rank may read once this returns. Rank r holds the examples r,
    r + W, … of the split (`data/finetune_data`), so the merge interleaves
    the shards back into the split's order. r and W count the ranks that
    split the batch (`mesh.dp_rank`, `dp_size`); the first rank of each
    tensor group writes its group's shard."""
    r, pcount = mesh.dp_rank(), mesh.dp_size()
    os.makedirs(out_dir, exist_ok=True)
    if mesh.tensor_rank() == 0:
        with open(os.path.join(out_dir, f"{filename}_rank{r}.json"),
                  "w") as f:
            json.dump(result, f)
    mesh.barrier()
    final = os.path.join(out_dir, f"{filename}.json")
    if is_main_process():
        shards = []
        for k in range(pcount):
            with open(os.path.join(out_dir, f"{filename}_rank{k}.json")) as f:
                shards.append(json.load(f))
        merged = [shards[i % pcount][i // pcount]
                  for i in range(sum(map(len, shards)))]
        with open(final, "w") as f:
            json.dump(merged, f)
    mesh.barrier()
    return final


@partitioning.unsharded_eval
def evaluate(model, data: VQAData, k: int, out_dir: str,
             tag: str = "") -> str:
    """Each test question's top-ranked answer of the answer list →
    the path of <out_dir>/result/vqa_result[_<tag>].json, [{question_id,
    answer}]."""
    dev = _device_of(model)

    def to(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t if dtype is None else t.to(dtype)

    ids, atts = data.encode_answer_list()
    ans_ids, ans_atts = to(ids, torch.int64), to(atts, torch.int64)
    results = []
    for batch in data.epoch():
        topk_ids, _ = model.rank(to(batch["images"]),
                                 to(batch["q_ids"], torch.int64),
                                 to(batch["q_atts"], torch.int64), ans_ids,
                                 ans_atts, k)
        for qid, aid in zip(batch["question_id"],
                            topk_ids[:, 0].cpu().tolist()):
            results.append({"question_id": int(qid),
                            "answer": data.answer_list[aid]})
    return collect_results(results, os.path.join(out_dir, "result"),
                           "vqa_result" + (f"_{tag}" if tag else ""))


def calculate_acc(result_path: str, data: VQAData) -> dict:
    """The accuracies where the test annotations hold answers:
    `vqa_acc_exact` over the questions with one answer (a string), the
    official `vqa_acc_official` over those with a list of human answers;
    {} where none do."""
    exact_gt, multi_gt = {}, {}
    for ann in data.ann:
        qid = ann.get("question_id")
        if qid is None:
            continue
        if isinstance(ann.get("answer"), str):
            exact_gt[int(qid)] = ann["answer"].strip()
        elif isinstance(ann.get("answer"), list) and ann["answer"]:
            multi_gt[int(qid)] = [str(a) for a in ann["answer"]]
    if not exact_gt and not multi_gt:
        return {}
    with open(result_path) as f:
        preds = json.load(f)
    out = {}
    if exact_gt:
        hits = [p["answer"].strip() == exact_gt[int(p["question_id"])]
                for p in preds if int(p["question_id"]) in exact_gt]
        if hits:
            out["vqa_acc_exact"] = sum(hits) / len(hits)
    if multi_gt:
        out["vqa_acc_official"] = vqa_accuracy(preds, multi_gt)
    return out


def vqa_texts(cfg: dict) -> list:
    """The questions and answers of the train and test files and the
    answer list: the words of a fallback tokenizer."""
    texts = []
    for key in ("train_file", "test_file"):
        if not cfg.get(key):
            continue
        for a in _load_ann(cfg[key]):
            texts.append(a.get("question", ""))
            ans = a.get("answer", [])
            texts.extend(ans if isinstance(ans, list) else [ans])
    if cfg.get("answer_list"):
        with open(cfg["answer_list"]) as f:
            texts.extend(json.load(f))
    return texts


def _report(ctx: TaskContext, path: str, data: VQAData,
            epoch=None) -> dict:
    acc = mesh.broadcast_object(calculate_acc(path, data)
                                if is_main_process() else {})
    if acc:
        if is_main_process():
            print(acc, flush=True)
        append_log(ctx.out_dir, acc if epoch is None
                   else {"epoch": epoch, **acc})
    return acc


def main(args) -> dict:
    """Random weights from `--seed`, overlaid by `--checkpoint` where given.
    `--evaluate`: the ranking of the test split alone. Otherwise the
    fine-tune on `train_file` (VQA and Visual Genome rows), with its
    per-epoch checkpoints and evals, and the final eval. → {"result_file":
    the final result's path, and the accuracies where the test split has
    answers}."""
    ctx = TaskContext.from_args(args)
    cfg = ctx.config
    image_res = cfg.get("image_res", 480)
    tokenizer = build_tokenizer_or_fallback(cfg,
                                            lambda: vqa_texts(cfg))
    with torch.device(ctx.device):  # built there: no host init, no copy
        model = XFMForVQA.from_yaml(
            cfg, _maybe_shrink_vocab(config_from_yaml(cfg), tokenizer),
            pad_token_id=getattr(tokenizer, "pad_token_id", 1)
        ).to(ctx.device)
    roots = {"vqa": cfg.get("vqa_root", "."), "vg": cfg.get("vg_root", ".")}
    test_data = VQAData(cfg["test_file"], TestTransform(image_res), roots,
                        tokenizer, batch_size=cfg.get("batch_size_test", 16),
                        split="test", answer_list=cfg.get("answer_list"))
    k = cfg.get("k_test", 128)
    load = None
    if args.checkpoint:
        def load(m):
            from ..train.checkpoint import (load_torch_state_dict,
                                            load_xfm_checkpoint,
                                            vqa_checkpoint)

            own = args.evaluate or cfg.get("load_vqa_pretrain", False)
            missing, _ = load_xfm_checkpoint(m, vqa_checkpoint(
                load_torch_state_dict(args.checkpoint), m, own))
            print(f"### loaded {args.checkpoint}: {len(missing)} missing",
                  flush=True)
    if args.evaluate:
        eval_model(ctx, model, load)
    else:
        train_data = VQAData(cfg["train_file"],
                             TrainTransform(image_res, hflip=False), roots,
                             tokenizer,
                             batch_size=cfg.get("batch_size_train", 16),
                             split="train")
        state, sched = build_state(ctx, model, epoch_opt_steps(
            cfg, len(train_data), train_data.batch_size), load=load)
    if args.evaluate:
        path = evaluate(model, test_data, k, ctx.out_dir)
        print("wrote", path, flush=True)
        return {"result_file": path, **_report(ctx, path, test_data)}

    step_fn, accum = make_task_step(ctx, functools.partial(
        vqa_loss_fn, deterministic=False))
    state, start_epoch = maybe_resume_epochs(ctx, state)
    start_eval = int(cfg.get("start_eval", 0))
    epochs = int(cfg.get("schedular", {}).get("epochs", 8))
    for epoch in range(start_epoch, epochs):
        loader = train_data.epoch(epoch_seed=ctx.seed + epoch)
        state, stats = train_epoch(ctx, state, step_fn, loader,
                                   step_generator(ctx, epoch), epoch, sched,
                                   accum_steps=accum)
        append_log(ctx.out_dir, {"epoch": epoch, **stats})
        if is_main_process():
            print(f"epoch {epoch}: {stats}", flush=True)
        save_task_checkpoint(ctx, state, epoch)
        if start_eval <= epoch < epochs - 1:
            _report(ctx, evaluate(model, test_data, k, ctx.out_dir,
                                  tag=f"epoch{epoch}"), test_data, epoch)
    path = evaluate(model, test_data, k, ctx.out_dir)
    print("wrote", path, flush=True)
    return {"result_file": path, **_report(ctx, path, test_data)}
