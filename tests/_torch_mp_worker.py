"""The port's data-parallel cases (`xfm_tpu_torch/core/mesh.py`), run by
`tests/test_torch_distributed.py` twice: in the test's own process (one
process, the global batch) and as each of two gloo processes on the CPU
(this file as a script), each given its half of every global batch.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_mp_worker.py SPEC OUT

SPEC (`torch.save`) holds the tiny XFMForPretrain's state dict, the
global batches and the injected negatives; the process writes what each
case gives to OUT/rank<r>.pt. The cases:
  a. one pretrain step with injected negatives (HF-AdamW, clip 1.0);
  b. the same with negatives drawn from the shared generator;
  c. gradient accumulation, K = 2;
  d. a stream step (image-text, ImageNet, text) leaving towers unused;
  r. one retrieval fine-tune step (idx-aware ITC and negatives, image ids
     shared by rows of both ranks), with the shared cross-k/v form of the
     negative pass and without;
  e. unequal masked-token and masked-patch counts across the ranks, and
     the bbox and VQ-KD MIM losses over unequal counts;
  f. dropout masks from the rank generators, draws from the shared ones;
  g. `merge_rerank_scores` of the ranks' row slices;
  h. `collect_results` of the ranks' shards;
  k. `rank_rows` / `rank_strided` of an order.

With SPEC's `suite` "tasks" (`tests/test_torch_distributed_tasks.py`)
the process runs `run_task_cases` instead: one step of NLVR, grounding's
stage 2, the ImageNet fine-tune (mixup off), the linear probe (LARS),
GLUE and classify's fused branch, each on the rank's rows of a global
batch of 4; each task's eval on a split of 5 rows in batches of 2 (W
does not divide it); and the ImageNet loader's mixup over the rank's
rows.
"""
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

KW = dict(hidden=64, layers=2, heads=2, inter=128, image_res=64, vocab=99)
B, T, M, NP = 4, 8, 3, 16
NEG = (np.array([1, 2, 3, 0]), np.array([2, 3, 0, 1]))
LR = 1e-3


def make_spec(state_dict) -> dict:
    """The global batches of every case (numpy, seeded)."""
    from xfm_tpu_torch.configs import make_batch

    base = make_batch(B, T, M, 64, NP, 99)
    big = make_batch(2 * B, T, M, 64, NP, 99, seed=1)
    uneven = {k: v.copy() for k, v in base.items()}
    uneven["masked_ids"][0, 1:] = -100  # rank 0: 1 + 3 tokens, rank 1: 6
    uneven["image_mask"][0] = False
    uneven["image_mask"][0, :2] = True  # rank 0: 2 + 5 patches, rank 1: 10
    uneven["image_mask"][3, :9] = True
    r = np.random.RandomState(7)
    return dict(
        state_dict={k: v.clone() for k, v in state_dict.items()},
        batch=base, big=big, uneven=uneven, neg=NEG,
        boxes=(r.uniform(0.2, 0.6, (B, 4)).astype(np.float32),
               r.uniform(0.2, 0.6, (B, 4)).astype(np.float32),
               np.array([1, 0, 0, 0])),
        vqkd=(r.randn(B, NP, 32).astype(np.float32),
              r.randint(0, 32, (B, NP)), base["image_mask"].copy()),
        scores=_scores(r),
        retrieval=dict(images=r.randn(B, 64, 64, 3).astype(np.float32),
                       text_ids=r.randint(3, 98, (B, T)).astype(np.int64),
                       text_atts=np.ones((B, T), np.int64),
                       idx=np.array([0, 1, 1, 2], np.int64)),
        retrieval_neg=(np.array([1, 3, 0, 0]), np.array([3, 0, 3, 1])))


def _scores(r):
    s_i2t = (50 * r.randn(5, 7)).astype(np.float32)
    s_i2t[1, 2] = -150.25
    s_i2t[3, 4] = np.float32(-100.0000076)
    s_t2i = (50 * r.randn(7, 5)).astype(np.float32)
    s_t2i[6, 0] = -3e4
    return s_i2t, s_t2i


def _model(spec):
    from xfm_tpu_torch.configs import xfm_base_pretrain_config
    from xfm_tpu_torch.models import XFMForPretrain

    model = XFMForPretrain(xfm_base_pretrain_config(dtype=torch.float32,
                                                    **KW))
    model.load_state_dict(spec["state_dict"], strict=True)
    return model


def _state(spec):
    from xfm_tpu_torch.train.optim import create_optimizer
    from xfm_tpu_torch.train.schedules import linear_warmup_decay
    from xfm_tpu_torch.train.train_state import TrainState

    model = _model(spec)
    return TrainState.create(model, create_optimizer(
        model, linear_warmup_decay(LR, 10, 0), weight_decay=0.01,
        lr_mult=2.0))


def _local(batch, neg=None):
    from xfm_tpu_torch.configs import batch_to_torch
    from xfm_tpu_torch.core.mesh import rank_slice

    out = batch_to_torch(rank_slice(batch), "cpu")
    if neg is not None:
        out["hard_negatives"] = tuple(torch.from_numpy(n)
                                      for n in rank_slice(neg))
    return out


def _record(state, metrics) -> dict:
    return dict(
        metrics={k: float(v) for k, v in metrics.items()
                 if torch.is_tensor(v) and v.dim() == 0},
        grads={n: (p.grad.clone() if p.grad is not None
                   else torch.zeros_like(p))
               for n, p in state.model.named_parameters()},
        params={n: p.detach().clone()
                for n, p in state.model.named_parameters()})


def case_step(spec, batch_key="batch", drawn=False) -> dict:
    """(a), (b), (e): one `make_train_step` step of `pretrain_loss_fn`."""
    from xfm_tpu_torch.core import mesh
    from xfm_tpu_torch.train.train_state import (make_train_step,
                                                 pretrain_loss_fn)

    state = _state(spec)
    gen = mesh.step_generators(0, (1,), "cpu") if drawn else None
    batch = _local(spec[batch_key], None if drawn else spec["neg"])
    state, metrics = make_train_step(pretrain_loss_fn)(state, batch, gen)
    return _record(state, metrics)


def case_accum(spec) -> dict:
    """(c): K = 2 micro-batches of the 8-row global batch."""
    from xfm_tpu_torch.train.train_state import (make_accum_train_step,
                                                 pretrain_loss_fn)

    state = _state(spec)
    halves = [{k: v[i * B:(i + 1) * B] for k, v in spec["big"].items()}
              for i in range(2)]
    micro = [_local(h, spec["neg"]) for h in halves]
    state, metrics = make_accum_train_step(pretrain_loss_fn, 2)(state,
                                                                micro)
    return _record(state, metrics)


STREAM_FLAGS = {
    "image": dict(ret_mim=True),
    "imagenet": dict(ret_itc=False, ret_match=False, ret_mlm=False,
                     ret_mim=True, data_source="imagenet"),
    "text": {},
}


def case_stream(spec) -> dict:
    """(d): three streams, forward and backward one at a time, one
    update; the ImageNet stream leaves the text and fusion towers unused,
    the text stream the vision tower."""
    from xfm_tpu_torch.train.train_state import make_stream_step

    state = _state(spec)
    b = _local(spec["batch"], spec["neg"])
    batches = {
        "image": b,
        "imagenet": {k: b[k] for k in ("images", "image_mask")},
        "text": {k: b[k] for k in ("text_ids_masked", "text_atts",
                                   "masked_pos", "masked_ids")},
    }
    weights = {"image": 1.0, "imagenet": 0.5, "text": 0.25}

    def loss_fn(model, name, batch, generator):
        out = model.loss(**batch, **STREAM_FLAGS[name], generator=generator,
                         deterministic=True)
        loss = weights[name] * sum(out.values())
        return loss, {f"{name}_{k}": v for k, v in out.items()}

    state, metrics = make_stream_step(loss_fn)(
        state, batches, dict.fromkeys(batches))
    return _record(state, metrics)


def case_retrieval(spec, shared_kv: str) -> dict:
    """(r): `retrieval_loss_fn`'s step on a tiny XFMForRetrieval (seeded
    init, dropout off), rows 1 and 2 of one image across the ranks,
    injected negatives of other images; `XFM_SHARED_CROSS_KV` =
    `shared_kv`."""
    from xfm_tpu_torch.configs import xfm_retrieval_eval_config
    from xfm_tpu_torch.models import XFMForRetrieval
    from xfm_tpu_torch.train.checkpoint import init_weights
    from xfm_tpu_torch.train.optim import create_optimizer
    from xfm_tpu_torch.train.schedules import linear_warmup_decay
    from xfm_tpu_torch.train.train_state import (TrainState,
                                                 make_train_step,
                                                 retrieval_loss_fn)

    before = os.environ.get("XFM_SHARED_CROSS_KV")
    os.environ["XFM_SHARED_CROSS_KV"] = shared_kv
    try:
        model = XFMForRetrieval(xfm_retrieval_eval_config(
            dtype=torch.float32, image_res=64, layers=2,
            vision_embed_dim=64, vision_num_heads=2, text_hidden_size=64,
            text_num_attention_heads=2, text_intermediate_size=128,
            text_vocab_size=99, embed_dim=32))
        init_weights(model, 5)
        state = TrainState.create(model, create_optimizer(
            model, linear_warmup_decay(LR, 10, 0), weight_decay=0.01,
            lr_mult=2.0))
        batch = _local(spec["retrieval"], spec["retrieval_neg"])
        state, metrics = make_train_step(retrieval_loss_fn)(state, batch)
    finally:
        if before is None:
            del os.environ["XFM_SHARED_CROSS_KV"]
        else:
            os.environ["XFM_SHARED_CROSS_KV"] = before
    return _record(state, metrics)


def case_losses(spec) -> dict:
    """(e): the bbox losses with `is_image` and the VQ-KD MIM loss over
    unequal counts: each rank's value averaged over the ranks."""
    from xfm_tpu_torch.core import mesh
    from xfm_tpu_torch.core.mesh import rank_slice
    from xfm_tpu_torch.models import losses

    pred, target, is_image = (torch.from_numpy(x)
                              for x in rank_slice(spec["boxes"]))
    l1, giou = losses.bbox_loss(pred, target, is_image)
    logits, ids, mask = (torch.from_numpy(x)
                         for x in rank_slice(spec["vqkd"]))
    mim = losses.mim_vqkd_loss(logits, ids, mask)
    vals = torch.stack([l1, giou, mim])
    return dict(zip(("loss_bbox", "loss_giou", "loss_mim_vqkd"),
                    mesh.all_reduce_mean(vals).tolist()))


def case_generators() -> dict:
    """(f): a dropout mask drawn inside `dropout_generator` and a draw
    from the shared generator."""
    from xfm_tpu_torch.core import mesh
    from xfm_tpu_torch.ops.dropout import dropout_generator, keep_mask

    g = mesh.step_generators(0, (3,), "cpu")
    with dropout_generator(g):
        mask = keep_mask((64,), 0.5, "cpu")
    return dict(mask=mask, shared=torch.rand(8, generator=g.shared))


def case_merge(spec):
    """(g): each rank's rerank slice (its rows, the rest -100), merged."""
    from xfm_tpu_torch.core import mesh
    from xfm_tpu_torch.tasks.retrieval import merge_rerank_scores

    parts = []
    for full in spec["scores"]:
        mine = np.full_like(full, -100.0)
        rows = np.arange(mesh.rank(), full.shape[0], mesh.world_size())
        mine[rows] = full[rows]
        parts.append(mine)
    return merge_rerank_scores(*parts, chunk=3)


def case_collect(out_dir, n=5):
    """(h): rank r's results are examples r, r + W, …"""
    from xfm_tpu_torch.core import mesh
    from xfm_tpu_torch.tasks.vqa import collect_results

    mine = [{"question_id": i, "answer": f"a{i}"}
            for i in mesh.rank_strided(list(range(n)))]
    return collect_results(mine, out_dir, "vqa_result")


def case_rows():
    from xfm_tpu_torch.core import mesh

    return dict(rows=mesh.rank_rows(np.arange(20), 3),
                strided=mesh.rank_strided(list(range(7))))


def run_cases(spec, out_dir) -> dict:
    torch.manual_seed(0)
    return dict(
        a=case_step(spec), b=case_step(spec, drawn=True),
        c=case_accum(spec), d=case_stream(spec),
        r1=case_retrieval(spec, "1"), r0=case_retrieval(spec, "0"),
        e=case_step(spec, "uneven"), e_losses=case_losses(spec),
        f=case_generators(), g=case_merge(spec),
        h=case_collect(os.path.join(out_dir, "result")), k=case_rows())


# --- the five tasks' steps and evals --------------------------------------

TASK_KW = dict(image_res=64, layers=2, vision_embed_dim=64,
               vision_num_heads=2, text_hidden_size=64,
               text_num_attention_heads=2, text_intermediate_size=128,
               text_vocab_size=60, compute_dtype="float32",
               drop_path_rate=0.0)
TASKS = ("nlvr", "grounding", "imagenet", "probe", "glue", "stsb",
         "classify")
NL = 5  # ImageNet's classes
EVAL_BS = 2


def task_yaml(name: str) -> dict:
    """The task's YAML at 2 layers a tower, width 64, 64 px, f32 (mixup
    and cutmix off for ImageNet)."""
    from xfm_tpu_torch import configs

    if name == "nlvr":
        return configs.nlvr_yaml(**TASK_KW)
    if name == "grounding":
        return configs.grounding_yaml(**TASK_KW)
    if name in ("imagenet", "probe"):
        return configs.imagenet_yaml(lp=name == "probe", num_labels=NL,
                                     mixup=0.0, cutmix=0.0, **TASK_KW)
    if name in ("glue", "stsb"):
        return configs.glue_yaml(task_name="mrpc" if name == "glue"
                                 else "stsb", **TASK_KW)
    return configs.nlvr_yaml(num_labels=2, **TASK_KW)  # classify, fused


def task_model(name: str):
    """The port's model of `name`, as the task's main builds it."""
    from xfm_tpu_torch.models import (XFMForClassification, XFMForGrounding,
                                      XFMForNLVR, config_from_yaml)

    cfg = task_yaml(name)
    if name == "nlvr":
        return XFMForNLVR(config_from_yaml(cfg))
    if name == "grounding":
        return XFMForGrounding(config_from_yaml(cfg, use_bbox_loss=True))
    if name in ("imagenet", "probe"):
        return XFMForClassification(config_from_yaml(cfg), num_labels=NL,
                                    task_name="imagenet",
                                    is_lp=name == "probe")
    if name in ("glue", "stsb"):
        return XFMForClassification(config_from_yaml(cfg),
                                    num_labels=2 if name == "glue" else 1,
                                    task_name="glue")
    return XFMForClassification(config_from_yaml(cfg), num_labels=2,
                                task_name="fused")


def make_task_batches(seed: int = 11) -> dict:
    """Each task's global batch of 4 rows (numpy, seeded); NLVR's images
    [all first images; all second images]."""
    r = np.random.RandomState(seed)
    B, T = 4, 8

    def text():
        ids = r.randint(5, 40, (B, T)).astype(np.int64)
        ids[:, 0] = 1
        atts = np.ones((B, T), np.int64)
        for b in range(B):
            n = T - b
            ids[b, n - 1], ids[b, n:], atts[b, n:] = 2, 0, 0
        return ids, atts

    def images(n=B):
        return r.randn(n, 64, 64, 3).astype(np.float32)

    out = {}
    ids, atts = text()
    out["nlvr"] = dict(images=images(2 * B), text_ids=ids, text_atts=atts,
                       targets=np.array([1, 0, 0, 1], np.int64))
    ids, atts = text()
    out["grounding"] = dict(
        images=images(), text_ids=ids, text_atts=atts,
        target_bbox=r.uniform(0.2, 0.6, (B, 4)).astype(np.float32))
    out["imagenet"] = dict(images=images(),
                           targets=np.array([0, 3, 4, 1], np.int64))
    out["probe"] = dict(images=images(),
                        targets=np.array([2, 2, 0, 4], np.int64))
    ids, atts = text()
    out["glue"] = dict(text_ids=ids, text_atts=atts,
                       targets=np.array([1, 0, 1, 1], np.int32))
    out["stsb"] = dict(text_ids=ids, text_atts=atts,
                       targets=r.uniform(0, 5, B).astype(np.float32))
    ids, atts = text()
    out["classify"] = dict(images=images(), text_ids=ids, text_atts=atts,
                           targets=np.array([0, 1, 1, 0], np.int32))
    return out


def local_batch(name: str, batch: dict) -> dict:
    """The rank's rows of a global batch as torch tensors, integers as
    int64 as `data/prefetch` copies them: NLVR's pairs with both of each
    pair's images, every other task's `rank_slice`."""
    from xfm_tpu_torch.core import mesh

    if name == "nlvr":
        images = batch["images"].reshape(2, -1, *batch["images"].shape[1:])
        batch = mesh.rank_slice(dict(batch, images=images.swapaxes(0, 1)))
        batch["images"] = np.ascontiguousarray(
            batch["images"].swapaxes(0, 1)).reshape(
                -1, *batch["images"].shape[2:])
    else:
        batch = mesh.rank_slice(batch)
    return {k: torch.from_numpy(np.ascontiguousarray(
        v.astype(np.int64) if v.dtype.kind in "iu" else v))
        for k, v in batch.items()}


def _task_state(name: str, state_dict):
    """The model with `state_dict` and the task's optimizer at lr `LR`."""
    from xfm_tpu_torch.tasks import imagenet
    from xfm_tpu_torch.train.optim import (create_optimizer,
                                           create_optimizer_from_config)
    from xfm_tpu_torch.train.train_state import TrainState

    model = task_model(name)
    model.load_state_dict(state_dict, strict=True)
    cfg = task_yaml(name)

    def sched(step):
        return LR

    if name in ("imagenet", "probe"):
        opt = imagenet.build_optimizer(model, cfg, sched)
    elif name in ("glue", "stsb"):
        opt = create_optimizer(model, sched, weight_decay=0.0,
                               clip_grad_norm=1.0)
    else:
        opt = create_optimizer_from_config(model, cfg, sched)
    return TrainState.create(model, opt)


def _task_loss_fn(name: str):
    from xfm_tpu_torch.tasks import classify, glue, imagenet
    from xfm_tpu_torch.train import train_state

    if name in ("imagenet", "probe"):
        return imagenet.make_loss_fn(task_yaml(name))
    return {"nlvr": train_state.nlvr_loss_fn,
            "grounding": train_state.grounding_loss_fn,
            "glue": glue.glue_loss_fn, "stsb": glue.glue_loss_fn,
            "classify": classify.classify_loss_fn}[name]


def case_task_step(spec, name: str) -> dict:
    """One step of the task's loss (dropout off) on the rank's rows."""
    from xfm_tpu_torch.core import mesh
    from xfm_tpu_torch.train.train_state import make_train_step

    state = _task_state(name, spec["state_dicts"][name])
    gen = mesh.step_generators(0, (1,), "cpu")
    state, metrics = make_train_step(_task_loss_fn(name))(
        state, local_batch(name, spec["batches"][name]), gen)
    return _record(state, metrics)


def case_task_evals(spec) -> dict:
    """Each task's eval, as its main calls it, on 5 rows in batches of
    `EVAL_BS` (3 and 2 rows on two ranks) → the metrics."""
    from xfm_tpu_torch.core import mesh
    from xfm_tpu_torch.data.finetune_data import GroundingData, NLVRData
    from xfm_tpu_torch.data.timm_aug import ImagenetEvalTransform
    from xfm_tpu_torch.data.tokenization import SimpleTokenizer
    from xfm_tpu_torch.data.transforms import TestTransform
    from xfm_tpu_torch.tasks import classify, glue, grounding, imagenet, nlvr

    d = spec["data"]
    tok = SimpleTokenizer(d["words"])
    models = {}
    for name in TASKS:
        models[name] = task_model(name).eval()
        models[name].load_state_dict(spec["state_dicts"][name], strict=True)
    tf = TestTransform(64)
    out = {"rows": len(mesh.rank_batches(list(range(5)), EVAL_BS))}
    out["nlvr"] = nlvr.evaluate(models["nlvr"], NLVRData(
        d["nlvr"], tf, d["root"], tok, max_tokens=10, batch_size=EVAL_BS,
        train=False))
    out["grounding"] = grounding.evaluate(models["grounding"], GroundingData(
        d["grounding"], tf, d["root"], tok, max_tokens=10,
        batch_size=EVAL_BS, train=False))
    for name in ("imagenet", "probe"):
        out[name] = imagenet.evaluate(models[name], d["rows"],
                                      ImagenetEvalTransform(64), d["root"],
                                      EVAL_BS)
    tokenize = glue.make_tokenize_fn(tok, 10)
    for name, task in (("glue", "mrpc"), ("stsb", "stsb")):
        out[name] = glue.evaluate(models[name], d[name], tokenize, task,
                                  EVAL_BS)
    out["classify"] = classify.evaluate(models["classify"], classify.batches(
        mesh.rank_batches(d["cls_rows"], EVAL_BS), tok, tf, d["root"], 10,
        EVAL_BS, shuffle=False, drop_last=False))
    return out


MIX = dict(mixup=0.8, cutmix=1.0, mixup_prob=1.0, mixup_switch_prob=0.5,
           label_smoothing=0.1)


def case_mixup(spec) -> dict:
    """The ImageNet loader (`batches`: the rank's rows of a global batch of
    4) and `mixed` with the task's generator (`mix_generator`, mixup and
    cutmix on) → the rank's batch before and after the mix."""
    from xfm_tpu_torch.core import mesh
    from xfm_tpu_torch.data.timm_aug import ImagenetEvalTransform
    from xfm_tpu_torch.tasks import imagenet

    d = spec["data"]
    plain = next(imagenet.batches(d["rows"], ImagenetEvalTransform(64),
                                  d["root"], 4 // mesh.world_size(),
                                  seed=5))
    mixed = next(imagenet.mixed(iter([plain]), MIX,
                                imagenet.mix_generator(7), NL))
    return dict(plain=plain, mixed=mixed)


def run_task_cases(spec, out_dir) -> dict:
    torch.manual_seed(0)
    out = {name: case_task_step(spec, name) for name in TASKS}
    out["evals"] = case_task_evals(spec)
    out["mixup"] = case_mixup(spec)
    return out


def main():
    spec_path, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    from xfm_tpu_torch.core import mesh

    mesh.maybe_init_distributed("cpu")
    assert mesh.world_size() == int(os.environ["WORLD_SIZE"])
    spec = torch.load(spec_path, weights_only=False)
    run = run_task_cases if spec.get("suite") == "tasks" else run_cases
    out = run(spec, out_dir)
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank()}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
