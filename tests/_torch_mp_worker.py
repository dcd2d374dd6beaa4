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


def main():
    spec_path, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    from xfm_tpu_torch.core import mesh

    mesh.maybe_init_distributed("cpu")
    assert mesh.world_size() == int(os.environ["WORLD_SIZE"])
    spec = torch.load(spec_path, weights_only=False)
    out = run_cases(spec, out_dir)
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank()}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
