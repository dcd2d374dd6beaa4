"""The port's FSDP cases (`xfm_tpu_torch/core/partitioning.py`), run by
`tests/test_torch_fsdp.py` twice: in the test's own process (one process,
no group, the global batch, the model not sharded) and as each of two gloo
processes at `parallel: {fsdp: 2}` (this file as a script), each given its
half of every global batch and holding half of every parameter.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_fsdp_worker.py SPEC OUT

SPEC (`torch.save`) holds the tiny XFMForPretrain's state dict (from the
JAX package's init), the global batches, and the paths of the checkpoint
and the task runs; the process writes what each case gives to
OUT/rank<r>.pt. The state is built as the tasks build it
(`tasks/common.place_state` on a config whose `parallel.fsdp` is the
world size). The cases:
  a. one pretrain step, injected negatives, HF-AdamW with a clip of
     `CLIP`, far below the gradient's norm;
  s. a stream step (image-text, ImageNet, text) leaving towers unused;
  c. gradient accumulation, K = 2;
  m. a stream step with dropout live, plain and under
     `gradient_checkpointing: full`;
  b. two steps under `bf16_params` (the bf16 mixed-precision policy on
     the shards, `MasterWeights` on one process), then the checkpoint;
  t. one step of each of NLVR, grounding, ImageNet, the LARS probe (a
     frozen tower), GLUE, STS-B and the fused classifier;
  k. a checkpoint written after a step, and one written by one process
     restored into the shards;
  e. the retrieval eval (`evaluation`) on a synthetic corpus, and the
     rerank in chunks of 2 rows (3 rows on rank 0, 2 on rank 1: unequal
     numbers of calls);
  r. `run.main` for `itr_coco` (one epoch and its eval) and
     `pretrain_DIY` (2 steps) under the config's `parallel` block.
"""
import dataclasses
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (REPO, os.path.join(REPO, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import _torch_mp_worker as mp  # noqa: E402

LR = mp.LR
CLIP = 0.05  # the gradients' norm is ~20: the clip bites
EVAL = dict(n_img=5, per_image=2, k_test=3)


def _ctx(bf16: bool = False, out: str = ""):
    from xfm_tpu_torch.core import mesh
    from xfm_tpu_torch.tasks.common import TaskContext

    return TaskContext(config={"parallel": {"fsdp": mesh.world_size()},
                               "bf16_params": bf16},
                       out_dir=out, device="cpu")


def _sched(step):
    return LR


def _opt(clip, wd=0.01, lr_mult=2.0):
    from xfm_tpu_torch.train.optim import create_optimizer

    return lambda m, named: create_optimizer(
        m, _sched, weight_decay=wd, lr_mult=lr_mult, clip_grad_norm=clip,
        named_params=named)


def pretrain_config(remat: bool = False, drop_path_rate: float = 0.0):
    """The tiny pretrain config (`mp.KW`, f32); `remat`: every block and
    layer under `full` checkpointing."""
    from xfm_tpu_torch.configs import xfm_base_pretrain_config

    c = xfm_base_pretrain_config(dtype=torch.float32, **mp.KW)
    return dataclasses.replace(
        c, vision=dataclasses.replace(c.vision, remat=remat,
                                      drop_path_rate=drop_path_rate),
        text=dataclasses.replace(c.text, remat=remat),
        fusion=dataclasses.replace(c.fusion, remat=remat))


def _state(spec, clip=CLIP, bf16=False, remat=False, drop_path_rate=0.0):
    """The tiny pretrain model with the spec's weights and HF-AdamW,
    placed as a task places it (sharded over the world size)."""
    from xfm_tpu_torch.models import XFMForPretrain
    from xfm_tpu_torch.tasks.common import place_state

    model = XFMForPretrain(pretrain_config(remat, drop_path_rate))
    model.load_state_dict(spec["state_dict"], strict=True)
    return place_state(_ctx(bf16), model, _sched, _opt(clip))


def _gather(items) -> dict:
    """(name, tensor, like) → name: the whole tensor on the host, where
    `like` is a parameter sharded on dim 0 (`tensor` its shard, or the
    DTensor itself) the ranks' shards concatenated in rank order, all in
    one collective."""
    from xfm_tpu_torch.core import mesh, partitioning

    items = list(items)
    mine = {n: partitioning.local(t).detach().cpu().clone()
            for n, t, like in items if partitioning.is_dtensor(like)}
    parts = [mine]
    if mesh.is_distributed():
        import torch.distributed as dist

        parts = [None] * mesh.world_size()
        dist.all_gather_object(parts, mine)
    return {n: (torch.cat([p[n] for p in parts])
                if partitioning.is_dtensor(like)
                else t.detach().cpu().clone()) for n, t, like in items}


def record(state, metrics=None) -> dict:
    """The step's scalar metrics, every gradient and parameter (whole:
    gathered from the shards) and the optimizer's state, in the form of
    its `state_dict`."""
    model = state.model
    named = list(model.named_parameters())
    grads = _gather((n, p.grad if p.grad is not None
                     else torch.zeros_like(p), p) for n, p in named)
    params = _gather((n, p, p) for n, p in named)
    opt = state.optimizer
    inner = getattr(opt, "inner", opt)
    optim = {key: _gather(zip(inner.names, getattr(inner, key), opt.params))
             for key in ("mu", "nu") if hasattr(inner, key)}
    optim["count"] = inner.count
    if inner is not opt:
        optim = {"master": _gather(zip(opt.names, opt.masters, opt.params)),
                 "inner": optim}
        # the gathered weights: the masters rounded, as they compute
        params = {n: (p.to(torch.bfloat16) if p.is_floating_point() else p)
                  for n, p in params.items()}
    return dict(
        metrics={k: float(v) for k, v in (metrics or {}).items()
                 if torch.is_tensor(v) and v.dim() == 0},
        grads=grads, params=params, optimizer=optim, step=state.step)


def case_step(spec) -> dict:
    """(a)"""
    from xfm_tpu_torch.train.train_state import (make_train_step,
                                                 pretrain_loss_fn)

    state = _state(spec)
    batch = mp._local(spec["batch"], spec["neg"])
    state, metrics = make_train_step(pretrain_loss_fn)(state, batch)
    return record(state, metrics)


def _stream_batches(spec):
    b = mp._local(spec["batch"], spec["neg"])
    return {
        "image": b,
        "imagenet": {k: b[k] for k in ("images", "image_mask")},
        "text": {k: b[k] for k in ("text_ids_masked", "text_atts",
                                   "masked_pos", "masked_ids")},
    }


def _stream_loss(deterministic=True):
    weights = {"image": 1.0, "imagenet": 0.5, "text": 0.25}

    def loss_fn(model, name, batch, generator):
        out = model.loss(**batch, **mp.STREAM_FLAGS[name],
                         generator=generator, deterministic=deterministic)
        loss = weights[name] * sum(out.values())
        return loss, {f"{name}_{k}": v for k, v in out.items()}

    return loss_fn


def case_stream(spec) -> dict:
    """(s)"""
    from xfm_tpu_torch.train.train_state import make_stream_step

    state = _state(spec)
    batches = _stream_batches(spec)
    state, metrics = make_stream_step(_stream_loss())(
        state, batches, dict.fromkeys(batches))
    return record(state, metrics)


def case_accum(spec) -> dict:
    """(c)"""
    from xfm_tpu_torch.train.train_state import (make_accum_train_step,
                                                 pretrain_loss_fn)

    state = _state(spec, clip=1.0)
    halves = [{k: v[i * mp.B:(i + 1) * mp.B] for k, v in spec["big"].items()}
              for i in range(2)]
    micro = [mp._local(h, spec["neg"]) for h in halves]
    state, metrics = make_accum_train_step(pretrain_loss_fn, 2)(state,
                                                                micro)
    return record(state, metrics)


def case_remat(spec) -> dict:
    """(m): the same dropout-live stream step, plain and under `full`
    checkpointing of every block and layer."""
    from xfm_tpu_torch.core import mesh
    from xfm_tpu_torch.train.train_state import make_stream_step

    out = {}
    for name, remat in (("plain", False), ("full", True)):
        state = _state(spec, remat=remat, drop_path_rate=0.1)
        state.model.train()
        batches = _stream_batches(spec)
        gens = {k: mesh.step_generators(0, (i,), "cpu")
                for i, k in enumerate(sorted(batches))}
        state, metrics = make_stream_step(_stream_loss(False))(
            state, batches, gens)
        out[name] = record(state, metrics)
    return out


def case_bf16(spec, out_dir) -> dict:
    """(b): two steps under `bf16_params`, then the state saved."""
    from xfm_tpu_torch.train.checkpoint import save_checkpoint
    from xfm_tpu_torch.train.train_state import (make_train_step,
                                                 pretrain_loss_fn)

    state = _state(spec, clip=1.0, bf16=True)
    step = make_train_step(pretrain_loss_fn)
    batch = mp._local(spec["batch"], spec["neg"])
    metrics = [step(state, batch)[1] for _ in range(1)]
    rec = record(state, metrics[-1])
    rec["losses"] = [float(m["loss"]) for m in metrics]
    save_checkpoint(os.path.join(out_dir, "ckpt_bf16"), state)
    return rec


def case_tasks(spec) -> dict:
    """(t): one step of each task's loss on the rank's rows of a global
    batch of 4, the model placed as the task places it."""
    from xfm_tpu_torch.core import mesh
    from xfm_tpu_torch.tasks import imagenet
    from xfm_tpu_torch.tasks.common import place_state
    from xfm_tpu_torch.train.optim import create_optimizer_from_config
    from xfm_tpu_torch.train.train_state import make_train_step

    out = {}
    for name in mp.TASKS:
        model = mp.task_model(name)
        model.load_state_dict(spec["task_state_dicts"][name], strict=True)
        cfg = mp.task_yaml(name)
        if name in ("imagenet", "probe"):
            def make(m, named, cfg=cfg):
                return imagenet.build_optimizer(m, cfg, _sched, named)
        elif name in ("glue", "stsb"):
            make = _opt(1.0, wd=0.0, lr_mult=1.0)
        else:
            def make(m, named, cfg=cfg):
                return create_optimizer_from_config(m, cfg, _sched,
                                                    named_params=named)
        state = place_state(_ctx(), model, _sched, make)
        gen = mesh.step_generators(0, (1,), "cpu")
        state, metrics = make_train_step(mp._task_loss_fn(name))(
            state, mp.local_batch(name, spec["task_batches"][name]), gen)
        out[name] = record(state, metrics)
    return out


def case_checkpoint(spec, out_dir) -> dict:
    """(k): the state after one step saved, then a second step; and the
    one-process checkpoint of `spec["one_ckpt"]` restored into a fresh
    state, then a step."""
    from xfm_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
    from xfm_tpu_torch.train.train_state import (make_train_step,
                                                 pretrain_loss_fn)

    step = make_train_step(pretrain_loss_fn)
    batch = mp._local(spec["batch"], spec["neg"])
    state = _state(spec, clip=1.0)
    step(state, batch)
    saved = record(state)
    save_checkpoint(os.path.join(out_dir, "ckpt"), state)
    state, metrics = step(state, batch)
    out = dict(saved=saved, next=record(state, metrics))
    fresh = restore_checkpoint(spec["one_ckpt"], _state(spec, clip=1.0))
    out["restored"] = record(fresh)
    fresh, metrics = step(fresh, batch)
    out["restored_next"] = record(fresh, metrics)
    return out


def retrieval_model():
    from xfm_tpu_torch.configs import xfm_retrieval_eval_config
    from xfm_tpu_torch.models import XFMForRetrieval
    from xfm_tpu_torch.train.checkpoint import init_weights

    model = XFMForRetrieval(xfm_retrieval_eval_config(
        dtype=torch.float32, image_res=64, layers=2, vision_embed_dim=64,
        vision_num_heads=2, text_hidden_size=64, text_num_attention_heads=2,
        text_intermediate_size=128, text_vocab_size=99, embed_dim=32))
    init_weights(model, 5)
    return model.eval()


def case_eval(spec) -> dict:
    """(e)"""
    from xfm_tpu_torch.configs import SyntheticRetrievalEvalData
    from xfm_tpu_torch.tasks import retrieval
    from xfm_tpu_torch.tasks.common import eval_model

    model = eval_model(_ctx(), retrieval_model())
    data = SyntheticRetrievalEvalData(EVAL["n_img"], EVAL["per_image"], 64,
                                      99, max_tokens=8, min_tokens=4)
    cfg = dict(batch_size_test=2, k_test=EVAL["k_test"])
    metrics = retrieval.evaluation(model, data, cfg)
    img_e, img_f, txt_e, txt_f, txt_a = retrieval.encode_corpus(model, data,
                                                                2)
    scores = retrieval.rerank_scores(model, img_e, txt_e, txt_a,
                                     img_f @ txt_f.T, EVAL["k_test"],
                                     chunk=2)
    return dict(metrics=metrics,
                scores=retrieval.merge_rerank_scores(*scores))


def case_runs(spec, out_dir) -> dict:
    """(r): the two task runs, their outputs under `out_dir`."""
    from xfm_tpu_torch import run

    out = {}
    for task, cfg, extra in spec["runs"]:
        dest = os.path.join(out_dir, task)
        out[task] = run.main(["--task", task, "--config", cfg,
                              "--output_dir", dest, "--device", "cpu",
                              "--seed", "0", *extra])
    return out


def run_cases(spec, out_dir) -> dict:
    torch.manual_seed(0)
    out = dict(a=case_step(spec), s=case_stream(spec), c=case_accum(spec),
               m=case_remat(spec), b=case_bf16(spec, out_dir),
               t=case_tasks(spec), k=case_checkpoint(spec, out_dir),
               e=case_eval(spec))
    if spec.get("runs"):
        out["r"] = case_runs(spec, out_dir)
    return out


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
