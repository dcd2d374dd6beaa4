"""The port's tensor-parallel cases (`xfm_tpu_torch/ops/tensor_parallel.py`,
`core/partitioning.cut_model`), run by `tests/test_torch_tensor_parallel.py`
in its own process (one process, the model whole) and as each of the gloo
processes of a group (this file as a script) at the layouts of SPEC:

    RANK=r WORLD_SIZE=W MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_tp_worker.py SPEC OUT

SPEC (`torch.save`) holds the state dicts, the global batches and, under
`layouts`, the `parallel` blocks to run with the cases of each; the process
writes what each gives to OUT/rank<r>.pt, keyed by layout. The state is
built as the tasks build it (`tasks/common.place_state` / `eval_model`).
The cases:
  c. the JAX `tiny_cfg` model's deterministic ITC + MLM + MIM loss;
  d. one pretrain step, dropout, drop-path and attention dropout live,
     the fused routes on (K4's and K5's plain versions), HF-AdamW with a
     clip of `CLIP`, far below the gradient's norm; `d_det` the same step
     deterministic;
  m. step `d` under `gradient_checkpointing: full` in every block and
     layer (the recompute all-reduces again);
  b. step `d_det` under `bf16_params` (bf16 live weights, f32 masters);
  l. one LARS step (weight decay on), its trust ratio over whole weights;
  e. the retrieval eval, `XFMForVQA.rank` and greedy and beam captions;
  f. the checkpoint written after step `d_det`, and the one-process one
     restored into the cut state;
  r. `run.main` for `itr_coco` (one epoch and its eval) under the
     config's `parallel` block.
"""
import dataclasses
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (REPO, os.path.join(REPO, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

LR = 1e-3
CLIP = 0.05
KW = dict(hidden=128, layers=2, heads=4, inter=256, image_res=32, vocab=99)
B, T, M, NP = 4, 8, 3, 4
NEG = (np.array([1, 2, 3, 0]), np.array([2, 3, 0, 1]))
EVAL = dict(n_img=5, per_image=2, k_test=3)
SMALL = dict(image_res=32, layers=2, vision_embed_dim=32,
             vision_num_heads=2, text_hidden_size=32,
             text_num_attention_heads=2, text_intermediate_size=64,
             text_vocab_size=100, compute_dtype="float32",
             drop_path_rate=0.0)


def make_spec() -> dict:
    """The pretrain model's weights (random, seeded) and the batches."""
    from xfm_tpu_torch.configs import make_batch
    from xfm_tpu_torch.models import XFMForPretrain
    from xfm_tpu_torch.train.checkpoint import init_weights

    model = XFMForPretrain(pretrain_config())
    init_weights(model, 3)
    r = np.random.RandomState(11)
    return dict(
        state_dict={k: v.detach().clone()
                    for k, v in model.state_dict().items()},
        batch=make_batch(B, T, M, KW["image_res"], NP, KW["vocab"]),
        neg=NEG,
        eval_images=r.randn(3, 32, 32, 3).astype(np.float32),
        q_ids=r.randint(5, 99, (3, 6)), answers=r.randint(5, 99, (6, 4)))


def pretrain_config(live: bool = False, remat: bool = False):
    """The pretrain model at `KW` (f32, both fused routes on); `live`:
    dropout, attention dropout and drop-path at 0.1 in every tower;
    `remat`: every block and layer under `full` checkpointing."""
    from xfm_tpu_torch.configs import xfm_base_pretrain_config

    c = xfm_base_pretrain_config(dtype=torch.float32, fused_ln=True,
                                 fused_mlp=True, **KW)
    vision = c.vision
    if live:
        vision = dataclasses.replace(vision, drop_rate=0.1,
                                     attn_drop_rate=0.1, drop_path_rate=0.1)
    return dataclasses.replace(
        c, vision=dataclasses.replace(vision, remat=remat),
        text=dataclasses.replace(c.text, remat=remat),
        fusion=dataclasses.replace(c.fusion, remat=remat))


def ctx(layout, out: str = "", bf16: bool = False):
    from xfm_tpu_torch.tasks.common import TaskContext

    return TaskContext(config={"parallel": dict(layout or {}),
                               "bf16_params": bf16},
                       out_dir=out, device="cpu")


def _sched(step):
    return LR


def adamw(m, named):
    from xfm_tpu_torch.train.optim import create_optimizer

    return create_optimizer(m, _sched, weight_decay=0.01, lr_mult=2.0,
                            clip_grad_norm=CLIP, named_params=named)


def lars(m, named):
    from xfm_tpu_torch.train.optim import LARS

    return LARS(named, 0.1, weight_decay=1e-4)


def state(spec, layout, make=adamw, live=False, remat=False, bf16=False):
    from xfm_tpu_torch.models import XFMForPretrain
    from xfm_tpu_torch.tasks.common import place_state

    model = XFMForPretrain(pretrain_config(live, remat))
    model.load_state_dict(spec["state_dict"], strict=True)
    return place_state(ctx(layout, bf16=bf16), model, _sched, make)


def local_batch(spec):
    from xfm_tpu_torch.configs import batch_to_torch
    from xfm_tpu_torch.core.mesh import rank_slice

    out = batch_to_torch(rank_slice(spec["batch"]), "cpu")
    out["hard_negatives"] = tuple(torch.from_numpy(n)
                                  for n in rank_slice(spec["neg"]))
    return out


def whole(items) -> dict:
    """(name, tensor, like) → name: the whole tensor on the host, gathered
    over the shards and the tensor cuts as `like` is laid out."""
    from xfm_tpu_torch.core import partitioning

    return {n: partitioning.full_tensor(t, like=like).detach().cpu().clone()
            for n, t, like in items}


def record(st, metrics=None) -> dict:
    """The step's scalar metrics, every gradient and parameter (whole) and
    the optimizer's state."""
    named = list(st.model.named_parameters())
    return dict(
        metrics={k: float(v) for k, v in (metrics or {}).items()
                 if torch.is_tensor(v) and v.dim() == 0},
        grads=whole((n, p.grad if p.grad is not None
                     else torch.zeros_like(p), p) for n, p in named),
        params=whole((n, p, p) for n, p in named),
        optimizer=st.optimizer.state_dict(), step=st.step)


def live_loss(model, batch, generator):
    out = model.loss(**batch, ret_mim=True, generator=generator,
                     deterministic=False)
    return sum(out.values()), out


def case_step(spec, layout, live: bool, remat=False, bf16=False) -> dict:
    """(d) / (d_det) / (m) / (b)"""
    from xfm_tpu_torch.core import mesh
    from xfm_tpu_torch.train.train_state import (make_train_step,
                                                 pretrain_loss_fn)

    st = state(spec, layout, live=live, remat=remat, bf16=bf16)
    gen = mesh.step_generators(0, (1,), "cpu")
    fn = live_loss if live else pretrain_loss_fn
    st, metrics = make_train_step(fn)(st, local_batch(spec), gen)
    return record(st, metrics)


def case_lars(spec, layout) -> dict:
    """(l)"""
    from xfm_tpu_torch.train.train_state import (make_train_step,
                                                 pretrain_loss_fn)

    st = state(spec, layout, make=lars)
    st, metrics = make_train_step(pretrain_loss_fn)(st, local_batch(spec))
    return record(st, metrics)


def case_jax_loss(spec, layout) -> dict:
    """(c): the deterministic ITC + MLM + MIM loss of the JAX `tiny_cfg`
    model's weights, the model cut as an `--evaluate` run cuts it."""
    from xfm_tpu_torch.configs import batch_to_torch
    from xfm_tpu_torch.core.mesh import rank_slice, reduce_metrics
    from xfm_tpu_torch.models import XFMForPretrain
    from xfm_tpu_torch.tasks.common import eval_model

    jx = jax_inputs(spec)
    model = eval_model(ctx(layout), XFMForPretrain(tiny_config()),
                       lambda m: m.load_state_dict(jx["state_dict"]))
    batch = {k: v.long() if k != "image_mask" and v.dtype == torch.int32
             else v for k, v in batch_to_torch(rank_slice(
                 jx["batch"]), "cpu").items()}
    with torch.no_grad():
        out = model.loss(**batch, ret_mim=True, ret_match=False)
    out = reduce_metrics({k: out[k] for k in ("loss_itc", "loss_mlm",
                                              "loss_mim")})
    return {k: float(v) for k, v in out.items()}


def jax_inputs(spec) -> dict:
    """The JAX model's weights (through `state_dict_from_jax`) and batch,
    from the file `spec["jax"]`, which the test writes once JAX has made
    them, while the groups run their other cases: waited for."""
    for _ in range(1200):
        if os.path.exists(spec["jax"]):
            return torch.load(spec["jax"], weights_only=False)
        time.sleep(0.25)
    raise TimeoutError(f"no {spec['jax']}")


def tiny_config():
    """The port's counterpart of `tests/test_sharding.py`'s `tiny_cfg`."""
    from xfm_tpu_torch.models import TextConfig, VisionConfig, XFMConfig

    vis = VisionConfig(image_res=32, patch_size=16, embed_dim=64, depth=2,
                       num_heads=4, drop_path_rate=0.0)
    kw = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=128, vocab_size=1000, encoder_width=64)
    return XFMConfig(vision=vis,
                     text=TextConfig.roberta_base(fusion_layer=2, **kw),
                     fusion=TextConfig.roberta_base(fusion_layer=0, **kw),
                     embed_dim=32, use_contrastive_loss=True,
                     use_matching_loss=True, use_mlm_loss=True,
                     use_bbox_loss=True)


def case_evals(spec, layout) -> dict:
    """(e): the retrieval eval's R@K and merged scores, `rank_answer`,
    and greedy and beam-3 captions, each model cut as an `--evaluate` run
    cuts it."""
    from xfm_tpu_torch.configs import (SyntheticRetrievalEvalData,
                                       caption_yaml, vqa_yaml,
                                       xfm_retrieval_eval_config)
    from xfm_tpu_torch.models import (XFMForCaptioning, XFMForRetrieval,
                                      XFMForVQA)
    from xfm_tpu_torch.models.generation import beam_generate, generate
    from xfm_tpu_torch.tasks import retrieval
    from xfm_tpu_torch.tasks.common import eval_model

    c = ctx(layout)
    c.seed = 5
    model = eval_model(c, XFMForRetrieval(xfm_retrieval_eval_config(
        dtype=torch.float32, image_res=32, layers=2, vision_embed_dim=64,
        vision_num_heads=4, text_hidden_size=64, text_num_attention_heads=4,
        text_intermediate_size=128, text_vocab_size=99,
        embed_dim=32))).eval()
    data = SyntheticRetrievalEvalData(EVAL["n_img"], EVAL["per_image"], 32,
                                      99, max_tokens=8, min_tokens=4)
    out = dict(retrieval=retrieval.evaluation(
        model, data, dict(batch_size_test=2, k_test=EVAL["k_test"])))
    images = torch.from_numpy(spec["eval_images"])
    vqa = eval_model(c, XFMForVQA.from_yaml(vqa_yaml(**SMALL))).eval()
    q = torch.from_numpy(spec["q_ids"]).long()
    ans = torch.from_numpy(spec["answers"]).long()
    ans[:, 0], ans[:, -1] = 0, 2
    with torch.no_grad():
        ids, probs = vqa.rank(images, q, torch.ones_like(q), ans,
                              torch.ones_like(ans), 3)
    out["rank"] = (ids, probs)
    cap = eval_model(c, XFMForCaptioning.from_yaml(caption_yaml(**SMALL)))
    cap.eval()
    kw = dict(bos_id=0, eos_id=2, pad_id=1, max_len=6)
    with torch.no_grad():
        out["greedy"] = generate(cap, images, **kw)
        out["beam"] = beam_generate(cap, images, num_beams=3, **kw)
    return out


def case_checkpoint(spec, layout, out_dir) -> dict:
    """(f): the state after step `d_det` saved under out_dir/ckpt; the
    one-process checkpoint of `spec["one_ckpt"]` restored into a fresh cut
    state."""
    from xfm_tpu_torch.core import mesh
    from xfm_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
    from xfm_tpu_torch.train.train_state import (make_train_step,
                                                 pretrain_loss_fn)

    st = state(spec, layout)
    st, _ = make_train_step(pretrain_loss_fn)(
        st, local_batch(spec), mesh.step_generators(0, (1,), "cpu"))
    save_checkpoint(os.path.join(out_dir, "ckpt"), st)
    mesh.barrier()
    fresh = restore_checkpoint(spec["one_ckpt"], state(spec, layout))
    return dict(restored=record(fresh))


def case_runs(spec, out_dir) -> dict:
    """(r): the task runs of `spec["runs"]`, their outputs under
    `out_dir`."""
    from xfm_tpu_torch import run

    return {task: run.main(["--task", task, "--config", cfg, "--output_dir",
                            os.path.join(out_dir, task), "--device", "cpu",
                            "--seed", "0", *extra])
            for task, cfg, extra in spec["runs"]}


def run_cases(spec, layout, cases, out_dir) -> dict:
    torch.manual_seed(0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    run = dict(
        c=lambda: case_jax_loss(spec, layout),
        d=lambda: case_step(spec, layout, live=True),
        d_det=lambda: case_step(spec, layout, live=False),
        m=lambda: case_step(spec, layout, live=True, remat=True),
        b=lambda: case_step(spec, layout, live=False, bf16=True),
        l=lambda: case_lars(spec, layout),
        e=lambda: case_evals(spec, layout),
        f=lambda: case_checkpoint(spec, layout, out_dir),
        r=lambda: case_runs(spec, out_dir))
    return {k: run[k]() for k in cases}


def layout_name(layout) -> str:
    return ",".join(f"{k}{v}" for k, v in sorted(layout.items())) or "one"


def main():
    spec_path, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    from xfm_tpu_torch.core import mesh

    mesh.maybe_init_distributed("cpu")
    spec = torch.load(spec_path, weights_only=False)
    w = mesh.world_size()
    out = {}
    for layout, cases in spec["layouts"][w]:
        name = layout_name(layout)
        out[name] = run_cases(spec, layout, cases,
                              os.path.join(out_dir, f"{name}"))
    torch.save(out, os.path.join(out_dir, f"w{w}_rank{mesh.rank()}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
