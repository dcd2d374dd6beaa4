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
     config's `parallel` block;
  s. the sequence functions of `seq_shard` round-tripped at N = 5 and
     530 over the group;
  t. the retrieval model with each of the CLIP-ViT, DeiT and Swin towers
     (`TOWERS`, the JAX package's weights): the deterministic loss, one
     step, and the checkpoint written after it;
  k. each block of `BLOCKS` at the group's T (`block_case`: BEiT-2 blocks
     and text and fusion layers under `seq_shard`, CLIP-ViT layers, DeiT
     and Swin blocks), cut for the rank and run under the group
     (`chip_smoke.cut_block_run`): its output and whole gradients.
A layout with `seq_shard` builds the pretrain, retrieval, VQA and caption
models with it (the BEiT-2 tower and the text, fusion and decoder
stacks).
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


def pretrain_config(live: bool = False, remat: bool = False,
                    seq: bool = False):
    """The pretrain model at `KW` (f32, both fused routes on); `live`:
    dropout, attention dropout and drop-path at 0.1 in every tower;
    `remat`: every block and layer under `full` checkpointing; `seq`:
    `seq_shard` on."""
    from xfm_tpu_torch.configs import xfm_base_pretrain_config

    c = xfm_base_pretrain_config(dtype=torch.float32, fused_ln=True,
                                 fused_mlp=True, **KW)
    vision = c.vision
    if live:
        vision = dataclasses.replace(vision, drop_rate=0.1,
                                     attn_drop_rate=0.1, drop_path_rate=0.1)
    return with_seq(dataclasses.replace(
        c, vision=dataclasses.replace(vision, remat=remat),
        text=dataclasses.replace(c.text, remat=remat),
        fusion=dataclasses.replace(c.fusion, remat=remat)), seq)


def with_seq(c, seq: bool):
    """The XFM config `c` with `seq_shard` on its BEiT-2 tower and text
    and fusion stacks where `seq`, as `config_from_yaml` sets it."""
    if not seq:
        return c
    return dataclasses.replace(
        c, vision=dataclasses.replace(c.vision, seq_shard=True),
        text=dataclasses.replace(c.text, seq_shard=True),
        fusion=dataclasses.replace(c.fusion, seq_shard=True))


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

    model = XFMForPretrain(pretrain_config(live, remat,
                                           layout.get("seq_shard", False)))
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
    model = eval_model(ctx(layout), XFMForPretrain(with_seq(
        tiny_config(), layout.get("seq_shard", False))),
                       lambda m: m.load_state_dict(jx["state_dict"]))
    batch = {k: v.long() if k != "image_mask" and v.dtype == torch.int32
             else v for k, v in batch_to_torch(rank_slice(
                 jx["batch"]), "cpu").items()}
    with torch.no_grad():
        out = model.loss(**batch, ret_mim=True, ret_match=False)
    out = reduce_metrics({k: out[k] for k in ("loss_itc", "loss_mlm",
                                              "loss_mim")})
    return {k: float(v) for k, v in out.items()}


def jax_inputs(spec, key: str = "jax") -> dict:
    """The JAX models' weights (through `state_dict_from_jax`) and
    batches, from the file `spec[key]`, which the test writes once JAX has
    made them, while the groups run their other cases: waited for."""
    for _ in range(1200):
        if os.path.exists(spec[key]):
            return torch.load(spec[key], weights_only=False)
        time.sleep(0.25)
    raise TimeoutError(f"no {spec[key]}")


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
    seq = layout.get("seq_shard", False)
    model = eval_model(c, XFMForRetrieval(with_seq(xfm_retrieval_eval_config(
        dtype=torch.float32, image_res=32, layers=2, vision_embed_dim=64,
        vision_num_heads=4, text_hidden_size=64, text_num_attention_heads=4,
        text_intermediate_size=128, text_vocab_size=99,
        embed_dim=32), seq))).eval()
    data = SyntheticRetrievalEvalData(EVAL["n_img"], EVAL["per_image"], 32,
                                      99, max_tokens=8, min_tokens=4)
    out = dict(retrieval=retrieval.evaluation(
        model, data, dict(batch_size_test=2, k_test=EVAL["k_test"])))
    images = torch.from_numpy(spec["eval_images"])
    vqa = eval_model(c, XFMForVQA.from_yaml(vqa_yaml(
        **SMALL, seq_shard=seq))).eval()
    q = torch.from_numpy(spec["q_ids"]).long()
    ans = torch.from_numpy(spec["answers"]).long()
    ans[:, 0], ans[:, -1] = 0, 2
    with torch.no_grad():
        ids, probs = vqa.rank(images, q, torch.ones_like(q), ans,
                              torch.ones_like(ans), 3)
    out["rank"] = (ids, probs)
    cap = eval_model(c, XFMForCaptioning.from_yaml(caption_yaml(
        **SMALL, seq_shard=seq)))
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


def case_sequence(layout) -> dict:
    """(s): at N = 5 and 530 (B = 2, C = 8, seeded with the length) on
    each rank: scatter → gather (to a whole consumer) gives x back, its
    gradient the output's bit for bit; a rank's row partials reduce-
    scattered then gathered give their sum over the ranks, each rank's
    partial's gradient the output gradient; a column gather's gradient is
    the ranks' gradients summed, their rows. → the checks' results."""
    from xfm_tpu_torch.core import mesh, partitioning
    from xfm_tpu_torch.ops import tensor_parallel as tp

    mesh.use_mesh(mesh.mesh_from_config({"parallel": layout}))
    cut = partitioning.model_cut()
    out = {}
    for n in (5, 530):
        g = torch.Generator().manual_seed(n)
        x = torch.randn(2, n, 8, generator=g).requires_grad_()
        w = torch.randn(2, n, 8, generator=g)
        # a rank-dependent partial and output gradient (the seed and rank)
        part = (torch.randn(2, n, 8, generator=g) * (1 + cut.rank)
                ).requires_grad_()
        dy = torch.randn(2, n, 8, generator=g)
        rows = tp.scatter_to_sequence(x, cut)
        m = tp.rows_per_rank(n, cut.size)
        # this rank's rows of x (none where the padding is all it holds)
        lo, hi = min(cut.rank * m, n), min((cut.rank + 1) * m, n)
        pad_zero = bool((rows[:, hi - lo:] == 0).all())
        back = tp.gather_from_sequence(rows, cut, n, to_column=False)
        (back * w).sum().backward()
        with tp.sequence(n):
            summed = tp.gather_from_sequence(
                tp.row_output(part, None, cut, torch.float32), cut, n,
                to_column=False)
        (summed * dy).sum().backward()
        # the whole sum, gathered for the check alone
        whole = tp.gather_tensor(part.detach().contiguous(), tp.COLUMN,
                                 cut).reshape(cut.size, *part.shape)
        # a column layer's input: each rank's gradient of the whole
        # sequence (x·(1 + rank)) summed, this rank's rows
        leaf = tp.own_rows(x.detach(), cut).requires_grad_()
        col = tp.gather_from_sequence(leaf, cut, n)
        (col * x.detach() * (1 + cut.rank)).sum().backward()
        ranks = sum(1 + r for r in range(cut.size))
        out[n] = dict(
            rows=tuple(rows.shape), pad_zero=pad_zero,
            own=torch.equal(rows[:, :hi - lo], x.detach()[:, lo:hi]),
            back=torch.equal(back, x.detach()),
            grad=torch.equal(x.grad, w),
            sum=float((summed - whole.sum(0)).abs().max()),
            part_grad=torch.equal(part.grad, dy),
            col_grad=float((leaf.grad - tp.own_rows(
                x.detach() * ranks, cut)).abs().max()))
    return out


TOWERS = ("clip", "deit", "swin")
TOWER_B = 4  # the retrieval batch of case (t): B = 4, T = 8, 32 px


def tower_yaml(kind: str) -> dict:
    """The retrieval YAML of case (t): `kind`'s tower at 32 px (CLIP-ViT
    and DeiT width 64, 4 heads, 2 layers; Swin embed 16, depths (2, 2),
    heads (2, 4), window 4, stage 0's second block shifted) and the
    RoBERTa text and fusion stacks at width 64, 2 + 2 layers."""
    common = dict(image_res=32, patch_size=16, text_num_hidden_layers=2,
                  text_fusion_start_at=2, fusion_num_hidden_layers=2,
                  text_hidden_size=64, text_num_attention_heads=4,
                  text_intermediate_size=128, text_vocab_size=99,
                  embed_dim=32, temp=0.07)
    vit = dict(vision_width=64, patch_size=16, num_attention_heads=4,
               num_hidden_layers=2, intermediate_size=128)
    if kind == "clip":
        return dict(common, use_clip_vit=True,
                    _vision=dict(vit, hidden_act="quick_gelu"))
    if kind == "deit":
        return dict(common, use_deit=True, _vision=vit)
    return dict(common, use_swin=True, _vision=dict(
        image_res=32, embed_dim=16, depths=[2, 2], num_heads=[2, 4],
        window_size=4))


def tower_config(kind: str, layout=None):
    """The port's retrieval config of `tower_yaml(kind)` under the
    `parallel` block `layout`, f32, ITC and ITM heads."""
    from xfm_tpu_torch.models import config_from_yaml

    return config_from_yaml(dict(tower_yaml(kind), parallel=dict(
        layout or {})), dtype=torch.float32, use_contrastive_loss=True,
        use_matching_loss=True)


def tower_state(layout, kind: str, jx):
    """Case (t)'s train state: the JAX weights of `kind` in the port's
    retrieval model, cut and placed as the task places it."""
    from xfm_tpu_torch.models import XFMForRetrieval
    from xfm_tpu_torch.tasks.common import place_state

    model = XFMForRetrieval(tower_config(kind, layout))
    model.load_state_dict(jx[kind]["state_dict"], strict=True)
    return place_state(ctx(layout), model, _sched, adamw)


def case_towers(spec, layout, out_dir) -> dict:
    """(t): for each of `TOWERS` the deterministic ITC + ITM loss of the
    JAX weights and batch (fixed hard negatives), one HF-AdamW step with
    the clip, the checkpoint after it under out_dir/ckpt_<kind>."""
    from xfm_tpu_torch.configs import batch_to_torch
    from xfm_tpu_torch.core.mesh import rank_slice, reduce_metrics
    from xfm_tpu_torch.train.checkpoint import save_checkpoint
    from xfm_tpu_torch.train.train_state import (make_train_step,
                                                 retrieval_loss_fn)

    jx = jax_inputs(spec, "jax_towers")
    out = {}
    for kind in TOWERS:
        st = tower_state(layout, kind, jx)
        batch = batch_to_torch(rank_slice(jx[kind]["batch"]), "cpu")
        batch["hard_negatives"] = tuple(torch.from_numpy(n)
                                        for n in rank_slice(NEG))
        with torch.no_grad():
            _, parts = retrieval_loss_fn(st.model, batch)
        loss = {k: float(v) for k, v in reduce_metrics(parts).items()}
        st, metrics = make_train_step(retrieval_loss_fn)(st, batch)
        save_checkpoint(os.path.join(out_dir, f"ckpt_{kind}"), st)
        out[kind] = dict(loss=loss, step=record(st, metrics))
    return out


# case (k)'s blocks: (kind, image px: N = 5 at 32, 530 at 368; the tensor
# sizes that run it)
BLOCKS = (("beit", 32, (2, 4)), ("beit", 368, (2, 4)), ("text", 0, (2, 4)),
          ("fusion", 0, (2, 4)), ("clip", 32, (2, 4)), ("clip", 368, (2,)),
          ("deit", 32, (2, 4)), ("deit", 368, (2,)), ("swin", 32, (2, 4)))


def _perturbed(module, seed):
    """`module` with seeded weights moved off their zero and one inits."""
    from xfm_tpu_torch.train.checkpoint import init_weights

    init_weights(module, 1)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    return module


def block_case(kind: str, res: int, size: int):
    """Case (k)'s whole block at `res` px for a group of `size`, the same
    in every process (f32, width 128, 4 heads, both fused routes on where
    the block has them; K1's plain version at N = 5, K2's or K3's at 530):
    a BEiT-2 block under `seq_shard`; a text layer (self-attention over 7
    rows, one padded) or fusion layer (the cross-attention to 9 rows of
    96-wide features) under `seq_shard`; a CLIP-ViT layer or DeiT block;
    a shifted Swin block (width 32, window 4 on an 8 × 8 stage) → (block,
    run(block, x) → its output, x [B, N, C], the output gradient's
    seed)."""
    from xfm_tpu_torch.models.beit2 import BeitBlock, VisionConfig
    from xfm_tpu_torch.models.clip_vit import (ClipEncoderLayer,
                                               ClipVisionConfig)
    from xfm_tpu_torch.models.deit import DeitBlock, DeitConfig
    from xfm_tpu_torch.models.swin import SwinBlock, SwinConfig
    from xfm_tpu_torch.models.text_encoder import (TextConfig,
                                                   TransformerLayer)
    from xfm_tpu_torch.ops.attention import mask_to_bias
    from xfm_tpu_torch.train.checkpoint import init_weights

    def whole(m, x):
        return m(x)

    if kind in ("text", "fusion"):
        cross = kind == "fusion"
        layer = TransformerLayer(TextConfig.roberta_base(
            hidden_size=128, num_attention_heads=4, intermediate_size=256,
            encoder_width=96, fusion_layer=0, vocab_size=99,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            fused_ln=True, fused_mlp=True, seq_shard=True),
            has_cross_attention=cross)
        init_weights(layer, 2)
        g = torch.Generator().manual_seed(size)
        h = torch.randn(3, 7, 128, generator=g)
        enc = torch.randn(3, 9, 96, generator=g) if cross else None
        m = torch.ones(3, 7)
        m[1, -2:] = 0
        bias = mask_to_bias(m)
        return layer, lambda mm, x: mm(x, bias, enc, None), h, size
    if kind == "beit":
        c = VisionConfig(image_res=res, patch_size=16, embed_dim=128,
                         depth=1, num_heads=4, drop_path_rate=0.0,
                         fused_ln=True, fused_mlp=True,
                         hidden_act="gelu_tanh", seq_shard=True)
        x = torch.randn(2, c.num_patches + 1, 128,
                        generator=torch.Generator().manual_seed(size))
        return _perturbed(BeitBlock(c), res + size), whole, x, res
    g = torch.Generator().manual_seed(res)
    if kind == "swin":
        c = SwinConfig(image_res=32, patch_size=4, embed_dim=32,
                       depths=(2,), num_heads=(4,), window_size=4)
        blk = SwinBlock(c, 32, 4, (8, 8), shift=2)
        x = torch.randn(2, 64, 32, generator=g)
    else:
        n = (res // 16) ** 2 + 1
        if kind == "clip":
            blk = ClipEncoderLayer(ClipVisionConfig(
                image_res=res, hidden_size=128, num_attention_heads=4,
                intermediate_size=256))
        else:
            blk = DeitBlock(DeitConfig(image_res=res, embed_dim=128,
                                       num_heads=4))
        x = torch.randn(2, n, 128, generator=g)
    return _perturbed(blk, res + size), whole, x, size


def case_blocks(layout) -> dict:
    """(k): each block of `BLOCKS` run at this group's T → (kind, res) →
    (its output, name → whole gradient) for the output gradient of
    `block_case`'s seed."""
    import chip_smoke
    from xfm_tpu_torch.core import mesh, partitioning

    mesh.use_mesh(mesh.mesh_from_config({"parallel": layout}))
    cut = partitioning.model_cut()
    out = {}
    for kind, res, sizes in BLOCKS:
        if cut.size not in sizes:
            continue
        full, run, x, seed = block_case(kind, res, cut.size)
        blk, y = chip_smoke.cut_block_run(full, cut, run, x)
        y.backward(torch.randn(y.shape,
                               generator=torch.Generator().manual_seed(seed)))
        out[(kind, res)] = (y.detach(), chip_smoke.cut_whole_grads(blk, cut))
    return out


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
        r=lambda: case_runs(spec, out_dir),
        s=lambda: case_sequence(layout),
        t=lambda: case_towers(spec, layout, out_dir),
        k=lambda: case_blocks(layout))
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
        out.setdefault(name, {}).update(run_cases(
            spec, layout, cases, os.path.join(out_dir, f"{name}")))
    torch.save(out, os.path.join(out_dir, f"w{w}_rank{mesh.rank()}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
