"""Parameter sharding over the `tensor` and `fsdp` axes
(`xfm_tpu/core/partitioning.py`): the Megatron tensor cut
(`ops/tensor_parallel`, below), then FSDP2:
`torch.distributed.fsdp.fully_shard` on the ("data", "fsdp") dims of a
DeviceMesh (`core/mesh.device_mesh`), which is HSDP where data > 1 and
plain FSDP where data = 1. NCCL on the card, gloo on the CPU.

The JAX package gives each parameter a PartitionSpec by path rules
(`DEFAULT_RULES`) and lets GSPMD gather it where it is used. FSDP2 shards
every parameter on dim 0 instead (`Shard(0)`, uneven sizes padded) and
gathers a unit's parameters before the unit runs. The layout differs and
the math is the same: a step on W = data × fsdp processes equals one
process's step on the global batch (the rule of `core/mesh`), with each
rank holding 1/fsdp of every parameter, of its gradient and of its
optimizer state.

`shard_model` makes a unit of every BEiT-2, CLIP, Swin and DeiT block and
every text, fusion and decoder layer; the task model is the root and keeps
the rest: the embeddings (the MLM decoder tied to the word embeddings
stays with them), the patch kernels, the shared rel-pos tables, the
projections, `temp` and the heads. FSDP2 hooks only `forward`, so the
methods the tasks call on the root (`ROOT_METHODS`) are registered with
`register_fsdp_forward_method`; a registered method that another one calls
(`rank` → `encode_question`) runs inside the outer call's gather.

Every forward of a sharded unit is a collective, so the ranks must make
the same calls in the same order. The steps do; an eval, whose ranks take
unequal shares, and a decode loop, which stops when its rows are done,
run inside `unsharded`, which gathers the whole model once and keeps it
so for their duration.

FSDP2 shards no 0-dim parameter, so `temp` stays whole on every rank
(`replicated_parameters`): its gradient is averaged by
`core/mesh.reduce_gradients`, and under `bf16_params` it is made bf16 with
an f32 master in the optimizer, as on one process.

The gradients: FSDP2 reduce-scatters each unit's gradient in f32 in the
backward (and all-reduces it over `data` under HSDP) and divides by W, the
mean over the ranks that `core/mesh.reduce_gradients` takes on a
replicated model, so `reduce_gradients` does not run on a sharded one.
Several backwards before one update (accumulation, the pretrain task's
streams) add their reduced shards into `.grad`.

`bf16_params` is FSDP2's `MixedPrecisionPolicy(param_dtype=bfloat16,
reduce_dtype=float32)`: the f32 shards are the masters the optimizer steps,
the gathered bf16 weights are the rounded masters, as the port's
`optim.MasterWeights` sets the live weights, and the gradients are reduced
in f32.

The kernels K1-K5 launch through their `autograd.Function`s on the gathered
(unsharded) weights of the unit that runs them; a unit under
`ops/checkpoint.checkpoint_block` gathers again for its recompute.

A checkpoint holds the full tensors whatever the layout (`full_tensor`,
`full_parameters`; every rank takes part in the gather, rank 0 writes) and
is cut back into the shards on restore (`shard_of`).

`parallel.tensor` T > 1 first cuts the model over the T ranks of each
tensor group (`cut_model`), as Megatron pairs: column (by output
features) `qkv` (the q, k and v rows of the rank's heads), `q_bias`,
`v_bias`, `fc1`, `query`/`key`/`value` of every self- and
cross-attention and `intermediate.dense`; row (by input features)
`proj`, `fc2`, `attention.output.dense` (and the cross-attention's) and
`output.dense`, whose biases stay whole. Everything else stays whole on
every rank: the embeddings (with the tied MLM decoder), the patch
kernels, the rel-pos tables (a rank reads its heads' columns),
`vision_proj`/`text_proj`, `temp` and the heads. FSDP2 then shards what
the cut left over the ("data", "fsdp") ranks of each tensor index. This
differs from `DEFAULT_RULES` in layout only: the JAX rules cut `proj`,
`vision_proj`, `text_proj` and the word embeddings over `tensor` and
miss the text MLP's `intermediate_dense`/`output_dense` (their regexes
name `intermediate/dense` and `ffn_output/dense`), which GSPMD then
gathers; the port cuts all four pairs of every block, so that no layer
waits on an all-gather, and GSPMD keeps the math the same either way.
The CLIP-ViT, DeiT and Swin blocks are cut as whole pairs too: CLIP's
`q_proj`, `k_proj`, `v_proj` (with their biases) and `fc1` by columns,
`out_proj` and `fc2` by rows; DeiT's and Swin's packed `qkv` (weight and
bias) by the q, k and v rows of the rank's heads, `proj` and `fc2` by
rows; a Swin block's table whole, its heads' columns read. T must divide
the heads of every Swin stage. `DEFAULT_RULES` cut the towers' `qkv`,
`fc1`, `fc2` and leave `q_proj`, `k_proj`, `v_proj`, `out_proj` and
`proj` whole (GSPMD gathers them): again a difference of layout.
A cut parameter carries its kind (`tensor_cut_of`), by which the
checkpoint gathers it whole and cuts it back, and the optimizer's norms
sum it over the tensor group. Under `seq_shard` the parameters that act
on a rank's rows carry `_xfm_sequence_partial` (`sequence_partial`);
`sum_sequence_gradients` completes their gradients.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from ..ops import tensor_parallel as tp

# the methods that the tasks and the evals call on a task model
ROOT_METHODS = ("loss", "encode_images", "encode_texts",
                "itm_scores", "encode_question", "rank", "decode",
                "decode_step")


def unit_types() -> tuple:
    """The module classes that `shard_model` makes FSDP units of: the
    blocks of every vision tower and the layers of every text stack."""
    from ..models.beit2 import BeitBlock
    from ..models.clip_vit import ClipEncoderLayer
    from ..models.deit import DeitBlock
    from ..models.swin import SwinBlock
    from ..models.text_encoder import TransformerLayer

    return (BeitBlock, ClipEncoderLayer, DeitBlock, SwinBlock,
            TransformerLayer)


def model_cut():
    """This process's `TensorCut` (`core/mesh`'s tensor group), or None
    where T = 1."""
    from . import mesh

    if mesh.tensor_size() == 1:
        return None
    return tp.TensorCut(mesh.tensor_size(), mesh.tensor_rank(),
                        mesh.tensor_group())


def tensor_cut_of(t) -> "str | None":
    """The kind of tensor cut of a parameter (or of the master or moment
    laid out as it): "column", "row", "qkv", or None for a whole one."""
    return getattr(t, "_xfm_tensor_cut", None)


def cut_plan(model) -> tuple:
    """(name → cut kind of each parameter `cut_model` cuts, the modules
    that read their cut: the attentions, MLPs and layers of the BEiT-2
    towers and text stacks, the blocks of the CLIP-ViT, DeiT and Swin
    towers, and the BEiT-2 towers and text stacks for their shared table
    and `seq_shard`)."""
    from ..models.beit2 import BeitAttention, BeitVisionTransformer, _Mlp
    from ..models.clip_vit import ClipEncoderLayer
    from ..models.deit import DeitBlock
    from ..models.swin import SwinBlock
    from ..models.text_encoder import (SelfAttention, TextTransformer,
                                       TransformerLayer)

    col, row, qkv = tp.COLUMN, tp.ROW, tp.QKV
    mlp = {"mlp.fc1.weight": col, "mlp.fc1.bias": col,
           "mlp.fc2.weight": row}
    packed = {"attn.qkv.weight": qkv, "attn.qkv.bias": qkv,
              "attn.proj.weight": row}
    local = {
        BeitAttention: {"qkv.weight": qkv, "q_bias": col, "v_bias": col,
                        "proj.weight": row},
        _Mlp: {"fc1.weight": col, "fc1.bias": col, "fc2.weight": row},
        SelfAttention: {f"self.{n}.{w}": col for n in ("query", "key",
                                                        "value")
                        for w in ("weight", "bias")}
        | {"output.dense.weight": row},
        TransformerLayer: {"intermediate.dense.weight": col,
                           "intermediate.dense.bias": col,
                           "output.dense.weight": row},
        ClipEncoderLayer: {f"self_attn.{n}_proj.{w}": col
                           for n in "qkv" for w in ("weight", "bias")}
        | {"self_attn.out_proj.weight": row} | mlp,
        DeitBlock: packed | mlp,
        SwinBlock: packed | mlp,
        BeitVisionTransformer: {},
        TextTransformer: {},
    }
    plan, mods = {}, []
    for name, m in model.named_modules():
        kinds = local.get(type(m))
        if kinds is None:
            continue
        mods.append(m)
        for leaf, kind in kinds.items():
            if _get(m, leaf) is not None:
                plan[f"{name}.{leaf}" if name else leaf] = kind
    return plan, mods


def _get(module, dotted: str):
    for part in dotted.split("."):
        module = getattr(module, part, None)
        if module is None:
            return None
    return module


@torch.no_grad()
def cut_model(model: torch.nn.Module, cut) -> torch.nn.Module:
    """`model` cut in place for rank `cut.rank` of a tensor group of
    `cut.size` (a `TensorCut`): each parameter of `cut_plan` replaced by
    its cut (a new parameter, so call it before the optimizer is built
    over `model.parameters()`), marked with its kind, and `tp` set on
    every module that reads the cut. Call it after the weights are final
    on every rank (init, broadcast, reference import); ValueError where
    T does not divide the heads or an MLP width. → `model`."""
    plan, mods = cut_plan(model)
    for m in mods:  # every check before anything is cut
        # a Swin block's own stage heads, else its config's
        heads = (getattr(m, "num_heads", None)
                 or getattr(m.c, "num_heads", None)
                 or m.c.num_attention_heads)
        tp.local_size(heads, cut.size, "heads")
    for name, kind in plan.items():  # the MLP widths
        if kind == tp.COLUMN and name.endswith("weight"):
            tp.local_size(_get(model, name).shape[0], cut.size,
                          f"output features of {name}")
    for name, kind in plan.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        old = getattr(mod, leaf)
        new = torch.nn.Parameter(tp.cut_tensor(old.data, kind, cut.size,
                                               cut.rank),
                                 requires_grad=old.requires_grad)
        setattr(mod, leaf, new)
    for m in mods:
        m.tp = cut
    model._xfm_tensor_plan = plan
    model._xfm_sequence_partial = sequence_partial(model, plan)
    _mark_cut(model)
    return model


def sequence_partial(model, plan) -> set:
    """The names of the whole parameters that act on a rank's rows of the
    sequence under `seq_shard` (each BEiT-2 block's and text, fusion or
    decoder layer's LayerNorms, layer scales and row biases: everything of
    the block that `plan` leaves whole but the rel-pos tables, whose
    columns `head_columns` reads with its gradient summed)."""
    from ..models.beit2 import BeitBlock
    from ..models.text_encoder import TransformerLayer

    out = set()
    for name, m in model.named_modules():
        if isinstance(m, (BeitBlock, TransformerLayer)) and m.c.seq_shard:
            for leaf, _ in m.named_parameters():
                full = f"{name}.{leaf}" if name else leaf
                if (full not in plan and not
                        leaf.endswith("relative_position_bias_table")):
                    out.add(full)
    return out


def _mark_cut(model) -> None:
    """Each cut parameter marked with its kind, each of
    `sequence_partial` as such (again after FSDP2 has replaced the
    parameters by its own)."""
    plan = getattr(model, "_xfm_tensor_plan", {})
    seq = getattr(model, "_xfm_sequence_partial", set())
    for name, p in model.named_parameters():
        if name in plan:
            p._xfm_tensor_cut = plan[name]
        if name in seq:
            p._xfm_sequence_partial = True


def sum_sequence_gradients(model) -> None:
    """The gradients of `sequence_partial`'s parameters, each rank's sum
    over its rows of the sequence, summed over the tensor group (in f32,
    written back in the gradient's dtype; on a sharded model the local
    shards, which line up across the group): the whole gradient on every
    rank. Once an optimizer step, before the clip; a no-op where the
    model runs no `seq_shard` under a tensor group."""
    cut = model_cut()
    if cut is None:
        return
    grads = [local(p.grad) for p in model.parameters()
             if getattr(p, "_xfm_sequence_partial", False)
             and p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    torch.distributed.all_reduce(flat, group=cut.group)
    off = 0
    with torch.no_grad():
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def is_cut(model) -> bool:
    """Whether `cut_model` has cut `model`."""
    return bool(getattr(model, "_xfm_tensor_plan", None))


def tensor_shards(module: torch.nn.Module, size: int) -> list:
    """The `size` cuts of a whole module (a block, a layer or a tower),
    each a copy cut for one rank with no group (`TensorCut` without
    communication): a check runs each and sums their partial outputs
    itself."""
    import copy

    return [cut_model(copy.deepcopy(module), tp.TensorCut(size, r))
            for r in range(size)]


def fsdp_size(config: dict) -> int:
    """The `fsdp` size of the config's `parallel` block (checked against
    the process group by `core/mesh.mesh_from_config`)."""
    from .mesh import mesh_from_config

    return mesh_from_config(config).fsdp


def is_sharded(model) -> bool:
    """Whether `shard_model` has sharded `model`."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def is_dtensor(t) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor's local shard (a view: writes reach the shard), any
    other tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def shard_group(params):
    """The process group over which `params` are sharded (the `fsdp` dim of
    their mesh), or None where none is a sharded tensor."""
    for p in params:
        if is_dtensor(p):
            dims = [i for i, pl in enumerate(p.placements) if pl.is_shard()]
            return p.device_mesh.get_group(dims[0]) if dims else None
    return None


def sum_over_shards(x: torch.Tensor, group) -> torch.Tensor:
    """`x` (a sum over a rank's shards) summed over the ranks of `group`
    (a new tensor); `x` itself where `group` is None."""
    if group is None:
        return x
    x = x.detach().clone()
    torch.distributed.all_reduce(x, group=group)
    return x


def full_tensor(t: torch.Tensor, like=None) -> torch.Tensor:
    """The whole tensor of a sharded one, gathered from every rank (each
    rank must call it): `t` a DTensor, or a local shard of the layout of
    the DTensor `like`, gathered over FSDP2's ranks; then, where `like`
    (or `t`) is tensor-cut, over the tensor group; any other tensor
    itself."""
    kind = tensor_cut_of(like if like is not None else t)
    if like is not None and is_dtensor(like) and not is_dtensor(t):
        from torch.distributed.tensor import DTensor

        t = DTensor.from_local(t, like.device_mesh, like.placements,
                               shape=like.shape, stride=like.stride())
    t = t.full_tensor() if is_dtensor(t) else t
    if kind is not None:
        t = tp.gather_tensor(t, kind, model_cut())
    return t


def shard_of(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the whole tensor `full` in the layout of
    `like` (cut locally, no communication): its tensor cut where `like`
    is tensor-cut, then its FSDP2 shard where `like` is a DTensor; `full`
    itself where `like` is neither."""
    kind = tensor_cut_of(like)
    if kind is not None:
        cut = model_cut()
        full = tp.cut_tensor(full, kind, cut.size, cut.rank)
    if not is_dtensor(like):
        return full
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(like.device), like.device_mesh,
                             like.placements, src_data_rank=None).to_local()


@torch.no_grad()
def full_parameters(model) -> dict:
    """name → the whole parameter: on a sharded or cut model gathered on
    every rank, copied to the host and cast to the dtype in which it
    computes (bf16 under `bf16_params`), as a one-process model holds it;
    else the live parameters themselves."""
    if not is_sharded(model) and not is_cut(model):
        return dict(model.named_parameters())
    dtype = getattr(model, "_xfm_param_dtype", None)
    out = {}
    for name, p in model.named_parameters():
        full = full_tensor(p)
        if dtype is not None and full.is_floating_point():
            full = full.to(dtype)
        out[name] = full.cpu()
    return out


def replicated_parameters(model) -> list:
    """The parameters that FSDP2 cannot shard and `shard_model` leaves
    whole on every rank: the 0-dim ones (`temp`). Their gradients are
    averaged over the ranks as on a replicated model
    (`core/mesh.reduce_gradients`)."""
    return [p for p in model.parameters() if p.dim() == 0]


def _guard_methods(model, names) -> None:
    """Each of `names` on the root registered with FSDP2, so that a call
    gathers the root's parameters first (and its backward reduce-scatters
    their gradients); a call made inside another registered call, inside
    the root's `forward` or inside `unsharded` runs the plain method."""
    from torch.distributed.fsdp import register_fsdp_forward_method

    depth = model._xfm_depth = [0]

    def enter(*_):
        depth[0] += 1

    def leave(*_):
        depth[0] -= 1

    model.register_forward_pre_hook(enter)
    model.register_forward_hook(leave, always_call=True)
    for name in names:
        plain = getattr(model, name)
        register_fsdp_forward_method(model, name)
        hooked = getattr(model, name)

        def method(*args, _plain=plain, _hooked=hooked, **kwargs):
            if depth[0]:
                return _plain(*args, **kwargs)
            depth[0] += 1
            try:
                return _hooked(*args, **kwargs)
            finally:
                depth[0] -= 1

        setattr(model, name, method)


def shard_model(model: torch.nn.Module, mesh,
                bf16_params: bool = False) -> torch.nn.Module:
    """`model` sharded in place over the `fsdp` dim of `mesh` (a
    DeviceMesh of dims ("data", "fsdp") or ("data", "fsdp", "tensor"),
    whose ("data", "fsdp") ranks of each tensor index shard what
    `cut_model` left; replicated over "data"): each
    module of `unit_types()` a unit, the model the
    root, every method of `ROOT_METHODS` it has registered; with
    `bf16_params` under the bf16 mixed-precision policy. Call it after the
    weights are final on every rank (init, broadcast, reference import)
    and before the optimizer is built over `model.parameters()`, which
    are then the shards. → `model`."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

    if mesh.ndim == 3:
        sub = mesh["data", "fsdp"] if mesh.size(0) > 1 else mesh["fsdp"]
    else:
        sub = mesh if mesh.ndim == 1 or mesh.size(0) > 1 else mesh["fsdp"]
    kw = dict(mesh=sub, reshard_after_forward=True)
    if bf16_params:
        kw["mp_policy"] = MixedPrecisionPolicy(
            param_dtype=torch.bfloat16, reduce_dtype=torch.float32,
            cast_forward_inputs=False)
    units = unit_types()
    for m in list(model.modules()):
        if m is not model and isinstance(m, units):
            fully_shard(m, **kw)
    replicated = replicated_parameters(model)
    fully_shard(model, ignored_params=set(replicated), **kw)
    # the root's setup, which its first forward would make: a unit that
    # runs first (inside `unsharded`) must find the model its root
    model._get_fsdp_state()._lazy_init()
    # the dtype the gathered weights compute in, as a checkpoint holds them
    model._xfm_param_dtype = torch.bfloat16 if bf16_params else None
    _mark_cut(model)
    _guard_methods(model, [n for n in ROOT_METHODS if hasattr(model, n)])
    return model


@contextlib.contextmanager
def unsharded(model):
    """The whole model gathered on every rank for the body, which runs
    without grad (an eval, a decode loop, SCST's sampling): every unit
    gathered once on entry, kept so while the body runs (no collective
    inside it, so ranks may make unequal numbers of calls: an eval's
    unequal shares, a decode that stops when its rows are done), and
    resharded on exit. Every rank enters together. On a model that is not
    sharded only the no-grad mode."""
    if not is_sharded(model):
        with torch.no_grad():
            yield model
        return
    from torch.distributed.fsdp import FSDPModule

    depth = model._xfm_depth
    outer = depth[0] == 0
    mods = [m for m in model.modules() if isinstance(m, FSDPModule)]
    if outer:
        for m in mods:
            m.unshard()
        model.set_reshard_after_forward(False)
    depth[0] += 1
    try:
        with torch.no_grad():
            yield model
    finally:
        depth[0] -= 1
        if outer:
            model.set_reshard_after_forward(True)
            for m in mods:
                m.reshard()


def unsharded_eval(fn):
    """`fn(model, ...)` (an eval) run inside `unsharded(model)`, without
    grad: on a model that is not sharded what `torch.no_grad()` gives."""

    @functools.wraps(fn)
    def wrapped(model, *args, **kwargs):
        with unsharded(model):
            return fn(model, *args, **kwargs)

    return wrapped
