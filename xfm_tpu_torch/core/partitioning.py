"""Parameter sharding over the `fsdp` axis (`xfm_tpu/core/partitioning.py`)
as FSDP2: `torch.distributed.fsdp.fully_shard` on a DeviceMesh of dims
("data", "fsdp") (`core/mesh.device_mesh`), which is HSDP where data > 1
and plain FSDP where data = 1. NCCL on the card, gloo on the CPU.

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
"""
from __future__ import annotations

import contextlib
import functools

import torch

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
    the DTensor `like`; any other tensor itself."""
    if like is not None and is_dtensor(like) and not is_dtensor(t):
        from torch.distributed.tensor import DTensor

        t = DTensor.from_local(t, like.device_mesh, like.placements,
                               shape=like.shape, stride=like.stride())
    return t.full_tensor() if is_dtensor(t) else t


def shard_of(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the whole tensor `full` in the layout of the
    DTensor `like` (cut locally, no communication); `full` itself where
    `like` is no DTensor."""
    if not is_dtensor(like):
        return full
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(like.device), like.device_mesh,
                             like.placements, src_data_rank=None).to_local()


@torch.no_grad()
def full_parameters(model) -> dict:
    """name → the whole parameter: on a sharded model gathered on every
    rank, copied to the host and cast to the dtype in which it computes
    (bf16 under `bf16_params`), as a one-process model holds it; else the
    live parameters themselves."""
    if not is_sharded(model):
        return dict(model.named_parameters())
    dtype = model._xfm_param_dtype
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
    DeviceMesh of dims ("data", "fsdp"); replicated over "data"): each
    module of `unit_types()` a unit, the model the
    root, every method of `ROOT_METHODS` it has registered; with
    `bf16_params` under the bf16 mixed-precision policy. Call it after the
    weights are final on every rank (init, broadcast, reference import)
    and before the optimizer is built over `model.parameters()`, which
    are then the shards. → `model`."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

    kw = dict(mesh=mesh if mesh.ndim == 1 or mesh.size(0) > 1
              else mesh["fsdp"], reshard_after_forward=True)
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
