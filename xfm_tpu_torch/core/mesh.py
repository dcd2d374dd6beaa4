"""Data parallelism across processes (`xfm_tpu/core/mesh.py`'s `data`
axis) as `torch.distributed`: one process a card, NCCL on the card and
gloo on the CPU.

The JAX package computes every loss over the global batch, because GSPMD
sees one array. Here each of the W processes holds B / W rows of the
global batch of B (`rank_slice`), and the rule the port keeps is that a
step on W processes equals one process's step on all B rows: the loss,
every gradient and the updated parameters. The pieces of that rule:

- a loss over the batch is written as W × this rank's share of the global
  loss: a mean over rows as the mean over the rank's rows (the ranks hold
  equal rows), a mean over a count (masked tokens, masked patches, region
  rows) as the rank's sum over the global count divided by W
  (`mean_divisor`); a loss over pairs of rows (ITC, the hard negatives)
  takes the other ranks' rows from `all_gather_with_grad`, whose backward
  carries each rank's gradient back to the rank that owns the rows;
- the gradients are averaged over the ranks once per optimizer step,
  before the clip (`reduce_gradients`), so that the sum of the W shares
  is differentiated;
- draws over the global batch (the hard negatives) come from a generator
  equal on every rank, draws over a rank's own rows (dropout, drop-path,
  augmentation, mixup, sampling) from one with the rank folded into its
  seed (`StepGenerators`, `rank_seed`);
- an eval gives rank r the batches r, r + W, … of the one-process eval
  (`rank_batches`, or the examples r, r + W, … with `rank_strided`), and
  merges what the ranks computed: counts summed (`sum_over_ranks`),
  predictions gathered at unequal lengths (`all_gather_ragged`) and put
  back in the one-process order (`merge_rank_batches`), so that the
  metric is the one-process metric.

`fsdp` > 1 shards the parameters over the ranks of each replica
(`core/partitioning`, FSDP2), and FSDP2's reduce-scatter takes the place
of `reduce_gradients`. `tensor` T > 1 cuts the attention and MLP weights
of every block over the T ranks of a tensor group (`core/partitioning`,
`ops/tensor_parallel`; with `seq_shard` the blocks' hidden states are
sharded over the sequence between the pairs): the T ranks of a group take
the same rows, so the
batch is split over the data × fsdp ranks only (`dp_size`, `dp_rank`),
and every batch split, generator and merge above runs over those ranks
(`use_mesh` makes their groups): on W = D·F·T processes a step equals one
process's step on the global batch as before, and an eval counts each row
once. The tensor axis is innermost (consecutive ranks share a group).
`pipe` > 1 in a config's `parallel` block raises (`mesh_from_config`).
`constrain_batch_sharding` is a GSPMD layout hint that the batch split
above replaces; `constrain_seq_sharding`'s layout is
`ops/tensor_parallel`'s sequence functions, which the BEiT-2 tower and
the text stacks call under `seq_shard`."""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch


class MultiProcessUnsupported(NotImplementedError):
    """A `parallel` setting that does not run in the port yet (ROADMAP.md,
    Queue 1: pipeline parallelism), or a function with no entry point
    that runs on one process only (GradCAM grounding)."""


def _dist():
    """torch.distributed where a process group is initialized, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def world_size() -> int:
    """The process group's size where one is initialized, else 1."""
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def rank() -> int:
    """This process's rank in the group, 0 without one."""
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


@dataclasses.dataclass
class _Layout:
    """This process's place on the mesh: the tensor size and the two
    groups of `use_mesh` (None while T = 1: the default group is both)."""
    tensor: int = 1
    tensor_group: object = None
    dp_group: object = None


_LAYOUT = _Layout()


def tensor_size() -> int:
    """T: the ranks of a tensor group, which hold the cuts of one weight
    and take the same rows (1 unless `use_mesh` set more)."""
    return _LAYOUT.tensor


def tensor_rank() -> int:
    """This process's place in its tensor group."""
    return rank() % tensor_size()


def tensor_group():
    """The process group of this rank's tensor group (ranks T·d … T·d +
    T − 1), or None where T = 1."""
    return _LAYOUT.tensor_group


def dp_size() -> int:
    """The ranks the batch is split over: data × fsdp = W / T."""
    return world_size() // tensor_size()


def dp_rank() -> int:
    """This rank's place among the `dp_size` ranks that split the batch
    (the rank of its tensor group)."""
    return rank() // tensor_size()


def dp_group():
    """The process group of the data × fsdp ranks at this rank's tensor
    index (ranks t, t + T, …): the collectives over the batch; None (the
    default group) where T = 1."""
    return _LAYOUT.dp_group


def is_distributed() -> bool:
    """The batch is split over more than one rank (`dp_size` > 1)."""
    return dp_size() > 1


def maybe_init_distributed(device: str = "cuda") -> str:
    """The process group of a `torchrun` launch (its `RANK`, `WORLD_SIZE`,
    `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`), as `XFM_MULTIHOST` and
    the coordinator variables gate `jax.distributed.initialize` in the JAX
    package: NCCL for a card, with `torch.cuda.set_device(LOCAL_RANK)`,
    gloo for `device` "cpu" → the device this process computes on
    ("cuda:LOCAL_RANK" for a card). No-op (returning `device`) outside
    `torchrun`, with `XFM_MULTIHOST=0`, or where a group exists. A card
    asked for where none is visible raises, and so does a failed
    rendezvous: no rank carries on alone."""
    import torch.distributed as dist

    torchrun = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if (os.environ.get("XFM_MULTIHOST") == "0" or not torchrun
            or dist.is_initialized()):
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    on_card = not str(device).startswith("cpu")
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"torchrun rank {os.environ['RANK']}: device {device!r} asked "
                "for but no CUDA device is visible; pass --device cpu to run "
                "the processes on the CPU (gloo)")
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
    dist.init_process_group(backend="nccl" if on_card else "gloo",
                            init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    return device


class MeshShape(NamedTuple):
    """The sizes of the port's three axes, `data` (replicas), `fsdp`
    (parameter shards, `core/partitioning`) and `tensor` (the Megatron
    cut, `ops/tensor_parallel`), whose product is the world size. Rank r
    sits at (r // (fsdp·tensor), r // tensor % fsdp, r % tensor), the
    `data` axis outer and `tensor` inner, as the JAX package lays its
    devices out."""
    data: int
    fsdp: int
    tensor: int = 1


def mesh_from_config(config: dict) -> MeshShape:
    """The config's `parallel` block → the `MeshShape` of the processes
    (one a card), as `xfm_tpu/core/mesh.py` `mesh_from_config`: `fsdp` ×
    `tensor` must divide the world size, `data: -1` takes the rest of it,
    any other `data` must make data × fsdp × tensor the world size (else
    ValueError); `pipe` > 1 raises `MultiProcessUnsupported` (ROADMAP.md
    Queue 1, item 4: `core/pipeline` (GPipe)). Whether T divides the
    heads and the MLP width is checked where the model is cut
    (`core/partitioning.cut_model`)."""
    par = config.get("parallel") or {}
    if int(par.get("pipe", 1) or 1) > 1:
        raise MultiProcessUnsupported(
            f"parallel.pipe = {par['pipe']}: the port runs the data, fsdp "
            f"and tensor axes; core/pipeline (GPipe) is in ROADMAP.md "
            f"Queue 1, item 4 (multi-card past the data axis)")
    w = world_size()
    fsdp = int(par.get("fsdp", 1) or 1)
    tensor = int(par.get("tensor", 1) or 1)
    if fsdp < 1 or tensor < 1 or w % (fsdp * tensor):
        raise ValueError(f"parallel.fsdp = {fsdp} × tensor = {tensor} does "
                         f"not divide the {w} processes")
    data = int(par.get("data", -1) or -1)
    if data == -1:
        data = w // (fsdp * tensor)
    if data * fsdp * tensor != w:
        raise ValueError(f"parallel.data = {data} × fsdp = {fsdp} × tensor "
                         f"= {tensor} but {w} processes run")
    return MeshShape(data, fsdp, tensor)


def use_mesh(shape: MeshShape) -> MeshShape:
    """Place this process on `shape`: with T = `shape.tensor` > 1 the
    tensor groups (T consecutive ranks) and the data × fsdp groups (the
    ranks of one tensor index) made, which every rank must do together;
    T = 1 leaves the default group for both. The same T again keeps the
    groups made. → `shape`."""
    t = int(shape.tensor)
    if t == _LAYOUT.tensor and (t == 1 or _LAYOUT.tensor_group is not None):
        return shape
    dist = _dist()
    w = world_size()
    if t == 1:
        _LAYOUT.__init__()
        return shape
    if dist is None or w % t:
        raise ValueError(f"parallel.tensor = {t} needs a process group of a "
                         f"multiple of {t} processes, not {w}")
    me = rank()
    tgroup = dgroup = None
    for d in range(w // t):  # every rank makes every group, in one order
        g = dist.new_group(list(range(d * t, (d + 1) * t)))
        if me // t == d:
            tgroup = g
    for i in range(t):
        g = dist.new_group(list(range(i, w, t)))
        if me % t == i:
            dgroup = g
    _LAYOUT.tensor, _LAYOUT.tensor_group, _LAYOUT.dp_group = t, tgroup, dgroup
    return shape


def device_mesh(shape: MeshShape, device):
    """The `torch.distributed` DeviceMesh of `shape` with the dims
    ("data", "fsdp", "tensor") over the initialized group, on the CPU
    (gloo) or the card (NCCL) of `device`."""
    from torch.distributed.device_mesh import init_device_mesh

    kind = "cpu" if str(device).startswith("cpu") else "cuda"
    return init_device_mesh(kind, (shape.data, shape.fsdp, shape.tensor),
                            mesh_dim_names=("data", "fsdp", "tensor"))


def rank_seed(seed) -> list:
    """A seed list with this rank folded in where more than one process
    runs (a rank's own augmentation): on one process the list as it is, so
    that a single-process run draws what it drew before."""
    seed = list(seed) if isinstance(seed, (list, tuple)) else [seed]
    return seed + [dp_rank()] if is_distributed() else seed


def rank_rows(order: np.ndarray, batch_size: int) -> np.ndarray:
    """This rank's rows of each global batch of W · `batch_size` rows of
    `order`: rows [r·b, (r+1)·b) of each, so that the union over the ranks
    is the one-process order, batch by batch; a last partial global batch
    is dropped. One process: `order` as it is. W and r here and below are
    `dp_size` and `dp_rank`: the ranks of a tensor group share rows."""
    w = dp_size()
    if w == 1:
        return order
    n = len(order) // (w * batch_size)
    return np.asarray(order)[: n * w * batch_size].reshape(
        n, w, batch_size)[:, dp_rank()].reshape(-1)


def rank_strided(items):
    """Items r, r + W, r + 2W, … of this rank r (its share of an eval)."""
    return items[dp_rank()::dp_size()]


def rank_batches(items, batch_size: int):
    """This rank r's share of an eval: `items` cut in order into batches of
    `batch_size` (the last may be partial), batches r, r + W, r + 2W, …
    concatenated, so that every batch a rank evaluates is one that a
    single process forms (`merge_rank_batches` puts their rows back in
    order). One process: `items` as they are."""
    w = dp_size()
    if w == 1:
        return items
    idx = [i for s in range(dp_rank() * batch_size, len(items),
                            w * batch_size)
           for i in range(s, min(s + batch_size, len(items)))]
    if isinstance(items, np.ndarray):
        return items[idx]
    return [items[i] for i in idx]


def merge_rank_batches(parts, batch_size: int) -> np.ndarray:
    """The rows of every rank's `rank_batches` (`parts`, one array a rank
    in rank order) back in the one-process order."""
    w = len(parts)
    n = sum(len(p) for p in parts)
    out, taken = [], [0] * w
    for g, s in enumerate(range(0, n, batch_size)):
        r, k = g % w, min(batch_size, n - s)
        out.append(parts[r][taken[r]:taken[r] + k])
        taken[r] += k
    if taken != [len(p) for p in parts]:
        raise ValueError(f"rows of each rank {[len(p) for p in parts]} are "
                         f"not the batches of {batch_size} of {n} rows")
    return np.concatenate(out) if out else np.asarray(parts[0])


def rank_slice(batch):
    """This rank r's rows [r·B/W, (r+1)·B/W) of each array of a global
    batch (a dict, tuple or list of arrays or tensors), as `shard_batch`
    places them; an array whose leading size does not divide by W stays
    whole, as the JAX package replicates it."""
    r, w = dp_rank(), dp_size()

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(take(v) for v in x)
        shape = getattr(x, "shape", ())
        if w == 1 or not shape or shape[0] == 0 or shape[0] % w:
            return x
        n = shape[0] // w
        return x[r * n:(r + 1) * n]

    return take(batch)


# --- the step's generators ------------------------------------------------

@dataclasses.dataclass
class StepGenerators:
    """A step's two generators: `shared`, equal on every rank, for draws
    over the global batch (the hard negatives); `rank`, with the rank
    folded into its seed, for draws over the rank's own rows (dropout,
    drop-path, RandAugment, sampling). The JAX package draws both from one
    key over the global arrays."""
    shared: torch.Generator
    rank: torch.Generator


def shared_generator(g):
    """The generator of draws over the global batch: a `StepGenerators`'
    `shared`, or a plain generator itself."""
    return g.shared if isinstance(g, StepGenerators) else g


def rank_generator(g):
    """The generator of draws over a rank's own rows: a `StepGenerators`'
    `rank`, or a plain generator itself."""
    return g.rank if isinstance(g, StepGenerators) else g


def step_generators(seed: int, key, device) -> StepGenerators:
    """The shared generator seeded from (seed, *key) and the rank's from
    the same entropy spawned at the rank."""
    entropy = [int(seed), *map(int, key)]
    shared = int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0])
    own = int(np.random.SeedSequence(entropy, spawn_key=(dp_rank(),))
              .generate_state(1, np.uint64)[0])
    return StepGenerators(
        shared=torch.Generator(device=device).manual_seed(shared),
        rank=torch.Generator(device=device).manual_seed(own))


# --- collectives ------------------------------------------------------------
# Each runs over the data × fsdp ranks of this rank's tensor index
# (`dp_group`; the whole group where T = 1), so that the T ranks of a
# tensor group, which hold the same rows, are counted once.

def all_gather(x: torch.Tensor) -> torch.Tensor:
    """The ranks' `x` (equal shapes) concatenated along dim 0 in rank
    order, without gradient; `x` itself on one process."""
    dist = _dist()
    if dist is None or dp_size() == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dp_size())]
    dist.all_gather(parts, x.contiguous(), group=dp_group())
    return torch.cat(parts)


class _AllGatherWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rank, ctx.n = dp_rank(), x.shape[0]
        return all_gather(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        # each rank's gradient of the gathered rows, summed over the ranks
        # (gloo has no reduce-scatter), then the owner's own rows
        grad = grad.contiguous()
        dist.all_reduce(grad, group=dp_group())
        return grad[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """`all_gather` whose backward sums every rank's gradient of a rank's
    rows back to that rank; `x` itself on one process."""
    if not is_distributed():
        return x
    return _AllGatherWithGrad.apply(x)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks (a new tensor, no gradient)."""
    dist = _dist()
    if dist is None or dp_size() == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=dp_group())
    return x


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks (a new tensor, no gradient)."""
    w = dp_size()
    return x if w == 1 else all_reduce_sum(x) / w


def mean_divisor(count: torch.Tensor, floor: float = 1.0) -> torch.Tensor:
    """The divisor of a mean over a count (masked tokens, patches, rows):
    max(global count, `floor`) / W, so that this rank's sum over it is W ×
    the rank's share of the global mean; on one process max(count,
    `floor`)."""
    if not is_distributed():
        return torch.clamp(count, min=floor)
    total = all_reduce_sum(count.detach().to(torch.float64))
    return (torch.clamp(total, min=floor) / dp_size()).to(
        torch.float32 if not count.is_floating_point() else count.dtype)


def barrier() -> None:
    """Every rank of the group meets here."""
    dist = _dist()
    if dist is not None and dist.get_world_size() > 1:
        dist.barrier()


def collective_device():
    """Where the backend's collectives take their tensors: this process's
    card under NCCL, the CPU under gloo."""
    dist = _dist()
    if dist is not None and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_numpy(a: np.ndarray) -> np.ndarray:
    """The ranks' arrays (equal shapes) stacked → [W, *shape]."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(collective_device())
    return all_gather(t[None]).cpu().numpy()


def all_gather_ragged(a: np.ndarray) -> list:
    """The ranks' arrays of one dtype and trailing shape but unequal
    lengths → a list of them in rank order: each padded to the longest,
    gathered, and cut back to the true length gathered beside it. On one
    process [a]."""
    a = np.asarray(a)
    if not is_distributed():
        return [a]
    lengths = all_gather_numpy(np.asarray([len(a)], np.int64))[:, 0]
    pad = np.zeros((int(lengths.max()) - len(a),) + a.shape[1:], a.dtype)
    rows = all_gather_numpy(np.concatenate([a, pad]))
    return [rows[r, :n] for r, n in enumerate(lengths)]


def sum_over_ranks(*counts: int) -> tuple:
    """Integer counts summed over the ranks (one int64 all-reduce); on one
    process the counts themselves."""
    if not is_distributed():
        return tuple(int(c) for c in counts)
    t = torch.tensor([int(c) for c in counts], dtype=torch.int64,
                     device=collective_device())
    return tuple(int(v) for v in all_reduce_sum(t).tolist())


def broadcast_object(obj, src: int = 0):
    """`obj` of rank `src` on every rank; `obj` itself on one process."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src,
                               device=collective_device())
    return box[0]


def broadcast_parameters(model: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of rank `src` written into the others',
    so that the ranks start from one state."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=src)


# one all-reduce moves at most this many f32 gradient elements (256 MiB)
BUCKET_ELEMENTS = 64 << 20


def reduce_gradients(params) -> None:
    """The mean over the ranks of the `.grad` of `params` (every one that
    requires a gradient, in their order), in flattened f32 buckets of at
    most `BUCKET_ELEMENTS`, written back in each gradient's dtype. A
    parameter no rank's loss reached (an unused tower) gets a zero
    gradient, which the port's optimizers step as they step a missing one.
    Call it once an optimizer step, before the clip; a no-op on one
    process. Never on a model that `core/partitioning.shard_model` sharded:
    FSDP2 has reduce-scattered its gradients in the backward already. A
    weight cut over the tensor group is averaged with the same cut of the
    other replicas."""
    dist = _dist()
    if dist is None or dp_size() == 1:
        return
    w = dp_size()
    params = [p for p in params if p.requires_grad]
    with torch.no_grad():
        start = 0
        while start < len(params):
            end, n = start, 0
            while end < len(params) and (
                    n == 0 or n + params[end].numel() <= BUCKET_ELEMENTS):
                n += params[end].numel()
                end += 1
            group = params[start:end]
            dev = group[0].device
            flat = torch.cat([
                (p.grad if p.grad is not None else torch.zeros_like(p))
                .reshape(-1).to(device=dev, dtype=torch.float32)
                for p in group])
            dist.all_reduce(flat, group=dp_group())
            flat /= w
            off = 0
            for p in group:
                g = flat[off:off + p.numel()].view_as(p)
                off += p.numel()
                if p.grad is None:
                    p.grad = g.to(p.dtype).clone()
                else:
                    p.grad.copy_(g)
            start = end


def reduce_metrics(metrics: dict) -> dict:
    """The scalar tensors of `metrics` averaged over the ranks in one
    all-reduce (each a rank's W × share, so the mean is the global value);
    `grad_norm` (the reduced gradient's, equal on every rank already) and
    non-scalars stay as they are."""
    if not is_distributed():
        return metrics
    names = [k for k, v in metrics.items()
             if torch.is_tensor(v) and v.dim() == 0 and k != "grad_norm"]
    if not names:
        return metrics
    vals = all_reduce_mean(torch.stack([metrics[k].detach().float()
                                        for k in names]))
    return {**metrics, **dict(zip(names, vals.unbind(0)))}
