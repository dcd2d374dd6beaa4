"""Tensor parallelism: the Megatron column/row pairs that the JAX package
gets from GSPMD (the `tensor` axis of `xfm_tpu/core/mesh.py` and the
tensor entries of `xfm_tpu/core/partitioning.py` `DEFAULT_RULES`), written
out for `torch.distributed`. There is no JAX file of it: GSPMD inserts
these collectives itself.

A block's attention and MLP each take one pair. The first layer is cut by
its output features (column: `qkv`, `query`/`key`/`value`, `fc1`,
`intermediate.dense`), so that a rank computes the heads or the inner
width that are its own from the whole (replicated) input; the second by
its input features (row: `proj`, `attention.output.dense`, `fc2`,
`output.dense`), so that a rank's product is a partial sum of the output,
which one all-reduce over the tensor group completes. The row layer's bias
is added once, after the reduce (`row_output`). The pair's input goes
through `copy_to_tensor` (identity forward, all-reduce backward: the
input's gradient is the sum of the ranks' partial gradients) and its
output through `reduce_from_tensor` (all-reduce forward, identity
backward).

The packed `qkv` [3C, C] is laid out q|k|v, head after head: a rank takes
the q, k and v rows of its own heads (`qkv_cut`), not a contiguous chunk.
A rel-pos table [num_rel, H] stays whole on every rank; a rank reads its
heads' columns (`head_columns`), whose gradient is summed over the group so
that every rank holds the whole table's gradient.

A `TensorCut` with no group is one shard held alone (a check that runs the
T shards in one process and sums their partials itself): its collectives
are the identity.

Sequence parallelism (Megatron-SP, the JAX package's `seq_shard`:
`xfm_tpu/core/mesh.py` `constrain_seq_sharding`, which GSPMD lowers to the
same collectives). Between the pairs a rank holds its rows of the
sequence, [B, ⌈N/T⌉, C], the sequence padded with zero rows to T·⌈N/T⌉;
the LayerNorms, layer scales, drop-path, dropout and residual adds run on
those rows alone. A stack enters the mode with `sequence(N)` after
`scatter_to_sequence` and leaves it with `gather_from_sequence`; inside,
a column layer's input is gathered (`column_input`: an all-gather, whose
backward is a reduce-scatter), and a row layer's partial sums are
reduce-scattered (`row_output`: summed in f32, the rank's rows taken, the
bias added, one rounding; backward an all-gather). The padding is dropped
at every gather, so a padded row reaches no attention, readout, loss or
gradient of a parameter. A parameter that acts on a rank's rows (a
LayerNorm's γ and β, a layer scale, a row layer's bias) gets a partial
gradient there; `core/partitioning.sum_sequence_gradients` sums it over
the group once an optimizer step.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch

COLUMN, ROW, QKV = "column", "row", "qkv"


@dataclasses.dataclass(frozen=True)
class TensorCut:
    """Rank `rank` of a tensor group of `size` ranks over `group` (a
    torch.distributed process group; None: no communication)."""
    size: int
    rank: int
    group: object = None

    def heads(self, num_heads: int) -> int:
        """This rank's share of `num_heads` (ValueError where T does not
        divide them)."""
        return local_size(num_heads, self.size, "heads")

    def head_range(self, num_heads: int) -> tuple:
        """(the first of this rank's heads, all heads): the slice of a
        mask drawn over every head (`ops/dropout.dropout`'s `heads`)."""
        return self.rank * self.heads(num_heads), num_heads


def local_size(n: int, size: int, what: str) -> int:
    """n / size, or ValueError where `size` does not divide `n`."""
    if n % size:
        raise ValueError(f"parallel.tensor = {size} does not divide the "
                         f"{n} {what}")
    return n // size


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tensor(x: torch.Tensor, cut: Optional[TensorCut]
                   ) -> torch.Tensor:
    """`x` (whole on every rank of the group) as it enters a column layer:
    the identity forward, its gradient summed over the group."""
    if cut is None or cut.group is None:
        return x
    return _CopyToTensor.apply(x, cut.group)


def reduce_from_tensor(x: torch.Tensor, cut: Optional[TensorCut]
                       ) -> torch.Tensor:
    """The ranks' partial sums `x` summed over the group (every rank gets
    the same bits); the gradient passes as it is."""
    if cut is None or cut.group is None:
        return x
    return _ReduceFromTensor.apply(x, cut.group)


def row_sum(partials, bias: Optional[torch.Tensor],
            dtype: torch.dtype) -> torch.Tensor:
    """Partial products summed in f32, the bias added once (in `dtype`,
    widened), rounded to `dtype`: the T shards' partials held in one
    process, or one rank's already reduced (`row_output`)."""
    out = sum(p.float() for p in partials)
    if bias is not None:
        out = out + bias.to(dtype).float()
    return out.to(dtype)


def row_output(partial: torch.Tensor, bias: Optional[torch.Tensor],
               cut: Optional[TensorCut], dtype: torch.dtype) -> torch.Tensor:
    """A row layer's output: the rank's partial product summed over the
    group in f32, then `row_sum`'s bias and rounding. Inside `sequence`
    the sum is reduce-scattered: this rank's rows [B, ⌈N/T⌉, C]."""
    if in_sequence(cut):
        return row_sum([_ReduceScatterRows.apply(partial.float(), cut)],
                       bias, dtype)
    return row_sum([reduce_from_tensor(partial.float(), cut)], bias, dtype)


def column_input(x: torch.Tensor, cut: Optional[TensorCut]) -> torch.Tensor:
    """`x` as a column layer reads it: whole on every rank
    (`copy_to_tensor`), or inside `sequence` this rank's rows gathered
    into the whole sequence (its gradient reduce-scattered)."""
    if in_sequence(cut):
        return gather_from_sequence(x, cut)
    return copy_to_tensor(x, cut)


def head_columns(table: torch.Tensor, cut: Optional[TensorCut]
                 ) -> torch.Tensor:
    """The columns [..., H/T] of this rank's heads of a table whose last
    dim is the heads (a rel-pos table), contiguous; the table's gradient
    summed over the group. The table itself where `cut` is None."""
    if cut is None:
        return table
    h = local_size(table.shape[-1], cut.size, "heads")
    cols = copy_to_tensor(table, cut)[..., cut.rank * h:(cut.rank + 1) * h]
    return cols.contiguous()


# --- sequence parallelism ---------------------------------------------------

_SEQUENCE: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "sequence_length", default=None)


@contextlib.contextmanager
def sequence(n: Optional[int]):
    """The blocks inside hold a rank's rows of a sequence of `n` (None:
    the whole sequence, as outside)."""
    token = _SEQUENCE.set(n)
    try:
        yield
    finally:
        _SEQUENCE.reset(token)


def sequence_length() -> Optional[int]:
    """The length of the sequence whose rows the blocks hold, or None."""
    return _SEQUENCE.get()


def in_sequence(cut: Optional[TensorCut]) -> bool:
    """Whether a module cut by `cut` runs on a rank's rows here."""
    return cut is not None and cut.group is not None \
        and _SEQUENCE.get() is not None


def sequence_cut(cut: Optional[TensorCut], seq_shard: bool
                 ) -> Optional[TensorCut]:
    """`cut` where a stack whose config has `seq_shard` runs sharded over
    the sequence (a tensor group of more than one rank), else None."""
    if not seq_shard or cut is None or cut.group is None or cut.size == 1:
        return None
    return cut


def rows_per_rank(n: int, size: int) -> int:
    """⌈n / size⌉: a rank's rows of a sequence of n padded to size·that."""
    return -(-n // size)


def row_range(cut: Optional[TensorCut]):
    """(the first of this rank's rows, the sequence's length) inside
    `sequence` (the rows of a mask drawn over the whole sequence:
    `ops/dropout.dropout`'s `rows`), else None."""
    if not in_sequence(cut):
        return None
    n = _SEQUENCE.get()
    return cut.rank * rows_per_rank(n, cut.size), n


def own_rows(x: torch.Tensor, cut: TensorCut) -> torch.Tensor:
    """Rank `cut.rank`'s rows [B, ⌈N/T⌉, ...] of x [B, N, ...] (a copy;
    zero rows past N): what `scatter_to_sequence` gives it, with no
    communication."""
    m = rows_per_rank(x.shape[1], cut.size)
    pad = cut.size * m - x.shape[1]
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)
    return x[:, cut.rank * m:(cut.rank + 1) * m].contiguous()


def _gather_rows(x: torch.Tensor, cut: TensorCut, n: int) -> torch.Tensor:
    """Every rank's rows x [B, ⌈n/T⌉, ...] all-gathered over the group
    into the sequence [B, n, ...], the padding dropped."""
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(cut.size)]
    dist.all_gather(parts, x, group=cut.group)
    return torch.cat(parts, dim=1)[:, :n]


def _reduce_scatter_rows(x: torch.Tensor, cut: TensorCut) -> torch.Tensor:
    """x [B, N, ...] summed over the group, this rank's rows taken
    ([B, ⌈N/T⌉, ...], zero rows past N summed as zeros)."""
    import torch.distributed as dist

    m = rows_per_rank(x.shape[1], cut.size)
    pad = cut.size * m - x.shape[1]
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)
    rows = x.transpose(0, 1).contiguous()  # the rows leading, rank by rank
    out = rows.new_empty((m,) + rows.shape[1:])
    dist.reduce_scatter_tensor(out, rows, group=cut.group)
    return out.transpose(0, 1).contiguous()


class _ScatterToSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cut):
        ctx.cut, ctx.n = cut, x.shape[1]
        return own_rows(x, cut)

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g, ctx.cut, ctx.n), None


class _GatherFromSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cut, n, to_column):
        ctx.cut, ctx.to_column = cut, to_column
        return _gather_rows(x, cut, n)

    @staticmethod
    def backward(ctx, g):
        if ctx.to_column:
            return _reduce_scatter_rows(g, ctx.cut), None, None, None
        return own_rows(g, ctx.cut), None, None, None


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cut):
        ctx.cut, ctx.n = cut, x.shape[1]
        return _reduce_scatter_rows(x, cut)

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g, ctx.cut, ctx.n), None


def scatter_to_sequence(x: torch.Tensor, cut: TensorCut) -> torch.Tensor:
    """This rank's rows [B, ⌈N/T⌉, C] of x [B, N, C] (whole and equal on
    every rank), zero rows past N; the gradient all-gathered."""
    return _ScatterToSequence.apply(x, cut)


def gather_from_sequence(x: torch.Tensor, cut: TensorCut,
                         n: Optional[int] = None, to_column: bool = True
                         ) -> torch.Tensor:
    """The sequence [B, n, C] (n: `sequence_length()` by default) from
    every rank's rows x, the padding dropped. Its gradient: where it feeds
    a column layer (`to_column`), each rank's partial gradient of the
    whole sequence, so reduce-scattered; where a whole consumer that every
    rank runs alike reads it (a readout, a head), this rank's rows of it."""
    n = _SEQUENCE.get() if n is None else n
    return _GatherFromSequence.apply(x, cut, n, to_column)


# --- the cuts and their inverses --------------------------------------------

def column_cut(w: torch.Tensor, size: int, rank: int) -> torch.Tensor:
    """Rows [r·n/T, (r+1)·n/T) of a weight [n, ...] or a bias [n]."""
    n = local_size(w.shape[0], size, "output features")
    return w[rank * n:(rank + 1) * n]


def row_cut(w: torch.Tensor, size: int, rank: int) -> torch.Tensor:
    """Columns [r·k/T, (r+1)·k/T) of a weight [n, k]."""
    k = local_size(w.shape[1], size, "input features")
    return w[:, rank * k:(rank + 1) * k]


def qkv_cut(w: torch.Tensor, size: int, rank: int) -> torch.Tensor:
    """The q, k and v rows of this rank's heads of a packed [3C, ...]
    weight, in that order: [3C/T, ...]."""
    return torch.cat([column_cut(part, size, rank)
                      for part in w.chunk(3, dim=0)])


CUTS = {COLUMN: column_cut, ROW: row_cut, QKV: qkv_cut}


def cut_tensor(w: torch.Tensor, kind: str, size: int, rank: int
               ) -> torch.Tensor:
    """Rank `rank`'s cut of the whole tensor `w` (a contiguous copy)."""
    return CUTS[kind](w, size, rank).contiguous().clone()


def join(parts, kind: str) -> torch.Tensor:
    """The whole tensor from the T ranks' cuts (`parts` in rank order)."""
    if kind == COLUMN:
        return torch.cat(list(parts), dim=0)
    if kind == ROW:
        return torch.cat(list(parts), dim=1)
    if kind == QKV:
        thirds = [p.chunk(3, dim=0) for p in parts]
        return torch.cat([t[i] for i in range(3) for t in thirds], dim=0)
    raise ValueError(f"unknown tensor cut {kind!r}")


def gather_tensor(t: torch.Tensor, kind: str, cut: TensorCut
                  ) -> torch.Tensor:
    """The whole tensor from every rank's cut `t` (each rank of the group
    calls it): all-gathered over the group and joined."""
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(cut.size)]
    dist.all_gather(parts, t.contiguous(), group=cut.group)
    return join(parts, kind)
