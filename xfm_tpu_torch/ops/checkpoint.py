"""Activation checkpointing: the `remat_policy` of `xfm_tpu/ops/attention.py`
and the `nn.remat` that `xfm_tpu/models/beit2.py` and
`xfm_tpu/models/text_encoder.py` put around each BEiT-2 block and each
text, fusion or decoder layer when the config's `remat` is on
(`gradient_checkpointing` in a YAML).

A block or layer runs through `checkpoint_block`, which under grad and
`remat` hands it to `torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)`; the policy says what the forward keeps:

- `full`: the block's inputs only. The backward reruns the whole block
  first.
- `dots`: besides, the outputs of the weight products (`aten.mm`,
  `aten.addmm`: no batch dims, as JAX's `dots_with_no_batch_dims_saveable`)
  through `create_selective_checkpoint_contexts`; the rest (LayerNorms,
  activations, dropout, the attention's batched products) is recomputed.
- `attn_out`: besides the inputs, each attention module's output (the
  [B, N, C] before its out-projection, tagged by `name_attn_out`), also
  through a selective context; everything else is recomputed.
- `except_attn`: no block is checkpointed. Only the plain attention
  (`ops/attention.attention_reference`, with no live dropout) recomputes
  its logits and probabilities from the q, k, v and bias it saves, the
  one place where the JAX package names `attn_logits` and `attn_probs`;
  elsewhere everything is kept, as the JAX policy keeps every unnamed
  residual. `XFM_ATTN_REMAT=1` (the configs' `attn_remat`) is the same
  checkpoint of the plain attention, under any policy or none.

The kernels K1-K5 launch through `ctypes` inside `torch.autograd.Function`s,
which the selective contexts' dispatch mode does not see: their outputs
are never cached, so under `full`, `dots` and `attn_out` the recompute
launches every kernel of the block's forward once more (K1's forward
twice a block and step, its backward once). Under `except_attn` no kernel
is launched again.

Live dropout in a checkpointed block draws from the active generator
(`ops/dropout.py`); the recompute draws from a copy restored to that
generator's state when the block first ran, so its masks are the
forward's and the step's generator ends where it would without
checkpointing. Under `seq_shard` the recompute runs inside the
`ops/tensor_parallel.sequence` the block first ran in, so it replays the
block's gathers and reduce-scatters on the same rows. Unlike the JAX package, which reads an unknown policy name
as `full`, `remat_policy` raises on one.
"""
from __future__ import annotations

import contextvars
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from .dropout import active_generator, dropout_generator
from .tensor_parallel import sequence, sequence_length

POLICIES = ("full", "dots", "except_attn", "attn_out")

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
# set while `name_attn_out` dispatches its alias, so that the `attn_out`
# policy saves that op's output and no other alias
_NAMING = contextvars.ContextVar("naming_attn_out", default=False)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_attn_out(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE
            if op is torch.ops.aten.alias.default and _NAMING.get()
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy(name: str):
    """The `context_fn` of `torch.utils.checkpoint.checkpoint` for a block
    under policy `name`, or None for `except_attn` (no block checkpoint);
    raises on a name outside `POLICIES`."""
    if name == "full":
        return noop_context_fn
    if name == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
    if name == "attn_out":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_attn_out)
    if name == "except_attn":
        return None
    raise ValueError(f"unknown remat_policy {name!r}: one of {POLICIES}")


def name_attn_out(x: torch.Tensor) -> torch.Tensor:
    """An alias of an attention module's output that the `attn_out` policy
    saves (a view: no copy)."""
    token = _NAMING.set(True)
    try:
        return torch.ops.aten.alias.default(x)
    finally:
        _NAMING.reset(token)


def run_checkpointed(fn, *args, policy: str = "full"):
    """fn(*args) under `torch.utils.checkpoint.checkpoint` with `policy`'s
    context, its recompute drawing dropout from the active generator's
    state at this call."""
    context_fn = remat_policy(policy)
    if context_fn is None:
        raise ValueError(f"remat_policy {policy!r} checkpoints no block")
    g = active_generator()
    state = None if g is None else g.get_state()
    n = sequence_length()
    first = [True]

    def body(*a):
        if first[0]:
            first[0] = False
            return fn(*a)
        replay = None
        if state is not None:
            replay = torch.Generator(device=g.device)
            replay.set_state(state)
        with dropout_generator(replay), sequence(n):
            return fn(*a)

    return checkpoint(body, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=context_fn)


def checkpoint_block(cfg, fn, *args):
    """fn(*args) for one block or layer of a stack whose config is `cfg`
    (`remat`, `remat_policy`): checkpointed under grad unless the policy is
    `except_attn`."""
    if (cfg.remat and cfg.remat_policy != "except_attn"
            and torch.is_grad_enabled()):
        return run_checkpointed(fn, *args, policy=cfg.remat_policy)
    return fn(*args)


def attention_remat(cfg) -> bool:
    """Whether the plain attention of a stack with config `cfg` recomputes
    its logits and probabilities: `attn_remat` (XFM_ATTN_REMAT=1) or the
    `except_attn` policy."""
    return cfg.attn_remat or (cfg.remat and cfg.remat_policy == "except_attn")


def names_attn_out(cfg) -> bool:
    """Whether the attention modules of `cfg`'s stack tag their output for
    the `attn_out` policy."""
    return cfg.remat and cfg.remat_policy == "attn_out"
