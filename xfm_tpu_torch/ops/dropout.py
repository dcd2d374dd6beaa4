"""Dropout and drop-path (flax `nn.Dropout`, `xfm_tpu/models/beit2.py`
`DropPath`, the attention-probability dropout of `xfm_tpu/ops/attention.py`
`_dropout_attention`).

A mask keeps an element where a uniform draw is below 1 − rate, as
`jax.random.bernoulli` does, and survivors are divided by 1 − rate in the
input's dtype. Masks are drawn with `torch.rand(..., generator=g)` from the
generator of the innermost `dropout_generator(g)` block, never from the
global RNG: the step's generator, shared with the hard-negative draw, in
the forward's order. With `deterministic` or a rate of 0 nothing is drawn
and the input comes back as it is.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

_GENERATOR: contextvars.ContextVar[Optional[torch.Generator]] = \
    contextvars.ContextVar("dropout_generator", default=None)


@contextlib.contextmanager
def dropout_generator(generator: Optional[torch.Generator]):
    """Live dropout inside the block draws its masks from `generator`."""
    token = _GENERATOR.set(generator)
    try:
        yield
    finally:
        _GENERATOR.reset(token)


def keep_mask(shape, keep: float, device) -> torch.Tensor:
    """A bool mask of `shape`, each element true with probability `keep`,
    from the active generator (which must lie on `device`)."""
    g = _GENERATOR.get()
    if g is None:
        raise ValueError("live dropout draws from a torch.Generator: run the "
                         "forward inside dropout_generator(g)")
    return torch.rand(shape, generator=g, device=device) < keep


def dropout(x: torch.Tensor, rate: float,
            deterministic: bool = True) -> torch.Tensor:
    """Element-wise dropout: x / (1 − rate) where kept, else 0."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(keep_mask(x.shape, keep, x.device), x / keep, 0.0)


def drop_path(x: torch.Tensor, rate: float,
              deterministic: bool = True) -> torch.Tensor:
    """Per-sample stochastic depth: each row of the leading axis is kept
    whole (and divided by 1 − rate) or zeroed whole."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = keep_mask((x.shape[0],) + (1,) * (x.dim() - 1), keep, x.device)
    return torch.where(mask, x / keep, 0.0)
