"""Compute-dtype policy (`xfm_tpu/core/precision.py`).

Parameters stay f32; each op casts its inputs and weights to the compute
dtype (bf16 or f32, the configs' `dtype`), as flax's `dtype=` does.
`torch.autocast` is not used: its rounding points differ from the JAX
package's. Softmax, loss reductions and LayerNorm statistics run in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dense(x: torch.Tensor, layer: torch.nn.Linear,
          dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Dense(dtype=...)`: input, kernel and bias in `dtype`."""
    b = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), b)


def layer_norm(x: torch.Tensor, layer: torch.nn.LayerNorm,
               dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.LayerNorm(dtype=...)`: statistics and affine in f32, result
    in `dtype`."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight,
                        layer.bias, layer.eps).to(dtype)


def add_layer_norm(x: torch.Tensor, residual: torch.Tensor,
                   layer: torch.nn.LayerNorm, dtype: torch.dtype):
    """`xfm_tpu/ops/fused_ln.py` `fused_add_ln` (its plain path): the sum is
    taken in f32, normalized unrounded, and returned rounded to `dtype`.
    → (x + residual, LN(x + residual))."""
    s = x.to(dtype).float() + residual.to(dtype).float()
    h = F.layer_norm(s, layer.normalized_shape, layer.weight, layer.bias,
                     layer.eps)
    return s.to(dtype), h.to(dtype)
