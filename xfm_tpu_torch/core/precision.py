"""Compute-dtype policy (`xfm_tpu/core/precision.py`).

Parameters are f32 (or bf16 under `bf16_params`, with f32 masters in the
optimizer: `train/optim.with_master_weights`); each op casts its inputs and
weights to the compute dtype (bf16 or f32, the configs' `dtype`), as
flax's `dtype=` does. `torch.autocast` is not used: its rounding points
differ from the JAX package's. Softmax, loss reductions and LayerNorm
statistics run in f32, LayerNorm's γ and β taken in f32 whatever their
storage (a no-op for f32 parameters).
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.nn.functional as F

from ..ops.activations import ACT
from ..ops.fused_ln import fused_add_ln, fused_ln_ok, fused_ln_post
from ..ops.fused_mlp import act_dense as fused_act_dense
from ..ops.fused_mlp import fused_mlp_ok


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32


DEFAULT = Policy()
FULL_F32 = Policy(compute_dtype=torch.float32)


def policy_from_config(config: dict) -> Policy:
    """The task's compute policy (`xfm_tpu/core/precision.py`): the YAML's
    `compute_dtype`, else `XFM_COMPUTE_DTYPE`, else the `accelerator:`
    block (FP16_OPT_LEVEL O0 → f32), else bf16 compute."""
    cd = config.get("compute_dtype") or os.environ.get("XFM_COMPUTE_DTYPE")
    if cd:
        return FULL_F32 if str(cd) in ("float32", "fp32", "f32") else DEFAULT
    acc = config.get("accelerator", {}) or {}
    if str(acc.get("FP16_OPT_LEVEL", "O1")).upper() == "O0":
        return FULL_F32
    return DEFAULT


def dense(x: torch.Tensor, layer: torch.nn.Linear,
          dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Dense(dtype=...)`: input, kernel and bias in `dtype`."""
    b = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), b)


def layer_norm(x: torch.Tensor, layer: torch.nn.LayerNorm,
               dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.LayerNorm(dtype=...)`: statistics and affine in f32, result
    in `dtype`."""
    return F.layer_norm(x.float(), layer.normalized_shape,
                        layer.weight.float(), layer.bias.float(),
                        layer.eps).to(dtype)


def add_layer_norm(x: torch.Tensor, residual: torch.Tensor,
                   layer: torch.nn.LayerNorm, dtype: torch.dtype,
                   fused: bool = False):
    """`xfm_tpu/ops/fused_ln.py` `fused_add_ln`: the sum is taken in f32,
    normalized unrounded, and returned rounded to `dtype`.
    → (x + residual, LN(x + residual)). `fused` (the config's `fused_ln`)
    takes K4 where it takes the rows; otherwise the plain composition, whose
    backward is autograd's."""
    if fused and fused_ln_ok(x.shape, dtype):
        return fused_add_ln(x.to(dtype), residual.to(dtype),
                            layer.weight.float(), layer.bias.float(),
                            layer.eps)
    s = x.to(dtype).float() + residual.to(dtype).float()
    h = F.layer_norm(s, layer.normalized_shape, layer.weight.float(),
                     layer.bias.float(), layer.eps)
    return s.to(dtype), h.to(dtype)


def post_layer_norm(x: torch.Tensor, residual: torch.Tensor,
                    layer: torch.nn.LayerNorm, dtype: torch.dtype,
                    fused: bool = False) -> torch.Tensor:
    """LN(x + residual) for the post-LN BERT sites (`fused_ln_post` with
    `fused`, else `add_layer_norm`'s)."""
    if fused and fused_ln_ok(x.shape, dtype):
        return fused_ln_post(x.to(dtype), residual.to(dtype),
                             layer.weight.float(), layer.bias.float(),
                             layer.eps)
    return add_layer_norm(x, residual, layer, dtype)[1]


class _PartialLinear(torch.autograd.Function):
    """x·Wᵀ of x and W in one dtype, summed in f32 and returned in f32; the
    gradients as `F.linear`'s, from the output's gradient in that dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.dtype == torch.float32:
            y = x2 @ w.t()
        elif x.is_cuda:  # cuBLAS keeps its f32 sums
            y = torch.mm(x2, w.t(), out_dtype=torch.float32)
        else:
            y = x2.float() @ w.float().t()
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w if ctx.needs_input_grad[0] else None
        dw = (g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return dx, dw


def dense_partial(x: torch.Tensor, layer: torch.nn.Linear,
                  dtype: torch.dtype) -> torch.Tensor:
    """`dense` without its bias, input and kernel in `dtype`, the product
    in f32, unrounded: a tensor-parallel row layer's partial sum
    (`ops/tensor_parallel.row_output` rounds it once, after the group's
    all-reduce and the bias, as `dense` rounds the whole layer's)."""
    return _PartialLinear.apply(x.to(dtype), layer.weight.to(dtype))


def row_dense(x: torch.Tensor, layer: torch.nn.Linear, dtype: torch.dtype,
              cut=None) -> torch.Tensor:
    """`dense`, or under a tensor cut (`cut`, an `ops/tensor_parallel.
    TensorCut`) a row layer: the rank's partial sum (`dense_partial`)
    summed over the group, then the bias and one rounding
    (`row_output`)."""
    if cut is None:
        return dense(x, layer, dtype)
    from ..ops.tensor_parallel import row_output

    return row_output(dense_partial(x, layer, dtype), layer.bias, cut, dtype)


def act_row_dense(x: torch.Tensor, layer: torch.nn.Linear, act: str,
                  dtype: torch.dtype, fused: bool = False,
                  cut=None) -> torch.Tensor:
    """`act_dense`, or under a tensor cut its row form, as `row_dense`."""
    if cut is None:
        return act_dense(x, layer, act, dtype, fused)
    from ..ops.tensor_parallel import row_output

    return row_output(act_dense(x, layer, act, dtype, fused, bias=False),
                      layer.bias, cut, dtype)


def act_dense(x: torch.Tensor, layer: torch.nn.Linear, act: str,
              dtype: torch.dtype, fused: bool = False,
              bias: bool = True) -> torch.Tensor:
    """The JAX `ActDense`: `dense(ACT[act](x))`, or with `fused` (the
    config's `fused_mlp`) and an activation K5 computes, K5 on x, the
    kernel and the bias in `dtype`. Without `bias` the product alone, in
    f32 (a row-parallel partial sum, as `dense_partial`; K5 without a
    bias writes it so)."""
    if fused and fused_mlp_ok(act):
        b = layer.bias.to(dtype) if bias else None
        return fused_act_dense(x.to(dtype), layer.weight.to(dtype), b, act)
    if not bias:
        return dense_partial(ACT[act](x), layer, dtype)
    return dense(ACT[act](x), layer, dtype)
