"""Plain attention, as `xfm_tpu/ops/attention.py` `_xla_attention`.

Text and fusion attention (T≈30) stay plain PyTorch on the port's path, as
the JAX package leaves them to XLA. Rounding points: q is scaled in f32 and
rounded to the input dtype before QKᵀ; products accumulate in f32; softmax
in f32; probabilities are rounded to the input dtype before PV; the output
is in the input dtype. Matmuls run on f32 copies of the (already rounded)
operands, which is exact for bf16 inputs and matches f32 accumulation.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9


def mask_to_bias(mask: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, Nk] or [B, Nq, Nk] {0,1} mask → additive bias [B, 1, 1|Nq, Nk]."""
    if mask.dim() == 2:
        mask = mask[:, None, None, :]
    elif mask.dim() == 3:
        mask = mask[:, None, :, :]
    return (1.0 - mask.to(dtype)) * NEG_INF


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor],
                        scale: float) -> torch.Tensor:
    """q [B, Nq, H, D], k/v [B, Nk, H, D], bias broadcastable to
    [B, H, Nq, Nk] → [B, Nq, H, D] in q's dtype."""
    dt = q.dtype
    qs = (q.float() * scale).to(dt)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dt).float(), v.float())
    return out.to(dt)


def dot_product_attention(q, k, v, bias=None) -> torch.Tensor:
    """Entry the text/fusion encoders call ([B, N, H, D] layout, scale
    D^-1/2)."""
    return attention_reference(q, k, v, bias, q.shape[-1] ** -0.5)
