"""Attention entry and its plain version (`xfm_tpu/ops/attention.py`).

`dot_product_attention` routes as the JAX entry does: Nq and Nk ≥ 512 with
no live dropout (`flash_ok`) go to the long-sequence kernel K3
(`ops/flash_attention.py` `flash_attention`); the rest, text, fusion and
cross-attention (Nq = T ≈ 30-40), stay plain PyTorch, as the JAX package
leaves them to XLA. Rounding points of the plain version: q is scaled in
f32 and rounded to the input dtype before QKᵀ; products accumulate in f32;
softmax in f32; probabilities are rounded to the input dtype before PV; the
output is in the input dtype. Matmuls run on f32 copies of the (already
rounded) operands, which is exact for bf16 inputs and matches f32
accumulation. With live dropout the probabilities are masked and divided
by 1 − rate in f32 before that rounding (`_dropout_attention`), the mask
from `ops/dropout.py`'s generator.
"""
from __future__ import annotations

from typing import Optional

import torch

from .dropout import dropout

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
                        bias: Optional[torch.Tensor], scale: float,
                        dropout_rate: float = 0.0) -> torch.Tensor:
    """q [B, Nq, H, D], k/v [B, Nk, H, D], bias broadcastable to
    [B, H, Nq, Nk] → [B, Nq, H, D] in q's dtype; `dropout_rate` > 0 drops
    probabilities."""
    dt = q.dtype
    qs = (q.float() * scale).to(dt)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if bias is not None:
        logits = logits + bias.float()
    probs = dropout(torch.softmax(logits, dim=-1), dropout_rate, False)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dt).float(), v.float())
    return out.to(dt)


def flash_ok(q: torch.Tensor, k: torch.Tensor, deterministic: bool = True,
             dropout_rate: float = 0.0) -> bool:
    """Dispatch predicate for K3 (`xfm_tpu/ops/attention.py` `_flash_ok`
    without its TPU and environment switches): Nq ≥ 512 and Nk ≥ 512 and no
    live dropout."""
    if dropout_rate > 0.0 and not deterministic:
        return False
    return q.shape[1] >= 512 and k.shape[1] >= 512


def dot_product_attention(q, k, v, bias=None, mask=None, scale=None,
                          deterministic: bool = True,
                          dropout_rate: float = 0.0) -> torch.Tensor:
    """Scaled dot-product attention over [B, N, H, D] tensors (scale D^-1/2
    by default); `mask` ([B, Nk] or [B, Nq, Nk] of {0, 1}) is folded into
    `bias` as `mask_to_bias` makes it; `dropout_rate` drops probabilities
    unless `deterministic`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if mask is not None:
        mbias = mask_to_bias(mask)
        bias = mbias if bias is None else bias + mbias
    if flash_ok(q, k, deterministic, dropout_rate):
        # imported here: flash_attention imports this module's plain version
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, bias, scale)
    return attention_reference(q, k, v, bias, scale,
                               0.0 if deterministic else dropout_rate)
