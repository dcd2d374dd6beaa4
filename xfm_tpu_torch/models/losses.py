"""Pretraining and fine-tune losses (`xfm_tpu/models/losses.py`)."""
from __future__ import annotations

from typing import Optional

import torch


def _ce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.take_along_dim(logp, labels[:, None], dim=-1).mean()


def contrastive_loss(image_feat: torch.Tensor, text_feat: torch.Tensor,
                     temp: torch.Tensor,
                     idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ITC over l2-normalized features; with `idx`, duplicate images share
    soft positive mass."""
    logits = (image_feat @ text_feat.T).float() / temp
    n = logits.shape[0]
    if idx is None:
        labels = torch.arange(n, device=logits.device)
        li2t = _ce_logits(logits, labels)
        lt2i = _ce_logits(logits.T, labels)
    else:
        idx = idx.reshape(-1, 1)
        pos = (idx == idx.T).float()
        labels = pos / pos.sum(dim=1, keepdim=True)
        li2t = -(torch.log_softmax(logits, -1) * labels).sum(-1).mean()
        lt2i = -(torch.log_softmax(logits.T, -1) * labels).sum(-1).mean()
    return (li2t + lt2i) / 2


def hard_negative_indices(generator: torch.Generator,
                          image_feat: torch.Tensor, text_feat: torch.Tensor,
                          temp: torch.Tensor,
                          idx: Optional[torch.Tensor] = None):
    """In-batch hard negatives: each row draws one negative with weights
    softmax(sim) + 1e-5, positives zeroed (the diagonal, or with `idx` every
    pair of rows with the same image id), from `generator` (on the
    features' device). → (image_neg, text_neg), each [B] int64."""
    with torch.no_grad():
        sim_i2t = (image_feat @ text_feat.T).float() / temp
        sim_t2i = sim_i2t.T
        if idx is None:
            mask = torch.eye(sim_i2t.shape[0], dtype=torch.bool,
                             device=sim_i2t.device)
        else:
            idx = idx.reshape(-1, 1)
            mask = idx == idx.T
        zero = torch.zeros((), device=sim_i2t.device)
        wi2t = torch.where(mask, zero, torch.softmax(sim_i2t, -1) + 1e-5)
        wt2i = torch.where(mask, zero, torch.softmax(sim_t2i, -1) + 1e-5)
        text_neg = torch.multinomial(wi2t, 1, generator=generator)[:, 0]
        image_neg = torch.multinomial(wt2i, 1, generator=generator)[:, 0]
    return image_neg, text_neg


def mim_mse_loss(masked_embeds: torch.Tensor, target_embeds: torch.Tensor,
                 mask: torch.Tensor, cls_too: bool = True) -> torch.Tensor:
    """MIM feature regression: MSE at the masked patches against the
    detached unmasked forward, plus the cls slot unless `cls_too` is off.
    Computed in the embeddings' dtype, as the JAX package does."""
    target = target_embeds.detach()
    diff2 = (masked_embeds[:, 1:, :] - target[:, 1:, :]) ** 2
    w = mask.to(diff2.dtype)[..., None]
    masked_mse = (diff2 * w).sum() / torch.clamp(
        w.sum() * diff2.shape[-1], min=1.0)
    if not cls_too:
        return masked_mse
    cls_mse = ((masked_embeds[:, 0, :] - target[:, 0, :]) ** 2).mean()
    return masked_mse + cls_mse
