"""Pretraining and fine-tune losses (`xfm_tpu/models/losses.py`).

Under a process group whose batch is split over W ranks (data × fsdp: the
ranks of a tensor group share rows and compute the same loss) each loss
is W × this rank's share of the global-batch loss that the JAX package
computes (`core/mesh`): ITC takes the other ranks' features from
`all_gather_with_grad` and averages over its own rows and columns, the
hard negatives are drawn over the gathered similarity matrix from the
generator equal on every rank, and a mean over a count divides by the
global count (`mesh.mean_divisor`). On one process each is the loss over
its batch."""
from __future__ import annotations

from typing import Optional

import torch

from ..core import mesh


def _ce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.take_along_dim(logp, labels[:, None], dim=-1).mean()


def contrastive_loss(image_feat: torch.Tensor, text_feat: torch.Tensor,
                     temp: torch.Tensor,
                     idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ITC over l2-normalized features: the similarities of the W·B
    gathered features (whose backward carries the other ranks' gradients
    back), image → text over this rank's rows and text → image over its
    columns, averaged over the rank's B rows: W × its share of the global
    loss. With `idx`, duplicate images share soft positive mass over the
    gathered `idx`."""
    images = mesh.all_gather_with_grad(image_feat)
    texts = mesh.all_gather_with_grad(text_feat)
    logits = (images @ texts.T).float() / temp
    n = image_feat.shape[0]
    own = slice(mesh.dp_rank() * n, (mesh.dp_rank() + 1) * n)
    i2t, t2i = logits[own], logits.T[own]
    if idx is None:
        labels = torch.arange(own.start, own.stop, device=logits.device)
        return (_ce_logits(i2t, labels) + _ce_logits(t2i, labels)) / 2
    ids = mesh.all_gather(idx.reshape(-1))
    pos = (ids[own, None] == ids[None, :]).float()
    labels = pos / pos.sum(dim=1, keepdim=True)
    li2t = -(torch.log_softmax(i2t, -1) * labels).sum(-1).mean()
    lt2i = -(torch.log_softmax(t2i, -1) * labels).sum(-1).mean()
    return (li2t + lt2i) / 2


def hard_negative_indices(generator: torch.Generator,
                          image_feat: torch.Tensor, text_feat: torch.Tensor,
                          temp: torch.Tensor,
                          idx: Optional[torch.Tensor] = None):
    """In-batch hard negatives: each row draws one negative with weights
    softmax(sim) + 1e-5, positives zeroed (the diagonal, or with `idx` every
    pair of rows with the same image id), from `generator` (on the
    features' device). → (image_neg, text_neg), each [B] int64 indices into
    the global batch. The draw runs over the gathered global batch, the
    same on every rank from the shared generator, and each rank keeps its
    own rows' negatives."""
    n = image_feat.shape[0]
    with torch.no_grad():
        images = mesh.all_gather(image_feat)
        texts = mesh.all_gather(text_feat)
        sim_i2t = (images @ texts.T).float() / temp
        sim_t2i = sim_i2t.T
        if idx is None:
            mask = torch.eye(sim_i2t.shape[0], dtype=torch.bool,
                             device=sim_i2t.device)
        else:
            ids = mesh.all_gather(idx.reshape(-1))[:, None]
            mask = ids == ids.T
        zero = torch.zeros((), device=sim_i2t.device)
        wi2t = torch.where(mask, zero, torch.softmax(sim_i2t, -1) + 1e-5)
        wt2i = torch.where(mask, zero, torch.softmax(sim_t2i, -1) + 1e-5)
        text_neg = torch.multinomial(wi2t, 1, generator=generator)[:, 0]
        image_neg = torch.multinomial(wt2i, 1, generator=generator)[:, 0]
    own = slice(mesh.dp_rank() * n, (mesh.dp_rank() + 1) * n)
    return image_neg[own], text_neg[own]


def mim_mse_loss(masked_embeds: torch.Tensor, target_embeds: torch.Tensor,
                 mask: torch.Tensor, cls_too: bool = True) -> torch.Tensor:
    """MIM feature regression: MSE at the masked patches (over the global
    count of masked values) against the detached unmasked forward, plus
    the cls slot unless `cls_too` is off. Computed in the embeddings'
    dtype, as the JAX package does."""
    target = target_embeds.detach()
    diff2 = (masked_embeds[:, 1:, :] - target[:, 1:, :]) ** 2
    w = mask.to(diff2.dtype)[..., None]
    masked_mse = (diff2 * w).sum() / mesh.mean_divisor(
        w.sum() * diff2.shape[-1])
    if not cls_too:
        return masked_mse
    cls_mse = ((masked_embeds[:, 0, :] - target[:, 0, :]) ** 2).mean()
    return masked_mse + cls_mse


def mim_vqkd_loss(logits: torch.Tensor, code_ids: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """MIM cross-entropy against the frozen VQ-KD tokenizer's code ids at
    the masked patches: logits [B, N, codebook], code_ids and mask [B, N];
    log-softmax in f32, the mean over the global count of masked patches
    (at least 1)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.take_along_dim(logp, code_ids[..., None].long(),
                                dim=-1)[..., 0]
    w = mask.to(nll.dtype)
    return (nll * w).sum() / mesh.mean_divisor(w.sum())


# --- the bbox losses (`xfm_tpu/models/losses.py`) ---------------------------

def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], dim=-1)


def box_iou_union(b1: torch.Tensor, b2: torch.Tensor):
    """Row-wise IoU of xyxy boxes [B, 4] × [B, 4] → (iou [B], union [B])."""
    a1 = (b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1])
    a2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    lt = torch.maximum(b1[:, :2], b2[:, :2])
    rb = torch.minimum(b1[:, 2:], b2[:, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[:, 0] * wh[:, 1]
    union = a1 + a2 - inter
    return inter / torch.clamp(union, min=1e-6), union


def generalized_box_iou_diag(b1: torch.Tensor,
                             b2: torch.Tensor) -> torch.Tensor:
    iou, union = box_iou_union(b1, b2)
    lt = torch.minimum(b1[:, :2], b2[:, :2])
    rb = torch.maximum(b1[:, 2:], b2[:, 2:])
    wh = torch.clamp(rb - lt, min=0)
    area = wh[:, 0] * wh[:, 1]
    return iou - (area - union) / torch.clamp(area, min=1e-6)


def bbox_loss(output_coord: torch.Tensor, target_bbox: torch.Tensor,
              is_image: Optional[torch.Tensor] = None):
    """(L1, 1 − GIoU), each summed and divided by the rows that count.
    A row whose predicted or target box is degenerate (x2 < x1 or y2 < y1)
    adds no GIoU term, row by row as in the JAX package (the torch
    reference zeroes the whole batch's). With `is_image`, the rows where
    it is 1 are left out of both, and the count of the rest is the global
    one."""
    l1 = (output_coord - target_bbox).abs()
    b1 = box_cxcywh_to_xyxy(output_coord)
    b2 = box_cxcywh_to_xyxy(target_bbox)
    degenerate = ((b1[:, 2:] < b1[:, :2]).any(-1)
                  | (b2[:, 2:] < b2[:, :2]).any(-1))
    giou = torch.where(degenerate, torch.zeros_like(l1[:, 0]),
                       1 - generalized_box_iou_diag(b1, b2))
    if is_image is None:
        num = output_coord.shape[0]
    else:
        keep = 1.0 - is_image.to(l1.dtype)
        num = mesh.mean_divisor(keep.sum())
        l1 = l1 * keep[:, None]
        giou = giou * keep
    return l1.sum() / num, giou.sum() / num
