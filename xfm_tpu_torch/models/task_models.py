"""Pretraining head (`xfm_tpu/models/task_models.py` `XFMForPretrain`).

Holds the XFMBase parameters directly (not under a `backbone.` prefix), so
its state_dict is the reference's. Only the default path of the pretrain
step is ported: the 2B-row vision pair pass and the fused 4B-row fusion pass
for ITM + fusion-MLM.
"""
from __future__ import annotations

from typing import Optional

import torch

from .xfm import XFMBase


class XFMForPretrain(XFMBase):
    def loss(self, images, text_ids, text_atts, text_ids_masked, masked_pos,
             masked_ids, image_mask=None,
             generator: Optional[torch.Generator] = None,
             hard_negatives=None, deterministic: bool = True):
        """→ dict of ITC, ITM (in-batch hard negatives drawn from
        `generator`, or the given `hard_negatives=(image_neg, text_neg)`),
        fusion-MLM and MIM losses; the bbox losses are zero."""
        zero = torch.zeros((), device=text_ids.device)
        if image_mask is not None:
            image_embeds, image_embeds_masked = self.get_vision_embeds_pair(
                images, image_mask, deterministic=deterministic)
        else:
            image_embeds = self.get_vision_embeds(
                images, deterministic=deterministic)
        image_atts = torch.ones(image_embeds.shape[:2], dtype=torch.int64,
                                device=image_embeds.device)
        text_embeds = self.get_text_embeds(text_ids, text_atts,
                                           deterministic)
        image_feat, text_feat = self.get_features(image_embeds, text_embeds)
        out = {"loss_itc": self.get_contrastive_loss(image_feat, text_feat)}
        out["loss_itm"], out["loss_mlm"] = \
            self.get_matching_and_fuse_mlm_loss(
                generator, image_embeds, image_atts, image_feat, text_atts,
                text_feat, text_embeds, text_ids_masked, masked_pos,
                masked_ids, deterministic=deterministic,
                fixed_negatives=hard_negatives)
        out["loss_mim"] = (self.get_mim_loss(image_embeds_masked,
                                             image_embeds, image_mask)
                           if image_mask is not None else zero)
        out["loss_bbox"] = out["loss_giou"] = zero
        return out

    def forward(self, *args, **kwargs):
        return self.loss(*args, **kwargs)
