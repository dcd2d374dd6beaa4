"""Task heads (`xfm_tpu/models/task_models.py`): `XFMForPretrain` and
`XFMForRetrieval`.

Each holds the XFMBase parameters directly (not under a `backbone.` prefix),
so its state_dict is the reference's. Of the pretrain step only the default
path is ported: the 2B-row vision pair pass and the fused 4B-row fusion pass
for ITM + fusion-MLM. Of retrieval, the fine-tune step and the encoders of
the eval's first stage; the ITM rerank waits for grouped cross-attention.
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


class XFMForRetrieval(XFMBase):
    """ITC + ITM fine-tune head (reference models/model_retrieval.py)."""

    def loss(self, images, text_ids, text_atts, idx=None,
             generator: Optional[torch.Generator] = None,
             hard_negatives=None, deterministic: bool = True):
        """→ (loss_itc, loss_itm): ITC (with `idx`, rows of the same image
        share the positive mass) and ITM over in-batch hard negatives drawn
        from `generator`, or the given `hard_negatives=(image_neg,
        text_neg)`; the text encoder trains through the fusion passes."""
        image_embeds = self.get_vision_embeds(images,
                                              deterministic=deterministic)
        image_atts = torch.ones(image_embeds.shape[:2], dtype=torch.int64,
                                device=image_embeds.device)
        text_embeds = self.get_text_embeds(text_ids, text_atts,
                                           deterministic)
        image_feat, text_feat = self.get_features(image_embeds, text_embeds)
        loss_itc = self.get_contrastive_loss(image_feat, text_feat, idx=idx)
        loss_itm = self.get_matching_loss(
            generator, image_embeds, image_atts, image_feat, text_atts,
            text_feat, text_embeds, idx=idx, is_pretrain=False,
            deterministic=deterministic, fixed_negatives=hard_negatives)
        return loss_itc, loss_itm

    def forward(self, *args, **kwargs):
        return self.loss(*args, **kwargs)

    def encode_images(self, images, deterministic: bool = True):
        """→ (image_embeds, image_feat): the eval's first stage."""
        image_embeds = self.get_vision_embeds(images,
                                              deterministic=deterministic)
        return image_embeds, self.get_features(image_embeds=image_embeds)

    def encode_texts(self, text_ids, text_atts, deterministic: bool = True):
        """→ (text_embeds, text_feat)."""
        text_embeds = self.get_text_embeds(text_ids, text_atts,
                                           deterministic)
        return text_embeds, self.get_features(text_embeds=text_embeds)
