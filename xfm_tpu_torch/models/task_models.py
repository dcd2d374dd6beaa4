"""Task heads (`xfm_tpu/models/task_models.py`): `XFMForPretrain` and
`XFMForRetrieval`.

Each holds the XFMBase parameters directly (not under a `backbone.` prefix),
so its state_dict is the reference's. The pretrain head takes every stream
of the pretrain task (image-text, region, ImageNet, text-only); of
retrieval, the fine-tune step and the eval: the encoders of its first stage
and the ITM rerank of its second.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.dropout import dropout_generator
from .xfm import XFMBase


LOSS_KEYS = ("loss_itc", "loss_itm", "loss_mlm", "loss_mim", "loss_bbox",
             "loss_giou")


class XFMForPretrain(XFMBase):
    def loss(self, images=None, text_ids=None, text_atts=None,
             text_ids_masked=None, masked_pos=None, masked_ids=None,
             image_mask=None, idx_to_group_img=None, image_atts=None,
             target_bbox=None, is_image=None, ret_itc=True, ret_match=True,
             ret_mlm=True, ret_mim=False, ret_bbox=False,
             ret_bbox_giou=None, data_source=None,
             generator: Optional[torch.Generator] = None,
             hard_negatives=None, deterministic: bool = True):
        """→ {loss_itc, loss_itm, loss_mlm, loss_mim, loss_bbox, loss_giou}
        of one stream's batch, with the JAX package's branches and flags
        (a loss turned off is a zero):
        - `images` None: the text-only stream, the text encoder's MLM;
        - `ret_bbox`: the region stream: the vision pass in region mode,
          ITC / ITM / fusion-MLM over the region rows with their patch
          masks, and (unless `ret_bbox_giou` is False) the bbox L1 and
          GIoU of the fusion cls over each region's full image rows;
        - `data_source` "imagenet": MIM alone (text inputs unused);
        - otherwise the image-text stream: with `ret_mim` and an
          `image_mask`, the full and masked vision passes as one 2B-row
          pass and the MIM regression.
        ITM and fusion-MLM run as one 4B-row fusion pass when both are on
        (the JAX package's default), else (a `stop_calc` stage has turned
        one off) as their separate passes. Hard negatives are drawn from `generator`,
        or given as `hard_negatives=(image_neg, text_neg)`; unless
        `deterministic`, the dropout masks come from `generator` too."""
        ref = images if images is not None else text_ids_masked
        zero = torch.zeros((), device=ref.device)
        out = dict.fromkeys(LOSS_KEYS, zero)
        with dropout_generator(generator):
            if images is None:
                out["loss_mlm"] = self.get_mlm_loss(
                    text_ids_masked, text_atts, masked_pos, masked_ids,
                    deterministic=deterministic)
                return out
            image_embeds_masked = image_embeds_fullatts = None
            if ret_bbox:
                image_embeds, image_embeds_fullatts = self.get_vision_embeds(
                    images, idx_to_group_img=idx_to_group_img,
                    image_atts=image_atts, deterministic=deterministic)
            else:
                if ret_mim and image_mask is not None:
                    image_embeds, image_embeds_masked = \
                        self.get_vision_embeds_pair(
                            images, image_mask, deterministic=deterministic)
                else:
                    image_embeds = self.get_vision_embeds(
                        images, deterministic=deterministic)
                image_atts = torch.ones(image_embeds.shape[:2],
                                        dtype=torch.int64,
                                        device=image_embeds.device)
            if data_source != "imagenet":
                text_embeds = self.get_text_embeds(text_ids, text_atts,
                                                   deterministic)
                image_feat, text_feat = self.get_features(image_embeds,
                                                          text_embeds)
                if ret_itc:
                    out["loss_itc"] = self.get_contrastive_loss(image_feat,
                                                                text_feat)
                if ret_match and ret_mlm and text_ids_masked is not None:
                    out["loss_itm"], out["loss_mlm"] = \
                        self.get_matching_and_fuse_mlm_loss(
                            generator, image_embeds, image_atts, image_feat,
                            text_atts, text_feat, text_embeds,
                            text_ids_masked, masked_pos, masked_ids,
                            deterministic=deterministic,
                            fixed_negatives=hard_negatives)
                else:
                    if ret_match:
                        out["loss_itm"] = self.get_matching_loss(
                            generator, image_embeds, image_atts, image_feat,
                            text_atts, text_feat, text_embeds,
                            deterministic=deterministic,
                            fixed_negatives=hard_negatives)
                    if ret_mlm:
                        out["loss_mlm"] = self.get_fuse_mlm_loss(
                            text_ids_masked, text_atts, image_embeds,
                            image_atts, masked_pos, masked_ids,
                            deterministic)
            if ret_mim and not ret_bbox and image_mask is not None:
                out["loss_mim"] = self.get_mim_loss(image_embeds_masked,
                                                    image_embeds, image_mask)
            giou_on = ret_bbox if ret_bbox_giou is None else ret_bbox_giou
            if ret_bbox and giou_on and target_bbox is not None:
                coords = self.predict_bbox(image_embeds_fullatts, text_atts,
                                           text_embeds,
                                           deterministic=deterministic)
                out["loss_bbox"], out["loss_giou"] = self.get_bbox_loss(
                    coords, target_bbox, is_image)
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
        text_neg)`; the text encoder trains through the fusion passes.
        Unless `deterministic`, the dropout masks come from `generator`
        too, drawn in the forward's order: vision, text, then (after the
        hard negatives) the fusion passes."""
        with dropout_generator(generator):
            image_embeds = self.get_vision_embeds(
                images, deterministic=deterministic)
            image_atts = torch.ones(image_embeds.shape[:2],
                                    dtype=torch.int64,
                                    device=image_embeds.device)
            text_embeds = self.get_text_embeds(text_ids, text_atts,
                                               deterministic)
            image_feat, text_feat = self.get_features(image_embeds,
                                                      text_embeds)
            loss_itc = self.get_contrastive_loss(image_feat, text_feat,
                                                 idx=idx)
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

    def itm_scores(self, image_embeds, text_embeds, text_atts,
                   image_row_idx=None, image_group_size=None,
                   deterministic: bool = True):
        """ITM logit[:, 1] of each (image, text) row: the eval's second
        stage. `image_row_idx`: image_embeds holds the unique images and
        each row takes its own by index. `image_group_size` gs: image_embeds
        holds U unique images and the U·gs text rows come in contiguous runs
        of gs candidates per image (the i2t rerank); otherwise row i pairs
        image i with text i (the repeat form)."""
        if image_group_size is None and image_row_idx is not None:
            nrows = image_row_idx.shape[0]
        else:
            nrows = image_embeds.shape[0]
        image_atts = torch.ones(nrows, image_embeds.shape[1],
                                dtype=torch.int64, device=image_embeds.device)
        cross = self.get_cross_embeds(
            image_embeds, image_atts, text_embeds, text_atts,
            deterministic=deterministic, is_pretrain=False,
            image_row_idx=image_row_idx,
            image_group_size=image_group_size)[:, 0, :]
        return self.itm_head(cross)[:, 1]
