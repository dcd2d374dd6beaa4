"""Task heads (`xfm_tpu/models/task_models.py`): `XFMForPretrain`,
`XFMForRetrieval`, `XFMForNLVR`, `XFMForGrounding`, and the classifiers
`XFMForClassification` (with `DeepMLPHead`) and `TextClassifier`.

Each holds the XFMBase parameters directly (not under a `backbone.` prefix),
so its state_dict is the reference's. The pretrain head takes every stream
of the pretrain task (image-text, region, ImageNet, text-only); of
retrieval, the fine-tune step and the eval: the encoders of its first stage
and the ITM rerank of its second. NLVR2 classifies a pair of images against
one sentence; grounding regresses the box a phrase names. Their heads are
the ones the JAX package's `init_all` creates from the config: NLVR's
`cls_head` alone (no ITM head, projections or temperature), grounding's
`bbox_head` alone. A classifier holds only the towers its branch runs
(the leaves of the JAX tree its `init_all` creates): the image branch the
vision tower, the text branch the text encoder, the fused one the whole
backbone.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from ..core.precision import dense, layer_norm
from ..ops.activations import gelu
from ..ops.dropout import dropout_generator
from .text_encoder import TextTransformer, cross_entropy
from .xfm import MLPHead, XFMBase, vision_tower


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
             hard_negatives=None, vqkd_code_ids=None,
             deterministic: bool = True):
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
          pass and MIM: the regression, or with the tokenizer the CE
          against `vqkd_code_ids` ([B, num_patches], the frozen VQ-KD
          tokenizer's ids of the unmasked images).
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
                out["loss_mim"] = self.get_mim_loss(
                    image_embeds_masked, image_embeds, image_mask,
                    vqkd_code_ids=vqkd_code_ids)
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


class XFMForNLVR(XFMBase):
    """Two-image reasoning head (reference models/model_nlvr.py): the
    pair's images go through the vision tower as one [2B, ...] batch (all
    first images, then all second ones), two fusion passes share one text
    encoding, and their cls rows, concatenated (2 × text width), go through
    a 2-way `MLPHead` (`cls_head.{0,1,3}`)."""

    def __init__(self, c):
        super().__init__(c)
        self.cls_head = MLPHead(2 * c.text_width, 2, c.dtype)

    def loss(self, images, text_ids, text_atts, targets=None,
             train: bool = True, generator: Optional[torch.Generator] = None,
             deterministic: bool = True):
        """images [2B, H, W, 3] → the mean cross-entropy against `targets`
        [B], or with `train=False` the logits [B, 2]. Unless
        `deterministic`, the dropout masks come from `generator`."""
        with dropout_generator(generator):
            image_embeds = self.get_vision_embeds(
                images, deterministic=deterministic)
            text_embeds = self.get_text_embeds(text_ids, text_atts,
                                               deterministic)
            n = text_ids.shape[0]
            atts = torch.ones(n, image_embeds.shape[1], dtype=torch.int64,
                              device=image_embeds.device)
            cls = [self.get_cross_embeds(
                half, atts, text_embeds, text_atts, deterministic,
                is_pretrain=False)[:, 0, :]
                for half in (image_embeds[:n], image_embeds[n:])]
            pred = self.cls_head(torch.cat(cls, dim=-1))
        if not train:
            return pred
        return cross_entropy(pred, targets)

    def forward(self, *args, **kwargs):
        return self.loss(*args, **kwargs)


class XFMForGrounding(XFMBase):
    """RefCOCO bbox regression head (reference models/model_grounding.py):
    the fusion cls over the whole image → `bbox_head` → sigmoid cxcywh."""

    def loss(self, images, text_ids, text_atts, target_bbox=None,
             train: bool = True, generator: Optional[torch.Generator] = None,
             deterministic: bool = True):
        """→ (L1, GIoU) of the predicted boxes against `target_bbox` [B, 4]
        (normalized cxcywh), or with `train=False` the boxes [B, 4] f32.
        Unless `deterministic`, the dropout masks come from `generator`."""
        with dropout_generator(generator):
            image_embeds = self.get_vision_embeds(
                images, deterministic=deterministic)
            text_embeds = self.get_text_embeds(text_ids, text_atts,
                                               deterministic)
            coords = self.predict_bbox(image_embeds, text_atts, text_embeds,
                                       is_pretrain=False,
                                       deterministic=deterministic)
        if not train:
            return coords
        return self.get_bbox_loss(coords, target_bbox)

    def forward(self, *args, **kwargs):
        return self.loss(*args, **kwargs)


class DeepMLPHead(nn.Sequential):
    """The ImageNet / linear-probe head (reference
    models/model_classification.py:38-53): four Linear → LayerNorm →
    GELU(erf) blocks at widths 4d, 8d, 4d, 2d with d = in_dim / 2 (the input
    is [cls ‖ mean-patch], twice the feature width), then the output
    Linear; Linear at indices 0, 3, 6, 9 and 12, LayerNorm at 1, 4, 7, 10,
    as the reference's `nn.Sequential` names them. f32 parameters, compute
    in `dtype`."""

    def __init__(self, in_dim: int, output_dim: int, dtype: torch.dtype):
        d = in_dim // 2
        layers, prev = [], in_dim
        for w in (4 * d, 8 * d, 4 * d, 2 * d):
            layers += [nn.Linear(prev, w), nn.LayerNorm(w, eps=1e-6),
                       nn.GELU()]
            prev = w
        super().__init__(*layers, nn.Linear(prev, output_dim))
        self.dtype = dtype

    def forward(self, x):
        for i in range(0, 12, 3):
            x = gelu(layer_norm(dense(x, self[i], self.dtype), self[i + 1],
                                self.dtype))
        return dense(x, self[12], self.dtype)


class XFMForClassification(XFMBase):
    """GLUE / ImageNet / linear-probe / generic classifier (reference
    models/model_classification.py:17-96), by `task_name`:
    - "glue": the text encoder's cls → `MLPHead`;
    - "imagenet": the vision embeds' [cls ‖ mean of the patches] →
      `DeepMLPHead`;
    - "fused": the fusion encoder's cls over the image → `MLPHead`.
    `is_lp` (a linear probe) takes `DeepMLPHead` whatever the branch, and in
    the image branch freezes the tower: its parameters take no gradient
    (so no optimizer holds them) and it runs with no graph, dropout and
    drop-path still live, as the JAX package's `stop_gradient` of the
    embeds in train mode. The loss is the cross-entropy, or the MSE where
    `num_labels` is 1 (STS-B)."""

    def __init__(self, c, num_labels: int = 2, task_name: str = "glue",
                 is_lp: bool = False):
        if task_name not in ("glue", "imagenet", "fused"):
            raise ValueError(f"task_name {task_name!r}")
        if task_name == "fused":
            super().__init__(c)
        else:
            nn.Module.__init__(self)
            self.config = c
            if task_name == "imagenet":
                self.vision_encoder = vision_tower(c)
            else:
                self.text_encoder = TextTransformer(c.text)
        self.num_labels, self.task_name = num_labels, task_name
        self.is_lp = is_lp
        width = 2 * c.vision_width if task_name == "imagenet" \
            else c.text_width
        deep = task_name == "imagenet" or is_lp
        self.cls_head = (DeepMLPHead if deep else MLPHead)(
            width, num_labels, c.dtype)
        self.frozen_tower = is_lp and task_name == "imagenet"
        if self.frozen_tower:
            self.vision_encoder.requires_grad_(False)

    def features(self, images=None, text_ids=None, text_atts=None,
                 deterministic: bool = True):
        """The head's input: the text cls where `images` is None, the
        image [cls ‖ mean-patch] where `text_ids` is None, else the fusion
        cls."""
        if images is None:
            return self.text_encoder(text_ids, attention_mask=text_atts,
                                     deterministic=deterministic)[:, 0, :]
        if text_ids is None:
            frozen = torch.no_grad() if self.frozen_tower \
                else contextlib.nullcontext()
            with frozen:
                emb = self.get_vision_embeds(images,
                                             deterministic=deterministic)
            return torch.cat([emb[:, 0, :], emb[:, 1:, :].mean(1)], dim=-1)
        image_embeds = self.get_vision_embeds(images,
                                              deterministic=deterministic)
        image_atts = torch.ones(image_embeds.shape[:2], dtype=torch.int64,
                                device=image_embeds.device)
        text_embeds = self.get_text_embeds(text_ids, text_atts,
                                           deterministic)
        return self.get_cross_embeds(image_embeds, image_atts, text_embeds,
                                     text_atts, deterministic,
                                     is_pretrain=False)[:, 0, :]

    def loss(self, images=None, text_ids=None, text_atts=None, targets=None,
             train: bool = True, generator: Optional[torch.Generator] = None,
             deterministic: bool = True):
        """→ the loss against `targets` [B] (class ids, or values where
        `num_labels` is 1), or with `train=False` the logits [B,
        num_labels]. Unless `deterministic`, the dropout masks come from
        `generator`."""
        with dropout_generator(generator):
            pred = self.cls_head(self.features(images, text_ids, text_atts,
                                               deterministic))
        if not train:
            return pred
        if self.num_labels == 1:
            return torch.mean((pred.reshape(-1).float()
                               - targets.reshape(-1).float()) ** 2)
        return cross_entropy(pred, targets)

    def forward(self, *args, **kwargs):
        return self.loss(*args, **kwargs)


class TextClassifier(nn.Module):
    """The text-only classifier (reference models/model_classification.py:
    98-150, Classify.py `use_text_classifier`): the text encoder alone and
    an `MLPHead` over its cls, cross-entropy; no vision or fusion
    parameters."""

    def __init__(self, text_config, num_labels: int = 2):
        super().__init__()
        self.config = text_config
        self.text_encoder = TextTransformer(text_config)
        self.cls_head = MLPHead(text_config.hidden_size, num_labels,
                                text_config.dtype)

    def loss(self, images=None, text_ids=None, text_atts=None, targets=None,
             train: bool = True, generator: Optional[torch.Generator] = None,
             deterministic: bool = True):
        """As `XFMForClassification.loss`; `images` is ignored."""
        with dropout_generator(generator):
            hidden = self.text_encoder(text_ids, attention_mask=text_atts,
                                       deterministic=deterministic)
            pred = self.cls_head(hidden[:, 0, :])
        if not train:
            return pred
        return cross_entropy(pred, targets)

    def forward(self, *args, **kwargs):
        return self.loss(*args, **kwargs)
