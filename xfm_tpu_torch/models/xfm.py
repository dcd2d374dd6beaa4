"""XFMBase: the vision / text / fusion composite (`xfm_tpu/models/xfm.py`),
with the BEiT-2, CLIP-ViT, Swin or DeiT vision tower
(`XFMConfig.vision_backbone`) and RoBERTa or BERT text and fusion encoders.
Parameter names are the reference torch names."""
from __future__ import annotations

import dataclasses
import os
from typing import Union

import torch
from torch import nn

from ..core import mesh
from ..core.precision import dense, layer_norm
from ..data.device_aug import maybe_normalize
from ..ops.activations import gelu
from . import losses
from .beit2 import BeitVisionTransformer, VisionConfig
from .clip_vit import ClipVisionConfig, ClipVisionTransformer
from .deit import DeitConfig, DeitVisionTransformer
from .swin import SwinConfig, SwinTransformer
from .text_encoder import TextConfig, TextTransformer, cross_entropy


def shared_cross_kv(n_image_tokens: int) -> bool:
    """Whether the ITM negative pass projects cross k/v once per unique
    image (`xfm_tpu/models/xfm.py`'s switch): `XFM_SHARED_CROSS_KV` = "1"
    or "0" forces it either way; unset, from 577 image tokens (384 px)."""
    env = os.environ.get("XFM_SHARED_CROSS_KV")
    if env is not None:
        return env == "1"
    return n_image_tokens >= 577


class MLPHead(nn.Sequential):
    """Linear(d→2d) → LayerNorm → GELU(erf) → Linear(2d→out); indices 0, 1,
    3 are the reference's `itm_head.{0,1,3}`."""

    def __init__(self, in_dim: int, output_dim: int, dtype: torch.dtype):
        super().__init__(nn.Linear(in_dim, 2 * in_dim),
                         nn.LayerNorm(2 * in_dim, eps=1e-6), nn.GELU(),
                         nn.Linear(2 * in_dim, output_dim))
        self.dtype = dtype

    def forward(self, x):
        x = dense(x, self[0], self.dtype)
        x = gelu(layer_norm(x, self[1], self.dtype))
        return dense(x, self[3], self.dtype)


@dataclasses.dataclass(frozen=True)
class XFMConfig:
    vision: Union[VisionConfig, ClipVisionConfig, SwinConfig,
                  DeitConfig] = VisionConfig()
    text: TextConfig = TextConfig.roberta_base()
    fusion: TextConfig = TextConfig.roberta_base(fusion_layer=0)
    vision_backbone: str = "beit2"   # beit2 | clip_vit | swin | deit
    embed_dim: int = 256
    temp: float = 0.07
    learnable_temp: bool = True
    max_temp: float = 0.5
    min_temp: float = 0.001
    detach_text_forMLM: bool = True
    mim_cls_only: bool = False
    use_contrastive_loss: bool = False
    use_matching_loss: bool = False
    use_mlm_loss: bool = False
    use_bbox_loss: bool = False
    use_vision_tokenizer: bool = False
    codebook_size: int = 8192
    dtype: torch.dtype = torch.float32

    @property
    def vision_width(self) -> int:
        if self.vision_backbone == "clip_vit":
            return self.vision.hidden_size
        if self.vision_backbone == "swin":
            return self.vision.num_features
        return self.vision.embed_dim

    @property
    def text_width(self) -> int:
        return self.text.hidden_size


def config_from_yaml(config: dict, *, use_contrastive_loss=False,
                     use_matching_loss=False, use_mlm_loss=False,
                     use_bbox_loss=False, dtype=None) -> XFMConfig:
    """XFMConfig from the reference YAML schema, as `xfm_tpu/models/xfm.py`
    `config_from_yaml` builds it: the CLIP-ViT (`use_clip_vit`), DeiT
    (`use_deit`), Swin (`use_swin`, its sizes from `_vision`, patch 4,
    width `num_features`) or BEiT-2 (default) tower, in that order, and a
    RoBERTa text side, or BERT-base for a `text_encoder` without "roberta"
    in its name. `dtype` None takes
    the compute dtype of `core.precision.policy_from_config`. The JAX
    package's environment switches `XFM_FUSED_LN` / `XFM_MLP_FUSED` == "1"
    become the configs' `fused_ln` / `fused_mlp` (the CLIP tower takes
    neither, as there). `gradient_checkpointing` and `remat_policy`
    become `remat` and `remat_policy` of the BEiT-2 tower and the text and
    fusion encoders (the decoders inherit the text config's), and
    `XFM_ATTN_REMAT` == "1" their `attn_remat`; the CLIP-ViT, Swin and
    DeiT towers take none of them, as in the JAX package, which
    checkpoints none of them. `use_vision_tokenizer` adds the MIM code head
    (`codebook_size` classes); `local_attn_depth` > 0 runs region attention
    in the last blocks of the BEiT-2 or CLIP tower. `seq_shard` (in
    `parallel` or at the top level: Megatron-SP) is set, as in the JAX
    package, on the BEiT-2 tower alone of the vision towers and on the
    text and fusion configs (the decoders inherit the text config's); it
    acts under a tensor group (`parallel.tensor` > 1) and is a no-op at
    T = 1."""
    if dtype is None:
        from ..core.precision import policy_from_config

        dtype = policy_from_config(config).compute_dtype
    fused = dict(fused_ln=os.environ.get("XFM_FUSED_LN", "0") == "1",
                 fused_mlp=os.environ.get("XFM_MLP_FUSED", "0") == "1")
    remat = dict(remat=bool(config.get("gradient_checkpointing", False)),
                 remat_policy=config.get("remat_policy", "full"),
                 attn_remat=os.environ.get("XFM_ATTN_REMAT", "0") == "1")
    vision_cfg_json = config.get("_vision", {})
    image_res = config.get("image_res", 224)
    if config.get("use_clip_vit", False):
        vision = ClipVisionConfig(
            image_res=image_res,
            patch_size=config.get("patch_size", 16),
            hidden_size=vision_cfg_json.get("vision_width", 768),
            num_hidden_layers=vision_cfg_json.get("num_hidden_layers", 12),
            num_attention_heads=vision_cfg_json.get("num_attention_heads", 12),
            intermediate_size=vision_cfg_json.get("intermediate_size", 3072),
            hidden_act=vision_cfg_json.get("hidden_act", "quick_gelu"),
            local_attn_depth=vision_cfg_json.get(
                "local_attn_depth", config.get("local_attn_depth", 0)),
            dtype=dtype)
        backbone, vwidth = "clip_vit", vision.hidden_size
    elif config.get("use_deit", False):
        vision = DeitConfig(
            image_res=image_res, patch_size=config.get("patch_size", 16),
            embed_dim=vision_cfg_json.get("vision_width", 768),
            depth=vision_cfg_json.get("num_hidden_layers", 12),
            num_heads=vision_cfg_json.get("num_attention_heads", 12),
            dtype=dtype)
        backbone, vwidth = "deit", vision.embed_dim
    elif config.get("use_swin", False):
        vision = SwinConfig(
            image_res=vision_cfg_json.get("image_res", image_res),
            patch_size=4,
            embed_dim=vision_cfg_json.get("embed_dim", 128),
            depths=tuple(vision_cfg_json.get("depths", (2, 2, 18, 2))),
            num_heads=tuple(vision_cfg_json.get("num_heads",
                                                (4, 8, 16, 32))),
            window_size=vision_cfg_json.get("window_size", 7), dtype=dtype)
        backbone, vwidth = "swin", vision.num_features
    else:
        large = "large" in str(config.get("vision_config", "base"))
        vkw = dict(embed_dim=1024, depth=24, num_heads=16) if large else {}
        for src, dst in (("vision_embed_dim", "embed_dim"),
                         ("vision_depth", "depth"),
                         ("vision_num_heads", "num_heads"),
                         ("patch_size", "patch_size")):
            if config.get(src) is not None:
                vkw[dst] = config[src]
        vision = VisionConfig(
            image_res=image_res,
            drop_path_rate=config.get("drop_path_rate", 0.1),
            init_values=0.1, qkv_bias=True, dtype=dtype,
            hidden_act=config.get("hidden_act", "gelu"),
            local_attn_depth=config.get("local_attn_depth", -1), **fused,
            **remat, **vkw)
        backbone, vwidth = "beit2", vision.embed_dim

    mk = (TextConfig.roberta_base
          if "roberta" in str(config.get("text_encoder", "roberta-base"))
          else TextConfig.bert_base)
    n_text = config.get("text_num_hidden_layers", 12)
    tkw = dict(fused, **remat)
    if config.get("hidden_act"):
        tkw["hidden_act"] = config["hidden_act"]
    for k in ("hidden_dropout_prob", "attention_probs_dropout_prob"):
        if config.get(k) is not None:
            tkw[k] = float(config[k])
    for src, dst in (("text_hidden_size", "hidden_size"),
                     ("text_num_attention_heads", "num_attention_heads"),
                     ("text_intermediate_size", "intermediate_size"),
                     ("text_vocab_size", "vocab_size")):
        if config.get(src) is not None:
            tkw[dst] = config[src]
    par = config.get("parallel") or {}
    if par.get("seq_shard", config.get("seq_shard", False)):
        tkw["seq_shard"] = True
        if backbone == "beit2":
            vision = dataclasses.replace(vision, seq_shard=True)
    text = mk(
        num_hidden_layers=n_text,
        fusion_layer=config.get("text_fusion_start_at", n_text),
        encoder_width=vwidth, dtype=dtype, **tkw)
    fusion = mk(
        num_hidden_layers=config.get("fusion_num_hidden_layers", 12),
        fusion_layer=config.get("fusion_fusion_start_at", 0),
        encoder_width=vwidth, dtype=dtype, **tkw)
    return XFMConfig(
        vision=vision, text=text, fusion=fusion, vision_backbone=backbone,
        embed_dim=config.get("embed_dim", 256),
        temp=config.get("temp", 0.07),
        learnable_temp=config.get("learnable_temp", True),
        max_temp=config.get("max_temp", 0.5),
        min_temp=config.get("min_temp", 0.001),
        detach_text_forMLM=config.get("detach_text_forMLM", True),
        mim_cls_only=config.get("mim_cls_only", False),
        use_contrastive_loss=use_contrastive_loss,
        use_matching_loss=use_matching_loss, use_mlm_loss=use_mlm_loss,
        use_bbox_loss=use_bbox_loss,
        use_vision_tokenizer=config.get("use_vision_tokenizer", False),
        codebook_size=config.get("codebook_size", 8192), dtype=dtype)


def vision_tower(c: XFMConfig) -> nn.Module:
    """The config's vision tower: BEiT-2, CLIP-ViT, Swin or DeiT."""
    towers = {"beit2": BeitVisionTransformer,
              "clip_vit": ClipVisionTransformer, "swin": SwinTransformer,
              "deit": DeitVisionTransformer}
    if c.vision_backbone not in towers:
        raise ValueError(f"unknown vision backbone {c.vision_backbone!r}")
    return towers[c.vision_backbone](c.vision)


class XFMBase(nn.Module):
    def __init__(self, c: XFMConfig):
        super().__init__()
        self.config = c
        self.vision_encoder = vision_tower(c)
        self.text_encoder = TextTransformer(c.text, with_mlm=c.use_mlm_loss)
        self.fusion_encoder = TextTransformer(c.fusion, with_mlm=True)
        if c.use_contrastive_loss:
            self.vision_proj = nn.Linear(c.vision_width, c.embed_dim)
            self.text_proj = nn.Linear(c.text_width, c.embed_dim)
            if c.learnable_temp:
                self.temp = nn.Parameter(torch.tensor(c.temp))
        if c.use_matching_loss:
            self.itm_head = MLPHead(c.text_width, 2, c.dtype)
        if c.use_bbox_loss:
            self.bbox_head = MLPHead(c.text_width, 4, c.dtype)
        if c.use_vision_tokenizer:
            # the MIM code head (the JAX package's `mim_lm_head`)
            self.lm_head = nn.Linear(c.vision_width, c.codebook_size)
        if c.vision_width != c.text_width:
            # kept for checkpoint round trips; no forward uses it (as in the
            # reference and the JAX package)
            self.fusion_proj = nn.Linear(c.text_width, c.vision_width)

    # --- encoders ---------------------------------------------------------

    def get_vision_embeds(self, images, mask=None, idx_to_group_img=None,
                          image_atts=None, deterministic=True):
        """NHWC images → [B, 1+tokens, C]: BEiT [avgpool ‖ patches], CLIP
        and DeiT the post-LN [cls ‖ patches], Swin [avgpool ‖ final-stage
        tokens]. Region mode (`idx_to_group_img`, `image_atts`; BEiT, CLIP
        and Swin; DeiT raises) → (grouped, full), both [R, 1+tokens, C]:
        the region rows (pooled, or with `local_attn_depth` > 0 from the
        masked last blocks) and each region's image's full rows."""
        out = self.vision_encoder(maybe_normalize(images), mask=mask,
                                  idx_to_group_img=idx_to_group_img,
                                  image_atts=image_atts,
                                  deterministic=deterministic)
        if idx_to_group_img is None:
            return out
        grouped, full = out
        return grouped, full[idx_to_group_img]

    def get_vision_embeds_pair(self, images, mask, deterministic=True):
        """(full, MIM-masked) vision embeds in one 2B-row pass (BEiT-2; the
        CLIP, Swin and DeiT towers have no mask path and raise, as their
        masked pass does in the JAX package)."""
        if self.config.vision_backbone != "beit2":
            raise NotImplementedError(
                f"the {self.config.vision_backbone} tower has no MIM mask "
                "path: use the BEiT-2 backbone for MIM")
        return self.vision_encoder.pair(maybe_normalize(images), mask,
                                        deterministic=deterministic)

    def get_text_embeds(self, text_ids, text_atts, deterministic=True):
        return self.text_encoder(text_ids, attention_mask=text_atts,
                                 mode="multi_modal",
                                 deterministic=deterministic)

    def get_cross_embeds(self, image_embeds, image_atts, text_embeds,
                         text_atts, deterministic=True, is_pretrain=True,
                         image_row_idx=None, image_group_size=None):
        """Fusion encoder over the text embeds with cross-attention to the
        image embeds. In pretraining the text embeds are detached; a
        fine-tune trains the text encoder through it. With `image_row_idx`
        image_embeds holds the unique images and each row takes its own by
        index (cross k/v projected once per unique image). With
        `image_group_size` gs the text rows come in contiguous runs of gs
        per unique image (the rerank's shape): the cross-attention views the
        queries per image, so k/v are neither repeated nor gathered."""
        return self.fusion_encoder(
            inputs_embeds=text_embeds.detach() if is_pretrain else text_embeds,
            attention_mask=text_atts, encoder_hidden_states=image_embeds,
            encoder_attention_mask=image_atts, deterministic=deterministic,
            encoder_row_idx=image_row_idx,
            encoder_group_size=image_group_size)

    def get_features(self, image_embeds=None, text_embeds=None):
        """l2-normalized cls projections → (image_feat, text_feat), or the
        one of them whose embeds are given."""
        dt = self.config.dtype

        def norm(x):
            return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

        if image_embeds is not None:
            image_feat = norm(dense(image_embeds[:, 0, :], self.vision_proj,
                                    dt))
            if text_embeds is None:
                return image_feat
        text_feat = norm(dense(text_embeds[:, 0, :], self.text_proj, dt))
        if image_embeds is None:
            return text_feat
        return image_feat, text_feat

    def clamped_temp(self):
        c = self.config
        if not c.learnable_temp:
            return torch.tensor(c.temp)
        return torch.clamp(self.temp, c.min_temp, c.max_temp)

    # --- losses -----------------------------------------------------------

    def get_contrastive_loss(self, image_feat, text_feat, idx=None):
        return losses.contrastive_loss(image_feat, text_feat,
                                       self.clamped_temp(), idx=idx)

    def _negatives(self, generator, image_feat, text_feat, fixed_negatives,
                   idx=None):
        """(image_neg, text_neg) of this rank's rows: indices into the
        global batch (every rank's rows in rank order; on one process the
        batch), drawn from the shared generator or given."""
        if fixed_negatives is not None:
            return fixed_negatives
        if generator is None:
            raise ValueError("hard negatives need a torch.Generator or "
                             "fixed_negatives")
        return losses.hard_negative_indices(
            mesh.shared_generator(generator), image_feat, text_feat,
            self.clamped_temp(), idx=idx)

    @staticmethod
    def _global_rows(x, index, grad: bool = True):
        """Rows `index` (into the global batch) of every rank's `x`
        gathered, with gradient back to the rank that owns each where
        `grad`; on one process `x[index]`."""
        src = mesh.all_gather_with_grad(x) if grad else mesh.all_gather(x)
        return src[index]

    def _itm_loss(self, cls_rows):
        B = cls_rows.shape[0] // 3
        logits = self.itm_head(cls_rows)
        labels = torch.cat([torch.ones(B, dtype=torch.int64),
                            torch.zeros(2 * B, dtype=torch.int64)])
        return cross_entropy(logits, labels.to(logits.device))

    def get_matching_loss(self, generator, image_embeds, image_atts,
                          image_feat, text_atts, text_feat, text_embeds,
                          idx=None, is_pretrain=True, deterministic=True,
                          fixed_negatives=None):
        """ITM with in-batch hard negatives: one positive pass and one pass
        over [text_pos × image_neg ‖ text_neg × image_pos]. From 577 image
        tokens (384 px) the second pass projects cross k/v once per unique
        image and gathers them per row, as the JAX package does by default;
        `XFM_SHARED_CROSS_KV` = "1" / "0" forces the shared / gathered form
        at any length, as there. `fixed_negatives=(image_neg, text_neg)`
        replaces the draw; `idx` (image ids) keeps rows of the same image
        from being drawn. Under a process group the negatives are rows of
        the global batch, gathered from the ranks that own them; the
        shared form then projects this rank's images and its negatives'."""
        image_neg, text_neg = self._negatives(generator, image_feat,
                                              text_feat, fixed_negatives, idx)
        rows = self._global_rows
        text_embeds_all = torch.cat([text_embeds, rows(text_embeds,
                                                       text_neg)])
        text_atts_all = torch.cat([text_atts, rows(text_atts, text_neg,
                                                   False)])
        if shared_cross_kv(image_embeds.shape[1]):
            ar = torch.arange(image_neg.shape[0], device=image_neg.device,
                              dtype=image_neg.dtype)
            if mesh.is_distributed():
                image_embeds_all = torch.cat([image_embeds, rows(
                    image_embeds, image_neg)])
                atts_pool = torch.cat([image_atts, rows(image_atts,
                                                        image_neg, False)])
                row_idx = torch.cat([ar + ar.shape[0], ar])
            else:
                image_embeds_all, atts_pool = image_embeds, image_atts
                row_idx = torch.cat([image_neg, ar])
            image_atts_all = atts_pool[row_idx]
        else:
            row_idx = None
            image_embeds_all = torch.cat([rows(image_embeds, image_neg),
                                          image_embeds])
            image_atts_all = torch.cat([rows(image_atts, image_neg, False),
                                        image_atts])
        cross_pos = self.get_cross_embeds(
            image_embeds, image_atts, text_embeds, text_atts, deterministic,
            is_pretrain)[:, 0, :]
        cross_neg = self.get_cross_embeds(
            image_embeds_all, image_atts_all, text_embeds_all, text_atts_all,
            deterministic, is_pretrain, image_row_idx=row_idx)[:, 0, :]
        return self._itm_loss(torch.cat([cross_pos, cross_neg]))

    def get_matching_and_fuse_mlm_loss(self, generator, image_embeds,
                                       image_atts, image_feat, text_atts,
                                       text_feat, text_embeds,
                                       text_ids_masked, masked_pos,
                                       masked_ids, deterministic=True,
                                       fixed_negatives=None):
        """ITM (1 positive + 2 hard-negative rows) and fusion-MLM in one
        4B-row fusion pass; image k/v are projected once per unique image
        (under a process group: this rank's and its negatives', gathered
        from the ranks that own them). The MLM mean is over every rank's
        masked tokens."""
        B = text_atts.shape[0]
        image_neg, text_neg = self._negatives(generator, image_feat,
                                              text_feat, fixed_negatives)
        enc_masked = self.get_text_embeds(text_ids_masked, text_atts,
                                          deterministic)
        if self.config.detach_text_forMLM:
            enc_masked = enc_masked.detach()
        text_embeds = text_embeds.detach()
        rows = self._global_rows
        # rows: [pos ‖ text_pos×image_neg ‖ text_neg×image_pos ‖ mlm]
        emb_all = torch.cat([text_embeds, text_embeds,
                             rows(text_embeds, text_neg, False), enc_masked])
        atts_all = torch.cat([text_atts, text_atts,
                              rows(text_atts, text_neg, False), text_atts])
        ar = torch.arange(B, device=image_neg.device, dtype=image_neg.dtype)
        if mesh.is_distributed():
            pool = torch.cat([image_embeds, rows(image_embeds, image_neg)])
            atts_pool = torch.cat([image_atts, rows(image_atts, image_neg,
                                                    False)])
            row_idx = torch.cat([ar, ar + B, ar, ar])
        else:
            pool, atts_pool = image_embeds, image_atts
            row_idx = torch.cat([ar, image_neg, ar, ar])
        hidden = self.fusion_encoder(
            inputs_embeds=emb_all, attention_mask=atts_all,
            encoder_hidden_states=pool,
            encoder_attention_mask=atts_pool[row_idx],
            deterministic=deterministic, encoder_row_idx=row_idx)
        loss_itm = self._itm_loss(hidden[: 3 * B, 0, :])
        mlm_logits = self.fusion_encoder.mlm_logits(hidden[3 * B:],
                                                    masked_pos)
        return loss_itm, cross_entropy(mlm_logits, masked_ids,
                                       over_ranks=True)

    def get_fuse_mlm_loss(self, text_ids_masked, text_atts, image_embeds,
                          image_atts, masked_pos, masked_ids,
                          deterministic=True):
        """Fusion-MLM: masked text through the text encoder (detached), the
        fusion encoder, and the MLM head at the masked positions."""
        enc = self.get_text_embeds(text_ids_masked, text_atts, deterministic)
        if self.config.detach_text_forMLM:
            enc = enc.detach()
        hidden = self.fusion_encoder(
            inputs_embeds=enc, attention_mask=text_atts,
            encoder_hidden_states=image_embeds,
            encoder_attention_mask=image_atts, deterministic=deterministic)
        logits = self.fusion_encoder.mlm_logits(hidden, masked_pos)
        return cross_entropy(logits, masked_ids, over_ranks=True)

    def get_mlm_loss(self, text_ids_masked, text_atts, masked_pos,
                     masked_ids, deterministic=True):
        """Text-encoder MLM of the text-only stream: the masked text
        through the text encoder alone and its MLM head."""
        hidden = self.text_encoder(text_ids_masked, attention_mask=text_atts,
                                   deterministic=deterministic)
        logits = self.text_encoder.mlm_logits(hidden, masked_pos)
        return cross_entropy(logits, masked_ids, over_ranks=True)

    def get_mim_loss(self, image_embeds_masked, targets, mask,
                     vqkd_code_ids=None):
        """MIM: with `use_vision_tokenizer` the CE of `lm_head` over the
        masked patches against the tokenizer's code ids (ValueError where
        they are missing); otherwise the feature regression (MSE) against
        the unmasked forward."""
        if self.config.use_vision_tokenizer:
            if vqkd_code_ids is None:
                raise ValueError(
                    "use_vision_tokenizer=True: MIM needs vqkd_code_ids from "
                    "the frozen VQ-KD tokenizer (the pretrain task computes "
                    "them when the YAML sets use_vision_tokenizer)")
            logits = dense(image_embeds_masked[:, 1:, :], self.lm_head,
                           self.config.dtype)
            return losses.mim_vqkd_loss(logits, vqkd_code_ids, mask)
        return losses.mim_mse_loss(image_embeds_masked, targets, mask,
                                   cls_too=not self.config.mim_cls_only)

    def get_bbox_loss(self, output_coord, target_bbox, is_image=None):
        return losses.bbox_loss(output_coord, target_bbox, is_image)

    def predict_bbox(self, image_embeds, text_atts, text_embeds,
                     is_pretrain=True, deterministic=True):
        """The fusion cls over all of `image_embeds` → the bbox head →
        sigmoid cxcywh [B, 4]."""
        image_atts = torch.ones(image_embeds.shape[:2], dtype=torch.int64,
                                device=image_embeds.device)
        cls = self.get_cross_embeds(image_embeds, image_atts, text_embeds,
                                    text_atts, deterministic,
                                    is_pretrain)[:, 0, :]
        return torch.sigmoid(self.bbox_head(cls).float())

    def forward(self, images, text_ids, text_atts,
                deterministic: bool = True):
        """Vision + text + one fusion pass."""
        image_embeds = self.get_vision_embeds(images,
                                              deterministic=deterministic)
        text_embeds = self.get_text_embeds(text_ids, text_atts,
                                           deterministic)
        image_atts = torch.ones(image_embeds.shape[:2], dtype=torch.int64,
                                device=image_embeds.device)
        cross = self.get_cross_embeds(image_embeds, image_atts, text_embeds,
                                      text_atts, deterministic)
        return image_embeds, text_embeds, cross
