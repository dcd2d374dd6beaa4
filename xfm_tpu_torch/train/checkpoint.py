"""Weights carried across, loaded and initialized.

- `state_dict_from_jax`: the JAX package's param tree (nested dicts of numpy
  arrays) → a state_dict the port loads with `load_state_dict(strict=True)`.
  It is the port's own copy of `xfm_tpu/train/checkpoint.py`
  `export_xfm_checkpoint`: Dense kernels transposed, the decoder tied to the
  word embeddings; the patch kernel stays in the port's matmul layout
  [P·P·3, C] (the export writes the reference's Conv2d layout). The CLIP-ViT
  tower (`clip_vit_from_jax`) is the inverse of `import_clip_vit`.
- `load_reference_state_dict`: a reference-named torch state dict (e.g. a
  released checkpoint or a golden fixture) into a port module.
- `init_weights`: random weights that follow the JAX package's initializers.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ..ops.patch_embed import patch_kernel_from_conv


def _t(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _pre(prefix: str) -> str:
    return f"{prefix}." if prefix else ""


def text_encoder_from_jax(p: Dict[str, Any], num_layers: int,
                          prefix: str = "") -> Dict[str, np.ndarray]:
    """JAX TextTransformer params → reference names under `prefix`."""
    sd: Dict[str, np.ndarray] = {}
    r = f"{_pre(prefix)}roberta"
    emb = p["embeddings"]
    for nm in ("word_embeddings", "position_embeddings",
               "token_type_embeddings"):
        sd[f"{r}.embeddings.{nm}.weight"] = _t(emb[nm]["embedding"])

    def dense(dst, sub):
        sd[f"{dst}.weight"] = _t(sub["kernel"]).T
        sd[f"{dst}.bias"] = _t(sub["bias"])

    def ln(dst, sub):
        sd[f"{dst}.weight"] = _t(sub["scale"])
        sd[f"{dst}.bias"] = _t(sub["bias"])

    ln(f"{r}.embeddings.LayerNorm", emb["LayerNorm"])
    for i in range(num_layers):
        lp = p[f"layer_{i}"]
        b = f"{r}.encoder.layer.{i}"
        for att in ("attention", "crossattention"):
            if att not in lp:
                continue
            for qkv in ("query", "key", "value"):
                dense(f"{b}.{att}.self.{qkv}", lp[att][qkv])
            dense(f"{b}.{att}.output.dense", lp[att]["attn_out"])
            ln(f"{b}.{att}.output.LayerNorm", lp[att]["output_LayerNorm"])
        dense(f"{b}.intermediate.dense", lp["intermediate_dense"])
        dense(f"{b}.output.dense", lp["output_dense"])
        ln(f"{b}.output.LayerNorm", lp["ffn_LayerNorm"])
    if "mlm_head" in p:
        h = f"{_pre(prefix)}lm_head"
        dense(f"{h}.dense", p["mlm_head"]["dense"])
        ln(f"{h}.layer_norm", p["mlm_head"]["layer_norm"])
        sd[f"{h}.bias"] = _t(p["mlm_head"]["bias"])
        sd[f"{h}.decoder.weight"] = sd[
            f"{r}.embeddings.word_embeddings.weight"]
        sd[f"{h}.decoder.bias"] = _t(p["mlm_head"]["bias"])
    return sd


def beit2_from_jax(p: Dict[str, Any], depth: int,
                   prefix: str = "") -> Dict[str, np.ndarray]:
    """JAX BeitVisionTransformer params → reference names under `prefix`
    (patch kernel kept in matmul layout)."""
    sd: Dict[str, np.ndarray] = {}
    v = _pre(prefix)
    sd[f"{v}patch_embed.proj.weight"] = _t(p["patch_embed_kernel"])
    sd[f"{v}patch_embed.proj.bias"] = _t(p["patch_embed_bias"])
    sd[f"{v}cls_token"] = _t(p["cls_token"])
    sd[f"{v}mask_token"] = _t(p["mask_token"])
    for i in range(depth):
        bp = p[f"block_{i}"]
        b = f"{v}blocks.{i}"
        for nm in ("norm1", "norm2"):
            sd[f"{b}.{nm}.weight"] = _t(bp[nm]["scale"])
            sd[f"{b}.{nm}.bias"] = _t(bp[nm]["bias"])
        if "gamma_1" in bp:
            sd[f"{b}.gamma_1"] = _t(bp["gamma_1"])
            sd[f"{b}.gamma_2"] = _t(bp["gamma_2"])
        a = bp["attn"]
        sd[f"{b}.attn.qkv.weight"] = _t(a["qkv"]["kernel"]).T
        sd[f"{b}.attn.q_bias"] = _t(a["q_bias"])
        sd[f"{b}.attn.v_bias"] = _t(a["v_bias"])
        sd[f"{b}.attn.proj.weight"] = _t(a["proj"]["kernel"]).T
        sd[f"{b}.attn.proj.bias"] = _t(a["proj"]["bias"])
        sd[f"{b}.attn.relative_position_bias_table"] = _t(
            a["relative_position_bias_table"])
        for fc in ("fc1", "fc2"):
            sd[f"{b}.mlp.{fc}.weight"] = _t(bp[fc]["kernel"]).T
            sd[f"{b}.mlp.{fc}.bias"] = _t(bp[fc]["bias"])
    sd[f"{v}fc_norm.weight"] = _t(p["fc_norm"]["scale"])
    sd[f"{v}fc_norm.bias"] = _t(p["fc_norm"]["bias"])
    return sd


def clip_vit_from_jax(p: Dict[str, Any], num_layers: int,
                      prefix: str = "") -> Dict[str, np.ndarray]:
    """JAX ClipVisionTransformer params → reference names under `prefix`
    (the inverse of `xfm_tpu/train/checkpoint.py` `import_clip_vit`; patch
    kernel kept in matmul layout)."""
    sd: Dict[str, np.ndarray] = {}
    v = _pre(prefix)

    def dense(dst, sub):
        sd[f"{dst}.weight"] = _t(sub["kernel"]).T
        sd[f"{dst}.bias"] = _t(sub["bias"])

    def ln(dst, sub):
        sd[f"{dst}.weight"] = _t(sub["scale"])
        sd[f"{dst}.bias"] = _t(sub["bias"])

    sd[f"{v}class_embedding"] = _t(p["class_embedding"])
    sd[f"{v}patch_embed.weight"] = _t(p["patch_embed_kernel"])
    sd[f"{v}pos_embed.weight"] = _t(p["position_embedding"])
    ln(f"{v}pre_layrnorm", p["pre_layrnorm"])
    for i in range(num_layers):
        lp = p[f"layer_{i}"]
        b = f"{v}encoder.layers.{i}"
        ln(f"{b}.layer_norm1", lp["layer_norm1"])
        ln(f"{b}.layer_norm2", lp["layer_norm2"])
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{b}.self_attn.{proj}", lp[proj])
        dense(f"{b}.mlp.fc1", lp["fc1"])
        dense(f"{b}.mlp.fc2", lp["fc2"])
    ln(f"{v}post_layernorm", p["post_layernorm"])
    return sd


def _mlp_head(p: Dict[str, Any], prefix: str,
              sd: Dict[str, np.ndarray]) -> None:
    sd[f"{prefix}.0.weight"] = _t(p["fc1"]["kernel"]).T
    sd[f"{prefix}.0.bias"] = _t(p["fc1"]["bias"])
    sd[f"{prefix}.1.weight"] = _t(p["ln"]["scale"])
    sd[f"{prefix}.1.bias"] = _t(p["ln"]["bias"])
    sd[f"{prefix}.3.weight"] = _t(p["fc2"]["kernel"]).T
    sd[f"{prefix}.3.bias"] = _t(p["fc2"]["bias"])


def state_dict_from_jax(params: Dict[str, Any],
                        config) -> Dict[str, torch.Tensor]:
    """JAX XFM param tree (with or without the `backbone` level) → port
    state_dict for `XFMBase` and its heads, either vision tower."""
    bb = params["backbone"] if "backbone" in params else params
    if config.vision_backbone == "clip_vit":
        sd = clip_vit_from_jax(bb["vision_encoder"],
                               config.vision.num_hidden_layers,
                               "vision_encoder")
    else:
        sd = beit2_from_jax(bb["vision_encoder"], config.vision.depth,
                            "vision_encoder")
    sd.update(text_encoder_from_jax(bb["text_encoder"],
                                    config.text.num_hidden_layers,
                                    "text_encoder"))
    sd.update(text_encoder_from_jax(bb["fusion_encoder"],
                                    config.fusion.num_hidden_layers,
                                    "fusion_encoder"))
    for name in ("vision_proj", "text_proj", "fusion_proj"):
        if name in bb:
            sd[f"{name}.weight"] = _t(bb[name]["kernel"]).T
            sd[f"{name}.bias"] = _t(bb[name]["bias"])
    if "temp" in bb:
        sd["temp"] = _t(bb["temp"]).reshape(())
    for head in ("itm_head", "bbox_head"):
        if head in bb:
            _mlp_head(bb[head], head, sd)
    return to_torch(sd)


def to_torch(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


# buffers the reference saves that the port rebuilds itself
_REFERENCE_BUFFERS = ("relative_position_index", "position_ids")


def load_reference_state_dict(model: torch.nn.Module, sd, strict=True):
    """Load a reference-named state dict (numpy or torch values): the
    reference's buffers are dropped and its Conv2d patch weight
    [C, 3, P, P] (BEiT's `patch_embed.proj.weight`, CLIP's
    `patch_embed.weight`) becomes the matmul kernel. → load_state_dict's
    result."""
    out = {}
    for k, v in sd.items():
        if k.rsplit(".", 1)[-1] in _REFERENCE_BUFFERS:
            continue
        v = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if k.endswith(("patch_embed.proj.weight", "patch_embed.weight")) \
                and v.dim() == 4:
            v = patch_kernel_from_conv(v)
        out[k] = v.float() if v.is_floating_point() else v
    return model.load_state_dict(out, strict=strict)


def _trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator):
    """Standard normal truncated to [-2, 2], times `std` (flax
    `truncated_normal`)."""
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = torch.empty_like(t).uniform_(lo, 1 - lo, generator=g)
    t.copy_((torch.erfinv(2 * u - 1) * math.sqrt(2)).clamp_(-2, 2) * std)


@torch.no_grad()
def init_weights(model: torch.nn.Module, seed: int = 0) -> None:
    """Random weights following the JAX package's initializers: Dense
    lecun-normal (truncated), zero biases, LayerNorm ones, embeddings
    normal(1/√width), BEiT's patch kernel and cls/mask tokens trunc-normal
    0.02, BEiT proj/fc2 trunc-normal 0.02/√(2·layer) (`fix_init`),
    LayerScale at its init value, zero rel-pos tables, CLIP's class
    embedding, patch kernel and position embedding normal(0.02), temp at its
    init value."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            _trunc_normal_(m.weight, math.sqrt(1.0 / m.in_features)
                           / 0.87962566103423978, g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, torch.nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in model.modules():  # after Linear: the tied decoder shares these
        if isinstance(m, torch.nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim),
                             generator=g)
    for name, p in model.named_parameters():
        last = name.rsplit(".", 1)[-1]
        if last in ("cls_token", "mask_token") or name.endswith(
                "patch_embed.proj.weight"):
            _trunc_normal_(p, 0.02, g)
        elif last == "class_embedding" or name.endswith(
                ("patch_embed.weight", "pos_embed.weight")):
            p.normal_(0.0, 0.02, generator=g)
        elif last in ("q_bias", "v_bias", "relative_position_bias_table") \
                or name.endswith("patch_embed.proj.bias") \
                or name.endswith("lm_head.bias"):
            p.zero_()
    cfg = getattr(model, "config", None)
    vision = getattr(model, "vision_encoder", model)
    for i, blk in enumerate(getattr(vision, "blocks", [])):
        std = 0.02 / math.sqrt(2.0 * (i + 1))
        _trunc_normal_(blk.attn.proj.weight, std, g)
        _trunc_normal_(blk.mlp.fc2.weight, std, g)
        if blk.use_ls:
            blk.gamma_1.fill_(blk.c.init_values)
            blk.gamma_2.fill_(blk.c.init_values)
    if cfg is not None and hasattr(model, "temp"):
        model.temp.fill_(cfg.temp)
