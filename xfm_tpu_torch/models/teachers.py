"""The frozen teachers of VQ-KD tokenizer training (`xfm_tpu/models/
teachers.py`): OpenAI CLIP ViT-B/16 (the CLIP tower and its `proj`) and
DINO ViT-B/16 (a plain ViT: absolute positions, no rel-pos bias, no
LayerScale, a final norm). The tokenizer's decoder regresses their patch
features. Images come CLIP-normalized from the pipeline; `renormalize`
gives the DINO teacher ImageNet statistics.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..data.device_aug import CLIP_MEAN, CLIP_STD
from .beit2 import BeitVisionTransformer, VisionConfig
from .clip_vit import ClipVisionConfig, ClipVisionTransformer

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def renormalize(images: torch.Tensor, src_mean, src_std, dst_mean,
                dst_std) -> torch.Tensor:
    """Images normalized with the (src) statistics → normalized with the
    (dst) ones."""
    def t(v):
        return torch.as_tensor(v, dtype=images.dtype, device=images.device)

    raw = images * t(src_std) + t(src_mean)
    return (raw - t(dst_mean)) / t(dst_std)


class CLIPTeacher(nn.Module):
    """The CLIP image tower (`visual`) and its projection `proj` [C, D]:
    the projected features of the patch tokens (the cls token dropped)."""

    def __init__(self, config: ClipVisionConfig = ClipVisionConfig(),
                 proj_dim: int = 512):
        super().__init__()
        self.visual = ClipVisionTransformer(config)
        self.proj = nn.Parameter(torch.zeros(config.hidden_size, proj_dim))

    def forward(self, images: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        tokens = self.visual(images, deterministic=deterministic)
        return tokens[:, 1:, :] @ self.proj.to(tokens.dtype)


def dino_vit_base(image_res: int = 224,
                  dtype: torch.dtype = torch.float32) -> VisionConfig:
    """DINO ViT-B/16: absolute positions, no rel-pos bias, no LayerScale,
    the final norm, eps 1e-6."""
    return VisionConfig(
        image_res=image_res, patch_size=16, embed_dim=768, depth=12,
        num_heads=12, init_values=0.0, use_rel_pos_bias=False,
        use_abs_pos_emb=True, use_mean_pooling=False, drop_path_rate=0.0,
        layer_norm_eps=1e-6, dtype=dtype)


class DINOTeacher(nn.Module):
    """DINO ViT-B/16 (`backbone`): the patch tokens after the final norm.
    `config` replaces `dino_vit_base(image_res, dtype)` (a smaller tower)."""

    def __init__(self, image_res: int = 224,
                 dtype: torch.dtype = torch.float32,
                 config: Optional[VisionConfig] = None):
        super().__init__()
        self.backbone = BeitVisionTransformer(
            config or dino_vit_base(image_res, dtype))

    def forward(self, images: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        return self.backbone(images, deterministic=deterministic)[:, 1:, :]


def teacher_features(teacher: nn.Module, images: torch.Tensor,
                     pipeline: str = "clip") -> torch.Tensor:
    """A frozen teacher's features of pipeline-normalized (CLIP) images,
    under `no_grad`; any `pipeline` but "clip" renormalizes to ImageNet's
    statistics first."""
    if pipeline != "clip":
        images = renormalize(images, CLIP_MEAN, CLIP_STD, IMAGENET_MEAN,
                             IMAGENET_STD)
    with torch.no_grad():
        return teacher(images)
