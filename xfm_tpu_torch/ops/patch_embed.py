"""Patch extraction for the matmul patch embedding
(`xfm_tpu/ops/patch_embed.py`)."""
from __future__ import annotations

import torch


def extract_patches(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """NHWC [B, H, W, C] → [B, (H/P)·(W/P), P·P·C]; patches row-major, and
    inside a patch the feature order is (prow, pcol, channel)."""
    B, H, W, C = images.shape
    P = patch_size
    gh, gw = H // P, W // P
    x = images.reshape(B, gh, P, gw, P, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, P * P * C)


def patch_kernel_from_conv(conv_w: torch.Tensor) -> torch.Tensor:
    """Conv2d weight [D, C, P, P] (OIHW) → matmul kernel [P·P·C, D] in the
    feature order of `extract_patches`."""
    D, C, P, _ = conv_w.shape
    return conv_w.permute(2, 3, 1, 0).reshape(P * P * C, D)
