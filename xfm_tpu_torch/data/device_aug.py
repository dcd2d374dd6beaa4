"""uint8 → CLIP-normalized images on the device
(`xfm_tpu/data/device_aug.py` `maybe_normalize`)."""
from __future__ import annotations

import torch

# copies of xfm_tpu/data/transforms.py CLIP_MEAN / CLIP_STD
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def maybe_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC images → CLIP-normalized float32; float input passes
    through unchanged."""
    if images.dtype.is_floating_point:
        return images
    x = images.float() / 255.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std
