"""Host image transforms of the eval (`xfm_tpu/data/transforms.py`
`decode_image`, `normalize`, `TestTransform`): NHWC float32 arrays. PIL is
imported inside the functions that decode or resize."""
from __future__ import annotations

import base64
import io

import numpy as np

from .device_aug import CLIP_MEAN as _MEAN, CLIP_STD as _STD

CLIP_MEAN = np.array(_MEAN, np.float32)
CLIP_STD = np.array(_STD, np.float32)


def _pil():
    from PIL import Image, ImageFile

    Image.MAX_IMAGE_PIXELS = None  # tolerate huge inputs
    ImageFile.LOAD_TRUNCATED_IMAGES = True  # and truncated JPEGs
    return Image


def decode_image(source):
    """Path / bytes / base64 string / uint8 array → RGB PIL image."""
    Image = _pil()
    if isinstance(source, np.ndarray):
        if source.ndim == 2:
            source = np.stack([source] * 3, axis=-1)
        return Image.fromarray(source.astype(np.uint8)).convert("RGB")
    if isinstance(source, Image.Image):
        img = source
    elif isinstance(source, (bytes, bytearray)):
        img = Image.open(io.BytesIO(source))
    elif isinstance(source, str) and len(source) > 260:
        img = Image.open(io.BytesIO(base64.b64decode(source)))
    else:
        img = Image.open(source)
    return img.convert("RGB")


def normalize(arr: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] → CLIP-normalized float32."""
    return (arr.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD


class TestTransform:
    """Bicubic resize to image_res², then `normalize`."""

    __test__ = False  # not a pytest class

    def __init__(self, image_res: int):
        self.image_res = image_res

    def __call__(self, img) -> np.ndarray:
        Image = _pil()
        img = img.resize((self.image_res, self.image_res), Image.BICUBIC)
        return normalize(np.asarray(img, np.uint8))
