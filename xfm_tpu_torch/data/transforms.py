"""Host image transforms (`xfm_tpu/data/transforms.py` `decode_image`,
`normalize`, `crop_box`, `random_resized_crop`, `TrainTransform`,
`TestTransform`): NHWC float32 arrays. PIL is imported inside the functions
that decode or resize."""
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


def crop_box(w: int, h: int, scale=(0.5, 1.0), ratio=(3 / 4, 4 / 3),
             rng: np.random.Generator | None = None):
    """(x, y, cw, ch) with the RandomResizedCrop distribution; the centre
    square after 10 rejected draws."""
    rng = rng if rng is not None else np.random.default_rng()
    area = w * h
    for _ in range(10):
        target = rng.uniform(*scale) * area
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        ar = float(np.exp(log_r))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x = int(rng.integers(0, w - cw, endpoint=True))
            y = int(rng.integers(0, h - ch, endpoint=True))
            return x, y, cw, ch
    s = min(w, h)
    return (w - s) // 2, (h - s) // 2, s, s


def random_resized_crop(img, size: int, scale=(0.5, 1.0),
                        ratio=(3 / 4, 4 / 3),
                        rng: np.random.Generator | None = None):
    """A `crop_box` of `img` resized bicubic to size²."""
    Image = _pil()
    w, h = img.size
    x, y, cw, ch = crop_box(w, h, scale, ratio, rng)
    return img.resize((size, size), Image.BICUBIC,
                      box=(x, y, x + cw, y + ch))


class TrainTransform:
    """RandomResizedCrop(scale) + hflip + RandAugment(2, 7) + normalize,
    every draw from one numpy generator (`seed`; `reseed` starts it
    anew)."""

    def __init__(self, image_res: int, scale=(0.5, 1.0), hflip=True,
                 randaug=True, augs=None, seed=None):
        from .randaugment import RandomAugment

        self.image_res = image_res
        self.scale = scale
        self.hflip = hflip
        self.randaug = RandomAugment(2, 7, augs=augs) if randaug else None
        self.reseed(seed)

    def reseed(self, seed) -> None:
        """Draw from `np.random.default_rng(seed)` from now on."""
        self.rng = np.random.default_rng(seed)
        if self.randaug is not None:
            self.randaug.rng = self.rng

    def __call__(self, img) -> np.ndarray:
        Image = _pil()
        img = random_resized_crop(img, self.image_res, self.scale,
                                  rng=self.rng)
        if self.hflip and self.rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if self.randaug is not None:
            img = self.randaug(img)
        return normalize(np.asarray(img, np.uint8))


class TestTransform:
    """Bicubic resize to image_res², then `normalize`."""

    __test__ = False  # not a pytest class

    def __init__(self, image_res: int):
        self.image_res = image_res

    def __call__(self, img) -> np.ndarray:
        Image = _pil()
        img = img.resize((self.image_res, self.image_res), Image.BICUBIC)
        return normalize(np.asarray(img, np.uint8))
