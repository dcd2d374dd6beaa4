"""Host image transforms (`xfm_tpu/data/transforms.py` `decode_image`,
`normalize`, `crop_box`, `random_resized_crop`, `TrainTransform`,
`NativeBatchTransform`, `TestTransform`), and grounding's box-aware
`BoxTrainTransform`: NHWC float32 arrays, or uint8 batches from the C++
loader (`NativeBatchTransform`). PIL is imported inside the functions
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
    """Path / bytes / base64 string / uint8 array ([H, W], [H, W, 1] or
    [H, W, 3]: a row of an npz split) → RGB PIL image."""
    Image = _pil()
    if isinstance(source, np.ndarray):
        if source.ndim == 3 and source.shape[-1] == 1:
            source = source[..., 0]
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


class NativeBatchTransform:
    """A `TrainTransform` over encoded blobs, a batch at a time, through
    the C++ loader (`xfm_tpu_torch.native`): the crops (`crop_box`) and
    flips drawn from the transform's generator, decode + crop + bilinear
    resize + flip on `workers` threads, then the batch's RandAugment plans
    (`RandomAugment.plan`, the same generator) applied by the C++ ops, or
    by PIL on a thread pool under XFM_NATIVE_RANDAUG=0. Emits uint8
    [B, S, S, 3]: the model normalizes on the device
    (`device_aug.maybe_normalize`). With `device_randaug` the plans are
    not drawn and the batch leaves un-augmented, for
    `device_aug.randaugment_batch` on the device. The pixels differ from
    `TrainTransform`'s by the resize filter (bilinear, PIL's bicubic)."""

    def __init__(self, train_transform: TrainTransform, workers: int = 8,
                 device_randaug: bool = False):
        from .. import native

        self.native = native
        self.transform = train_transform
        self.randaug = train_transform.randaug
        self.workers = max(1, workers)
        self.pool = None
        self.device_randaug = bool(device_randaug
                                   and self.randaug is not None)

    @classmethod
    def maybe_build(cls, train_transform, workers: int,
                    device_randaug: bool = False):
        """→ an instance, or None where `workers` <= 0,
        XFM_NATIVE_LOADER=0 or the loader is unavailable."""
        import os

        from .. import native

        if workers <= 0 or os.environ.get("XFM_NATIVE_LOADER", "1") == "0":
            return None
        if not native.available():
            return None
        return cls(train_transform, workers, device_randaug=device_randaug)

    def probe(self, blob: bytes):
        """(w, h) from the header, or None where the blob does not
        decode: the stream skips it at admission."""
        return self.native.image_dims(blob, fast=True)

    def __call__(self, blobs: list, dims: list):
        """→ (uint8 images, sub), or (None, None) when no blob of the batch
        decodes. sub[i] is the slot whose pixels slot i holds: a slot whose
        full decode failed (a body broken past its header) takes the pixels
        of a good one, the first failed the first good and so on, and a
        caller with a paired modality takes sub's entries of it too, so
        that the batch holds a repeated pair, never a mismatched one."""
        t, n = self.transform, len(blobs)
        crops = np.asarray(
            [crop_box(w, h, t.scale, rng=t.rng) for w, h in dims], np.int32)
        hflips = ((t.rng.random(n) < 0.5).astype(np.int32)
                  if t.hflip else np.zeros((n,), np.int32))
        u8, status = self.native.decode_batch(
            blobs, t.image_res, crops, hflips, threads=self.workers)
        good = np.flatnonzero(status == 0)
        if good.size == 0:
            return None, None
        sub = np.arange(n)
        for j, i in enumerate(np.flatnonzero(status != 0)):
            sub[i] = good[j % good.size]
            u8[i] = u8[sub[i]]
        return self._augment(u8), sub

    def _augment(self, u8):
        import os

        if self.randaug is None or self.device_randaug:
            return u8
        plans = [self.randaug.plan(self.transform.rng)
                 for _ in range(len(u8))]
        if os.environ.get("XFM_NATIVE_RANDAUG", "1") != "0":
            self.native.randaugment_batch(u8, plans, self.randaug.M,
                                          threads=self.workers)
            return u8
        if self.pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self.pool = ThreadPoolExecutor(self.workers)

        def one(i):
            return np.asarray(self.randaug.apply_plan(u8[i], plans[i]),
                              np.uint8)

        return np.stack(list(self.pool.map(one, range(len(u8)))))


class TestTransform:
    """Bicubic resize to image_res², then `normalize`."""

    __test__ = False  # not a pytest class

    def __init__(self, image_res: int):
        self.image_res = image_res

    def __call__(self, img) -> np.ndarray:
        Image = _pil()
        img = img.resize((self.image_res, self.image_res), Image.BICUBIC)
        return normalize(np.asarray(img, np.uint8))


class BoxTrainTransform:
    """The grounding fine-tune's train transform, which keeps the target
    box on the pixels it names: a crop that holds the box, drawn as the
    region stream draws its crop (x0 ∈ [0, x], y0 ∈ [0, y], x1 ∈
    [x + w, W], y1 ∈ [y + h, H], on whole pixels), resized bicubic to
    image_res², then RandAugment(2, 7) over its photometric ops alone (the
    geometric ones would move pixels under a box that stays put), then
    `normalize`. Every draw from one numpy generator, which `reseed`
    starts anew (the data's `epoch` reseeds it each epoch). (The JAX
    package trains through `TrainTransform`, a random resized crop and
    geometric RandAugment, and normalizes the box by the uncropped image,
    so its target names a region the crop has moved or cut away.)"""

    PHOTOMETRIC = ("Identity", "AutoContrast", "Equalize", "Brightness",
                   "Sharpness")
    maps_box = True

    def __init__(self, image_res: int):
        from .randaugment import RandomAugment

        self.image_res = image_res
        self.randaug = RandomAugment(2, 7, augs=self.PHOTOMETRIC)
        self.reseed(None)

    def reseed(self, seed) -> None:
        """Draw from `np.random.default_rng(seed)` from now on."""
        self.rng = self.randaug.rng = np.random.default_rng(seed)

    def __call__(self, img, box):
        """img (PIL), box (x, y, w, h) in its pixels → (the image array,
        the box as cxcywh normalized to the crop, float32 [4])."""
        import math

        Image = _pil()
        W, H = img.size
        x, y, w, h = (float(v) for v in box)
        bx0, by0 = min(max(x, 0.0), W - 1.0), min(max(y, 0.0), H - 1.0)
        bx1, by1 = min(max(x + w, bx0 + 1.0), W), min(max(y + h, by0 + 1.0),
                                                      H)
        r = self.rng
        x0 = int(r.integers(0, int(math.floor(bx0)), endpoint=True))
        y0 = int(r.integers(0, int(math.floor(by0)), endpoint=True))
        x1 = int(r.integers(min(int(math.ceil(bx1)), W), W, endpoint=True))
        y1 = int(r.integers(min(int(math.ceil(by1)), H), H, endpoint=True))
        img = img.crop((x0, y0, x1, y1)).resize(
            (self.image_res, self.image_res), Image.BICUBIC)
        img = self.randaug(img)
        cw, ch = x1 - x0, y1 - y0
        target = np.asarray([((bx0 + bx1) / 2 - x0) / cw,
                             ((by0 + by1) / 2 - y0) / ch,
                             (bx1 - bx0) / cw, (by1 - by0) / ch], np.float32)
        return normalize(np.asarray(img, np.uint8)), target
