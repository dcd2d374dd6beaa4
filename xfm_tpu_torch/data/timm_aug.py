"""The timm-recipe ImageNet augmentation (`xfm_tpu/data/timm_aug.py`;
reference Imagenet.py:260-295 `build_transform` → timm `create_transform`
with `auto_augment='rand-m9-mstd0.5-inc1'`, `re_prob` / `re_mode` /
`re_count`, `color_jitter`, bicubic, the ImageNet mean and std), draw for
draw the JAX copy's from the same seed:
- `parse_rand_augment` / `TimmRandAugment`: the `rand-mM-mstdS-incD`
  policy (a gaussian-sampled magnitude, the "increasing" severities, the
  timm op set with SolarizeAdd and the relative translates);
- `RandomErasing`: erasing on the normalized array, 'pixel' (per-pixel
  gaussian) or 'const' (0) fill, `count` rectangles;
- `color_jitter_img`: brightness, contrast and saturation jitter (timm
  applies it only where no auto-augment policy is set);
- `ImagenetTrainTransform` / `ImagenetEvalTransform`: the train and eval
  stacks, normalized with the ImageNet mean and std in f32 (so that
  `device_aug.maybe_normalize` passes them through), and the 224/256
  crop-pct eval resize.
Magnitudes follow timm's formulas over PIL; this is not timm bit for bit.
PIL is imported inside the functions that touch images.
"""
from __future__ import annotations

import re

import numpy as np

from .transforms import random_resized_crop

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_MAX_LEVEL = 10.0
_FILL = (124, 116, 104)  # timm's img_mean fill

# timm _RAND_INCREASING_TRANSFORMS
RAND_INC_OPS = ("AutoContrast", "Equalize", "Invert", "Rotate",
                "PosterizeIncreasing", "SolarizeIncreasing", "SolarizeAdd",
                "ColorIncreasing", "ContrastIncreasing",
                "BrightnessIncreasing", "SharpnessIncreasing",
                "ShearX", "ShearY", "TranslateXRel", "TranslateYRel")


def parse_rand_augment(aa: str) -> dict:
    """'rand-m9-mstd0.5-inc1' → dict(num_ops=2, magnitude=9.0, mstd=0.5,
    increasing=True) (timm auto_augment.py `rand_augment_transform`); a
    `p` token sets `prob`."""
    if not aa.startswith("rand"):
        raise ValueError(f"only rand-* auto_augment policies supported: {aa}")
    out = dict(num_ops=2, magnitude=9.0, mstd=0.0, increasing=False)
    for tok in aa.split("-")[1:]:
        if m := re.fullmatch(r"m(\d+)", tok):
            out["magnitude"] = float(m.group(1))
        elif m := re.fullmatch(r"mstd([\d.]+)", tok):
            out["mstd"] = float(m.group(1))
        elif m := re.fullmatch(r"inc(\d)", tok):
            out["increasing"] = bool(int(m.group(1)))
        elif m := re.fullmatch(r"n(\d+)", tok):
            out["num_ops"] = int(m.group(1))
        elif m := re.fullmatch(r"p([\d.]+)", tok):
            out["prob"] = float(m.group(1))
    return out


class TimmRandAugment:
    """RandAugment with timm's semantics: `num_ops` ops drawn with
    replacement, each applied with probability `prob` at a magnitude
    ~ N(magnitude, mstd) clipped to [0, 10], with a random sign, the
    'increasing' severities for the posterize, solarize and enhance ops.
    Every draw comes from `rng`."""

    def __init__(self, num_ops=2, magnitude=9.0, mstd=0.5, increasing=True,
                 prob=0.5, rng: np.random.Generator | None = None):
        self.num_ops = num_ops
        self.magnitude = magnitude
        self.mstd = mstd
        self.increasing = increasing
        self.prob = prob
        self.rng = rng or np.random.default_rng()

    @classmethod
    def from_config_str(cls, aa: str,
                        rng: np.random.Generator | None = None):
        return cls(rng=rng, **parse_rand_augment(aa))

    def _level(self, r) -> float:
        lvl = self.magnitude
        if self.mstd > 0:
            lvl = r.normal(lvl, self.mstd)
        return float(np.clip(lvl, 0.0, _MAX_LEVEL))

    def __call__(self, img):
        r = self.rng
        for i in r.choice(len(RAND_INC_OPS), self.num_ops):
            if r.random() > self.prob:
                continue
            img = self._apply(img, RAND_INC_OPS[int(i)], self._level(r),
                              -1.0 if r.random() < 0.5 else 1.0)
        return img

    @staticmethod
    def _apply(img, name, lvl, sign):
        from PIL import Image, ImageEnhance, ImageOps

        frac = lvl / _MAX_LEVEL
        if name == "AutoContrast":
            return ImageOps.autocontrast(img)
        if name == "Equalize":
            return ImageOps.equalize(img)
        if name == "Invert":
            return ImageOps.invert(img)
        if name == "Rotate":
            return img.rotate(sign * 30.0 * frac, resample=Image.BILINEAR,
                              fillcolor=_FILL)
        if name == "PosterizeIncreasing":
            # timm: 4 - int(frac * 4) bits removed from 8
            return ImageOps.posterize(img, max(1, 8 - int(frac * 4)))
        if name == "SolarizeIncreasing":
            return ImageOps.solarize(img, 256 - int(frac * 256))
        if name == "SolarizeAdd":
            add = int(frac * 110)
            arr = np.asarray(img).astype(np.int32)
            arr = np.where(arr < 128, np.clip(arr + add, 0, 255), arr)
            return Image.fromarray(arr.astype(np.uint8))
        if name.endswith("Increasing"):  # Color/Contrast/Brightness/Sharp
            enh = {"ColorIncreasing": ImageEnhance.Color,
                   "ContrastIncreasing": ImageEnhance.Contrast,
                   "BrightnessIncreasing": ImageEnhance.Brightness,
                   "SharpnessIncreasing": ImageEnhance.Sharpness}[name]
            return enh(img).enhance(1.0 + sign * 0.9 * frac)
        if name in ("ShearX", "ShearY"):
            s = sign * 0.3 * frac
            mat = (1, s, 0, 0, 1, 0) if name == "ShearX" else \
                (1, 0, 0, s, 1, 0)
            return img.transform(img.size, Image.AFFINE, mat,
                                 resample=Image.BILINEAR, fillcolor=_FILL)
        if name in ("TranslateXRel", "TranslateYRel"):
            t = sign * 0.45 * frac
            if name == "TranslateXRel":
                mat = (1, 0, t * img.size[0], 0, 1, 0)
            else:
                mat = (1, 0, 0, 0, 1, t * img.size[1])
            return img.transform(img.size, Image.AFFINE, mat,
                                 resample=Image.BILINEAR, fillcolor=_FILL)
        raise ValueError(name)


class RandomErasing:
    """timm's RandomErasing on the normalized float array: with probability
    `prob`, `count` rectangles (each of `area` · H · W / count, aspect
    log-uniform in `aspect`, 10 tries), filled per pixel from N(0, 1)
    ('pixel') or with 0 ('const')."""

    def __init__(self, prob=0.25, mode="pixel", count=1,
                 area=(0.02, 1 / 3), aspect=(0.3, 10 / 3),
                 rng: np.random.Generator | None = None):
        self.prob, self.mode, self.count = prob, mode, count
        self.area, self.aspect = area, aspect
        self.rng = rng or np.random.default_rng()

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        r = self.rng
        if r.random() > self.prob:
            return arr
        H, W = arr.shape[:2]
        arr = arr.copy()
        for _ in range(self.count):
            for _ in range(10):
                a = r.uniform(*self.area) * H * W / self.count
                ar = float(np.exp(r.uniform(np.log(self.aspect[0]),
                                            np.log(self.aspect[1]))))
                eh = int(round(np.sqrt(a * ar)))
                ew = int(round(np.sqrt(a / ar)))
                if 0 < eh < H and 0 < ew < W:
                    y = int(r.integers(0, H - eh))
                    x = int(r.integers(0, W - ew))
                    if self.mode == "pixel":
                        arr[y:y + eh, x:x + ew] = r.normal(
                            size=(eh, ew, arr.shape[2])).astype(arr.dtype)
                    else:
                        arr[y:y + eh, x:x + ew] = 0.0
                    break
        return arr


def color_jitter_img(img, factor: float, rng: np.random.Generator):
    """Brightness, contrast and saturation jitter by ±factor (torchvision
    ColorJitter as timm configures it)."""
    from PIL import ImageEnhance

    for enh in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                ImageEnhance.Color):
        img = enh(img).enhance(rng.uniform(max(0.0, 1 - factor), 1 + factor))
    return img


def imagenet_normalize(arr: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] → ImageNet-normalized float32."""
    return (arr.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


class ImagenetTrainTransform:
    """RandomResizedCrop(0.08-1, bicubic) + hflip + [RandAugment `aa` |
    `color_jitter`] + `imagenet_normalize` + `RandomErasing` (reference
    Imagenet.py:265-278), every draw from one generator seeded from
    `seed`."""

    def __init__(self, image_res: int, aa: str | None = "rand-m9-mstd0.5-inc1",
                 color_jitter: float | None = None, reprob: float = 0.25,
                 remode: str = "pixel", recount: int = 1,
                 seed: int | None = None):
        self.image_res = image_res
        self.rng = np.random.default_rng(seed)
        self.aa = (TimmRandAugment.from_config_str(aa, rng=self.rng)
                   if aa else None)
        self.color_jitter = color_jitter if not aa else None
        self.erase = (RandomErasing(reprob, remode, recount, rng=self.rng)
                      if reprob and reprob > 0 else None)

    def __call__(self, img) -> np.ndarray:
        from PIL import Image

        img = random_resized_crop(img, self.image_res, scale=(0.08, 1.0),
                                  rng=self.rng)
        if self.rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if self.aa is not None:
            img = self.aa(img)
        elif self.color_jitter:
            img = color_jitter_img(img, self.color_jitter, self.rng)
        arr = imagenet_normalize(np.asarray(img, np.uint8))
        if self.erase is not None:
            arr = self.erase(arr)
        return arr


class ImagenetEvalTransform:
    """Resize the short side to image_res / crop_pct (bicubic), center crop,
    `imagenet_normalize` (reference Imagenet.py:281-295: crop_pct 224/256
    up to 224 px, else 1)."""

    def __init__(self, image_res: int):
        self.image_res = image_res
        crop_pct = 224 / 256 if image_res <= 224 else 1.0
        self.scale_size = int(image_res / crop_pct)

    def __call__(self, img) -> np.ndarray:
        from PIL import Image

        w, h = img.size
        short = min(w, h)
        ow = int(round(w * self.scale_size / short))
        oh = int(round(h * self.scale_size / short))
        img = img.resize((ow, oh), Image.BICUBIC)
        x = (ow - self.image_res) // 2
        y = (oh - self.image_res) // 2
        img = img.crop((x, y, x + self.image_res, y + self.image_res))
        return imagenet_normalize(np.asarray(img, np.uint8))
