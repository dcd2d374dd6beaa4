"""RandAugment (`xfm_tpu/data/randaugment.py`): N ops drawn per image, each
applied with probability 0.5 at magnitude M on the MAX_LEVEL = 10 scale,
over PIL. PIL is imported inside the functions that touch images."""
from __future__ import annotations

import numpy as np

MAX_LEVEL = 10
REPLACE = (128, 128, 128)


def _shear_arg(level):
    return (level / MAX_LEVEL) * 0.3


def _translate_arg(level, const=250):
    return int((level / MAX_LEVEL) * const)


def _rotate_arg(level):
    return (level / MAX_LEVEL) * 30


def _enhance_arg(level):
    return (level / MAX_LEVEL) * 1.8 + 0.1


def _posterize_arg(level):
    return int((level / MAX_LEVEL) * 4)


def _solarize_arg(level):
    return int((level / MAX_LEVEL) * 256)


def _as_pil(img):
    from PIL import Image

    if isinstance(img, np.ndarray):
        return Image.fromarray(img.astype(np.uint8))
    return img


class RandomAugment:
    DEFAULT_AUGS = ("Identity", "AutoContrast", "Equalize", "Brightness",
                    "Sharpness", "ShearX", "ShearY", "TranslateX",
                    "TranslateY", "Rotate")

    def __init__(self, N: int = 2, M: int = 7, augs=None,
                 rng: np.random.Generator | None = None):
        self.N, self.M = N, M
        self.augs = tuple(augs) if augs else self.DEFAULT_AUGS
        self.rng = rng if rng is not None else np.random.default_rng()

    def plan(self, rng: np.random.Generator | None = None):
        """Every draw for one image, up front → [(name, sign)] of the ops
        that apply."""
        r = rng if rng is not None else self.rng
        ops = r.choice(len(self.augs), self.N)
        planned = []
        for i in ops:
            skip = r.random() > 0.5
            sign = -1 if r.random() < 0.5 else 1
            if not skip:
                planned.append((self.augs[int(i)], sign))
        return planned

    def apply_plan(self, img, planned):
        img = _as_pil(img)
        for name, sign in planned:
            img = self._apply(img, name, sign=sign)
        return img

    def _apply(self, img, name: str, sign: int | None = None):
        from PIL import Image, ImageEnhance, ImageOps

        lvl = self.M
        if sign is None:
            sign = -1 if self.rng.random() < 0.5 else 1
        if name == "Identity":
            return img
        if name == "AutoContrast":
            return ImageOps.autocontrast(img)
        if name == "Equalize":
            return ImageOps.equalize(img)
        if name == "Invert":
            return ImageOps.invert(img)
        if name == "Posterize":
            return ImageOps.posterize(img, max(1, 8 - _posterize_arg(lvl)))
        if name == "Solarize":
            return ImageOps.solarize(img, 256 - _solarize_arg(lvl))
        if name in ("Color", "Contrast", "Brightness", "Sharpness"):
            enh = {"Color": ImageEnhance.Color,
                   "Contrast": ImageEnhance.Contrast,
                   "Brightness": ImageEnhance.Brightness,
                   "Sharpness": ImageEnhance.Sharpness}[name]
            return enh(img).enhance(_enhance_arg(lvl))
        if name == "Rotate":
            return img.rotate(sign * _rotate_arg(lvl),
                              resample=Image.BILINEAR, fillcolor=REPLACE)
        if name in ("ShearX", "ShearY", "TranslateX", "TranslateY"):
            a = [1, 0, 0, 0, 1, 0]
            if name == "ShearX":
                a[1] = sign * _shear_arg(lvl)
            elif name == "ShearY":
                a[3] = sign * _shear_arg(lvl)
            elif name == "TranslateX":
                a[2] = sign * _translate_arg(lvl, img.size[0] // 3)
            else:
                a[5] = sign * _translate_arg(lvl, img.size[1] // 3)
            return img.transform(img.size, Image.AFFINE, tuple(a),
                                 resample=Image.BILINEAR, fillcolor=REPLACE)
        raise ValueError(name)

    def __call__(self, img):
        img = _as_pil(img)
        ops = self.rng.choice(len(self.augs), self.N)
        for i in ops:
            if self.rng.random() > 0.5:
                continue
            img = self._apply(img, self.augs[int(i)])
        return img
