"""Image preprocessing on the device (`xfm_tpu/data/device_aug.py`):
`maybe_normalize` (uint8 → CLIP-normalized float32) and RandAugment(N, M)
on a uint8 batch, `randaugment_batch`, for streams that leave the loader
un-augmented (`device_randaug`).

A round of RandAugment draws, for each image, an op uniformly from
`augs`, whether it applies (probability 0.5) and its sign (±, 0.5 each),
as `RandomAugment.plan` does, and applies the op to the images that drew
it, all of one op at once; `randaug_round` takes the draws as tensors.
The ops follow PIL's conventions (held to PIL and to the JAX package's
ops by the tests): the photometric ones on the whole image, Equalize's
histogram and LUT in exact integers, the geometric ones as one bilinear
inverse-affine warp of a matrix per image (pixel centres at +0.5, gray
128 outside the source, taps clamped at the border). Values stay float32
through a round and are rounded to integers at its end."""
from __future__ import annotations

import torch

# copies of xfm_tpu/data/transforms.py CLIP_MEAN / CLIP_STD
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

RANDAUG_DEFAULT = ("Identity", "AutoContrast", "Equalize", "Brightness",
                   "Sharpness", "ShearX", "ShearY", "TranslateX",
                   "TranslateY", "Rotate")
_GEO_OPS = ("ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate")
_FILL = 128.0  # PIL fillcolor (128, 128, 128) of the geometric ops
_MAX_LEVEL = 10


def maybe_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC images → CLIP-normalized float32; float input passes
    through unchanged."""
    if images.dtype.is_floating_point:
        return images
    x = images.float() / 255.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


def _autocontrast(img: torch.Tensor) -> torch.Tensor:
    """Each image's channels stretched from [min, max] to [0, 255]
    (`ImageOps.autocontrast`, cutoff 0), the value truncated; a flat
    channel stays. img: float32 [B, H, W, 3]."""
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    scale = 255.0 / torch.clamp(hi - lo, min=1.0)
    out = torch.clamp(torch.floor((img - lo) * scale), 0.0, 255.0)
    return torch.where(hi > lo, out, img)


def _equalize(img: torch.Tensor) -> torch.Tensor:
    """`ImageOps.equalize` per image and channel: lut[i] = (step // 2 +
    (pixels below level i)) // step with step = (pixels − the last
    non-empty level's count) // 255; identity where step is 0 or the
    channel holds one level. Histogram by `bincount` over (image, channel,
    level), the LUT applied by a gather: exact."""
    B, H, W, C = img.shape
    v = img.to(torch.int64)
    key = ((torch.arange(B, device=img.device).view(B, 1, 1, 1) * C
            + torch.arange(C, device=img.device)) * 256 + v)
    h = torch.bincount(key.reshape(-1), minlength=B * C * 256).view(
        B, C, 256)
    levels = torch.arange(256, device=img.device)
    last_nz = torch.where(h > 0, levels, -1).amax(dim=-1, keepdim=True)
    h_last = h.gather(-1, last_nz.clamp(min=0))
    step = (H * W - h_last) // 255
    csum = torch.cumsum(h, dim=-1) - h
    lut = torch.clamp((step // 2 + csum) // torch.clamp(step, min=1), 0, 255)
    degenerate = (step == 0) | ((h > 0).sum(dim=-1, keepdim=True) <= 1)
    lut = torch.where(degenerate, levels, lut)
    out = lut.view(B * C * 256).gather(0, key.reshape(-1))
    return out.view(B, H, W, C).to(img.dtype)


def _brightness(img: torch.Tensor, factor: float) -> torch.Tensor:
    """`ImageEnhance.Brightness`: a blend toward black."""
    return torch.clamp(img * factor, 0.0, 255.0)


def _sharpness(img: torch.Tensor, factor: float) -> torch.Tensor:
    """`ImageEnhance.Sharpness`: a blend of the image with its SMOOTH
    filter (3 × 3 [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13, rounded), the
    1-pixel border left unfiltered as PIL does. img: [B, H, W, 3]."""
    H, W = img.shape[1], img.shape[2]
    p = torch.nn.functional.pad(img, (0, 0, 1, 1, 1, 1))
    acc = 5.0 * img
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                acc = acc + p[:, 1 + dy:H + 1 + dy, 1 + dx:W + 1 + dx]
    smooth = torch.round(acc / 13.0)
    inner = smooth[:, 1:H - 1, 1:W - 1]
    smooth = img.clone()
    smooth[:, 1:H - 1, 1:W - 1] = inner
    return torch.clamp(smooth + factor * (img - smooth), 0.0, 255.0)


def _affine_sample(img: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Inverse-affine bilinear warp with PIL's conventions, a matrix per
    image: output pixel (x, y) samples the input at (a(x + .5) + b(y + .5)
    + c − .5, d(x + .5) + e(y + .5) + f − .5); a position outside
    [0, W) × [0, H) before the −.5 takes the gray fill; the taps clamp at
    the border. img: float32 [B, H, W, C]; mat: [B, 6]."""
    B, H, W, C = img.shape
    y, x = torch.meshgrid(torch.arange(H, device=img.device,
                                       dtype=torch.float32),
                          torch.arange(W, device=img.device,
                                       dtype=torch.float32), indexing="ij")
    m = [mat[:, k].view(B, 1, 1) for k in range(6)]
    xc = m[0] * (x + 0.5) + m[1] * (y + 0.5) + m[2]
    yc = m[3] * (x + 0.5) + m[4] * (y + 0.5) + m[5]
    valid = (xc >= 0) & (xc < W) & (yc >= 0) & (yc < H)
    xs, ys = xc - 0.5, yc - 0.5
    x0, y0 = torch.floor(xs), torch.floor(ys)
    wx = (xs - x0).unsqueeze(-1)
    wy = (ys - y0).unsqueeze(-1)
    flat = img.reshape(B, H * W, C)

    def tap(yi, xi):
        yi = torch.clamp(yi, 0, H - 1).to(torch.int64)
        xi = torch.clamp(xi, 0, W - 1).to(torch.int64)
        idx = (yi * W + xi).view(B, H * W, 1).expand(B, H * W, C)
        return flat.gather(1, idx).view(B, H, W, C)

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    out = ((1 - wy) * ((1 - wx) * v00 + wx * v01)
           + wy * ((1 - wx) * v10 + wx * v11))
    return torch.where(valid.unsqueeze(-1), out, _FILL)


def _geo_mat(name: str, m: float, H: int, W: int,
             sign: torch.Tensor) -> torch.Tensor:
    """The inverse-affine matrices [B, 6] (float32) of the named geometric
    op at magnitude m for signs [B] (±1), the magnitude maps of
    data/randaugment.py."""
    sign = sign.to(torch.float32)
    one, zero = torch.ones_like(sign), torch.zeros_like(sign)
    shear = (m / _MAX_LEVEL) * 0.3
    if name == "ShearX":
        mat = [one, sign * shear, zero, zero, one, zero]
    elif name == "ShearY":
        mat = [one, zero, zero, sign * shear, one, zero]
    elif name == "TranslateX":
        t = float(int((m / _MAX_LEVEL) * (W // 3)))
        mat = [one, zero, sign * t, zero, one, zero]
    elif name == "TranslateY":
        t = float(int((m / _MAX_LEVEL) * (H // 3)))
        mat = [one, zero, zero, zero, one, sign * t]
    elif name == "Rotate":
        # PIL Image.rotate(angle): the inverse matrix from -angle
        th = -torch.deg2rad(sign * ((m / _MAX_LEVEL) * 30.0))
        a, b = torch.cos(th), torch.sin(th)
        cx, cy = W / 2.0, H / 2.0
        mat = [a, b, cx - (a * cx + b * cy), -b, a, cy - (-b * cx + a * cy)]
    else:
        raise ValueError(name)
    return torch.stack(mat, dim=-1)


def apply_op(name: str, img: torch.Tensor, m: float,
             sign: torch.Tensor) -> torch.Tensor:
    """The named op on float32 images [B, H, W, 3] (integral values) at
    magnitude m, signs [B] for the geometric ops → float32, not rounded."""
    enh = (m / _MAX_LEVEL) * 1.8 + 0.1
    if name == "Identity":
        return img
    if name == "AutoContrast":
        return _autocontrast(img)
    if name == "Equalize":
        return _equalize(img)
    if name == "Brightness":
        return _brightness(img, enh)
    if name == "Sharpness":
        return _sharpness(img, enh)
    if name in _GEO_OPS:
        return _affine_sample(img, _geo_mat(name, m, img.shape[1],
                                            img.shape[2], sign))
    raise ValueError(name)


def randaug_round(imgs: torch.Tensor, op: torch.Tensor,
                  applied: torch.Tensor, neg: torch.Tensor,
                  augs=RANDAUG_DEFAULT, m: float = 7) -> torch.Tensor:
    """One round on float32 [B, H, W, 3]: image i takes `augs[op[i]]`
    where `applied[i]`, with sign −1 where `neg[i]`, rounded → float32
    with integral values. The images of one op go through it together."""
    code = torch.where(applied, op, -1).tolist()
    out = imgs.clone()
    for k, name in enumerate(augs):
        idx = [i for i, c in enumerate(code) if c == k]
        if not idx or name == "Identity":
            continue
        sel = torch.tensor(idx, device=imgs.device)
        sign = 1.0 - 2.0 * neg[sel].to(torch.float32)
        res = apply_op(name, imgs.index_select(0, sel), m, sign)
        out.index_copy_(0, sel, torch.round(torch.clamp(res, 0.0, 255.0)))
    return out


def randaug_draws(B: int, n_augs: int, generator: torch.Generator):
    """One round's draws for B images from `generator`, on its device:
    (op [B] int64, applied [B] bool, neg [B] bool)."""
    dev = generator.device
    op = torch.randint(0, n_augs, (B,), generator=generator, device=dev)
    applied = torch.rand(B, generator=generator, device=dev) <= 0.5
    neg = torch.rand(B, generator=generator, device=dev) < 0.5
    return op, applied, neg


def randaugment_batch(images_u8: torch.Tensor, generator: torch.Generator,
                      augs=RANDAUG_DEFAULT, n: int = 2,
                      m: float = 7) -> torch.Tensor:
    """uint8 [B, H, W, 3] → uint8 [B, H, W, 3], RandAugment(n, m) of each
    image, n rounds of draws from `generator` (`randaug_draws`)."""
    imgs = images_u8.to(torch.float32)
    for _ in range(n):
        op, applied, neg = randaug_draws(imgs.shape[0], len(augs), generator)
        imgs = randaug_round(imgs, op.to(imgs.device),
                             applied.to(imgs.device), neg.to(imgs.device),
                             augs, m)
    return imgs.to(torch.uint8)
