"""Device RandAugment (`xfm_tpu_torch.data.device_aug`) on the CPU against
the JAX package's ops (`xfm_tpu/data/device_aug.py`) and against PIL
(`data/randaugment.py`'s contract).

- Each op, at both signs, on a batch of four images (the JAX suite's
  smooth 64 × 64 image, flipped, a flat one, a narrow-range one) within 1
  uint8 level of the JAX op applied image by image (both rounded).
- Against PIL, the JAX suite's bounds (`tests/test_device_randaug.py`):
  ≤ 1 level for AutoContrast and Equalize, ≤ 1.5 for Brightness and
  Sharpness, ≤ 2 for the warps, translations exact.
- A round with injected draws (every op, applied or not, either sign)
  equals the JAX ops composed image by image, within 1 level a round.
- One generator seed gives one output, another seed another; a single-op
  augment leaves the share of unchanged images that the JAX suite
  bounds (both rounds skipped: 1/4).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xfm_tpu.data import device_aug as jda
from xfm_tpu_torch.data import device_aug as da
from xfm_tpu_torch.data.randaugment import RandomAugment
from _torch_threads import one_intra_op_thread  # noqa: F401

OPS = ("AutoContrast", "Equalize", "Brightness", "Sharpness", "ShearX",
       "ShearY", "TranslateX", "TranslateY", "Rotate")
ENH = (7 / 10) * 1.8 + 0.1


def _smooth(seed=0, n=64):
    from numpy.lib.stride_tricks import sliding_window_view

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, n, 3), np.uint8).astype(np.float32)
    k = np.ones((7, 7), np.float32) / 49.0

    def conv(a):
        win = sliding_window_view(np.pad(a, 3, mode="edge"), k.shape)
        return (win * k).sum((-1, -2))

    return np.stack([conv(base[..., c]) for c in range(3)], -1).astype(
        np.uint8)


@pytest.fixture(scope="module")
def imgs():
    img = _smooth()
    narrow = np.clip(img, 100, 104)
    return np.stack([img, img[::-1], np.full_like(img, 7), narrow])


def _jax_op(name, img, sign):
    im = jnp.asarray(img, jnp.float32)
    if name == "AutoContrast":
        out = jda._autocontrast(im)
    elif name == "Equalize":
        out = jda._equalize(im)
    elif name == "Brightness":
        out = jda._brightness(im, ENH)
    elif name == "Sharpness":
        out = jda._sharpness(im, ENH)
    else:
        out = jda._geo_branch(name, 7, img.shape[0], img.shape[1])(
            im, jnp.float32(sign))
    return np.asarray(jnp.round(jnp.clip(out, 0.0, 255.0)))


def _ours(name, imgs, signs):
    out = da.apply_op(name, torch.from_numpy(imgs.astype(np.float32)), 7,
                      torch.tensor(signs, dtype=torch.float32))
    return torch.round(torch.clamp(out, 0, 255)).numpy()


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("name", OPS)
def test_op_matches_jax(imgs, name, sign):
    got = _ours(name, imgs, [sign] * len(imgs))
    want = np.stack([_jax_op(name, im, sign) for im in imgs])
    d = np.abs(got - want)
    assert d.max() <= 1.0, (name, sign, d.max())


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("name", OPS)
def test_op_matches_pil(imgs, name, sign):
    from PIL import Image

    img = imgs[0]
    got = _ours(name, img[None], [sign])[0]
    pil = np.asarray(RandomAugment(2, 7)._apply(Image.fromarray(img), name,
                                                sign=sign), np.float32)
    d = np.abs(got - pil)
    bound = {"AutoContrast": 1.0, "Equalize": 1.0, "Brightness": 1.5,
             "Sharpness": 1.5, "TranslateX": 0.0,
             "TranslateY": 0.0}.get(name, 2.0)
    assert d.max() <= bound, (name, sign, d.max())


def test_round_with_injected_draws_equals_the_jax_ops():
    """Two rounds of injected draws over 12 images: every op once with each
    sign spread over the images, some not applied, Identity among them."""
    augs = da.RANDAUG_DEFAULT
    base = np.stack([np.roll(_smooth(1, 48), 4 * i, axis=1)
                     for i in range(12)])
    rounds = [(np.arange(12) % len(augs), np.arange(12) % 5 != 4,
               np.arange(12) % 2 == 1),
              ((np.arange(12) * 7 + 3) % len(augs), np.arange(12) % 3 != 0,
               np.arange(12) % 3 == 1)]
    ours = torch.from_numpy(base.astype(np.float32))
    want = base.astype(np.float32)
    for op, applied, neg in rounds:
        ours = da.randaug_round(ours, torch.from_numpy(op),
                                torch.from_numpy(applied),
                                torch.from_numpy(neg), augs, 7)
        want = np.stack([
            _jax_op(augs[o], im, -1.0 if n else 1.0)
            if a and augs[o] != "Identity" else im
            for im, o, a, n in zip(want, op, applied, neg)])
        d = np.abs(ours.numpy() - want)
        assert d.max() <= 1.0, d.max()
        assert (d > 0).mean() < 1e-3
        # the next round composes from the same pixels on both sides
        want = ours.numpy()


def test_one_seed_one_output(imgs):
    batch = torch.from_numpy(np.concatenate([imgs] * 4))
    a = da.randaugment_batch(batch, torch.Generator().manual_seed(1))
    b = da.randaugment_batch(batch, torch.Generator().manual_seed(1))
    c = da.randaugment_batch(batch, torch.Generator().manual_seed(2))
    assert a.dtype == torch.uint8 and a.shape == batch.shape
    assert torch.equal(a, b) and not torch.equal(a, c)
    ident = da.randaugment_batch(batch, torch.Generator().manual_seed(1),
                                 augs=("Identity",))
    assert torch.equal(ident, batch)


def test_apply_rate():
    """Rotate alone over 256 images: both rounds skipped for ~1/4 of them
    (the JAX suite's bounds)."""
    img = np.random.default_rng(3).integers(0, 256, (16, 16, 3), np.uint8)
    batch = torch.from_numpy(np.stack([img] * 256))
    out = da.randaugment_batch(batch, torch.Generator().manual_seed(4),
                               augs=("Rotate",)).numpy()
    unchanged = (out == img).all(axis=(1, 2, 3)).mean()
    assert 0.12 < unchanged < 0.42


def test_draws_follow_the_plan_contract():
    op, applied, neg = da.randaug_draws(20000, 10,
                                        torch.Generator().manual_seed(0))
    counts = torch.bincount(op, minlength=10).float() / 20000
    assert op.min() >= 0 and op.max() <= 9
    assert (counts - 0.1).abs().max() < 0.01
    assert abs(applied.float().mean() - 0.5) < 0.015
    assert abs(neg.float().mean() - 0.5) < 0.015
