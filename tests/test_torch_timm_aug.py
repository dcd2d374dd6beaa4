"""The timm-recipe ImageNet augmentation in the port
(`xfm_tpu_torch/data/timm_aug.py`) against the JAX package's copy
(`xfm_tpu/data/timm_aug.py`), bit for bit from the same seed: the policy
parser, every RandAugment op at two severities and both signs, the whole
RandAugment draw, RandomErasing in each fill mode and with several
rectangles, the colour jitter, the normalization and both transforms."""
import numpy as np
import pytest
from PIL import Image

import xfm_tpu.data.timm_aug as jta
import xfm_tpu_torch.data.timm_aug as ta
from _torch_threads import one_intra_op_thread  # noqa: F401


def _img(seed=0, w=53, h=41):
    r = np.random.default_rng(seed)
    return Image.fromarray(r.integers(0, 256, (h, w, 3), np.uint8))


@pytest.mark.parametrize("aa", ["rand-m9-mstd0.5-inc1", "rand-m7-n3",
                                "rand-m5-mstd1.0-inc0-p0.7"])
def test_parse_rand_augment_matches_jax(aa):
    assert ta.parse_rand_augment(aa) == jta.parse_rand_augment(aa)
    with pytest.raises(ValueError):
        ta.parse_rand_augment("augmix-m5")


@pytest.mark.parametrize("name", ta.RAND_INC_OPS)
def test_every_op_matches_jax(name):
    assert ta.RAND_INC_OPS == jta.RAND_INC_OPS
    img = _img(1)
    for lvl, sign in ((9.0, 1.0), (3.5, -1.0), (10.0, -1.0)):
        got = np.asarray(ta.TimmRandAugment._apply(img, name, lvl, sign))
        want = np.asarray(jta.TimmRandAugment(rng=None)._apply(
            img, name, lvl, sign))
        assert np.array_equal(got, want), (name, lvl, sign)


@pytest.mark.parametrize("aa", ["rand-m9-mstd0.5-inc1", "rand-m9-n4"])
def test_rand_augment_draws_match_jax(aa):
    """The whole draw (ops, probabilities, magnitudes, signs) from one
    seeded generator, over several images in a row."""
    mine = ta.TimmRandAugment.from_config_str(aa, np.random.default_rng(5))
    theirs = jta.TimmRandAugment.from_config_str(aa,
                                                 np.random.default_rng(5))
    for i in range(12):
        img = _img(i)
        assert np.array_equal(np.asarray(mine(img)), np.asarray(theirs(img)))


@pytest.mark.parametrize("mode,count", [("pixel", 1), ("const", 1),
                                        ("rand", 1), ("pixel", 3)])
def test_random_erasing_matches_jax(mode, count):
    """'pixel' (gaussian per pixel), 'const' and any other mode (0, as the
    JAX copy fills), with one and with three rectangles; the input is not
    written."""
    arr = np.random.default_rng(2).normal(size=(40, 36, 3)).astype(
        np.float32)
    keep = arr.copy()
    mine = ta.RandomErasing(1.0, mode, count, rng=np.random.default_rng(7))
    theirs = jta.RandomErasing(1.0, mode, count,
                               rng=np.random.default_rng(7))
    for _ in range(5):
        got, want = mine(arr), theirs(arr)
        assert np.array_equal(got, want) and got.dtype == np.float32
        assert not np.array_equal(got, arr)
    assert np.array_equal(arr, keep)
    skip = ta.RandomErasing(0.0, mode, count, rng=np.random.default_rng(7))
    assert skip(arr) is arr


def test_color_jitter_and_normalize_match_jax():
    img = _img(3)
    got = ta.color_jitter_img(img, 0.4, np.random.default_rng(1))
    want = jta.color_jitter_img(img, 0.4, np.random.default_rng(1))
    assert np.array_equal(np.asarray(got), np.asarray(want))
    u8 = np.asarray(img)
    assert np.array_equal(ta.imagenet_normalize(u8),
                          jta.imagenet_normalize(u8))


@pytest.mark.parametrize("kw", [
    dict(),  # the shipped recipe: rand-m9-mstd0.5-inc1, reprob 0.25
    dict(aa=None, color_jitter=0.4, reprob=0.5, remode="const",
         recount=2)])
def test_train_transform_matches_jax(kw):
    """RandomResizedCrop(0.08-1) + hflip + RandAugment or colour jitter +
    normalize + erasing, seeded once: 10 images in a row bit-equal, f32
    ImageNet-normalized (so `maybe_normalize` passes them through)."""
    from xfm_tpu_torch.data.device_aug import maybe_normalize

    mine = ta.ImagenetTrainTransform(32, seed=11, **kw)
    theirs = jta.ImagenetTrainTransform(32, seed=11, **kw)
    for i in range(10):
        img = _img(i, 60 + i, 45)
        got, want = mine(img), theirs(img)
        assert got.shape == (32, 32, 3) and got.dtype == np.float32
        assert np.array_equal(got, want), i
    import torch

    t = torch.from_numpy(got)
    assert maybe_normalize(t) is t


@pytest.mark.parametrize("res", [32, 224, 384])
def test_eval_transform_matches_jax(res):
    """The short side to res / crop_pct (224/256 up to 224 px, else 1),
    bicubic, then the center crop."""
    img = _img(4, 300, 257)
    got = ta.ImagenetEvalTransform(res)(img)
    assert got.shape == (res, res, 3)
    assert np.array_equal(got, jta.ImagenetEvalTransform(res)(img))
