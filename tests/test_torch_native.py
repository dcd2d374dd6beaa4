"""The port's C++ loader (`xfm_tpu_torch.native`, its own copy of
`loader.cpp`) against the JAX package's (`xfm_tpu.native`) on the same
blobs, bit for bit: both are built here by the same g++ with the same
flags (`-O3 -march=native`). `decode_batch` (pixels and status) over
JPEGs at full and DCT-reduced scale, PNGs, a JPEG whose body is cut and
one cut before its scan; `image_dims` in both forms; `randaugment_batch`
on every op code at both signs and on RandomAugment plans; then the C++
ops against PIL at the JAX suite's tolerances, `NativeBatchTransform`
against the JAX class, and the build: the library under build/, the
reason printed where the headers are missing, a broken source raising.
Skipped where libjpeg's or libpng's headers are absent."""
import io

import numpy as np
import pytest

from xfm_tpu_torch import native
from xfm_tpu_torch.data.randaugment import RandomAugment
from _torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def libs():
    if not native.available():
        pytest.skip(f"native loader unavailable "
                    f"({native.unavailable_reason()})")
    from xfm_tpu import native as jnative

    if not jnative.available():
        pytest.skip("the JAX package's loader is unavailable")
    return native, jnative


def _photo(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    arr = (rng.integers(0, 256, 3) + 70 * np.sin(xx / rng.uniform(5, 40)
                                                 + yy / rng.uniform(5, 40))
           [..., None] + rng.normal(0, 15, (h, w, 3)))
    return np.clip(arr, 0, 255).astype(np.uint8)


def _encode(arr, fmt, **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def blobs():
    """JPEGs of 60-1,100 px (q 75-95), two PNGs (RGB and gray), a JPEG
    whose body is cut in half, one cut before its scan."""
    rng = np.random.default_rng(0)
    out = []
    for h, w in ((60, 80), (300, 400), (1100, 900), (700, 1000),
                 (480, 640)):
        out.append(_encode(_photo(rng, h, w), "JPEG",
                           quality=int(rng.integers(75, 96))))
    out.append(_encode(_photo(rng, 90, 70), "PNG"))
    out.append(_encode(_photo(rng, 50, 64)[..., 0], "PNG"))
    out.append(out[3][:len(out[3]) // 2])
    out.append(out[1][:out[1].index(b"\xff\xda")])
    return out


def _crops(blobs, rng, size):
    """One crop a blob: full frame, large (DCT scaling at `size`) and
    small ones."""
    from PIL import Image

    crops = []
    for i, b in enumerate(blobs):
        try:
            w, h = Image.open(io.BytesIO(b)).size
        except Exception:
            w, h = 64, 64
        if i % 3 == 0:
            crops.append((0, 0, 0, 0))
            continue
        cw = int(rng.integers(min(w, size) // 2, w + 1))
        ch = int(rng.integers(min(h, size) // 2, h + 1))
        crops.append((int(rng.integers(0, w - cw + 1)),
                      int(rng.integers(0, h - ch + 1)), cw, ch))
    return np.asarray(crops, np.int32)


@pytest.mark.parametrize("size", [32, 224])
def test_decode_batch_equals_jax(libs, blobs, size):
    ours, theirs = libs
    rng = np.random.default_rng(size)
    crops = _crops(blobs, rng, size)
    flips = (np.arange(len(blobs)) % 2).astype(np.int32)
    a, sa = ours.decode_batch(blobs, size, crops, flips, threads=4)
    b, sb = theirs.decode_batch(blobs, size, crops, flips, threads=4,
                                return_status=True)
    np.testing.assert_array_equal(sa, sb)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.uint8 and a.shape == (len(blobs), size, size, 3)
    # the body cut in half decodes (libjpeg pads it); the cut before the
    # scan fails and is zero-filled
    assert sa.tolist() == [0] * (len(blobs) - 1) + [1]
    assert not a[-1].any()


def test_dct_scaling_is_taken(libs, blobs):
    """A crop of at least 2 × the output decodes at reduced scale: the
    result differs from the full-scale decode of the same crop (the PNG
    path, which never scales) but stays close to it."""
    ours, _ = libs
    from PIL import Image

    y, x = np.mgrid[0:1024, 0:1024]
    smooth = np.stack([np.sin(x / 211.0) * 100 + 120,
                       np.cos(y / 157.0) * 100 + 120,
                       (x + y) / 2048.0 * 255], -1).astype(np.uint8)
    jpeg = _encode(smooth, "JPEG", quality=95)
    crop = np.asarray([[64, 32, 896, 896]], np.int32)  # 896 ≥ 2 · 224
    scaled, _ = ours.decode_batch([jpeg], 224, crop)
    rgb = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))
    full, _ = ours.decode_batch([_encode(rgb, "PNG")], 224, crop)
    d = np.abs(scaled.astype(np.int16) - full.astype(np.int16))
    assert d.max() > 0 and d.mean() < 2.0


@pytest.mark.parametrize("fast", [False, True])
def test_image_dims_equal_jax(libs, blobs, fast):
    ours, theirs = libs
    got = [ours.image_dims(b, fast=fast) for b in blobs]
    assert got == [theirs.image_dims(b, fast=fast) for b in blobs]
    assert got[2] == (900, 1100) and got[6] == (64, 50)
    assert (got[-1] is None) != fast  # the header alone reads
    assert ours.image_dims(b"not an image" * 8, fast=fast) is None


@pytest.fixture(scope="module")
def smooth():
    """The JAX suite's 64 × 64 photo-like image."""
    from numpy.lib.stride_tricks import sliding_window_view

    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (64, 64, 3), np.uint8).astype(np.float32)
    k = np.ones((7, 7), np.float32) / 49.0

    def conv(a):
        win = sliding_window_view(np.pad(a, 3, mode="edge"), k.shape)
        return (win * k).sum((-1, -2))

    return np.stack([conv(base[..., c]) for c in range(3)], -1).astype(
        np.uint8)


@pytest.mark.parametrize("name", sorted(native.RANDAUG_OP_CODES))
def test_randaugment_ops_equal_jax(libs, smooth, name):
    ours, theirs = libs
    assert ours.RANDAUG_OP_CODES == theirs.RANDAUG_OP_CODES
    imgs = np.stack([smooth, smooth[::-1], smooth[:, ::-1].copy(),
                     np.full_like(smooth, 7)])
    plans = [[(name, 1)], [(name, -1)], [(name, -1)], [(name, 1)]]
    a, b = imgs.copy(), imgs.copy()
    ours.randaugment_batch(a, plans, 7, threads=2)
    assert theirs.randaugment_batch(b, plans, 7, threads=2)
    np.testing.assert_array_equal(a, b)


def test_randaugment_plans_equal_jax(libs, smooth):
    ours, theirs = libs
    ra = RandomAugment(2, 7, augs=tuple(native.RANDAUG_OP_CODES))
    rng = np.random.default_rng(3)
    plans = [ra.plan(rng) for _ in range(16)]
    a = np.stack([np.roll(smooth, 5 * i, axis=0) for i in range(16)])
    b = a.copy()
    ours.randaugment_batch(a, plans, 7)
    assert theirs.randaugment_batch(b, plans, 7)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        ours.randaugment_batch(a[:, ::2], plans, 7)


def _pil_op(img, name, sign):
    from PIL import Image

    return np.asarray(RandomAugment(2, 7)._apply(Image.fromarray(img), name,
                                                 sign=sign), np.uint8)


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("name", sorted(set(native.RANDAUG_OP_CODES)
                                        - {"Identity"}))
def test_randaugment_ops_match_pil(libs, smooth, name, sign):
    """The JAX suite's bounds: ≤ 1 level for the photometric ops, ≤ 1.5 for
    Sharpness, ≤ 2 for the warps, translations exact."""
    batch = smooth[None].copy()
    native.randaugment_batch(batch, [[(name, sign)]], 7, threads=1)
    d = np.abs(batch[0].astype(np.float32)
               - _pil_op(smooth, name, sign).astype(np.float32))
    bound = {"Sharpness": 1.5, "ShearX": 2.0, "ShearY": 2.0, "Rotate": 2.0,
             "TranslateX": 0.0, "TranslateY": 0.0}.get(name, 1.0)
    assert d.max() <= bound, (name, sign, d.max())


@pytest.mark.parametrize("device_randaug", [False, True])
def test_native_batch_transform_equals_jax(libs, blobs, device_randaug):
    from xfm_tpu.data.transforms import NativeBatchTransform as J
    from xfm_tpu.data.transforms import TrainTransform as JT

    from xfm_tpu_torch.data.transforms import (NativeBatchTransform,
                                               TrainTransform)

    ours = NativeBatchTransform(TrainTransform(48, seed=1), workers=3,
                                device_randaug=device_randaug)
    theirs = J(JT(48, seed=1), workers=3, device_randaug=device_randaug)
    dims = [ours.probe(b) for b in blobs]
    assert dims == [theirs.probe(b) for b in blobs]
    for _ in range(2):
        a, sub = ours(blobs, dims)
        b, jsub = theirs(blobs, dims, return_submap=True)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sub, jsub)
    assert sub[-1] == 0 and list(sub[:-1]) == list(range(len(blobs) - 1))


def test_the_build_lands_under_build_and_keys_on_the_source(libs):
    import os

    so = native.library_path()
    assert so.exists() and so.parent.name == "xfm_tpu_torch" \
        and so.parent.parent.name == "build"
    here = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(here) if f.endswith(".so")]
    assert native.unavailable_reason() is None


def _fresh(monkeypatch, **attrs):
    for k, v in dict(_lib=None, _reason=None, _probed=False, **attrs).items():
        monkeypatch.setattr(native, k, v)


def test_missing_headers_make_it_unavailable_once(monkeypatch, capsys):
    """Without libjpeg's header the loader is unavailable, says why once,
    and the streams' builder takes PIL (`maybe_build` → None)."""
    import shutil

    from xfm_tpu_torch.data.transforms import (NativeBatchTransform,
                                               TrainTransform)

    if shutil.which("g++") is None:
        pytest.skip("no g++")
    _fresh(monkeypatch, _PROBE="#include <no_such_jpeglib.h>\n")
    assert not native.available() and not native.available()
    out = capsys.readouterr().out
    assert out.count("native_loader: unavailable") == 1
    assert "no_such_jpeglib.h" in native.unavailable_reason()
    assert NativeBatchTransform.maybe_build(TrainTransform(32), 4) is None
    with pytest.raises(RuntimeError, match="unavailable"):
        native.decode_batch([b"x"], 32)


def test_a_source_that_does_not_compile_raises(libs, monkeypatch, tmp_path):
    bad = tmp_path / "loader.cpp"
    bad.write_text("int broken( {\n")
    _fresh(monkeypatch, _SRC=bad, _BUILD_DIR=tmp_path / "build")
    with pytest.raises(RuntimeError, match="building the native loader"):
        native.get_lib()
    assert not list((tmp_path / "build").glob("*.so"))
