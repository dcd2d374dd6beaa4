"""The pretrain task's data layer against the JAX package's, bit for bit:
the four streams (image-text, region, ImageNet, text-only) on the same
synthetic JSONL shards with the same tokenizer instance (the port's
SimpleTokenizer), stream seed and TrainTransform seed, 3 batches each;
the BEiT block masking, the text masking (whole words on and off) and the
sharded reader's order at three (rank, world_size) splits; the io
helpers. Each stream's batches hold numpy arrays, compared with
`assert_array_equal` (exact)."""
import base64
import io
import json
import os

import numpy as np
import pytest

from xfm_tpu_torch.data import io as tio
from xfm_tpu_torch.data.block_masking import BlockMaskingGenerator
from xfm_tpu_torch.data.jsonl import ShardedLineReader, split_shard
from xfm_tpu_torch.data.pretrain_data import (ImageStream, ImageTextStream,
                                              RegionTextStream, TextStream)
from xfm_tpu_torch.data.text_masking import TextMaskingGenerator
from xfm_tpu_torch.data.tokenization import SimpleTokenizer
from xfm_tpu_torch.data.transforms import TrainTransform
from _torch_threads import one_intra_op_thread  # noqa: F401

WORDS = ("a red dog on the left of a blue car near the green tree to the "
         "right with small and big boats").split()


def _png_b64(rng, h, w):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
        buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def write_corpus(root, n=12, seed=0, shards=1):
    """Synthetic shards of the four streams under `root` (`shards` files
    each; the first image shards end in a broken line and an image that
    does not decode) → {stream: [files]}."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)

    def cap(k):
        return " ".join(rng.choice(WORDS, k))

    rows = {"pairs": [], "regions": [], "imagenet": [], "texts": []}
    for i in range(n):
        rows["pairs"].append({"binary": _png_b64(rng, 40, 48),
                              "desc": [cap(6), cap(3)] if i % 3 == 0
                              else cap(6)})
        elems = []
        for _ in range(3):
            x, y = int(rng.integers(0, 24)), int(rng.integers(0, 24))
            elem = {"bb": [x, y, int(rng.integers(4, 24)),
                           int(rng.integers(4, 24))], "caption": cap(4)}
            if rng.random() < 0.3:
                elem["attributes"] = cap(1)
            elems.append(elem)
        rows["regions"].append({"binary": _png_b64(rng, 48, 56),
                                "elems": elems})
        rows["imagenet"].append({"binary": _png_b64(rng, 36, 36)})
    for i in range(3 * n):
        rows["texts"].append({"desc": cap(int(rng.integers(2, 20)))})
    files = {}
    for kind, items in rows.items():
        files[kind] = []
        for s in range(shards):
            path = os.path.join(root, f"{kind}_{s}.jsonl")
            with open(path, "w") as f:
                for item in items[s::shards]:
                    f.write(json.dumps(item) + "\n")
                if s == 0 and kind != "texts":
                    f.write("{broken line\n")
                    f.write(json.dumps({"binary": "no-such-image.png",
                                        "desc": "x", "elems": []}) + "\n")
            files[kind].append(path)
    return files


def stream_config(files, image_res=32, batch=4, max_images=3) -> dict:
    """The pretrain YAML's stream keys at a small size over `files`."""
    return {
        "train_file": files["pairs"], "train_file_regions": files["regions"],
        "train_file_imagenet": files["imagenet"],
        "train_file_text": files["texts"],
        "images": {"image_key": "binary", "is_image_rpath": False,
                   "caption_key": "desc", "batch_size": batch,
                   "num_workers": 4},
        "regions": {"image_key": "binary", "is_image_rpath": False,
                    "caption_key": "caption", "batch_size": batch + 2,
                    "max_images": max_images, "max_regions": 2,
                    "min_perc_in_image": 0.5},
        "images_imagenet": {"image_key": "binary", "batch_size": batch},
        "texts": {"text_key": "desc", "batch_size": batch, "max_words": 16,
                  "max_tokens": 16, "mask_prob": 0.15, "max_masks": 4,
                  "mask_whole_word": True},
        "image_res": image_res, "patch_size": 16,
        "num_masking_patches": 2, "min_num_patches": 1,
        "max_words": 10, "max_tokens": 12, "mask_prob": 0.5,
        "max_masks": 3, "skipgram_prb": 0.2, "skipgram_size": 3,
    }


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("pretrain_corpus")
    files = write_corpus(str(root), shards=2)
    cfg = stream_config(files)
    tok = SimpleTokenizer.from_texts(WORDS)
    return cfg, tok


def _streams(cfg, tok, jax_side: bool):
    if jax_side:
        from xfm_tpu.data import pretrain_data as pd
        from xfm_tpu.data.transforms import TrainTransform as T
    else:
        import xfm_tpu_torch.data.pretrain_data as pd
        T = TrainTransform
    res = cfg["image_res"]
    # num_workers > 0 in the image block: the JAX package takes its C++
    # loader only where it builds; hold it to the Python path
    cfg = dict(cfg, images=dict(cfg["images"], num_workers=0))
    return {
        "image": pd.ImageTextStream(cfg["train_file"], cfg, tok,
                                    T(res, scale=(0.2, 1.0), seed=5)),
        "region": pd.RegionTextStream(cfg["train_file_regions"], cfg, tok),
        "imagenet": pd.ImageStream(cfg["train_file_imagenet"], cfg,
                                   T(res, scale=(0.2, 1.0), seed=6)),
        "text": pd.TextStream(cfg["train_file_text"], cfg, tok),
    }


@pytest.mark.parametrize("name", ["image", "region", "imagenet", "text"])
def test_stream_batches_equal_jax(corpus, name):
    cfg, tok = corpus
    ours = iter(_streams(cfg, tok, False)[name])
    theirs = iter(_streams(cfg, tok, True)[name])
    for i in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b), (name, i)
        for k in a:
            assert a[k].dtype == np.asarray(b[k]).dtype, (name, i, k)
            np.testing.assert_array_equal(a[k], np.asarray(b[k]),
                                          err_msg=f"{name} batch {i} {k}")


def test_region_batch_shapes(corpus):
    """The region stream pads its images to max_images with zeros; every
    region's patch mask has the cls slot on and lies inside the grid."""
    cfg, tok = corpus
    # 4 regions of at most 2 an image fill a batch before 3 images
    cfg = dict(cfg, regions=dict(cfg["regions"], batch_size=4))
    b = next(iter(_streams(cfg, tok, False)["region"]))
    R, G = cfg["regions"]["batch_size"], cfg["image_res"] // 16
    assert b["images"].shape == (cfg["regions"]["max_images"], 32, 32, 3)
    live = b["images"].reshape(3, -1).any(1)
    assert not live[-1] and list(live) == sorted(live, reverse=True)
    assert b["image_atts"].shape == (R, 1 + G * G)
    assert (b["image_atts"][:, 0] == 1).all()
    assert (b["image_atts"][:, 1:].sum(1) >= 1).all()
    assert b["idx_to_group_img"].max() < cfg["regions"]["max_images"]
    assert ((b["target_bbox"] >= 0) & (b["target_bbox"] <= 1)).all()


def test_block_masking_matches_jax():
    from xfm_tpu.data.block_masking import BlockMaskingGenerator as J

    for grid, n, lo in ((14, 75, 16), (2, 2, 1), ((6, 9), 20, 4)):
        ours = BlockMaskingGenerator(grid, n, lo,
                                     rng=np.random.default_rng(3))
        theirs = J(grid, n, lo, rng=np.random.default_rng(3))
        a, b = ours.batch(8), theirs.batch(8)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == bool and (a.sum(1) == n).all()


@pytest.mark.parametrize("whole_word", [False, True])
def test_text_masking_matches_jax(whole_word):
    from xfm_tpu.data.text_masking import TextMaskingGenerator as J

    vocab = WORDS + ["##ing", "##ed", "##s"]
    tok = SimpleTokenizer(vocab)
    ours = TextMaskingGenerator(tok, 0.4, 6, 0.3, 3, whole_word,
                                rng=np.random.default_rng(7))
    theirs = J(tok, 0.4, 6, 0.3, 3, whole_word,
               rng=np.random.default_rng(7))
    rng = np.random.default_rng(1)
    for _ in range(50):
        toks = [tok.cls_token] + list(rng.choice(vocab,
                                                 int(rng.integers(1, 25))))
        a = ours(list(toks))
        b = theirs(list(toks))
        assert a[0] == b[0] and list(a[1]) == list(b[1])


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2), (0, 3)])
def test_sharded_reader_order_matches_jax(tmp_path, rank, world):
    from xfm_tpu.data.jsonl import ShardedLineReader as J

    for s in range(6):
        with open(tmp_path / f"s{s}.jsonl", "w") as f:
            for i in range(3):
                f.write(json.dumps({"s": s, "i": i}) + "\n")
            f.write("not json\n\n")
    pattern = str(tmp_path / "s*.jsonl")
    ours = iter(ShardedLineReader(pattern, rank, world, seed=4).iter_json())
    theirs = iter(J(pattern, rank, world, seed=4).iter_json())
    got = [next(ours) for _ in range(30)]
    assert got == [next(theirs) for _ in range(30)]
    assert all("s" in g for g in got)
    once = list(ShardedLineReader(str(tmp_path), rank, world, seed=4,
                                  repeat=False))
    assert len(once) == len(split_shard(list(range(6)), rank, world)) * 4


def test_io_helpers(tmp_path):
    p = str(tmp_path / "d" / "f.txt")
    with tio.open_file(p, "w") as f:
        f.write("a\nb\n")
    assert tio.exists(p) and tio.count_lines(p) == 2
    tio.copy(p, str(tmp_path / "g.txt"))
    assert tio.list_files(str(tmp_path)) == [str(tmp_path / "g.txt")]
    assert tio.glob_files(str(tmp_path / "d" / "*.txt")) == [p]
    assert tio.glob_files(str(tmp_path / "none*")) == []
    tio.makedirs(str(tmp_path / "e" / "f"))
    assert os.path.isdir(tmp_path / "e" / "f")
    with pytest.raises(NotImplementedError):
        tio.list_files("gs://bucket/x")
    with pytest.raises(FileNotFoundError):
        ShardedLineReader(str(tmp_path / "missing*.jsonl"))


@pytest.fixture
def native_loader():
    from xfm_tpu_torch import native

    if not native.available():
        pytest.skip(f"native loader unavailable "
                    f"({native.unavailable_reason()})")


def _jpeg_b64(rng, h, w, quality=90):
    from PIL import Image

    yy, xx = np.mgrid[0:h, 0:w]
    arr = (rng.integers(0, 256, 3) + 60 * np.sin(xx / rng.uniform(3, 9)
                                                 + yy / rng.uniform(3, 9))
           [..., None] + rng.normal(0, 20, (h, w, 3)))
    buf = io.BytesIO()
    Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
        buf, "JPEG", quality=quality)
    return buf.getvalue()


def _cut_before_scan(blob: bytes) -> bytes:
    """A JPEG cut just before its scan: the header (and its size) reads,
    the full decode fails."""
    return blob[:blob.index(b"\xff\xda")]


def write_jpeg_corpus(root, n=12, seed=0):
    """Image-text and ImageNet shards of JPEGs (40-200 px, so that some
    crops decode at 1/2 or 1/4 scale at 32 px), one PNG, a slot whose
    header reads but whose body does not (position 5) and a blob that is
    no image (position 9) → {"pairs": path, "imagenet": path}."""
    rng = np.random.default_rng(seed)
    paths = {}
    for kind in ("pairs", "imagenet"):
        rows = []
        for i in range(n):
            h, w = (int(v) for v in rng.integers(40, 201, 2))
            blob = _jpeg_b64(rng, h, w)
            if i == 5:
                blob = _cut_before_scan(blob)
            elif i == 9:
                blob = b"no image here" * 20
            b64 = (base64.b64decode(_png_b64(rng, 36, 44)) if i == 3
                   else blob)
            row = {"binary": base64.b64encode(b64).decode()}
            if kind == "pairs":
                row["desc"] = " ".join(rng.choice(WORDS, 5))
            rows.append(row)
        paths[kind] = os.path.join(root, f"{kind}.jsonl")
        with open(paths[kind], "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return paths


def _native_streams(cfg, tok, jax_side: bool, **block):
    """The image-text and ImageNet streams at the YAML's `num_workers: 4`
    (the C++ loader), `block` set on both stream blocks."""
    if jax_side:
        from xfm_tpu.data import pretrain_data as pd
        from xfm_tpu.data.transforms import TrainTransform as T
    else:
        import xfm_tpu_torch.data.pretrain_data as pd
        T = TrainTransform
    res = cfg["image_res"]
    cfg = dict(cfg, images=dict(cfg["images"], num_workers=4, **block),
               images_imagenet=dict(cfg["images_imagenet"], num_workers=4,
                                    **block))
    return {
        "image": pd.ImageTextStream(cfg["train_file"], cfg, tok,
                                    T(res, scale=(0.2, 1.0), seed=5)),
        "imagenet": pd.ImageStream(cfg["train_file_imagenet"], cfg,
                                   T(res, scale=(0.2, 1.0), seed=6)),
    }


def _assert_batches_equal(ours, theirs, n, tag):
    for i in range(n):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b), (tag, i)
        for k in a:
            assert a[k].dtype == np.asarray(b[k]).dtype, (tag, i, k)
            np.testing.assert_array_equal(a[k], np.asarray(b[k]),
                                          err_msg=f"{tag} batch {i} {k}")
        assert a["images"].dtype == np.uint8


@pytest.mark.parametrize("device_randaug", [False, True])
@pytest.mark.parametrize("name", ["image", "imagenet"])
def test_native_stream_batches_equal_jax(tmp_path, native_loader, name,
                                         device_randaug):
    """At the YAML's `num_workers` both packages decode through their C++
    loaders: uint8 batches bit-equal over JPEGs (DCT-scaled among them), a
    PNG, a body that fails past its header and a blob that is no image,
    with C++ RandAugment, or none under `device_randaug` (then
    `device_randaug_active` on both sides)."""
    files = write_jpeg_corpus(str(tmp_path))
    cfg, tok = stream_config({"pairs": [files["pairs"]], "regions": [],
                              "imagenet": [files["imagenet"]],
                              "texts": []}), SimpleTokenizer.from_texts(WORDS)
    ours = _native_streams(cfg, tok, False,
                           device_randaug=device_randaug)[name]
    theirs = _native_streams(cfg, tok, True,
                             device_randaug=device_randaug)[name]
    assert ours.native_batch is not None and theirs.native_batch is not None
    assert ours.device_randaug_active == theirs.device_randaug_active \
        == device_randaug
    _assert_batches_equal(iter(ours), iter(theirs), 4, name)


def test_native_stream_substitutes_the_broken_pair(tmp_path, native_loader):
    """A slot whose header reads but whose body does not decode takes a
    good slot's pixels and its caption too (the pair repeated, never
    mismatched), as in the JAX package; the undecodable blob is skipped at
    admission."""
    files = write_jpeg_corpus(str(tmp_path))
    cfg = stream_config({"pairs": [files["pairs"]], "regions": [],
                         "imagenet": [files["imagenet"]], "texts": []})
    tok = SimpleTokenizer.from_texts(WORDS)
    cfg["images"]["batch_size"] = 11  # the 11 admitted rows of one pass
    # un-augmented, so that the substituted pixels show as they are
    stream = _native_streams(cfg, tok, False, device_randaug=True)["image"]
    stream.reader.shuffle = False
    batch = next(iter(stream))
    theirs = _native_streams(cfg, tok, True, device_randaug=True)["image"]
    theirs.reader.shuffle = False
    _assert_batches_equal(iter([batch]), iter(theirs), 1, "image")
    # row 5 (the broken body) holds row 0's pixels and caption
    np.testing.assert_array_equal(batch["images"][5], batch["images"][0])
    np.testing.assert_array_equal(batch["text_ids"][5], batch["text_ids"][0])


def test_native_pil_randaug_equals_jax(tmp_path, native_loader, monkeypatch):
    """XFM_NATIVE_RANDAUG=0: the loader's batches augmented by PIL on the
    thread pool, bit-equal to the JAX package's."""
    monkeypatch.setenv("XFM_NATIVE_RANDAUG", "0")
    files = write_jpeg_corpus(str(tmp_path))
    cfg = stream_config({"pairs": [files["pairs"]], "regions": [],
                         "imagenet": [files["imagenet"]], "texts": []})
    tok = SimpleTokenizer.from_texts(WORDS)
    _assert_batches_equal(iter(_native_streams(cfg, tok, False)["image"]),
                          iter(_native_streams(cfg, tok, True)["image"]), 2,
                          "image")


def test_region_stream_ignores_device_randaug(corpus):
    """The region stream decodes with PIL whatever its block says, and
    `device_randaug` changes nothing there, as in the JAX package."""
    cfg, tok = corpus
    on = dict(cfg, regions=dict(cfg["regions"], num_workers=2,
                                device_randaug=True))
    a = next(iter(RegionTextStream(cfg["train_file_regions"], cfg, tok)))
    b = next(iter(RegionTextStream(on["train_file_regions"], on, tok)))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert b["images"].dtype == np.float32


def test_streams_run_past_what_they_cannot_read(corpus):
    """A broken JSON line and an image that does not decode are skipped,
    not raised: each stream goes on through two passes of its shards."""
    cfg, tok = corpus
    for stream in (ImageStream(cfg["train_file_imagenet"], cfg,
                               TrainTransform(32, seed=0)),
                   RegionTextStream(cfg["train_file_regions"], cfg, tok),
                   TextStream(cfg["train_file_text"], cfg, tok)):
        it = iter(stream)
        for _ in range(8):
            assert next(it)
