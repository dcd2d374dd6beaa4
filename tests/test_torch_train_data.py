"""The fine-tune's host data against the JAX package's, bit for bit on the
same seeds and synthetic PNGs: `RandomAugment` (`data/randaugment.py`),
`TrainTransform` with `crop_box` (`data/transforms.py`) and
`RetrievalTrainData.epoch` (`data/finetune_data.py`, whose transform the
port reseeds from [epoch_seed, 1]: the JAX package's, built with that
seed, draws the same). Then `data/prefetch.py`: `Prefetcher` keeps the
order and raises the producer's error again, and `DeviceBatches` hands
out every batch as int64 / float32 tensors equal to the host's.
"""
import json

import numpy as np
import pytest
import torch
from PIL import Image

from xfm_tpu_torch.data import prefetch
from xfm_tpu_torch.data.finetune_data import RetrievalTrainData
from xfm_tpu_torch.data.randaugment import RandomAugment
from xfm_tpu_torch.data.transforms import TrainTransform, crop_box


def _images(n, seed=0):
    """Smooth-ish RGB images of mixed sizes (so the ops change pixels)."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = 40 + 7 * i, 64 - 3 * i
        yy, xx = np.mgrid[0:h, 0:w]
        base = (np.sin(xx / (3 + i)) + np.cos(yy / 5)) * 60 + 128
        arr = np.clip(base[..., None] + r.normal(0, 20, (h, w, 3)), 0, 255)
        out.append(Image.fromarray(arr.astype(np.uint8)))
    return out


ALL_AUGS = ("Identity", "AutoContrast", "Equalize", "Invert", "Posterize",
            "Solarize", "Color", "Contrast", "Brightness", "Sharpness",
            "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate")


@pytest.mark.parametrize("augs", [None, ALL_AUGS])
def test_random_augment_bit_equal(augs):
    from xfm_tpu.data.randaugment import RandomAugment as JAug

    for i, img in enumerate(_images(6)):
        ours = RandomAugment(2, 7, augs=augs,
                             rng=np.random.default_rng(i))
        theirs = JAug(2, 7, augs=augs, rng=np.random.default_rng(i))
        for _ in range(4):
            assert np.array_equal(np.asarray(ours(img)),
                                  np.asarray(theirs(img)))
        plan = ours.plan(np.random.default_rng(10 + i))
        assert plan == theirs.plan(np.random.default_rng(10 + i))
        assert np.array_equal(np.asarray(ours.apply_plan(img, plan)),
                              np.asarray(theirs.apply_plan(img, plan)))
    # every op, each sign, on an array input
    arr = np.asarray(_images(1)[0])
    for name in ALL_AUGS:
        for sign in (-1, 1):
            a = RandomAugment(2, 7)._apply(Image.fromarray(arr), name, sign)
            b = JAug(2, 7)._apply(Image.fromarray(arr), name, sign)
            assert np.array_equal(np.asarray(a), np.asarray(b)), name
    with pytest.raises(ValueError):
        RandomAugment()._apply(Image.fromarray(arr), "Bogus", 1)


@pytest.mark.parametrize("hflip,randaug", [(True, True), (False, False)])
def test_train_transform_bit_equal(hflip, randaug):
    from xfm_tpu.data.transforms import TrainTransform as JTrain
    from xfm_tpu.data.transforms import crop_box as jcrop_box

    ours = TrainTransform(96, hflip=hflip, randaug=randaug, seed=3)
    theirs = JTrain(96, hflip=hflip, randaug=randaug, seed=3)
    for img in _images(8, 1) * 2:
        a, b = ours(img), theirs(img)
        assert a.dtype == np.float32 and a.shape == (96, 96, 3)
        assert np.array_equal(a, b)
    for w, h in ((640, 300), (10, 500), (33, 33)):
        r1, r2 = np.random.default_rng(w), np.random.default_rng(w)
        for _ in range(20):
            assert crop_box(w, h, rng=r1) == jcrop_box(w, h, rng=r2)
    # reseed restarts the stream of both the crop and RandAugment
    ours.reseed(9)
    first = [ours(img) for img in _images(3)]
    ours.reseed(9)
    assert all(np.array_equal(x, ours(img))
               for x, img in zip(first, _images(3)))


def _corpus(root, n=9):
    ann = []
    for i, img in enumerate(_images(n, 2)):
        img.save(root / f"img{i}.png")
        for j in range(2):
            ann.append({"image": f"img{i}.png", "image_id": f"id{i % 7}",
                        "caption": f"A photo, of thing {i} number {j}!"})
    (root / "train.json").write_text(json.dumps(ann))
    return str(root / "train.json")


@pytest.mark.parametrize("epoch_seed", [0, 43])
def test_retrieval_train_epoch_bit_equal(tmp_path, epoch_seed):
    from xfm_tpu.data.finetune_data import RetrievalTrainData as JData
    from xfm_tpu.data.tokenization import SimpleTokenizer as JTok
    from xfm_tpu.data.transforms import TrainTransform as JTrain

    from xfm_tpu_torch.data.tokenization import SimpleTokenizer
    from xfm_tpu_torch.tasks.retrieval import _ann_texts

    ann = _corpus(tmp_path)
    texts = _ann_texts(ann)
    theirs = JData(ann, JTrain(64, seed=[epoch_seed, 1]), str(tmp_path),
                   JTok.from_texts(texts), max_tokens=12, batch_size=4)
    ours = RetrievalTrainData(ann, TrainTransform(64, seed=123),
                              str(tmp_path), SimpleTokenizer.from_texts(texts),
                              max_tokens=12, batch_size=4)
    assert ours.img_ids == theirs.img_ids and len(ours) == len(theirs) == 18
    got = list(ours.epoch(epoch_seed))
    want = list(theirs.epoch(epoch_seed))
    assert len(got) == len(want) == 4  # 18 pairs, the last 2 dropped
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["idx", "images", "text_atts",
                                          "text_ids"]
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    # an epoch's draws depend on its seed alone
    again = list(ours.epoch(epoch_seed))
    assert all(np.array_equal(a["images"], b["images"])
               for a, b in zip(got, again))


def test_prefetcher_keeps_order_and_raises():
    assert list(prefetch.Prefetcher(iter(range(50)), depth=3)) == \
        list(range(50))

    def broken():
        yield 1
        yield 2
        raise RuntimeError("bad image")

    seen = []
    with pytest.raises(RuntimeError, match="bad image"):
        for x in prefetch.Prefetcher(broken()):
            seen.append(x)
    assert seen == [1, 2]
    p = prefetch.Prefetcher(iter(range(10 ** 6)), depth=2)
    it = iter(p)
    assert next(it) == 0
    p.close()
    p.thread.join(timeout=10)
    assert not p.thread.is_alive()


def test_device_batches_equal_the_host_batches():
    r = np.random.RandomState(0)
    host = [dict(images=r.randn(3, 8, 8, 3).astype(np.float32),
                 text_ids=r.randint(0, 9, (3, 5)).astype(np.int32),
                 idx=np.arange(3, dtype=np.int32)) for _ in range(5)]
    batches = prefetch.DeviceBatches(iter(host), "cpu")
    got = list(batches)
    batches.close()
    assert len(got) == 5
    for g, h in zip(got, host):
        assert g["images"].dtype == torch.float32
        assert g["text_ids"].dtype == g["idx"].dtype == torch.int64
        for k in h:
            assert np.array_equal(g[k].numpy(), h[k]), k


def test_prefetchers_under_thread_switching_keep_their_order():
    """More consumer threads than cores, each draining its own Prefetcher
    with a tiny queue, at a shortened switch interval: every stream comes
    out whole and in order (a lost or reordered item would break it)."""
    import os
    import sys
    import threading

    n = 2 * (os.cpu_count() or 2) + 2
    results = [None] * n

    def consume(i):
        results[i] = list(prefetch.Prefetcher(
            ((i, k) for k in range(300)), depth=1))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert results == [[(i, k) for k in range(300)] for i in range(n)]


def test_tokenizer_without_words_is_refused(tmp_path, monkeypatch):
    """A RobertaTokenizer whose files hold only the special tokens (what
    some `transformers` versions build for a path without a vocabulary)
    would read every word as unknown, so every caption alike: the port's
    `build_tokenizer` raises, and the task falls back to the
    SimpleTokenizer over the captions."""
    from xfm_tpu_torch.data.tokenization import (SimpleTokenizer,
                                                 build_tokenizer)
    from xfm_tpu_torch.tasks.retrieval import build_tokenizer_or_fallback

    path = tmp_path / "roberta-base"
    path.mkdir()
    specials = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "<mask>": 4}
    (path / "vocab.json").write_text(json.dumps(specials))
    (path / "merges.txt").write_text("#version: 0.2\n")
    with pytest.raises(OSError, match="no vocabulary"):
        build_tokenizer(str(path))
    tok = build_tokenizer_or_fallback({"text_encoder": str(path)},
                                      lambda: ["a red dog", "a blue cat"])
    assert isinstance(tok, SimpleTokenizer)
    assert tok.tokenize("red dog") != tok.tokenize("blue cat")
    (path / "vocab.json").write_text(json.dumps({**specials, "a": 5}))
    assert len(build_tokenizer(str(path)).get_vocab()) == 6
