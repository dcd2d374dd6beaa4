"""The pretraining streams (`xfm_tpu/data/pretrain_data.py`): Python
iterators over sharded JSONL that yield fixed-shape numpy batches.

- `ImageTextStream`: image-text pairs → images, the caption's ids and its
  MLM-masked copy, and a BEiT block mask for MIM;
- `RegionTextStream`: region captions → the crop's images padded to
  `max_images`, per-region patch masks, cxcywh box targets and
  `idx_to_group_img`;
- `TextStream`: text-only MLM batches;
- `ImageStream`: images and block masks (the ImageNet MIM source).

Each stream owns one numpy generator (seeded from seed + rank, + 1, 2, 3
by kind, as in the JAX package) that every draw of its text masking,
block masking, caption choice and region crop comes from; images go
through the transform given (its own generator). A sample that fails to
decode or encode is skipped.

Where a stream block sets `num_workers` > 0, the image-text and ImageNet
streams decode a batch at a time through the C++ loader
(`transforms.NativeBatchTransform` on `num_workers` threads; the header
probe admits a sample, a body that then fails to decode is replaced by a
good slot of the batch, its caption with it) and yield uint8 images,
which the model normalizes on the device; with the block's
`device_randaug` they leave un-augmented (`device_randaug_active`) and
the task runs RandAugment on the device. Without workers, with
XFM_NATIVE_LOADER=0 or where the loader is unavailable, they decode with
PIL on the calling thread and yield normalized float32, as the JAX
package does. The region stream decodes with PIL whatever its block says
and ignores `device_randaug`, as in the JAX package.
"""
from __future__ import annotations

import base64
import copy
import math
from typing import Iterator, Optional

import numpy as np

from .block_masking import BlockMaskingGenerator
from .jsonl import ShardedLineReader
from .text_masking import TextMaskingGenerator
from .tokenization import pre_caption
from .transforms import _pil, decode_image, normalize

PAD_MASK_LABEL = -100


class TextPreprocessor:
    """tokenize → cut and close with eos → mask → pad to (max_tokens,
    max_masks). The masker keeps the JAX constructor's `use_roberta=False`,
    so `mask_whole_word` widens over '##' pieces only."""

    def __init__(self, tokenizer, max_words=30, max_tokens=30, max_masks=15,
                 mask_prob=0.5, skipgram_prb=0.2, skipgram_size=3,
                 mask_whole_word=False, rng=None):
        self.tok = tokenizer
        self.max_words, self.max_tokens = max_words, max_tokens
        self.max_masks = max_masks
        self.cls = tokenizer.cls_token
        self.eos = tokenizer.sep_token
        self.pad_id = tokenizer.pad_token_id
        self.masker = TextMaskingGenerator(
            tokenizer, mask_prob, max_masks, skipgram_prb, skipgram_size,
            mask_whole_word, rng=rng)

    def _tokens(self, text: str):
        text = pre_caption(text, self.max_words)
        tokens = [self.cls] + self.tok.tokenize(text)[: self.max_tokens - 2]
        return tokens + [self.eos]

    def _pad(self, ids, value=None):
        value = self.pad_id if value is None else value
        return np.asarray(ids + [value] * (self.max_tokens - len(ids)),
                          np.int32)

    def encode(self, text: str):
        """→ (text_ids, text_atts) without masking."""
        ids = self.tok.convert_tokens_to_ids(self._tokens(text))
        return self._pad(ids), self._pad([1] * len(ids), 0)

    def encode_masked(self, text: str):
        """→ (ids, atts, ids_masked, masked_pos, masked_ids)."""
        tokens = self._tokens(text)
        if len(tokens) < 2:
            raise ValueError("too-short text")
        ids = self.tok.convert_tokens_to_ids(tokens)
        masked_tokens, masked_pos = self.masker(copy.deepcopy(tokens))
        ids_masked = self.tok.convert_tokens_to_ids(masked_tokens)
        masked_ids = [ids[p] for p in masked_pos]
        mpad = self.max_masks - len(masked_ids)
        return (self._pad(ids), self._pad([1] * len(ids), 0),
                self._pad(ids_masked),
                np.asarray(list(masked_pos) + [0] * mpad, np.int32),
                np.asarray(masked_ids + [PAD_MASK_LABEL] * mpad, np.int32))


def _get_caption(caption, rng, language=None):
    """A caption from a string, a list (one drawn) or a language dict (the
    chosen language, else one drawn)."""
    if isinstance(caption, list):
        caption = caption[rng.integers(0, len(caption))]
    if isinstance(caption, dict):
        if language is not None:
            caption = caption[language]
        else:
            vals = list(caption.values())
            caption = vals[rng.integers(0, len(vals))]
    if not isinstance(caption, str):
        raise ValueError(f"bad caption {type(caption)}")
    return caption


def _maybe_b64(v, rng):
    """One image of a list (drawn), else the value itself."""
    if isinstance(v, list):
        if not v:
            raise ValueError("empty image list")
        v = v[rng.integers(0, len(v))]
    return v


def _text_prep(tokenizer, config: dict, rng, sub: Optional[dict] = None):
    """The TextPreprocessor of a stream: lengths and masking from `sub`
    (the text stream's block) where given, else the top level."""
    src = config if sub is None else sub
    return TextPreprocessor(
        tokenizer,
        max_words=src.get("max_words", 128 if sub is not None else 30),
        max_tokens=src.get("max_tokens", 128 if sub is not None else 30),
        max_masks=src.get("max_masks", 20 if sub is not None else 15),
        mask_prob=src.get("mask_prob", 0.15 if sub is not None else 0.5),
        skipgram_prb=config.get("skipgram_prb", 0.2),
        skipgram_size=config.get("skipgram_size", 3),
        mask_whole_word=src.get("mask_whole_word", sub is not None),
        rng=rng)


def _block_masker(config: dict, rng) -> BlockMaskingGenerator:
    grid = config.get("image_res", 224) // config.get("patch_size", 16)
    return BlockMaskingGenerator(grid, config.get("num_masking_patches", 75),
                                 config.get("min_num_patches", 16), rng=rng)


def _native_batch(sub: dict, transform):
    """The C++ loader's batch transform of a stream block with
    `num_workers` > 0 and a TrainTransform-shaped transform, else None."""
    workers = sub.get("num_workers", 0)
    if not workers or not hasattr(transform, "randaug"):
        return None
    from .transforms import NativeBatchTransform

    return NativeBatchTransform.maybe_build(
        transform, workers, device_randaug=sub.get("device_randaug", False))


class _NativeImages:
    """The loader half of the image-text and ImageNet streams."""

    native_batch = None
    # whether a sample may hold a list of images, one drawn (image-text)
    image_lists = True

    @property
    def device_randaug_active(self) -> bool:
        """True where the batches leave un-augmented uint8 and the task
        must run `device_aug.randaugment_batch` on them."""
        return bool(self.native_batch is not None
                    and self.native_batch.device_randaug)

    def _blob(self, ann) -> bytes:
        """The encoded image of a sample: the file at its path, or its
        (base64) bytes, one of a list drawn where `image_lists`."""
        v = ann[self.image_key]
        if self.is_image_rpath:
            with open(v, "rb") as f:
                return f.read()
        if isinstance(v, list) and not self.image_lists:
            raise ValueError("a list of images")
        v = _maybe_b64(v, self.rng)
        if isinstance(v, str):
            return base64.b64decode(v)
        return bytes(v)


class ImageTextStream(_NativeImages):
    """→ batches {images, text_ids, text_atts, text_ids_masked, masked_pos,
    masked_ids, image_mask}."""

    def __init__(self, files, config: dict, tokenizer, transform,
                 rank=0, world_size=1, config_key="images",
                 batch_size: Optional[int] = None, seed=0,
                 with_image_mask=True, is_aux=False):
        sub = config.get(config_key, {}) or {}
        self.reader = ShardedLineReader(files, rank, world_size, seed=seed)
        self.image_key = sub.get("image_key", "binary")
        self.is_image_rpath = sub.get("is_image_rpath", False)
        self.caption_key = (sub.get("aux_caption_key") if is_aux
                            else sub.get("caption_key", "desc"))
        self.language = sub.get("language_chosen")
        self.batch_size = batch_size or sub.get("batch_size", 32)
        self.transform = transform
        self.rng = np.random.default_rng(seed + rank)
        self.print_broken = config.get("print_broken_data", False)
        self.prep = _text_prep(tokenizer, config, self.rng)
        self.with_image_mask = with_image_mask
        self.block_masker = _block_masker(config, self.rng)
        self.native_batch = _native_batch(sub, transform)

    def _iter_native(self) -> Iterator[dict]:
        nbt = self.native_batch
        blobs, dims, caps = [], [], []
        for ann in self.reader.iter_json():
            try:
                caption = _get_caption(ann[self.caption_key], self.rng,
                                       self.language)
                blob = self._blob(ann)
                d = nbt.probe(blob)
                if d is None:
                    raise ValueError("undecodable image")
            except Exception as e:  # a broken sample is skipped
                if self.print_broken:
                    print(f"broken sample skipped: {e}", flush=True)
                continue
            blobs.append(blob)
            dims.append(d)
            caps.append(caption)
            if len(blobs) == self.batch_size:
                images, sub = nbt(blobs, dims)
                if images is not None:
                    caps = [caps[int(j)] for j in sub]
                    enc = [self.prep.encode_masked(c) for c in caps]
                    ids, atts, idsm, mpos, mids = (np.stack(z)
                                                   for z in zip(*enc))
                    batch = dict(images=images, text_ids=ids, text_atts=atts,
                                 text_ids_masked=idsm, masked_pos=mpos,
                                 masked_ids=mids)
                    if self.with_image_mask:
                        batch["image_mask"] = self.block_masker.batch(
                            self.batch_size)
                    yield batch
                blobs, dims, caps = [], [], []

    def examples(self) -> Iterator[dict]:
        for ann in self.reader.iter_json():
            try:
                caption = _get_caption(ann[self.caption_key], self.rng,
                                       self.language)
                v = ann[self.image_key]
                img = decode_image(v if self.is_image_rpath
                                   else _maybe_b64(v, self.rng))
                image = self.transform(img)
                ids, atts, idsm, mpos, mids = self.prep.encode_masked(caption)
                yield dict(images=image, text_ids=ids, text_atts=atts,
                           text_ids_masked=idsm, masked_pos=mpos,
                           masked_ids=mids)
            except Exception as e:  # a broken sample is skipped
                if self.print_broken:
                    print(f"broken sample skipped: {e}", flush=True)

    def __iter__(self) -> Iterator[dict]:
        if self.native_batch is not None:
            yield from self._iter_native()
            return
        buf: list[dict] = []
        for ex in self.examples():
            buf.append(ex)
            if len(buf) == self.batch_size:
                batch = {k: np.stack([b[k] for b in buf]) for k in buf[0]}
                if self.with_image_mask:
                    batch["image_mask"] = self.block_masker.batch(
                        self.batch_size)
                yield batch
                buf = []


class RegionTextStream:
    """Region-text stream: per JSON record {image, elems: [{bb, caption[,
    attributes]}]} a random crop that holds one drawn box, a horizontal
    flip unless a caption mentions left or right (`careful_hflip`), and
    for each region kept (at least `min_perc_in_image` of it inside the
    crop, at most `max_regions` an image) its masked caption, its patch
    mask with the cls slot on, and its cxcywh target in [0, 1]. Images
    accumulate until `max_images` or `batch_size` regions; then
    `batch_size` regions are drawn without replacement (or all, padded by
    drawing with replacement), and the image stack is padded with zero
    images to `max_images` (fixed shapes, as in the JAX package)."""

    def __init__(self, files, config: dict, tokenizer, rank=0, world_size=1,
                 config_key="regions", seed=0):
        sub = config.get(config_key, {}) or {}
        self.reader = ShardedLineReader(files, rank, world_size, seed=seed)
        self.image_key = sub.get("image_key", "binary")
        self.is_image_rpath = sub.get("is_image_rpath", False)
        self.batch_size = sub.get("batch_size", 32)
        self.max_images = sub.get("max_images", 16)
        self.max_regions = sub.get("max_regions", 5)
        self.min_perc = sub.get("min_perc_in_image", 0.5)
        self.careful_hflip = sub.get("careful_hflip", True)
        self.image_res = config.get("image_res", 224)
        self.patch_size = config.get("patch_size", 16)
        self.num_patch = self.image_res // self.patch_size
        self.rng = np.random.default_rng(seed + rank + 3)
        self.print_broken = config.get("print_broken_data", False)
        self.prep = _text_prep(tokenizer, config, self.rng)

    def _image_attns(self, x, y, w, h):
        """A region's patch mask, cls included → [1 + G·G] int32."""
        P, G = self.patch_size, self.num_patch
        x_min = min(math.floor(x / P), G - 1)
        x_max = max(x_min + 1, min(math.ceil((x + w) / P), G))
        y_min = min(math.floor(y / P), G - 1)
        y_max = max(y_min + 1, min(math.ceil((y + h) / P), G))
        atts = np.zeros(1 + G * G, np.int32)
        atts[0] = 1
        for j in range(x_min, x_max):
            for i in range(y_min, y_max):
                atts[G * i + j + 1] = 1
        return atts

    @staticmethod
    def _mentions_side(ann):
        def in_it(elem):
            caps = elem.get("caption", [])
            caps = caps if isinstance(caps, list) else [caps]
            return any(("left" in c) or ("right" in c) for c in caps
                       if isinstance(c, str))

        if "caption" in ann and in_it(ann):
            return True
        return any(in_it(e) for e in ann.get("elems", []))

    def _one_image(self, ann):
        """→ (the normalized image, its region dicts), or raises."""
        Image = _pil()
        img = decode_image(ann[self.image_key])
        W, H = img.size
        elems = ann["elems"]
        x, y, w, h = [int(v) for v in
                      elems[self.rng.integers(0, len(elems))]["bb"]]
        assert 0 <= x and 0 <= y and x + w <= W and y + h <= H \
            and w > 0 and h > 0, "elem invalid"
        x0 = int(self.rng.integers(0, x, endpoint=True))
        y0 = int(self.rng.integers(0, y, endpoint=True))
        x1 = int(self.rng.integers(min(x + w, W), W, endpoint=True))
        y1 = int(self.rng.integers(min(y + h, H), H, endpoint=True))
        img = img.crop((x0, y0, x1, y1))
        W, H = img.size

        do_hflip = False
        if self.rng.random() < 0.5 and not (
                self.careful_hflip and self._mentions_side(ann)):
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            do_hflip = True
        img = img.resize((self.image_res, self.image_res), Image.BICUBIC)
        image = normalize(np.asarray(img, np.uint8))

        regions = []
        budget = self.max_regions
        s = self.image_res
        for elem in elems:
            if budget <= 0:
                break
            ex, ey, ew, eh = [int(v) for v in elem["bb"]]
            # clipped to the crop; kept if min_perc of it lies inside
            nx, ny = max(ex - x0, 0), max(ey - y0, 0)
            nx2 = min(ex + ew - x0, W)
            ny2 = min(ey + eh - y0, H)
            if nx2 <= nx or ny2 <= ny:
                continue
            if (nx2 - nx) * (ny2 - ny) < self.min_perc * ew * eh:
                continue
            rx, rw = float(nx), float(nx2 - nx)
            ry, rh = float(ny), float(ny2 - ny)
            if do_hflip:
                rx = (W - rx) - rw
            rx, rw = s / W * rx, s / W * rw
            ry, rh = s / H * ry, s / H * rh

            caption = _get_caption(elem["caption"], self.rng)
            if "attributes" in elem:
                caption = _get_caption(elem["attributes"], self.rng) \
                    + " " + caption
            try:
                enc = self.prep.encode_masked(caption)
            except Exception:
                continue
            regions.append(dict(
                enc=enc, image_atts=self._image_attns(rx, ry, rw, rh),
                target_bbox=np.asarray(
                    [(rx + rw / 2) / s, (ry + rh / 2) / s, rw / s, rh / s],
                    np.float32)))
            budget -= 1
        if not regions:
            raise ValueError("no usable regions")
        return image, regions

    def __iter__(self) -> Iterator[dict]:
        images, flat, group = [], [], []
        for ann in self.reader.iter_json():
            try:
                image, regions = self._one_image(ann)
            except Exception as e:
                if self.print_broken:
                    print(f"broken region sample: {e}", flush=True)
                continue
            gi = len(images)
            images.append(image)
            for r in regions:
                flat.append(r)
                group.append(gi)
            if len(images) < self.max_images and len(flat) < self.batch_size:
                continue

            n = len(flat)
            if n >= self.batch_size:
                keep = self.rng.choice(n, self.batch_size, replace=False)
            else:
                keep = np.concatenate([
                    np.arange(n),
                    self.rng.choice(n, self.batch_size - n, replace=True)])
            ids, atts, idsm, mpos, mids = (np.stack(x) for x in zip(
                *[flat[i]["enc"] for i in keep]))
            while len(images) < self.max_images:
                images.append(np.zeros_like(images[0]))
            yield dict(
                images=np.stack(images),
                idx_to_group_img=np.asarray([group[i] for i in keep],
                                            np.int32),
                text_ids=ids, text_atts=atts, text_ids_masked=idsm,
                masked_pos=mpos, masked_ids=mids,
                image_atts=np.stack([flat[i]["image_atts"] for i in keep]),
                target_bbox=np.stack([flat[i]["target_bbox"]
                                      for i in keep]),
                is_image=np.zeros(self.batch_size, np.float32))
            images, flat, group = [], [], []


class TextStream:
    """Text-only MLM batches {text_ids, text_atts, text_ids_masked,
    masked_pos, masked_ids}; lengths and masking from the `texts` block
    (128 tokens, 20 masks, 15 %, whole words by default). A text too short
    to mask is skipped."""

    def __init__(self, files, config: dict, tokenizer, rank=0, world_size=1,
                 seed=0):
        sub = config.get("texts", {}) or {}
        self.reader = ShardedLineReader(files, rank, world_size, seed=seed)
        self.text_key = sub.get("text_key", "desc")
        self.batch_size = sub.get("batch_size", 64)
        self.rng = np.random.default_rng(seed + rank + 1)
        self.prep = _text_prep(tokenizer, config, self.rng, sub=sub)

    def __iter__(self) -> Iterator[dict]:
        buf = []
        for ann in self.reader.iter_json():
            try:
                buf.append(self.prep.encode_masked(ann[self.text_key]))
            except Exception:
                continue
            if len(buf) == self.batch_size:
                ids, atts, idsm, mpos, mids = (np.stack(x) for x in
                                               zip(*buf))
                yield dict(text_ids=ids, text_atts=atts,
                           text_ids_masked=idsm, masked_pos=mpos,
                           masked_ids=mids)
                buf = []


class ImageStream(_NativeImages):
    """Image-only batches {images, image_mask} (the ImageNet MIM
    source)."""

    image_lists = False

    def __init__(self, files, config: dict, transform, rank=0, world_size=1,
                 config_key="images_imagenet", seed=0):
        sub = config.get(config_key, {}) or {}
        self.reader = ShardedLineReader(files, rank, world_size, seed=seed)
        self.image_key = sub.get("image_key", "binary")
        self.is_image_rpath = sub.get("is_image_rpath", False)
        self.batch_size = sub.get("batch_size", 32)
        self.transform = transform
        self.rng = np.random.default_rng(seed + rank + 2)
        self.block_masker = _block_masker(config, self.rng)
        self.native_batch = _native_batch(sub, transform)

    def _iter_native(self) -> Iterator[dict]:
        nbt = self.native_batch
        blobs, dims = [], []
        for ann in self.reader.iter_json():
            try:
                blob = self._blob(ann)
                d = nbt.probe(blob)
                if d is None:
                    raise ValueError("undecodable image")
            except Exception:
                continue
            blobs.append(blob)
            dims.append(d)
            if len(blobs) == self.batch_size:
                images, _ = nbt(blobs, dims)
                if images is not None:
                    yield dict(images=images,
                               image_mask=self.block_masker.batch(
                                   self.batch_size))
                blobs, dims = [], []

    def __iter__(self) -> Iterator[dict]:
        if self.native_batch is not None:
            yield from self._iter_native()
            return
        buf = []
        for ann in self.reader.iter_json():
            try:
                buf.append(self.transform(decode_image(ann[self.image_key])))
            except Exception:
                continue
            if len(buf) == self.batch_size:
                yield dict(images=np.stack(buf),
                           image_mask=self.block_masker.batch(
                               self.batch_size))
                buf = []

