"""The retrieval fine-tune's and eval's data (`xfm_tpu/data/finetune_data.py`
`RetrievalTrainData`, `RetrievalEvalData`): annotation lists of the
reference's json format → fixed-shape numpy batches."""
from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np

from .tokenization import pre_caption
from .transforms import decode_image


def _load_ann(files):
    if isinstance(files, str):
        files = [files]
    ann = []
    for f in files:
        with open(f) as fh:
            ann += json.load(fh)
    return ann


def _encode_texts(tokenizer, texts, max_tokens):
    """cls + tokens + sep, padded to max_tokens → (ids, atts) int32."""
    ids, atts = [], []
    for t in texts:
        toks = ([tokenizer.cls_token]
                + tokenizer.tokenize(t)[: max_tokens - 2]
                + [tokenizer.sep_token])
        i = tokenizer.convert_tokens_to_ids(toks)
        pad = max_tokens - len(i)
        ids.append(i + [tokenizer.pad_token_id] * pad)
        atts.append([1] * len(i) + [0] * pad)
    return np.asarray(ids, np.int32), np.asarray(atts, np.int32)


class RetrievalTrainData:
    """Image-caption pairs, one an annotation, with dense image ids (`idx`,
    in order of first appearance) for the idx-aware ITC and ITM losses."""

    def __init__(self, ann_file, transform, image_root, tokenizer,
                 max_words=30, max_tokens=30, batch_size=32):
        self.ann = _load_ann(ann_file)
        self.transform = transform
        self.image_root = image_root
        self.tok = tokenizer
        self.max_words, self.max_tokens = max_words, max_tokens
        self.batch_size = batch_size
        ids = {}
        for a in self.ann:
            ids.setdefault(a["image_id"], len(ids))
        self.img_ids = ids

    def __len__(self):
        return len(self.ann)

    def epoch(self, epoch_seed=0) -> Iterator[dict]:
        """One pass in the order `np.random.default_rng(epoch_seed)`
        shuffles, the transform reseeded from [epoch_seed, 1] first (so an
        epoch's draws depend on its seed alone) → full batches of images,
        text_ids, text_atts and idx; a last partial batch is dropped."""
        order = np.arange(len(self.ann))
        np.random.default_rng(epoch_seed).shuffle(order)
        self.transform.reseed([epoch_seed, 1])
        buf_img, buf_cap, buf_idx = [], [], []
        for i in order:
            a = self.ann[int(i)]
            img = decode_image(os.path.join(self.image_root, a["image"]))
            buf_img.append(self.transform(img))
            buf_cap.append(pre_caption(a["caption"], self.max_words))
            buf_idx.append(self.img_ids[a["image_id"]])
            if len(buf_img) == self.batch_size:
                ids, atts = _encode_texts(self.tok, buf_cap, self.max_tokens)
                yield dict(images=np.stack(buf_img), text_ids=ids,
                           text_atts=atts,
                           idx=np.asarray(buf_idx, np.int32))
                buf_img, buf_cap, buf_idx = [], [], []


class RetrievalEvalData:
    """Every image and every caption of an annotation file, with the
    ground truth img2txt (image → its caption indices) and txt2img."""

    def __init__(self, ann_file, transform, image_root, tokenizer,
                 max_words=30, max_tokens=30):
        self.ann = _load_ann(ann_file)
        self.transform = transform
        self.image_root = image_root
        self.tok = tokenizer
        self.max_words, self.max_tokens = max_words, max_tokens
        self.text, self.img2txt, self.txt2img = [], {}, {}
        t = 0
        for img_id, a in enumerate(self.ann):
            self.img2txt[img_id] = []
            caps = a["caption"] if isinstance(a["caption"], list) \
                else [a["caption"]]
            for c in caps:
                self.text.append(pre_caption(c, max_words))
                self.img2txt[img_id].append(t)
                self.txt2img[t] = img_id
                t += 1

    @property
    def num_images(self):
        return len(self.ann)

    def image_batches(self, batch_size) -> Iterator[np.ndarray]:
        buf = []
        for a in self.ann:
            img = decode_image(os.path.join(self.image_root, a["image"]))
            buf.append(self.transform(img))
            if len(buf) == batch_size:
                yield np.stack(buf)
                buf = []
        if buf:
            yield np.stack(buf)

    def text_batches(self, batch_size) -> Iterator[tuple]:
        for s in range(0, len(self.text), batch_size):
            yield _encode_texts(self.tok, self.text[s:s + batch_size],
                                self.max_tokens)
