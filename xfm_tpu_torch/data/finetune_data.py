"""The retrieval fine-tune's and eval's data, NLVR2's, VQA's,
captioning's and grounding's (`xfm_tpu/data/finetune_data.py`
`RetrievalTrainData`, `RetrievalEvalData`, `NLVRData`, `VQAData`,
`CaptioningData`, `GroundingData`): annotation lists of the reference's
json format → fixed-shape numpy batches."""
from __future__ import annotations

import json
import os
from typing import Iterator, Optional

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


class NLVRData:
    """NLVR2: two images, a sentence and a 'True' / 'False' label an
    annotation. Batches hold the images as [all first images; all second
    images] (2B rows), text_ids, text_atts and targets (1 where
    `str(label).lower() == "true"`)."""

    def __init__(self, ann_file, transform, image_root, tokenizer,
                 max_tokens=40, batch_size=16, train=True):
        self.ann = _load_ann(ann_file)
        self.transform = transform
        self.image_root = image_root
        self.tok = tokenizer
        self.max_tokens = max_tokens
        self.batch_size = batch_size
        self.train = train

    def __len__(self):
        return len(self.ann)

    def epoch(self, epoch_seed=0) -> Iterator[dict]:
        """One pass. Train: the order `np.random.default_rng(epoch_seed)`
        shuffles, the transform reseeded from [epoch_seed, 1] first (the
        pair's first image transformed before its second); a last partial
        batch is dropped. Eval: the file's order, the last batch kept."""
        order = np.arange(len(self.ann))
        if self.train:
            np.random.default_rng(epoch_seed).shuffle(order)
            self.transform.reseed([epoch_seed, 1])
        buf0, buf1, caps, labels = [], [], [], []
        for i in order:
            a = self.ann[int(i)]
            for buf, name in ((buf0, a["images"][0]), (buf1, a["images"][1])):
                buf.append(self.transform(decode_image(
                    os.path.join(self.image_root, name))))
            caps.append(pre_caption(a["sentence"], 50))
            labels.append(1 if str(a["label"]).lower() == "true" else 0)
            if len(buf0) == self.batch_size:
                yield self._pack(buf0, buf1, caps, labels)
                buf0, buf1, caps, labels = [], [], [], []
        if buf0 and not self.train:
            yield self._pack(buf0, buf1, caps, labels)

    def _pack(self, buf0, buf1, caps, labels):
        ids, atts = _encode_texts(self.tok, caps, self.max_tokens)
        images = np.concatenate([np.stack(buf0), np.stack(buf1)], axis=0)
        return dict(images=images, text_ids=ids, text_atts=atts,
                    targets=np.asarray(labels, np.int32))


class VQAData:
    """VQA questions over images under two roots (`image_roots`: {"vqa":
    ..., "vg": ...}, chosen by each annotation's `dataset`, "vqa" by
    default). The train split yields each batch's answers in a fixed flat
    layout of B · `max_answers` rows: a VQA question's distinct answers
    weighted by count / number of answers, a Visual Genome question's one
    answer at 0.5, pads of weight 0 after them, `ques_idx` naming each
    row's question. The test split yields `question_id`s. `answer_list`:
    the path of the json list of candidate answers the eval ranks."""

    def __init__(self, ann_file, transform, image_roots, tokenizer,
                 max_tokens=40, answer_max_tokens=10, batch_size=16,
                 split="train", answer_list: Optional[str] = None,
                 max_answers=4):
        self.ann = _load_ann(ann_file)
        self.transform = transform
        self.image_roots = image_roots
        self.tok = tokenizer
        self.max_tokens = max_tokens
        self.answer_max_tokens = answer_max_tokens
        self.batch_size = batch_size
        self.split = split
        self.max_answers = max_answers
        self.answer_list = None
        if answer_list:
            with open(answer_list) as f:
                self.answer_list = json.load(f)

    def __len__(self):
        return len(self.ann)

    def _image_path(self, a):
        root = self.image_roots.get(a.get("dataset", "vqa"),
                                    list(self.image_roots.values())[0])
        return os.path.join(root, a["image"])

    def encode_answer_list(self):
        """The answer list as (ids, atts) [A, answer_max_tokens]: cls,
        tokens, sep, pads. (The JAX package also builds each answer with
        the sep token appended as text and then encodes the bare list; the
        port encodes what that computes.)"""
        return _encode_texts(self.tok, self.answer_list,
                             self.answer_max_tokens)

    @staticmethod
    def _swap_left_right(text: str) -> str:
        return " ".join("right" if w == "left" else "left" if w == "right"
                        else w for w in text.split())

    def epoch(self, epoch_seed=0) -> Iterator[dict]:
        """One pass. Train: the order `np.random.default_rng(epoch_seed)`
        shuffles and, from the same generator after the shuffle, one draw
        an example for the careful flip (the image mirrored and left/right
        swapped in the question and answers, at 0.5), the transform
        reseeded from [epoch_seed, 1] first; a last partial batch is
        dropped. Test: the file's order, the last batch kept."""
        order = np.arange(len(self.ann))
        rng = np.random.default_rng(epoch_seed)
        train = self.split == "train"
        if train:
            rng.shuffle(order)
            self.transform.reseed([epoch_seed, 1])
        imgs, qs, ans_rows, qid_rows = [], [], [], []
        for i in order:
            a = self.ann[int(i)]
            img = self.transform(decode_image(self._image_path(a)))
            question = pre_caption(a["question"], 30)
            if train and rng.random() < 0.5:
                img = img[:, ::-1, :].copy()
                question = self._swap_left_right(question)
                if isinstance(a.get("answer"), list):
                    a = dict(a, answer=[self._swap_left_right(x)
                                        for x in a["answer"]])
            imgs.append(img)
            qs.append(question)
            if train:
                if a.get("dataset") == "vg":
                    rows = [(a["answer"], 0.5)]
                else:
                    counts = {}
                    for ans in a["answer"]:
                        counts[ans] = counts.get(ans, 0) + 1
                    rows = [(ans, c / len(a["answer"]))
                            for ans, c in counts.items()]
                ans_rows.append(rows)
            else:
                qid_rows.append(a["question_id"])
            if len(imgs) == self.batch_size:
                yield self._pack(imgs, qs, ans_rows, qid_rows)
                imgs, qs, ans_rows, qid_rows = [], [], [], []
        if imgs and not train:
            yield self._pack(imgs, qs, ans_rows, qid_rows)

    def _pack(self, imgs, qs, ans_rows, qid_rows):
        q_ids, q_atts = _encode_texts(self.tok, qs, self.max_tokens)
        out = dict(images=np.stack(imgs), q_ids=q_ids, q_atts=q_atts)
        if self.split != "train":
            out["question_id"] = np.asarray(qid_rows)
            return out
        K = self.max_answers
        texts, weights, ques_idx = [], [], []
        for b, rows in enumerate(ans_rows):
            rows = rows[:K] + [("", 0.0)] * (K - len(rows[:K]))
            texts += [t for t, _ in rows]
            weights += [w for _, w in rows]
            ques_idx += [b] * K
        ids, atts = _encode_texts(self.tok, texts, self.answer_max_tokens)
        out.update(answer_ids=ids, answer_atts=atts,
                   weights=np.asarray(weights, np.float32),
                   ques_idx=np.asarray(ques_idx, np.int32))
        return out


def caption_image_id(a: dict) -> int:
    """An annotation's COCO image id: its `image_id` (of a string such as
    "coco_123" the number after the last "_"), else the number at the end
    of its image's file name."""
    iid = a.get("image_id")
    if iid is None:
        iid = int(a["image"].split("_")[-1].split(".")[0])
    return int(str(iid).split("_")[-1]) if isinstance(iid, str) else iid


class CaptioningData:
    """COCO-Karpathy captions. Train: an image and its caption, `prompt` +
    `pre_caption(caption, 30)`, encoded to `max_tokens`; eval: an image and
    its image id."""

    def __init__(self, ann_file, transform, image_root, tokenizer,
                 max_tokens=30, batch_size=16, train=True, prompt=""):
        self.ann = _load_ann(ann_file)
        self.transform = transform
        self.image_root = image_root
        self.tok = tokenizer
        self.max_tokens = max_tokens
        self.batch_size = batch_size
        self.train = train
        self.prompt = prompt

    def __len__(self):
        return len(self.ann)

    def epoch(self, epoch_seed=0) -> Iterator[dict]:
        """One pass. Train: the order `np.random.default_rng(epoch_seed)`
        shuffles, the transform reseeded from [epoch_seed, 1] first; full
        batches of images, text_ids, text_atts and image_id, a last partial
        batch dropped. Eval: the file's order, batches of images and
        image_id, the last one kept."""
        order = np.arange(len(self.ann))
        if self.train:
            np.random.default_rng(epoch_seed).shuffle(order)
            self.transform.reseed([epoch_seed, 1])
        imgs, caps, img_ids = [], [], []
        for i in order:
            a = self.ann[int(i)]
            imgs.append(self.transform(decode_image(
                os.path.join(self.image_root, a["image"]))))
            img_ids.append(caption_image_id(a))
            if self.train:
                caps.append(self.prompt + pre_caption(a["caption"], 30))
            if len(imgs) == self.batch_size:
                yield self._pack(imgs, caps, img_ids)
                imgs, caps, img_ids = [], [], []
        if imgs and not self.train:
            yield self._pack(imgs, caps, img_ids)

    def _pack(self, imgs, caps, img_ids):
        out = dict(images=np.stack(imgs), image_id=np.asarray(img_ids))
        if self.train:
            ids, atts = _encode_texts(self.tok, caps, self.max_tokens)
            out.update(text_ids=ids, text_atts=atts)
        return out


class GroundingData:
    """RefCOCO-style referring expressions: an image, a phrase
    (`pre_caption(text, 30)`), its box `bbox` [x, y, w, h] in pixels and
    `ref_id`. Batches hold images, text_ids, text_atts, target_bbox (cxcywh
    normalized: by the source image's size, or by the crop a box-aware
    transform (`maps_box`, `BoxTrainTransform`) returns with the image)
    and ref_id. An annotation without `bbox` (the weakly supervised one,
    which carries candidate `boxes`) takes the dummy box (0, 0, 1, 1)."""

    def __init__(self, ann_file, transform, image_root, tokenizer,
                 max_tokens=30, batch_size=16, train=True):
        self.ann = _load_ann(ann_file)
        self.transform = transform
        self.image_root = image_root
        self.tok = tokenizer
        self.max_tokens = max_tokens
        self.batch_size = batch_size
        self.train = train

    def __len__(self):
        return len(self.ann)

    def epoch(self, epoch_seed=0) -> Iterator[dict]:
        """One pass. Train: the order `np.random.default_rng(epoch_seed)`
        shuffles, the transform reseeded from [epoch_seed, 1] first; a last
        partial batch is dropped. Eval: the file's order, the last batch
        kept."""
        order = np.arange(len(self.ann))
        if self.train:
            np.random.default_rng(epoch_seed).shuffle(order)
            self.transform.reseed([epoch_seed, 1])
        maps_box = getattr(self.transform, "maps_box", False)
        imgs, texts, boxes, ref_ids = [], [], [], []
        for i in order:
            a = self.ann[int(i)]
            img = decode_image(os.path.join(self.image_root, a["image"]))
            box = a.get("bbox", (0, 0, 1, 1))
            if maps_box:
                arr, target = self.transform(img, box)
            else:
                W, H = img.size
                x, y, w, h = box
                arr = self.transform(img)
                target = [(x + w / 2) / W, (y + h / 2) / H, w / W, h / H]
            imgs.append(arr)
            boxes.append(target)
            texts.append(pre_caption(a["text"], 30))
            ref_ids.append(a.get("ref_id", 0))
            if len(imgs) == self.batch_size:
                yield self._pack(imgs, texts, boxes, ref_ids)
                imgs, texts, boxes, ref_ids = [], [], [], []
        if imgs and not self.train:
            yield self._pack(imgs, texts, boxes, ref_ids)

    def _pack(self, imgs, texts, boxes, ref_ids):
        ids, atts = _encode_texts(self.tok, texts, self.max_tokens)
        return dict(images=np.stack(imgs), text_ids=ids, text_atts=atts,
                    target_bbox=np.asarray(boxes, np.float32),
                    ref_id=np.asarray(ref_ids))
