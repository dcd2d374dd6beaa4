"""Tokenizers (`xfm_tpu/data/tokenization.py`) and the caption cleanup
(`xfm_tpu/data/pretrain_data.py` `pre_caption`).

`build_tokenizer` selects a Hugging Face tokenizer by the `text_encoder`
path and reads local files only (`transformers` is imported inside it);
`SimpleTokenizer` is the word-level tokenizer with the same surface that
tests and machines without those files use.
"""
from __future__ import annotations

import re
from typing import Sequence


def pre_caption(caption: str, max_words: int) -> str:
    """Lower-case, punctuation to spaces, at most `max_words` words."""
    caption = re.sub(r"([,.'!?\"()*#:;~])", " ", caption.lower())
    caption = caption.replace("-", " ").replace("/", " ")
    caption = caption.replace("<person>", "person")
    caption = re.sub(r"\s{2,}", " ", caption).rstrip("\n").strip(" ")
    words = caption.split(" ")
    if len(words) > max_words:
        caption = " ".join(words[:max_words])
    return caption


def build_tokenizer(text_encoder: str):
    """The Bert / Roberta / XLMRoberta tokenizer the path names, with bos
    and eos aliases; raises where `transformers` or the files are
    missing, and where what loads holds no word beyond the special tokens
    (some versions of `transformers` build such a tokenizer for a path
    that holds no vocabulary, and every word of a caption would read as
    unknown)."""
    from transformers import (BertTokenizer, RobertaTokenizer,
                              XLMRobertaTokenizer)

    name = text_encoder.rstrip("/")
    if "xlm-roberta" in name:
        cls = XLMRobertaTokenizer
    elif "roberta" in name:
        cls = RobertaTokenizer
    elif "bert" in name:
        cls = BertTokenizer
    else:
        raise ValueError(f"cannot infer tokenizer family from {text_encoder}")
    tok = cls.from_pretrained(name, local_files_only=True)
    if len(tok.get_vocab()) <= len(tok.all_special_tokens):
        raise OSError(f"{text_encoder}: no vocabulary beyond the special "
                      f"tokens ({len(tok.get_vocab())} entries)")
    if tok.bos_token is None:
        tok.bos_token = tok.cls_token
    if tok.eos_token is None:
        tok.eos_token = tok.sep_token
    return tok


class SimpleTokenizer:
    """Word-level tokenizer with the Hugging Face surface the data layer
    uses (tokenize, convert_tokens_to_ids, get_vocab, special tokens)."""

    SPECIALS = ["<pad>", "<s>", "</s>", "<mask>", "<unk>"]

    def __init__(self, vocab: Sequence[str] | None = None, use_roberta=True):
        words = list(vocab or [])
        self.itos = list(self.SPECIALS) + [w for w in words
                                           if w not in self.SPECIALS]
        self.stoi = {w: i for i, w in enumerate(self.itos)}
        self.pad_token, self.cls_token = "<pad>", "<s>"
        self.sep_token, self.mask_token = "</s>", "<mask>"
        self.unk_token = "<unk>"
        self.bos_token, self.eos_token = "<s>", "</s>"
        self.pad_token_id = 0
        self.cls_token_id = self.bos_token_id = 1
        self.sep_token_id = self.eos_token_id = 2
        self.mask_token_id = 3
        self.unk_token_id = 4
        self.use_roberta = use_roberta

    @classmethod
    def from_texts(cls, texts: Sequence[str], max_vocab: int = 30000):
        """The `max_vocab` most frequent words of `texts` after the
        specials."""
        from collections import Counter

        counter = Counter()
        for t in texts:
            counter.update(cls._words(t))
        return cls([w for w, _ in counter.most_common(max_vocab)])

    @staticmethod
    def _words(text: str):
        return re.findall(r"\w+|[^\w\s]", text.lower())

    @property
    def vocab_size(self):
        return len(self.itos)

    def get_vocab(self):
        return dict(self.stoi)

    def tokenize(self, text: str):
        return [w if w in self.stoi else self.unk_token
                for w in self._words(text)]

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.stoi.get(tokens, self.unk_token_id)
        return [self.stoi.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, int):
            return self.itos[ids]
        return [self.itos[i] for i in ids]

    def decode(self, ids, skip_special_tokens=True):
        toks = [self.itos[int(i)] for i in ids]
        if skip_special_tokens:
            toks = [t for t in toks if t not in self.SPECIALS]
        return " ".join(toks)

    def __call__(self, texts, max_length=30, padding="max_length",
                 truncation=True, return_tensors=None):
        """cls + tokens, cut to `max_length` - 1, + sep, padded →
        {"input_ids", "attention_mask"} int32 arrays."""
        import numpy as np

        if isinstance(texts, str):
            texts = [texts]
        ids, atts = [], []
        for t in texts:
            tok = [self.cls_token] + self.tokenize(t)
            tok = tok[: max_length - 1] + [self.sep_token]
            i = self.convert_tokens_to_ids(tok)
            a = [1] * len(i)
            while len(i) < max_length:
                i.append(self.pad_token_id)
                a.append(0)
            ids.append(i)
            atts.append(a)
        return {"input_ids": np.asarray(ids, np.int32),
                "attention_mask": np.asarray(atts, np.int32)}
