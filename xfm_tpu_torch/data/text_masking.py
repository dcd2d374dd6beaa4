"""BERT-style text masking for MLM (`xfm_tpu/data/text_masking.py`).

n_pred = min(max_masks, max(1, round(len · mask_prob))) positions after
the cls token, picked in a shuffled order; with probability
`skipgram_prb` a pick grows into a span of 2..skipgram_size tokens; with
`mask_whole_word` a pick widens to its whole word ('Ġ'-led RoBERTa words
under `use_roberta`, else '##' WordPiece continuations); then 80 % of the
picks become the mask token, 10 % a random vocabulary token and 10 % stay.
"""
from __future__ import annotations

import numpy as np


class TextMaskingGenerator:
    def __init__(self, tokenizer, mask_prob: float, max_masks: int,
                 skipgram_prb: float = 0.2, skipgram_size: int = 3,
                 mask_whole_word: bool = True, use_roberta: bool = False,
                 rng: np.random.Generator | None = None):
        self.vocab_tokens = list(tokenizer.get_vocab().keys())
        self.cls_token = tokenizer.cls_token
        self.mask_token = tokenizer.mask_token
        self.mask_prob = mask_prob
        self.max_masks = max_masks
        self.skipgram_prb = skipgram_prb
        self.skipgram_size = skipgram_size
        self.mask_whole_word = mask_whole_word
        self.use_roberta = use_roberta
        self.rng = rng if rng is not None else np.random.default_rng()

    def _random_token(self) -> str:
        return self.vocab_tokens[self.rng.integers(0, len(self.vocab_tokens))]

    def _expand_word(self, tokens, st, end):
        if self.use_roberta:
            while st > 1 and not tokens[st].startswith("Ġ"):
                st -= 1
            while end < len(tokens) and not tokens[end].startswith("Ġ"):
                end += 1
        else:
            while st >= 0 and tokens[st].startswith("##"):
                st -= 1
            while end < len(tokens) and tokens[end].startswith("##"):
                end += 1
        return st, end

    def __call__(self, tokens: list[str]):
        """tokens: [cls] + sub-words → (the tokens, masked in place; the
        masked positions)."""
        assert tokens[0] == self.cls_token
        n_pred = min(self.max_masks,
                     max(1, int(round(len(tokens) * self.mask_prob))))
        cand = np.arange(1, len(tokens))
        self.rng.shuffle(cand)
        picked: set[int] = set()
        for pos in cand:
            pos = int(pos)
            if len(picked) >= n_pred:
                break
            if pos in picked:
                continue
            if (self.skipgram_prb > 0 and self.skipgram_size >= 2
                    and self.rng.random() < self.skipgram_prb):
                span = int(self.rng.integers(2, self.skipgram_size,
                                             endpoint=True))
                st, end = (self._expand_word(tokens, pos, pos + span)
                           if self.mask_whole_word else (pos, pos + span))
            else:
                st, end = (self._expand_word(tokens, pos, pos + 1)
                           if self.mask_whole_word else (pos, pos + 1))
            for mp in range(st, end):
                if 0 < mp < len(tokens):
                    picked.add(mp)
                else:
                    break

        masked_pos = list(picked)
        if len(masked_pos) > n_pred:
            self.rng.shuffle(masked_pos)
            masked_pos = masked_pos[:n_pred]

        for pos in masked_pos:
            if self.rng.random() < 0.8:
                tokens[pos] = self.mask_token
            elif self.rng.random() < 0.5:
                tokens[pos] = self._random_token()
        return tokens, masked_pos
