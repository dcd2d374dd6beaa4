"""CIDEr-D scorer (`xfm_tpu/eval/cider.py`, the port's own copy; reference
utils/cider/ CiderD, ~550 LoC) in compact Python.

Implements the standard CIDEr-D formulation: tf-idf weighted n-gram (n=1..4)
cosine similarity with length-gaussian penalty and count clipping, scores
scaled by 10. Document frequencies come from the reference corpus (the
per-image ground-truth captions), matching the SCST usage
(reference utils/__init__.py:16-97 ScstRewardCriterion).
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence


def _ngrams(words: Sequence[str], n_max: int = 4):
    out = [Counter() for _ in range(n_max)]
    for n in range(1, n_max + 1):
        for i in range(len(words) - n + 1):
            out[n - 1][tuple(words[i:i + n])] += 1
    return out


class CiderD:
    def __init__(self, refs: Dict[str, List[str]], n: int = 4,
                 sigma: float = 6.0):
        """refs: id → list of reference captions (whitespace-tokenized)."""
        self.n = n
        self.sigma = sigma
        self.crefs = {k: [_ngrams(r.split(), n) for r in v]
                      for k, v in refs.items()}
        self.doc_freq = [defaultdict(int) for _ in range(n)]
        for grams_list in self.crefs.values():
            seen = [set() for _ in range(n)]
            for grams in grams_list:
                for i in range(n):
                    seen[i].update(grams[i].keys())
            for i in range(n):
                for g in seen[i]:
                    self.doc_freq[i][g] += 1
        self.log_ref_len = math.log(max(len(self.crefs), 1))

    def _vec(self, grams):
        """tf-idf vector + norm per n."""
        vecs, norms, length = [], [], 0
        for i in range(self.n):
            v = {}
            for g, c in grams[i].items():
                df = math.log(max(self.doc_freq[i].get(g, 0), 1.0))
                idf = self.log_ref_len - df
                v[g] = c * idf
            vecs.append(v)
            norms.append(math.sqrt(sum(x * x for x in v.values())))
        length = sum(grams[0].values())
        return vecs, norms, length

    def _sim(self, vh, nh, lh, vr, nr, lr):
        score = 0.0
        for i in range(self.n):
            s = 0.0
            for g, x in vh[i].items():
                s += min(x, vr[i].get(g, 0.0)) * vr[i].get(g, 0.0)
            if nh[i] > 0 and nr[i] > 0:
                s /= nh[i] * nr[i]
            delta = lh - lr
            s *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
            score += s
        return score / self.n

    def score_one(self, ref_id: str, candidate: str) -> float:
        """Score ONE candidate against `crefs[ref_id]` (reusing the corpus
        doc-freq statistics). This is the SCST per-hypothesis reward path
        (reference ScstRewardCriterion, utils/__init__.py:26-57): many
        hypotheses per image, each scored against the same reference set."""
        refs = self.crefs.get(ref_id)
        if not refs:
            return 0.0
        grams = _ngrams(candidate.split(), self.n)
        vh, nh, lh = self._vec(grams)
        s = 0.0
        for rg in refs:
            vr, nr, lr = self._vec(rg)
            s += self._sim(vh, nh, lh, vr, nr, lr)
        return 10.0 * s / len(refs)

    def score(self, hypo: Dict[str, str]):
        """hypo: id → candidate caption. Returns (mean, per-id dict)."""
        per = {k: self.score_one(k, cand) for k, cand in hypo.items()}
        mean = sum(per.values()) / max(len(per), 1)
        return mean, per
