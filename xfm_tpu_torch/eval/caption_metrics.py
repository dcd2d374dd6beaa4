"""Caption evaluation (`xfm_tpu/eval/caption_metrics.py`, the port's own
copy): BLEU-1..4 + CIDEr-D + METEOR + ROUGE-L (replacing pycocoevalcap
in reference dataset/utils.py:368-391 coco_caption_eval, utils/bleu.py, and
the meteor-1.5 jar in refTools/evaluation/meteor — see eval/meteor.py for
the reimplementation notes). SPICE needs a Java dependency parser +
scene-graph models which cannot ship in-repo: when `pycocoevalcap` (with its
SPICE jar) is installed the optional hook scores it, otherwise the eval dict
carries an explicit `SPICE: None` + note so the omission is visible instead
of silent."""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List

from .cider import CiderD


def bleu(hypos: Dict[str, str], refs: Dict[str, List[str]], max_n: int = 4):
    """Corpus BLEU with standard brevity penalty."""
    clipped = [0] * max_n
    totals = [0] * max_n
    hyp_len = ref_len = 0
    for k, h in hypos.items():
        hw = h.split()
        rws = [r.split() for r in refs.get(k, [])]
        if not rws:
            continue
        hyp_len += len(hw)
        ref_len += min((abs(len(r) - len(hw)), len(r)) for r in rws)[1]
        for n in range(1, max_n + 1):
            hc = Counter(tuple(hw[i:i + n]) for i in range(len(hw) - n + 1))
            mc = Counter()
            for rw in rws:
                rc = Counter(tuple(rw[i:i + n])
                             for i in range(len(rw) - n + 1))
                for g, c in rc.items():
                    mc[g] = max(mc[g], c)
            clipped[n - 1] += sum(min(c, mc.get(g, 0))
                                  for g, c in hc.items())
            totals[n - 1] += max(sum(hc.values()), 0)
    precisions = [(clipped[i] / totals[i]) if totals[i] else 0.0
                  for i in range(max_n)]
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len /
                                                max(hyp_len, 1))
    out = {}
    for n in range(1, max_n + 1):
        ps = precisions[:n]
        if min(ps) > 0:
            out[f"Bleu_{n}"] = bp * math.exp(sum(math.log(p) for p in ps)
                                             / n)
        else:
            out[f"Bleu_{n}"] = 0.0
    return out


def _lcs_len(a: List[str], b: List[str]) -> int:
    """Longest-common-subsequence length, O(len(a)*len(b)) single-row DP
    (reference refTools/evaluation/rouge/rouge.py my_lcs)."""
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            cur[j] = (prev[j - 1] + 1 if ai == b[j - 1]
                      else max(prev[j], cur[j - 1]))
        prev = cur
    return prev[len(b)]


def rouge_l(hypos: Dict[str, str], refs: Dict[str, List[str]],
            beta: float = 1.2) -> float:
    """ROUGE-L (Lin & Hovy 2004) F-measure with beta=1.2, max over
    references, averaged over the corpus
    (reference refTools/evaluation/rouge/rouge.py calc_score/compute_score)."""
    scores = []
    for k, h in hypos.items():
        rws = refs.get(k, [])
        if not rws:
            continue
        hw = h.split()
        prec, rec = [], []
        for r in rws:
            rw = r.split()
            lcs = _lcs_len(hw, rw)
            prec.append(lcs / max(len(hw), 1))
            rec.append(lcs / max(len(rw), 1))
        p, r = max(prec), max(rec)
        if p != 0 and r != 0:
            scores.append(((1 + beta ** 2) * p * r) / (r + beta ** 2 * p))
        else:
            scores.append(0.0)
    return float(sum(scores) / max(len(scores), 1))


def coco_caption_eval(hypos: Dict[str, str],
                      refs: Dict[str, List[str]],
                      tokenize: bool = True) -> dict:
    from .meteor import meteor

    if tokenize:
        # pycocoevalcap runs both sides through the Stanford PTBTokenizer
        # (lowercase + PTB splits + punctuation removal) before any metric
        # (refTools/evaluation/refEvaluation.py:40-42); eval/ptb_tokenizer.py
        # reproduces that normalization.
        from .ptb_tokenizer import ptb_tokenize
        hypos = {k: v[0] for k, v in
                 ptb_tokenize({k: [h] for k, h in hypos.items()}).items()}
        refs = ptb_tokenize(refs)

    out = bleu(hypos, refs)
    cider_mean, _ = CiderD(refs).score(hypos)
    out["CIDEr"] = cider_mean
    out["METEOR"] = meteor(hypos, refs)
    out["ROUGE_L"] = rouge_l(hypos, refs)
    out.update(spice(hypos, refs))
    return out


def spice(hypos: Dict[str, str], refs: Dict[str, List[str]]) -> dict:
    """SPICE via the optional `pycocoevalcap` dependency (its bundled Java
    scene-graph parser — the same path the reference uses through
    refTools/pycocoevalcap, reference dataset/utils.py:384). When the
    package (or its Java runtime) is unavailable the score is reported as
    an explicit None + note rather than silently dropped."""
    try:  # pragma: no cover - optional heavy dependency
        from pycocoevalcap.spice.spice import Spice

        gts = {k: list(v) for k, v in refs.items()}
        res = {k: [h] for k, h in hypos.items()}
        score, _ = Spice().compute_score(gts, res)
        return {"SPICE": float(score)}
    except Exception:
        return {"SPICE": None,
                "SPICE_note": ("not computed: SPICE needs the pycocoevalcap "
                               "Java scene-graph parser (optional "
                               "dependency, not installed)")}
