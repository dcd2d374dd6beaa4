"""Pure-Python METEOR for caption evaluation (`xfm_tpu/eval/meteor.py`, the
port's own copy).

The reference scores METEOR through the Java jar in
refTools/evaluation/meteor (meteor-1.5.jar, shelled out per corpus). This is
a dependency-free reimplementation of the METEOR algorithm (Banerjee &
Lavie 2005) with exact-, stem-, and synonym-match stages. Synonymy uses
NLTK WordNet when its corpus is installed (full fidelity with the jar's
synonym module) and otherwise an embedded curated caption-domain synonym
table (`meteor_synonyms.py`) — scores can still slightly under-estimate
meteor-1.5 on out-of-domain text, documented so downstream comparisons
treat the absolute value accordingly.

Score: F_mean = 10·P·R / (R + 9·P); penalty = 0.5 · (chunks/matches)^3;
METEOR = F_mean · (1 − penalty), corpus score = mean over captions (the
reference jar's per-segment mean, refTools/evaluation/meteor/meteor.py).
"""
from __future__ import annotations

from typing import Dict, List

# ---------------------------------------------------------------------------
# Porter stemmer (standard algorithm; compact implementation)
# ---------------------------------------------------------------------------

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Number of VC sequences."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        cons = _is_cons(stem, i)
        if cons and prev_vowel:
            m += 1
        prev_vowel = not cons
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_cons(word, len(word) - 1))


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    return (_is_cons(word, len(word) - 3)
            and not _is_cons(word, len(word) - 2)
            and _is_cons(word, len(word) - 1)
            and word[-1] not in "wxy")


def porter_stem(word: str) -> str:
    w = word.lower()
    if len(w) <= 2:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
                w = w[:-1]
            elif _measure(w) == 1 and _cvc(w):
                w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    for suf, rep in (("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
                     ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
                     ("alli", "al"), ("entli", "ent"), ("eli", "e"),
                     ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
                     ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
                     ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
                     ("iviti", "ive"), ("biliti", "ble")):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 3
    for suf, rep in (("icate", "ic"), ("ative", ""), ("alize", "al"),
                     ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                     ("ness", "")):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 4
    for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                "ement", "ment", "ent", "ou", "ism", "ate", "iti", "ous",
                "ive", "ize"):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 1:
                w = w[: -len(suf)]
            break
    else:
        if w.endswith("ion") and _measure(w[:-3]) > 1 and w[-4] in "st":
            w = w[:-3]
    # step 5a
    if w.endswith("e"):
        m = _measure(w[:-1])
        if m > 1 or (m == 1 and not _cvc(w[:-1])):
            w = w[:-1]
    # step 5b
    if _ends_double_cons(w) and w.endswith("l") and _measure(w) > 1:
        w = w[:-1]
    return w


# ---------------------------------------------------------------------------
# METEOR alignment & score
# ---------------------------------------------------------------------------


def _align(hyp: List[str], ref: List[str]):
    """Greedy three-stage alignment (exact, stem, synonym — the meteor-1.5
    module order), each word used once. Returns list of (hyp_idx, ref_idx)
    matches sorted by hyp_idx."""
    matches = {}
    used_ref = set()
    # stage 1: exact
    for i, hw in enumerate(hyp):
        for j, rw in enumerate(ref):
            if j in used_ref:
                continue
            if hw == rw:
                matches[i] = j
                used_ref.add(j)
                break
    # stage 2: stem on the remainder
    hyp_stems = [porter_stem(w) for w in hyp]
    ref_stems = [porter_stem(w) for w in ref]
    for i, hs in enumerate(hyp_stems):
        if i in matches:
            continue
        for j, rs in enumerate(ref_stems):
            if j in used_ref:
                continue
            if hs == rs:
                matches[i] = j
                used_ref.add(j)
                break
    # stage 3: synonym (shared synset) on the remainder
    from .meteor_synonyms import synset_ids

    for i, hw in enumerate(hyp):
        if i in matches:
            continue
        hsyn = synset_ids(hw)
        if not hsyn:
            continue
        for j, rw in enumerate(ref):
            if j in used_ref:
                continue
            if hsyn & synset_ids(rw):
                matches[i] = j
                used_ref.add(j)
                break
    return sorted(matches.items())


def _chunks(pairs) -> int:
    """Number of maximal runs monotone-contiguous in both sentences."""
    if not pairs:
        return 0
    n = 1
    for (i0, j0), (i1, j1) in zip(pairs, pairs[1:]):
        if i1 != i0 + 1 or j1 != j0 + 1:
            n += 1
    return n


def meteor_sentence(hyp: str, refs: List[str]) -> float:
    """Best METEOR over the reference set (the jar scores against the
    best-matching reference)."""
    hw = hyp.lower().split()
    if not hw:
        return 0.0
    best = 0.0
    for ref in refs:
        rw = ref.lower().split()
        if not rw:
            continue
        pairs = _align(hw, rw)
        m = len(pairs)
        if m == 0:
            continue
        p = m / len(hw)
        r = m / len(rw)
        fmean = 10 * p * r / (r + 9 * p)
        penalty = 0.5 * (_chunks(pairs) / m) ** 3
        best = max(best, fmean * (1 - penalty))
    return best


def meteor(hypos: Dict[str, str], refs: Dict[str, List[str]]) -> float:
    """Corpus METEOR = mean per-segment score (jar convention)."""
    scores = [meteor_sentence(h, refs.get(k, []))
              for k, h in hypos.items()]
    return sum(scores) / max(len(scores), 1)
