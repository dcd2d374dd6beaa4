"""Pure-Python PTB caption tokenizer (`xfm_tpu/eval/ptb_tokenizer.py`, the
port's own copy).

The reference evaluates captions through pycocoevalcap's ``COCOEvalCap``,
which first runs every hypothesis and ground-truth sentence through the
Stanford PTBTokenizer jar (reference
refTools/evaluation/tokenizer/ptbtokenizer.py: ``-preserveLines
-lowerCase`` flags, then tokens in its PUNCTUATIONS list dropped).  This
module reproduces that normalization without the JVM: Penn-Treebank-style
splitting (contractions, punctuation, brackets), lowercasing, and the same
punctuation-token removal, so BLEU/METEOR/ROUGE-L/CIDEr scores are computed
over the same token streams as the reference pipeline.

Known intentional divergence: the jar (lowerCase) emits bracket tags in
lowercase ("-lrb-") which the reference's uppercase PUNCTUATIONS filter
fails to drop; we drop bracket tags in either case, which is the filter's
evident intent (captions essentially never contain brackets).
"""
from __future__ import annotations

import re
from typing import Dict, List

# reference refTools/evaluation/tokenizer/ptbtokenizer.py:21-22
PUNCTUATIONS = frozenset([
    "''", "'", "``", "`", "-lrb-", "-rrb-", "-lcb-", "-rcb-",
    "-lsb-", "-rsb-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
])

# Ordered (pattern, replacement) pairs; applied to a space-padded sentence.
_RULES = [
    # opening / closing quotes (straight and unicode)
    (re.compile(r'^"'), r'`` '),
    (re.compile(r'(``)'), r' \1 '),
    (re.compile(r'([ (\[{<])"'), r'\1 `` '),
    (re.compile(r'[“]'), r' `` '),
    (re.compile(r'[”]'), r" '' "),
    (re.compile(r'"'), r" '' "),
    # ellipsis before ordinary periods
    (re.compile(r'\.\.\.+'), r' ... '),
    # unambiguous punctuation
    (re.compile(r'([;@#$%&?!])'), r' \1 '),
    # commas: split unless digit,digit (Stanford keeps "4,000" whole)
    (re.compile(r'([^\d]),'), r'\1 , '),
    (re.compile(r',([^\d])'), r' , \1'),
    # colon: split unless between digits (times like 4:30)
    (re.compile(r'([^\d]):'), r'\1 : '),
    (re.compile(r':([^\d])'), r' : \1'),
    # final period (possibly followed by closing quotes/brackets)
    (re.compile(r"([^\.])(\.)([\]\)}>\"']*)\s*$"), r"\1 \2\3 "),
    # period after a single letter mid-sentence is likely an initial; keep.
    # brackets -> PTB tags
    (re.compile(r'\('), r' -lrb- '),
    (re.compile(r'\)'), r' -rrb- '),
    (re.compile(r'\['), r' -lsb- '),
    (re.compile(r'\]'), r' -rsb- '),
    (re.compile(r'\{'), r' -lcb- '),
    (re.compile(r'\}'), r' -rcb- '),
    # em dashes and standalone hyphens ("well-known" stays one token)
    (re.compile(r'--'), r' -- '),
    (re.compile(r'(\s)-(\s)'), r'\1 - \2'),
    # possessives and contractions (case-insensitive; input may be mixed)
    (re.compile(r"([^' ])('[sSmMdD]|'ll|'LL|'re|'RE|'ve|'VE)(?=\s|$)"),
     r"\1 \2"),
    (re.compile(r"([^' ])(n't|N'T)(?=\s|$)"), r"\1 \2"),
    # remaining apostrophes at word starts become quote tokens — but not
    # the contraction suffixes split off above ('s 'm 'd 'll 're 've),
    # which the jar emits as single apostrophe-bearing tokens
    (re.compile(r"(\s)'(?!(?:[smd]|ll|re|ve)(?:\s|$))([^'\s])",
                re.IGNORECASE), r"\1' \2"),
]


def ptb_word_tokenize(sentence: str) -> List[str]:
    """PTB-split a raw sentence into lowercase tokens (punctuation kept)."""
    s = " " + sentence.replace("\n", " ").strip() + " "
    for pat, rep in _RULES:
        s = pat.sub(rep, s)
    return s.lower().split()


def tokenize_sentence(sentence: str) -> List[str]:
    """PTB tokens with the reference's PUNCTUATIONS list removed."""
    return [t for t in ptb_word_tokenize(sentence) if t not in PUNCTUATIONS]


def ptb_tokenize(captions: Dict[str, List[str]]) -> Dict[str, List[str]]:
    """Dict-of-caption-lists -> dict of tokenized sentence strings, the same
    contract as the reference PTBTokenizer.tokenize
    (refTools/evaluation/tokenizer/ptbtokenizer.py:27-69)."""
    return {k: [" ".join(tokenize_sentence(c)) for c in v]
            for k, v in captions.items()}
