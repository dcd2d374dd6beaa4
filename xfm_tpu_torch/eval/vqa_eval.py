"""VQA accuracy (`xfm_tpu/eval/vqa_eval.py`, the port's own copy): the
official VQAv2 protocol's answer normalization (contractions, digits,
punctuation, articles) and its accuracy, min(#matching humans / 3, 1)
averaged over the leave-one-out subsets of the human answers.
"""
from __future__ import annotations

import re
from typing import Dict, List

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't", "didnt": "didn't",
    "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "im": "i'm", "ive": "i've", "isnt": "isn't", "itd": "it'd",
    "itll": "it'll", "lets": "let's", "maam": "ma'am",
    "mightve": "might've", "mustve": "must've", "shant": "shan't",
    "shed": "she'd", "shes": "she's", "shouldve": "should've",
    "shouldnt": "shouldn't", "somebodyd": "somebody'd",
    "somebodyll": "somebody'll", "somebodys": "somebody's",
    "someoned": "someone'd", "someonell": "someone'll",
    "someones": "someone's", "somethingd": "something'd",
    "somethingll": "something'll", "thats": "that's",
    "thered": "there'd", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't",
    "wed": "we'd", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "wholl": "who'll", "whos": "who's", "whove": "who've",
    "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "yall": "y'all", "youd": "you'd", "youll": "you'll",
    "youre": "you're", "youve": "you've",
}
DIGITS = {"none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
          "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
          "nine": "9", "ten": "10"}
ARTICLES = {"a", "an", "the"}
_PUNCT = re.compile(r"[;/\[\]\"{}()=+\\_\-><@`,?!]")
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_IN_NUM = re.compile(r"(\d)(,)(\d)")


def process_answer(ans: str) -> str:
    """An answer normalized as the official evaluation does."""
    ans = ans.replace("\n", " ").replace("\t", " ").strip().lower()
    ans = _COMMA_IN_NUM.sub(r"\1\3", ans)
    ans = _PUNCT.sub("", ans)
    ans = _PERIOD_STRIP.sub("", ans)
    words = []
    for w in ans.split():
        w = DIGITS.get(w, w)
        if w in ARTICLES:
            continue
        words.append(CONTRACTIONS.get(w, w))
    return " ".join(words)


def vqa_accuracy(predictions: List[dict],
                 annotations: Dict[int, List[str]]) -> float:
    """predictions [{"question_id", "answer"}], annotations {question id:
    the human answers} → the mean official accuracy over the predictions
    whose question is annotated (0 where none is)."""
    accs = []
    for p in predictions:
        qid = int(p["question_id"])
        if qid not in annotations:
            continue
        pred = process_answer(p["answer"])
        gts = [process_answer(a) for a in annotations[qid]]
        per_subset = []
        for i in range(len(gts)):
            others = gts[:i] + gts[i + 1:]
            match = sum(1 for g in others if g == pred)
            per_subset.append(min(match / 3.0, 1.0))
        accs.append(sum(per_subset) / len(per_subset))
    return sum(accs) / max(len(accs), 1)
