"""GLUE metrics in numpy (`xfm_tpu/eval/glue_metrics.py`, in place of the
reference's Hugging Face `load_metric("glue", task)`, run_glue.py:
138-143)."""
from __future__ import annotations

import numpy as np


def accuracy(preds, labels):
    preds, labels = np.asarray(preds), np.asarray(labels)
    return float((preds == labels).mean())


def f1(preds, labels, positive=1):
    preds, labels = np.asarray(preds), np.asarray(labels)
    tp = int(((preds == positive) & (labels == positive)).sum())
    fp = int(((preds == positive) & (labels != positive)).sum())
    fn = int(((preds != positive) & (labels == positive)).sum())
    if tp == 0:
        return 0.0
    p = tp / (tp + fp)
    r = tp / (tp + fn)
    return float(2 * p * r / (p + r))


def matthews_corrcoef(preds, labels):
    preds, labels = np.asarray(preds), np.asarray(labels)
    tp = float(((preds == 1) & (labels == 1)).sum())
    tn = float(((preds == 0) & (labels == 0)).sum())
    fp = float(((preds == 1) & (labels == 0)).sum())
    fn = float(((preds == 0) & (labels == 1)).sum())
    denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return float((tp * tn - fp * fn) / denom) if denom else 0.0


def pearson(preds, labels):
    preds, labels = np.asarray(preds, float), np.asarray(labels, float)
    if preds.std() == 0 or labels.std() == 0:
        return 0.0
    return float(np.corrcoef(preds, labels)[0, 1])


def spearman(preds, labels):
    """Pearson's r of the ranks, ties given their mean rank."""
    def rank(x):
        _, inv, counts = np.unique(x, return_inverse=True,
                                   return_counts=True)
        last = np.cumsum(counts) - 1
        return ((last - counts + 1 + last) / 2.0)[inv]

    return pearson(rank(np.asarray(preds, float)),
                   rank(np.asarray(labels, float)))


TASK_METRICS = {
    "cola": lambda p, l: {"matthews_correlation": matthews_corrcoef(p, l)},
    "sst2": lambda p, l: {"accuracy": accuracy(p, l)},
    "mrpc": lambda p, l: {"accuracy": accuracy(p, l), "f1": f1(p, l)},
    "stsb": lambda p, l: {"pearson": pearson(p, l),
                          "spearmanr": spearman(p, l)},
    "qqp": lambda p, l: {"accuracy": accuracy(p, l), "f1": f1(p, l)},
    "mnli": lambda p, l: {"accuracy": accuracy(p, l)},
    "qnli": lambda p, l: {"accuracy": accuracy(p, l)},
    "rte": lambda p, l: {"accuracy": accuracy(p, l)},
    "wnli": lambda p, l: {"accuracy": accuracy(p, l)},
}


def compute(task: str, preds, labels) -> dict:
    """The task's metrics of `preds` (class ids, or STS-B's scores)
    against `labels`."""
    return TASK_METRICS[task](preds, labels)
