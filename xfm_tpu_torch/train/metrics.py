"""Metric logging (`xfm_tpu/train/metrics.py`): `SmoothedValue`, a windowed
and global average, and `MetricLogger`, which holds one per name and prints
the rate of a loop every `print_freq` steps. Printing is left to rank 0
(`core/mesh`); the global averages are summed across the process group by
`synchronize_between_processes` (in one all-reduce on the device of the
group's collectives), or read so without changing the meters by
`synced_global_avg`."""
from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Iterable

import numpy as np
import torch

from ..core import mesh


def is_main_process() -> bool:
    """Rank 0 of the process group (true on one process)."""
    return mesh.rank() == 0


def _summed(pairs: list) -> list:
    """[(count, total), ...] summed over the process group in one
    all-reduce (`mesh.all_reduce_sum`); as they are on one process. Every
    rank must pass the same names."""
    if not mesh.is_distributed() or not pairs:
        return [(int(c), float(t)) for c, t in pairs]
    t = mesh.all_reduce_sum(torch.tensor(
        pairs, dtype=torch.float64, device=mesh.collective_device()))
    return [(int(c), float(s)) for c, s in t.tolist()]


class SmoothedValue:
    """The last `window_size` values and the count and total of all."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """Sum [count, total] over the process group (no-op alone)."""
        self.count, self.total = _summed([(self.count, self.total)])[0]

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg,
                               value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def synchronize_between_processes(self):
        """Every meter's [count, total] summed over the process group."""
        names = sorted(self.meters)
        summed = _summed([(self.meters[k].count, self.meters[k].total)
                          for k in names])
        for k, (count, total) in zip(names, summed):
            self.meters[k].count, self.meters[k].total = count, total

    def synced_global_avg(self) -> dict[str, float]:
        """`global_avg` of the meters summed over the process group, the
        meters left as they are (so that it may be read at every log
        line)."""
        if not mesh.is_distributed():
            return self.global_avg()
        names = sorted(self.meters)
        summed = _summed([(self.meters[k].count, self.meters[k].total)
                          for k in names])
        return {k: total / max(count, 1)
                for k, (count, total) in zip(names, summed)}

    def __getattr__(self, name):
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in
                                   self.meters.items())

    def global_avg(self) -> dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: int | None = None):
        """Yield the items, printing the meters, the rate and the ETA every
        `print_freq` items and the loop's time at its end."""
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            end = time.time()
            if i % print_freq == 0 and is_main_process():
                eta = ""
                if total:
                    secs = iter_time.global_avg * (total - i)
                    eta = f" eta: {datetime.timedelta(seconds=int(secs))}"
                print(f"{header} [{i}{f'/{total}' if total else ''}]{eta}  "
                      f"{self}  iter: {iter_time}  data: {data_time}",
                      flush=True)
        if is_main_process():
            span = datetime.timedelta(seconds=int(time.time() - start))
            print(f"{header} Total time: {span}", flush=True)
