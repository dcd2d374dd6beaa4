"""Metric logging (`xfm_tpu/train/metrics.py`): `SmoothedValue`, a windowed
and global average, and `MetricLogger`, which holds one per name and prints
the rate of a loop every `print_freq` steps. Printing is left to process 0
(rank 0 of an initialized process group); the global averages are summed
across the group by `synchronize_between_processes`."""
from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Iterable

import numpy as np


def _group():
    """The initialized default process group's torch.distributed, or
    None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def is_main_process() -> bool:
    """Rank 0 of an initialized process group, else true (one process)."""
    dist = _group()
    return dist is None or dist.get_rank() == 0


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
        dist = _group()
        if dist is None or dist.get_world_size() == 1:
            return
        import torch

        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        t = torch.tensor([self.count, self.total], dtype=torch.float64,
                         device=dev)
        dist.all_reduce(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

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
        for m in self.meters.values():
            m.synchronize_between_processes()

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
