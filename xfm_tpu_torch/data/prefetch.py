"""Host batches prefetched on a thread and copied to the device one batch
ahead (`xfm_tpu/data/prefetch.py` `Prefetcher`; `DeviceBatches` in place
of its `device_batches`).

A daemon thread runs the host iterator (decode, augment, collate) and turns
each batch into torch tensors, pinned when the device is a CUDA card; it
makes no other CUDA call. The consuming thread issues the copy of the next
batch (`.to(device, non_blocking=True)`, on its current stream, the one the
step runs on) before it hands out the current one, and holds each host
batch until the step that reads it has been enqueued.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch


class Prefetcher:
    """Wrap an iterator; a daemon thread keeps `depth` items ready. An error
    in the thread is raised again where the item would have come."""

    _SENTINEL = object()

    def __init__(self, iterable: Iterable, depth: int = 2):
        self.it = iter(iterable)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.err: BaseException | None = None
        self.closed = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            for item in self.it:
                if self.closed:
                    return
                self.q.put(item)
                if self.closed:
                    return
        except BaseException as e:  # raised again on the consuming side
            self.err = e
        finally:
            if not self.closed:
                self.q.put(self._SENTINEL)

    def close(self):
        """Stop the producer: drain once so that a blocked put returns."""
        self.closed = True
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass

    def __iter__(self) -> Iterator:
        while True:
            item = self.q.get()
            if item is self._SENTINEL:
                if self.err is not None:
                    raise self.err
                return
            yield item


def _host_tensors(batch: dict, pin: bool) -> dict:
    """A numpy batch → CPU tensors (integers as int64), pinned if `pin`."""
    out = {}
    for k, v in batch.items():
        a = np.ascontiguousarray(v)
        t = torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu"
                             else a)
        out[k] = t.pin_memory() if pin else t
    return out


class DeviceBatches:
    """Host numpy batches → device tensor batches, prefetched `depth` deep
    on a daemon thread; the copy of batch i + 1 is issued before batch i is
    handed out. `close()` stops the producer thread."""

    def __init__(self, loader: Iterable, device, depth: int = 2):
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        self.prefetcher = Prefetcher(
            (_host_tensors(b, pin) for b in loader), depth=depth)

    def _issue(self, host):
        if host is None:
            return None
        return host, {k: v.to(self.device, non_blocking=True)
                      for k, v in host.items()}

    def __iter__(self) -> Iterator[dict]:
        it = iter(self.prefetcher)
        nxt = self._issue(next(it, None))
        while nxt is not None:
            cur = nxt
            nxt = self._issue(next(it, None))
            yield cur[1]
            # the step on cur has been enqueued: its host batch may go
            del cur

    def close(self):
        self.prefetcher.close()

