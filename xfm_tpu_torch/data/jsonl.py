"""Sharded JSONL line reader (`xfm_tpu/data/jsonl.py`).

The file list is sorted, shuffled at file granularity by
`np.random.default_rng(seed + epoch)` each epoch, and split by contiguous
range across the data ranks; the stream repeats forever unless `repeat`
is off. Lines that do not parse as JSON are skipped.
"""
from __future__ import annotations

import json
from typing import Iterator, Sequence

import numpy as np

from .io import list_files, open_file


def split_shard(items: Sequence, rank: int, world_size: int):
    """Rank `rank`'s contiguous range of `items`."""
    n = len(items)
    if n < world_size:
        raise RuntimeError(f"{n} shards < {world_size} ranks")
    start = (rank * n) // world_size
    end = ((rank + 1) * n) // world_size
    return items[start:end]


class ShardedLineReader:
    """Iterator over the non-empty lines of a rank's JSONL shards."""

    def __init__(self, files: str | Sequence[str], rank: int = 0,
                 world_size: int = 1, shuffle: bool = True,
                 repeat: bool = True, seed: int = 0):
        if isinstance(files, str):
            files = [files]
        expanded: list[str] = []
        for f in files:
            expanded.extend(list_files(f))
        if not expanded:
            raise FileNotFoundError(f"no data files matched {files}")
        self.files = sorted(expanded)
        self.rank, self.world_size = rank, world_size
        self.shuffle, self.repeat = shuffle, repeat
        self.seed = seed

    def __iter__(self) -> Iterator[str]:
        epoch = 0
        while True:
            files = list(self.files)
            if self.shuffle:
                np.random.default_rng(self.seed + epoch).shuffle(files)
            for path in split_shard(files, self.rank, self.world_size):
                with open_file(path, "r") as fh:
                    for line in fh:
                        line = line.strip()
                        if line:
                            yield line
            epoch += 1
            if not self.repeat:
                return

    def iter_json(self) -> Iterator[dict]:
        for line in self:
            try:
                item = json.loads(line)
            except json.JSONDecodeError:
                continue  # a broken line is skipped
            yield item
