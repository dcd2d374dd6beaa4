"""BEiT block-wise MIM masking (`xfm_tpu/data/block_masking.py`).

Grows random rectangles (area and log-aspect drawn uniformly) until the
mask holds `num_masking_patches` patches, then trims or pads it to exactly
that count. Host numpy, every draw from the generator it is given; the
[num_patches] bool rows feed the BEiT tower's `mask`.
"""
from __future__ import annotations

import math

import numpy as np


class BlockMaskingGenerator:
    def __init__(self, input_size: int | tuple[int, int],
                 num_masking_patches: int = 75, min_num_patches: int = 16,
                 max_num_patches: int | None = None, min_aspect: float = 0.3,
                 max_aspect: float | None = None,
                 rng: np.random.Generator | None = None):
        if not isinstance(input_size, tuple):
            input_size = (input_size, input_size)
        self.height, self.width = input_size
        self.num_patches = self.height * self.width
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (num_masking_patches if max_num_patches is None
                                else max_num_patches)
        max_aspect = max_aspect or 1.0 / min_aspect
        self.log_aspect = (math.log(min_aspect), math.log(max_aspect))
        self.rng = rng if rng is not None else np.random.default_rng()

    def _add_block(self, mask: np.ndarray, budget: int) -> int:
        """Up to 10 tries to place one rectangle that adds at most `budget`
        new patches → the number added."""
        lo = min(self.min_num_patches, budget)
        hi = max(self.min_num_patches, budget)
        for _ in range(10):
            area = self.rng.uniform(lo, hi)
            ar = math.exp(self.rng.uniform(*self.log_aspect))
            h = int(round(math.sqrt(area * ar)))
            w = int(round(math.sqrt(area / ar)))
            if w >= self.width or h >= self.height:
                continue
            top = self.rng.integers(0, self.height - h, endpoint=True)
            left = self.rng.integers(0, self.width - w, endpoint=True)
            region = mask[top:top + h, left:left + w]
            fresh = h * w - int(region.sum())
            if 0 < fresh <= budget:
                region[:] = 1
                return fresh
        return 0

    def __call__(self) -> np.ndarray:
        """→ an [H, W] int32 mask of exactly num_masking_patches ones."""
        mask = np.zeros((self.height, self.width), np.int32)
        count = 0
        while count < self.num_masking_patches:
            budget = min(self.num_masking_patches - count,
                         self.max_num_patches)
            delta = self._add_block(mask, budget)
            if delta == 0:
                break
            count += delta
        if count > self.num_masking_patches:
            on = np.flatnonzero(mask)
            off = self.rng.choice(on, count - self.num_masking_patches,
                                  replace=False)
            mask.flat[off] = 0
        elif count < self.num_masking_patches:
            zeros = np.flatnonzero(mask == 0)
            on = self.rng.choice(zeros, self.num_masking_patches - count,
                                 replace=False)
            mask.flat[on] = 1
        return mask

    def batch(self, n: int) -> np.ndarray:
        """→ [n, num_patches] bool."""
        return np.stack([self().reshape(-1).astype(bool) for _ in range(n)])
