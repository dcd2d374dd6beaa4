"""BEiT relative-position bias (`xfm_tpu/ops/relpos.py` `beit_rel_pos_bias`,
`xfm_tpu/models/beit2.py` `relative_position_index`).

Built as a gather from the table; autograd's backward of the gather is a
scatter-add into the table.
"""
from __future__ import annotations

import numpy as np
import torch


def relative_position_index(window: tuple[int, int]) -> np.ndarray:
    """[N+1, N+1] index into the rel-pos table, including the 3 cls
    distances (row 0 = cls→patch, column 0 = patch→cls, [0, 0] = cls→cls)."""
    wh, ww = window
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    idx = np.zeros((wh * ww + 1, wh * ww + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel - 3
    idx[0:, 0] = num_rel - 2
    idx[0, 0] = num_rel - 1
    return idx


def num_relative_distance(window: tuple[int, int]) -> int:
    return (2 * window[0] - 1) * (2 * window[1] - 1) + 3


def beit_rel_pos_bias(table: torch.Tensor,
                      index: torch.Tensor) -> torch.Tensor:
    """table [num_rel, H], index [N, N] (int64) → bias [1, H, N, N] in the
    table's dtype."""
    n = index.shape[0]
    bias = table[index.reshape(-1)].reshape(n, n, -1)
    return bias.permute(2, 0, 1).unsqueeze(0).contiguous()
