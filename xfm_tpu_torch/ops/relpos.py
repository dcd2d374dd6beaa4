"""BEiT relative-position bias (`xfm_tpu/ops/relpos.py` `beit_rel_pos_bias`
and `compact_rel_pos`, `xfm_tpu/models/beit2.py` `relative_position_index`).

Built as gathers from the table; autograd's backward of a gather is a
scatter-add into the table.
"""
from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=8)
def _compact_table_index(wh: int, ww: int) -> np.ndarray:
    """[ww, 2wh−1, ww] rows of the table: (ci, e1, cj) →
    (2wh−2−e1)·(2ww−1) + ci−cj+ww−1."""
    ci = np.arange(ww)[:, None, None]
    e1 = np.arange(2 * wh - 1)[None, :, None]
    cj = np.arange(ww)[None, None, :]
    return (2 * wh - 2 - e1) * (2 * ww - 1) + ci - cj + ww - 1


def compact_rel_pos(table: torch.Tensor, wh: int, ww: int):
    """The block-Toeplitz compact form of the BEiT rel-pos bias
    (`xfm_tpu/ops/relpos.py` `compact_rel_pos`): table
    [(2wh−1)(2ww−1)+3, H] →
      cr   [H, ww, 2wh−1, ww] f32, cr[h, ci, e1, cj] =
           T2d[2wh−2−e1, ci−cj+ww−1, h] (the row-delta axis e1 reversed, so
           that query stripe a's bias rows are the contiguous slice at
           offset (wh−1−a)·ww of cr[h, ci] flattened);
      cls3 [H, 3] f32 = (cls→patch table[−3], patch→cls table[−2],
           cls→cls table[−1]).
    A gather, so autograd carries dcr and dcls back into the table."""
    idx = torch.from_numpy(_compact_table_index(wh, ww)).to(table.device)
    cr = table.float()[idx].permute(3, 0, 1, 2)
    cls3 = torch.stack([table[-3], table[-2], table[-1]], dim=-1).float()
    return cr, cls3


@functools.lru_cache(maxsize=8)
def _expanded_index(wh: int, ww: int) -> np.ndarray:
    """[N, N] positions in [c2a, a2c, cc, cr[ci, :] for ci < ww] (the compact
    form of one head, flattened) of each bias element."""
    L, P = (2 * wh - 1) * ww, wh * ww
    idx = np.empty((P + 1, P + 1), np.int64)
    idx[0, 0] = 2
    idx[0, 1:] = 0
    idx[1:, 0] = 1
    a, ci = np.divmod(np.arange(P), ww)
    idx[1:, 1:] = (3 + ci[:, None] * L + (wh - 1 - a)[:, None] * ww
                   + np.arange(P)[None, :])
    return idx


def expand_compact_rel_pos(cr: torch.Tensor, cls3: torch.Tensor,
                           window: tuple[int, int]) -> torch.Tensor:
    """The bias that the compact form stands for (`xfm_tpu/ops/
    flash_attention.py` `_relpos_scr_build`): cr [H, ww, (2wh−1)·ww] and
    cls3 [H, 3] → [1, H, N, N] in their common dtype, with bias[0, 0] = cc,
    bias[0, 1:] = c2a, bias[1:, 0] = a2c and
    bias[1 + a·ww + ci, 1 + j] = cr[h, ci, (wh−1−a)·ww + j]."""
    wh, ww = window
    flat = torch.cat([cls3.to(cr.dtype), cr.reshape(cr.shape[0], -1)], dim=1)
    idx = torch.from_numpy(_expanded_index(wh, ww)).to(cr.device)
    return flat[:, idx].unsqueeze(0)
