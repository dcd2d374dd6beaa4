"""Swin Transformer vision tower (`xfm_tpu/models/swin.py`), X-FM's third
vision encoder: window attention with a per-block relative-position table,
shifted windows on odd blocks, patch merging between stages, and the
readout [avgpool ‖ final-stage tokens] of width 8 × embed_dim.

Parameter names are the reference torch names (`patch_embed.proj`,
`patch_embed.norm`, `layers.{s}.blocks.{b}.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}`,
`layers.{s}.downsample.{norm, reduction}`, `norm`); the patch kernel
`patch_embed.proj.weight` is kept in matmul layout [P·P·3, C]
(`train/checkpoint.py` converts the reference's Conv2d weight). The
reference's `relative_position_index` and `attn_mask` are buffers that the
port derives and never loads.

The windows hold 49, 144 or 225 tokens (window 7, 12, 15), below K3's 512,
so every window attention is the plain attention, as in the JAX package.
A shifted block adds its shift mask to the rel-pos bias as one
[nw, H, ws², ws²] f32 bias, added to the scores viewed as
[B, nw, H, ws², ws²]: the JAX package broadcasts the bias to B·nw rows
first, which at 384 px, B = 32 is 680 MB a shifted stage-0 block; the
values are the same.

Under a tensor cut (`core/partitioning.cut_model`: `tp` on each block) a
rank holds the q, k and v rows of its nH/T heads of `qkv` (weight and
bias) and `fc1`'s rows, and the matching columns of `proj` and `fc2`;
the window attention runs at nH/T heads with the table's columns of those
heads (`head_columns`), and each pair's partial sums are summed over the
group before the bias (`ops/tensor_parallel.row_output`). T must divide
the heads of every stage.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..core.precision import act_row_dense, dense, layer_norm, row_dense
from ..ops.attention import NEG_INF
from ..ops.dropout import drop_path
from ..ops.patch_embed import extract_patches
from ..ops.relpos import beit_rel_pos_bias
from ..ops.tensor_parallel import copy_to_tensor, head_columns
from .beit2 import _PatchProj


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    image_res: int = 224
    patch_size: int = 4
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 7
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.1
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def num_features(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)


def window_partition(x, ws: int):
    """[B, H, W, C] (a tensor or a numpy array) → [B·nw, ws², C], windows
    row-major. H and W must be multiples of `ws`."""
    B, H, W, C = x.shape
    if H % ws or W % ws:
        # the reference's Swin has no padding either; its configs pick
        # window sizes that divide every stage
        raise ValueError(
            f"stage resolution {H}x{W} is not divisible by window_size "
            f"{ws}; pick a window size dividing image_res/patch_size and "
            "all its /2 stage reductions (e.g. 224→7, 384→12, 480→15)")
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.transpose(2, 3).reshape(-1, ws * ws, C) if torch.is_tensor(x) \
        else x.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(wins: torch.Tensor, ws: int, H: int, W: int
                   ) -> torch.Tensor:
    """The inverse of `window_partition`: [B·nw, ws², C] → [B, H, W, C]."""
    B = wins.shape[0] // (H * W // ws // ws)
    x = wins.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.transpose(2, 3).reshape(B, H, W, -1)


def swin_rel_pos_index(ws: int) -> np.ndarray:
    """[ws², ws²] rows of the table [(2ws−1)², H]: (dh + ws − 1)·(2ws − 1) +
    dw + ws − 1 for the row and column offsets (dh, dw) of query and key."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_attn_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """[nw, ws², ws²] f32 additive mask of the shifted windows: 0 between
    tokens of one region of the rolled image, NEG_INF across regions."""
    img = np.zeros((1, H, W, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    wins = window_partition(img, ws).reshape(-1, ws * ws)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff == 0, 0.0, NEG_INF).astype(np.float32)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, scale: float) -> torch.Tensor:
    """The plain attention (`ops/attention.py` `attention_reference`'s
    rounding points) over q/k/v [B·nw, N, H, D] with a per-window bias
    [1|nw, H, N, N] f32, added to the scores viewed as [B, nw, H, N, N]."""
    dt = q.dtype
    qs = (q.float() * scale).to(dt)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    shape = logits.shape
    logits = (logits.reshape(-1, bias.shape[0], *shape[1:]) + bias).view(
        shape)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dt).float(),
                        v.float()).to(dt)


class _WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, ws: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(swin_rel_pos_index(ws)),
                             persistent=False)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinBlock(nn.Module):
    """One block at stage resolution (H, W): the window is
    min(window_size, H, W) and the shift is 0 where the window covers the
    stage (at 384 px, window 12, the 12 × 12 last stage)."""

    def __init__(self, c: SwinConfig, dim: int, num_heads: int,
                 resolution: Tuple[int, int], shift: int = 0,
                 drop_path: float = 0.0):
        super().__init__()
        self.c = c
        H, W = resolution
        self.resolution = resolution
        self.ws = min(c.window_size, H, W)
        self.shift = shift if self.ws < min(H, W) else 0
        self.num_heads = num_heads
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=c.layer_norm_eps)
        self.attn = _WindowAttention(dim, num_heads, self.ws)
        self.norm2 = nn.LayerNorm(dim, eps=c.layer_norm_eps)
        self.mlp = _Mlp(dim, int(dim * c.mlp_ratio))
        if self.shift > 0:
            self.register_buffer("attn_mask", torch.from_numpy(
                shift_attn_mask(H, W, self.ws, self.shift)),
                persistent=False)
        self.tp = None  # the tensor cut (`core/partitioning.cut_model`)

    def forward(self, x: torch.Tensor, deterministic: bool = True):
        c, tp, shift = self.c, self.tp, self.shift
        H, W = self.resolution
        h = layer_norm(x, self.norm1, c.dtype)
        out = row_dense(self.attend(h), self.attn.proj, c.dtype, tp)
        h = window_reverse(out, self.ws, H, W)
        if shift > 0:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = x + drop_path(h.reshape(x.shape), self.drop_path, deterministic)
        h = layer_norm(x, self.norm2, c.dtype)
        h = dense(copy_to_tensor(h, tp), self.mlp.fc1, c.dtype)
        h = act_row_dense(h, self.mlp.fc2, "gelu", c.dtype, cut=tp)
        return x + drop_path(h, self.drop_path, deterministic)

    def attend(self, h):
        """The window attention of this rank's nH/T heads over the
        normalized rows h [B, L, C], before `proj`: [B·nw, ws², (nH/T)·D]
        (the shifted windows where the block shifts)."""
        c, ws, shift, tp = self.c, self.ws, self.shift, self.tp
        H, W = self.resolution
        B, L, C = h.shape
        D = C // self.num_heads
        nH = self.num_heads if tp is None else tp.heads(self.num_heads)
        a = self.attn
        h = copy_to_tensor(h, tp).reshape(B, H, W, C)
        if shift > 0:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        qkv = dense(window_partition(h, ws), a.qkv, c.dtype)
        q, k, v = (t.reshape(-1, ws * ws, nH, D)
                   for t in qkv.split(nH * D, -1))
        # [1, H, ws², ws²] f32 from the table widened to f32, as the JAX
        # package builds it; the shift mask added once per window
        bias = beit_rel_pos_bias(
            head_columns(a.relative_position_bias_table, tp).float(),
            a.relative_position_index)
        if shift > 0:
            bias = bias + self.attn_mask[:, None]
        return window_attention(q, k, v, bias, D ** -0.5).reshape(
            -1, ws * ws, nH * D)


class PatchMerging(nn.Module):
    def __init__(self, c: SwinConfig, dim: int,
                 resolution: Tuple[int, int]):
        super().__init__()
        self.c = c
        self.resolution = resolution
        self.norm = nn.LayerNorm(4 * dim, eps=c.layer_norm_eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = self.resolution
        B, _, C = x.shape
        # channel order (0,0), (1,0), (0,1), (1,1): the reference
        # concatenates x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2],
        # x[1::2, 1::2] (the row offset varies fastest); imported reduction
        # weights depend on it
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
        x = layer_norm(x.reshape(B, (H // 2) * (W // 2), 4 * C), self.norm,
                       self.c.dtype)
        return dense(x, self.reduction, self.c.dtype)


class _Stage(nn.Module):
    def __init__(self, blocks, downsample=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        if downsample is not None:
            self.downsample = downsample


class _PatchEmbed(nn.Module):
    def __init__(self, c: SwinConfig):
        super().__init__()
        self.proj = _PatchProj(c.patch_size * c.patch_size * 3, c.embed_dim)
        self.norm = nn.LayerNorm(c.embed_dim, eps=c.layer_norm_eps)


class SwinTransformer(nn.Module):
    def __init__(self, c: SwinConfig):
        super().__init__()
        self.c = c
        self.patch_embed = _PatchEmbed(c)
        H = W = c.image_res // c.patch_size
        dpr = np.linspace(0, c.drop_path_rate, sum(c.depths))
        di = 0
        stages = []
        for si, (depth, heads) in enumerate(zip(c.depths, c.num_heads)):
            dim = c.embed_dim * 2 ** si
            blocks = []
            for bi in range(depth):
                blocks.append(SwinBlock(
                    c, dim, heads, (H, W),
                    shift=0 if bi % 2 == 0 else min(c.window_size, H, W) // 2,
                    drop_path=float(dpr[di])))
                di += 1
            down = None
            if si < len(c.depths) - 1:
                down = PatchMerging(c, dim, (H, W))
                H, W = H // 2, W // 2
            stages.append(_Stage(blocks, down))
        self.layers = nn.ModuleList(stages)
        self.norm = nn.LayerNorm(c.num_features, eps=c.layer_norm_eps)

    def forward(self, images, mask=None, idx_to_group_img=None,
                image_atts=None, deterministic: bool = True):
        """NHWC images [B, H, W, 3] → [B, 1 + (res/32)², 8·embed_dim]:
        [mean ‖ final-stage tokens]. Region mode (`idx_to_group_img` [R],
        the image of each region, and `image_atts` [R, 1 + tokens], its
        token mask) → (each region's copy of its image's tokens with their
        mean over the mask in the first slot, the images' rows). A MIM mask
        raises: the reference Swin takes none."""
        if mask is not None:
            raise NotImplementedError(
                "Swin has no MIM mask path — use the BEiT-2 backbone for "
                "ret_mim / use_vision_tokenizer pretraining")
        c = self.c
        p = self.patch_embed.proj
        x = extract_patches(images.to(c.dtype), c.patch_size)
        x = x @ p.weight.to(c.dtype) + p.bias.to(c.dtype)
        x = layer_norm(x, self.patch_embed.norm, c.dtype)
        for stage in self.layers:
            for blk in stage.blocks:
                x = blk(x, deterministic)
            if hasattr(stage, "downsample"):
                x = stage.downsample(x)
        x = layer_norm(x, self.norm, c.dtype)
        full = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        if idx_to_group_img is None:
            return full
        xg = x[idx_to_group_img]
        w = image_atts[:, 1:].to(xg.dtype)[..., None]
        pooled = (xg * w).sum(dim=1, keepdim=True) / torch.clamp(
            w.sum(dim=1, keepdim=True), min=1e-6)
        return torch.cat([pooled, xg], dim=1), full
