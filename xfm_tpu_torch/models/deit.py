"""DeiT / plain ViT vision tower (`xfm_tpu/models/deit.py`), the reference's
legacy encoder (reference models/vit.py, timm-style): a patch embedding, a
cls token and a learned absolute `pos_embed`, pre-LN blocks, a final
LayerNorm at eps 1e-6; the readout is [cls ‖ patches], the real cls token
first.

Parameter names are the reference's timm names (`patch_embed.proj`,
`cls_token`, `pos_embed`, `blocks.{i}.{norm1, attn.qkv, attn.proj, norm2,
mlp.fc1, mlp.fc2}`, `norm`); the patch kernel `patch_embed.proj.weight` is
kept in matmul layout [P·P·3, C] (`train/checkpoint.py` converts the
reference's Conv2d weight). Each self-attention takes
`dot_product_attention` over views of the qkv projection, so at N ≥ 512
(384 px: N = 577, no bias) it is the long-sequence kernel K3, forward and
backward. `register_blk` / `prob_gate` multiply one block's attention
probabilities (the GradCAM hook of reference models/vit.py), on the plain
route.

Under a tensor cut (`core/partitioning.cut_model`: `tp` on each block) a
rank holds the q, k and v rows of its H/T heads of `qkv` (weight and
bias) and `fc1`'s rows, and the matching columns of `proj` and `fc2`: K3
runs at H/T heads, forward and backward, and each pair's partial sums are
summed over the group before the bias (`ops/tensor_parallel.row_output`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..core.precision import act_row_dense, dense, layer_norm, row_dense
from ..ops.attention import dot_product_attention
from ..ops.dropout import dropout
from ..ops.patch_embed import extract_patches
from ..ops.tensor_parallel import copy_to_tensor
from .beit2 import _Mlp, _PatchEmbed


@dataclasses.dataclass(frozen=True)
class DeitConfig:
    image_res: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    drop_rate: float = 0.0
    dtype: torch.dtype = torch.float32

    @property
    def grid_size(self) -> int:
        return self.image_res // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2


class _Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class DeitBlock(nn.Module):
    def __init__(self, c: DeitConfig):
        super().__init__()
        self.c = c
        C = c.embed_dim
        self.norm1 = nn.LayerNorm(C, eps=c.layer_norm_eps)
        self.attn = _Attention(C)
        self.norm2 = nn.LayerNorm(C, eps=c.layer_norm_eps)
        self.mlp = _Mlp(c)
        self.tp = None  # the tensor cut (`core/partitioning.cut_model`)

    def forward(self, x: torch.Tensor, prob_gate=None,
                deterministic: bool = True) -> torch.Tensor:
        c = self.c
        h = layer_norm(x, self.norm1, c.dtype)
        out = row_dense(self.attend(h, prob_gate, deterministic),
                        self.attn.proj, c.dtype, self.tp)
        x = x + dropout(out, c.drop_rate, deterministic)
        h = layer_norm(x, self.norm2, c.dtype)
        h = dense(copy_to_tensor(h, self.tp), self.mlp.fc1, c.dtype)
        h = act_row_dense(h, self.mlp.fc2, "gelu", c.dtype, cut=self.tp)
        return x + dropout(h, c.drop_rate, deterministic)

    def attend(self, h, prob_gate=None, deterministic: bool = True):
        """The attention of this rank's heads over the normalized rows h
        before `proj`: [B, N, (H/T)·D] (all heads where not cut)."""
        c, tp = self.c, self.tp
        B, N, C = h.shape
        H = c.num_heads
        hl, D = (H if tp is None else tp.heads(H)), C // H
        if tp is not None and prob_gate is not None \
                and prob_gate.shape[1] > 1:
            first = tp.head_range(H)[0]
            prob_gate = prob_gate[:, first:first + hl]
        h = copy_to_tensor(h, tp)
        # [B, N, H, D] views of the projection: K3 reads them in place
        q, k, v = (t.reshape(B, N, hl, D) for t in
                   dense(h, self.attn.qkv, c.dtype).split(hl * D, -1))
        return dot_product_attention(q, k, v, prob_gate=prob_gate,
                                     deterministic=deterministic
                                     ).reshape(B, N, hl * D)


class DeitVisionTransformer(nn.Module):
    def __init__(self, c: DeitConfig):
        super().__init__()
        self.c = c
        C = c.embed_dim
        self.patch_embed = _PatchEmbed(c)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_embed = nn.Parameter(torch.zeros(1, c.num_patches + 1, C))
        self.blocks = nn.ModuleList(DeitBlock(c) for _ in range(c.depth))
        self.norm = nn.LayerNorm(C, eps=c.layer_norm_eps)

    def forward(self, images, mask=None, idx_to_group_img=None,
                image_atts=None, register_blk: int = -1,
                prob_gate: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        """NHWC images [B, H, W, 3] → [B, 1 + num_patches, C], the cls
        token first; `prob_gate` multiplies the attention probabilities of
        block `register_blk` alone. A MIM mask or region mode
        (`idx_to_group_img`) raises, as in the JAX package: the reference
        has neither. `image_atts` alone is taken and unused."""
        if mask is not None or idx_to_group_img is not None:
            raise NotImplementedError(
                "DeiT (use_deit) has no MIM mask or region mode — use the "
                "BEiT-2 backbone (reference models/vit.py has neither)")
        c = self.c
        p = self.patch_embed.proj
        x = extract_patches(images.to(c.dtype), c.patch_size)
        x = x @ p.weight.to(c.dtype) + p.bias.to(c.dtype)
        B, _, C = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, C), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        for i, blk in enumerate(self.blocks):
            x = blk(x, prob_gate if i == register_blk else None,
                    deterministic)
        return layer_norm(x, self.norm, c.dtype)
