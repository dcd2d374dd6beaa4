"""BEiT-2 vision tower (`xfm_tpu/models/beit2.py`), BEiT backbone only.

Parameter names are the reference torch names (`vision_encoder.blocks.{i}.
attn.qkv.weight`, ...). The patch embedding is a matmul over NHWC patches;
its kernel `patch_embed.proj.weight` is kept in matmul layout [P·P·3, C]
(`train/checkpoint.py` converts the reference's Conv2d weight).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..core.precision import add_layer_norm, dense, layer_norm
from ..ops.activations import ACT
from ..ops.flash_attention import (beit_attention_relpos,
                                   flash_attention_packed, relpos_inkernel_ok)
from ..ops.patch_embed import extract_patches
from ..ops.relpos import (beit_rel_pos_bias, num_relative_distance,
                          relative_position_index)


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_res: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    init_values: float = 0.1         # LayerScale init
    hidden_act: str = "gelu"
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32

    @property
    def grid_size(self) -> int:
        return self.image_res // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2


def _check_deterministic(rate: float, deterministic: bool, what: str):
    if not deterministic and rate > 0.0:
        raise NotImplementedError(f"{what} with a live rate is not ported yet")


class BeitAttention(nn.Module):
    def __init__(self, c: VisionConfig):
        super().__init__()
        self.c = c
        C, H = c.embed_dim, c.num_heads
        self.qkv = nn.Linear(C, 3 * C, bias=False)
        if c.qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(C))
            self.v_bias = nn.Parameter(torch.zeros(C))
        window = (c.grid_size, c.grid_size)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(num_relative_distance(window), H))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window)),
            persistent=False)
        self.proj = nn.Linear(C, C)

    def forward(self, x: torch.Tensor, deterministic: bool = True):
        c = self.c
        _check_deterministic(c.attn_drop_rate, deterministic,
                             "attention dropout")
        _check_deterministic(c.drop_rate, deterministic, "dropout")
        H = c.num_heads
        D = x.shape[-1] // H
        qkv = dense(x, self.qkv, c.dtype)
        if c.qkv_bias:
            qkv = qkv + torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                                   self.v_bias]).to(qkv.dtype)
        table = self.relative_position_bias_table
        window = (c.grid_size, c.grid_size)
        if relpos_inkernel_ok(x.shape[1], window):
            # N >= 512: K2 expands the compact table in the kernel; the
            # table is rounded to the compute dtype (the JAX package rounds
            # it to bf16 on its accelerator)
            out = beit_attention_relpos(qkv, table, window, D ** -0.5, H,
                                        c.dtype)
        else:
            # the materialized bias stays f32, as in the JAX package
            bias = beit_rel_pos_bias(table, self.relative_position_index)
            out = flash_attention_packed(qkv, bias, D ** -0.5, H)
        return dense(out, self.proj, c.dtype)


class _Mlp(nn.Module):
    def __init__(self, c: VisionConfig):
        super().__init__()
        self.fc1 = nn.Linear(c.embed_dim, int(c.embed_dim * c.mlp_ratio))
        self.fc2 = nn.Linear(int(c.embed_dim * c.mlp_ratio), c.embed_dim)


class BeitBlock(nn.Module):
    def __init__(self, c: VisionConfig, drop_path: float = 0.0):
        super().__init__()
        self.c = c
        self.drop_path = drop_path
        C = c.embed_dim
        self.norm1 = nn.LayerNorm(C, eps=c.layer_norm_eps)
        self.attn = BeitAttention(c)
        self.norm2 = nn.LayerNorm(C, eps=c.layer_norm_eps)
        self.mlp = _Mlp(c)
        self.use_ls = bool(c.init_values and c.init_values > 0)
        if self.use_ls:
            self.gamma_1 = nn.Parameter(torch.full((C,), c.init_values))
            self.gamma_2 = nn.Parameter(torch.full((C,), c.init_values))

    def forward(self, x: torch.Tensor, deterministic: bool = True):
        c = self.c
        _check_deterministic(self.drop_path, deterministic, "drop-path")
        h = layer_norm(x, self.norm1, c.dtype)
        h = self.attn(h, deterministic)
        if self.use_ls:
            h = self.gamma_1.to(h.dtype) * h
        x, h = add_layer_norm(h, x, self.norm2, c.dtype)
        h = dense(h, self.mlp.fc1, c.dtype)
        h = dense(ACT[c.hidden_act](h), self.mlp.fc2, c.dtype)
        if self.use_ls:
            h = self.gamma_2.to(h.dtype) * h
        return x + h


class _PatchProj(nn.Module):
    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))


class _PatchEmbed(nn.Module):
    def __init__(self, c: VisionConfig):
        super().__init__()
        self.proj = _PatchProj(c.patch_size * c.patch_size * 3, c.embed_dim)


class BeitVisionTransformer(nn.Module):
    def __init__(self, c: VisionConfig):
        super().__init__()
        self.c = c
        C = c.embed_dim
        self.patch_embed = _PatchEmbed(c)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.mask_token = nn.Parameter(torch.zeros(1, 1, C))
        dpr = torch.linspace(0, c.drop_path_rate, c.depth).tolist()
        self.blocks = nn.ModuleList(BeitBlock(c, dpr[i])
                                    for i in range(c.depth))
        self.fc_norm = nn.LayerNorm(C, eps=c.layer_norm_eps)

    def _patch_tokens(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images → [B, num_patches, C] in the compute dtype."""
        c = self.c
        p = self.patch_embed.proj
        patches = extract_patches(images.float(), c.patch_size).to(c.dtype)
        return patches @ p.weight.to(c.dtype) + p.bias.to(c.dtype)

    def _apply_mim_mask(self, x, mask):
        w = mask.to(x.dtype)[..., None]
        return x * (1 - w) + self.mask_token.to(x.dtype) * w

    def _add_cls(self, x):
        B, _, C = x.shape
        cls = self.cls_token.to(x.dtype).expand(B, 1, C)
        return torch.cat([cls, x], dim=1)

    def embed(self, images, mask=None):
        x = self._patch_tokens(images)
        if mask is not None:
            x = self._apply_mim_mask(x, mask)
        return self._add_cls(x)

    def _encode(self, x, deterministic: bool = True):
        for blk in self.blocks:
            x = blk(x, deterministic)
        return self.readout(x)

    def readout(self, x):
        """Drop cls, normalize the patches, prepend their mean."""
        patches = layer_norm(x[:, 1:, :], self.fc_norm, self.c.dtype)
        pooled = patches.mean(dim=1, keepdim=True)
        return torch.cat([pooled, patches], dim=1), patches

    def pair(self, images, mask, deterministic: bool = True):
        """Full and MIM-masked forward of the same images as one 2B-row pass,
        rows interleaved [full_i, masked_i] → (full, masked)."""
        x = self._patch_tokens(images)
        masked = self._apply_mim_mask(x, mask)
        B, N, C = x.shape
        x2 = torch.stack([x, masked], dim=1).reshape(B * 2, N, C)
        full, _ = self._encode(self._add_cls(x2), deterministic)
        y = full.reshape(B, 2, *full.shape[1:])
        return y[:, 0], y[:, 1]

    def forward(self, images, mask=None, deterministic: bool = True):
        """NHWC images [B, H, W, 3] → [B, 1+num_patches, C]
        ([avgpool ‖ patches])."""
        full, _ = self._encode(self.embed(images, mask), deterministic)
        return full
