"""CLIP-ViT vision tower (`xfm_tpu/models/clip_vit.py`), X-FM's alternative
vision encoder: pre-LN blocks with separate q/k/v projections and
quick-GELU, a class embedding and an absolute position embedding, and a
LayerNorm over all tokens at the end.

Parameter names are the reference torch names (`class_embedding`,
`patch_embed.weight`, `pos_embed.weight`, `pre_layrnorm.*`,
`encoder.layers.{i}.{layer_norm1, layer_norm2, self_attn.{q,k,v,out}_proj,
mlp.fc1, mlp.fc2}.*`, `post_layernorm.*`). The patch embedding is a matmul
with no bias over NHWC patches; its kernel `patch_embed.weight` is kept in
matmul layout [P·P·3, C] (`train/checkpoint.py` converts the reference's
Conv2d weight). Each self-attention goes through `dot_product_attention`,
so at N ≥ 512 (384 px: N = 577) it is the long-sequence kernel K3. Region
mode (the pretrain region stream) takes both JAX forms: the last
`local_attn_depth` layers over each region's masked copy, or (at 0) a
masked average-pool readout.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..core.precision import dense, layer_norm
from ..ops.activations import ACT
from ..ops.attention import dot_product_attention, mask_to_bias
from ..ops.patch_embed import extract_patches


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_res: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    attention_dropout: float = 0.0
    local_attn_depth: int = 0  # last-k layers run region-local attention
    dtype: torch.dtype = torch.float32

    @property
    def num_patches(self) -> int:
        return (self.image_res // self.patch_size) ** 2


class _SelfAttn(nn.Module):
    def __init__(self, c: ClipVisionConfig):
        super().__init__()
        C = c.hidden_size
        self.q_proj = nn.Linear(C, C)
        self.k_proj = nn.Linear(C, C)
        self.v_proj = nn.Linear(C, C)
        self.out_proj = nn.Linear(C, C)


class _Mlp(nn.Module):
    def __init__(self, c: ClipVisionConfig):
        super().__init__()
        self.fc1 = nn.Linear(c.hidden_size, c.intermediate_size)
        self.fc2 = nn.Linear(c.intermediate_size, c.hidden_size)


class ClipEncoderLayer(nn.Module):
    def __init__(self, c: ClipVisionConfig):
        super().__init__()
        self.c = c
        self.layer_norm1 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.self_attn = _SelfAttn(c)
        self.layer_norm2 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.mlp = _Mlp(c)

    def forward(self, x: torch.Tensor, attn_bias=None,
                deterministic: bool = True) -> torch.Tensor:
        c = self.c
        H = c.num_attention_heads
        B, N, C = x.shape
        a = self.self_attn
        h = layer_norm(x, self.layer_norm1, c.dtype)
        # [B, N, H, D] views of the projections: K3 reads them in place
        q, k, v = (dense(h, p, c.dtype).reshape(B, N, H, C // H)
                   for p in (a.q_proj, a.k_proj, a.v_proj))
        ctx = dot_product_attention(q, k, v, bias=attn_bias,
                                    deterministic=deterministic,
                                    dropout_rate=c.attention_dropout)
        x = x + dense(ctx.reshape(B, N, C), a.out_proj, c.dtype)
        h = layer_norm(x, self.layer_norm2, c.dtype)
        h = dense(ACT[c.hidden_act](dense(h, self.mlp.fc1, c.dtype)),
                  self.mlp.fc2, c.dtype)
        return x + h


class _Weight(nn.Module):
    """One parameter under the reference's `<name>.weight`."""

    def __init__(self, *shape: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(*shape))


class _Encoder(nn.Module):
    def __init__(self, c: ClipVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(ClipEncoderLayer(c)
                                    for _ in range(c.num_hidden_layers))


class ClipVisionTransformer(nn.Module):
    def __init__(self, c: ClipVisionConfig):
        super().__init__()
        self.c = c
        C, P = c.hidden_size, c.patch_size
        self.class_embedding = nn.Parameter(torch.zeros(C))
        self.patch_embed = _Weight(P * P * 3, C)
        self.pos_embed = _Weight(c.num_patches + 1, C)
        self.pre_layrnorm = nn.LayerNorm(C, eps=c.layer_norm_eps)
        self.encoder = _Encoder(c)
        self.post_layernorm = nn.LayerNorm(C, eps=c.layer_norm_eps)

    def forward(self, images, mask=None, idx_to_group_img=None,
                image_atts=None, deterministic: bool = True):
        """NHWC images [B, H, W, 3] → [B, 1 + num_patches, C], post-LN over
        all tokens (the cls token first). `image_atts` ([B, N] of {0, 1})
        masks keys in every layer. Region mode (`idx_to_group_img` [R], the
        image of each region, and `image_atts` [R, N], its patch mask) →
        (region rows [R, N, C], image rows [B, N, C]): with
        `local_attn_depth` k > 0 the first L − k layers run over the B
        images and the last k over [R regions ‖ B images], each region's
        copy of its image's rows with its mask; with k = 0 every layer runs
        over the B images and each region's first slot is the mean of its
        image's patch rows over its mask."""
        if mask is not None:
            # as the JAX tower: CLIP-ViT has no mask token, and ignoring the
            # mask would make the MIM loss MSE(x, x) = 0
            raise NotImplementedError(
                "CLIP-ViT has no MIM mask path: use the BEiT-2 backbone for "
                "MIM pretraining")
        c = self.c
        x = extract_patches(images.to(c.dtype), c.patch_size)
        x = x @ self.patch_embed.weight.to(c.dtype)  # CLIP's conv has no bias
        B, _, C = x.shape
        cls = self.class_embedding.to(c.dtype).expand(B, 1, C)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.weight.to(c.dtype)
        x = layer_norm(x, self.pre_layrnorm, c.dtype)
        layers = self.encoder.layers
        if idx_to_group_img is None:
            bias = mask_to_bias(image_atts) if image_atts is not None else None
            for layer in layers:
                x = layer(x, attn_bias=bias, deterministic=deterministic)
            return layer_norm(x, self.post_layernorm, c.dtype)
        if c.local_attn_depth > 0:
            split = c.num_hidden_layers - c.local_attn_depth
            for layer in layers[:split]:
                x = layer(x, deterministic=deterministic)
            xall = torch.cat([x[idx_to_group_img], x])
            bias = mask_to_bias(torch.cat([
                image_atts.float(), torch.ones(x.shape[:2],
                                               device=x.device)]))
            for layer in layers[split:]:
                xall = layer(xall, attn_bias=bias,
                             deterministic=deterministic)
            out = layer_norm(xall, self.post_layernorm, c.dtype)
            R = idx_to_group_img.shape[0]
            return out[:R], out[R:]
        for layer in layers:
            x = layer(x, deterministic=deterministic)
        x = layer_norm(x, self.post_layernorm, c.dtype)
        xg = x[idx_to_group_img][:, 1:]
        w = image_atts[:, 1:].to(xg.dtype)[..., None]
        pooled = (xg * w).sum(dim=1, keepdim=True) / torch.clamp(
            w.sum(dim=1, keepdim=True), min=1e-6)
        return torch.cat([pooled, xg], dim=1), x
