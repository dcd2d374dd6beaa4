"""BEiT-2 vision tower (`xfm_tpu/models/beit2.py`), BEiT backbone only.

Parameter names are the reference torch names (`vision_encoder.blocks.{i}.
attn.qkv.weight`, ...). The patch embedding is a matmul over NHWC patches;
its kernel `patch_embed.proj.weight` is kept in matmul layout [P·P·3, C]
(`train/checkpoint.py` converts the reference's Conv2d weight).

The optional forms of the JAX tower are config fields: per-block rel-pos
tables (`use_rel_pos_bias`), one table shared by every block
(`use_shared_rel_pos_bias`, the reference's `rel_pos_bias.
relative_position_bias_table`), an absolute position embedding
(`use_abs_pos_emb`, `pos_embed`), the readout's `fc_norm` or final `norm`
(`use_mean_pooling`), and region attention in the last `local_attn_depth`
blocks (`forward_localattn`). Attention with a bias of one batch row at
N < 512 is K1 (`flash_attention_packed`); a per-block table alone at
N ≥ 512 is K2; everything else (no bias, the region blocks' masked bias
with a batch axis, live attention dropout) takes `dot_product_attention`,
which is K3 at N ≥ 512 and the plain attention below, as the JAX package
routes it.

With `remat` (`gradient_checkpointing`) each block runs through
`ops/checkpoint.checkpoint_block` under `remat_policy`, in every loop over
the blocks (`_encode`, which `pair` runs, `intermediate_layers` and both
loops of `forward_localattn`), as the JAX tower wraps `BeitBlock` in
`nn.remat`; `attn_remat` (`XFM_ATTN_REMAT=1`) checkpoints the plain
attention alone.

Under a tensor cut (`core/partitioning.cut_model`: `tp` on the attention,
the MLP and the tower) a rank holds the q, k and v rows of its H/T heads
(`qkv`, `q_bias`, `v_bias`), `fc1`'s rows and the matching columns of
`proj` and `fc2`: K1, K2 and the plain attention run at H/T heads, K5 at
K = 4C/T, and each pair's output is summed over the group before its bias
(`ops/tensor_parallel.row_output`). The rel-pos tables stay whole; a rank
reads its heads' columns (`head_columns`).

With `seq_shard` under a tensor group (Megatron-SP, the JAX tower's
`constrain_seq_sharding` around each block of `_encode`) every loop over
the blocks runs on the rank's rows of the sequence, [B, ⌈N/T⌉, C]: the
tokens are scattered after the embedding and gathered before the readout
(`_sequence_loop`); inside a block the LayerNorms (K4 on the fused route,
at B·⌈N/T⌉ rows), the layer scales, drop-path, dropout and the residual
adds take those rows, the attention and the MLP gather them
(`column_input`) and reduce-scatter their row partials (`row_output`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..core.precision import (act_dense, act_row_dense, add_layer_norm,
                              dense, dense_partial, layer_norm, row_dense)
from ..ops.attention import dot_product_attention, mask_to_bias
from ..ops.checkpoint import (attention_remat, checkpoint_block,
                              name_attn_out, names_attn_out)
from ..ops.checkpoint import remat_policy as policy_context
from ..ops.dropout import drop_path, dropout
from ..ops.flash_attention import (MAX_N, beit_attention_relpos,
                                   flash_attention_packed, relpos_inkernel_ok)
from ..ops.patch_embed import extract_patches
from ..ops.relpos import (beit_rel_pos_bias, num_relative_distance,
                          relative_position_index)
from ..ops.tensor_parallel import (column_input, gather_from_sequence,
                                   head_columns, row_range,
                                   scatter_to_sequence, sequence,
                                   sequence_cut)


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_res: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    init_values: float = 0.1         # LayerScale init (0: none)
    use_rel_pos_bias: bool = True    # a rel-pos table in every block
    use_shared_rel_pos_bias: bool = False  # one table for all blocks
    use_abs_pos_emb: bool = False
    use_mean_pooling: bool = True    # readout through fc_norm, else `norm`
    local_attn_depth: int = -1       # > 0: region attention, last k blocks
    hidden_act: str = "gelu"
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32
    fused_ln: bool = False     # norm2 through K4 (XFM_FUSED_LN=1)
    fused_mlp: bool = False    # fc2 through K5 (XFM_MLP_FUSED=1)
    seq_shard: bool = False    # Megatron-SP under a tensor group
    remat: bool = False        # checkpoint each block
    remat_policy: str = "full"  # full | dots | except_attn | attn_out
    attn_remat: bool = False   # the plain attention alone (XFM_ATTN_REMAT)

    def __post_init__(self):
        policy_context(self.remat_policy)  # raises on an unknown name

    @property
    def grid_size(self) -> int:
        return self.image_res // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2


class _RelPosTable(nn.Module):
    """A rel-pos table [(2w−1)² + 3, H] and its index buffer."""

    def __init__(self, c: VisionConfig):
        super().__init__()
        window = (c.grid_size, c.grid_size)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(num_relative_distance(window), c.num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window)),
            persistent=False)

    def forward(self, tp=None) -> torch.Tensor:
        """→ the bias [1, H, N, N] in f32 (a bf16 table is widened before
        the gather, so its gradient sums in f32, as the JAX package builds
        the bias in f32 from any table); under the tensor cut `tp` the
        rank's H/T heads."""
        return beit_rel_pos_bias(
            head_columns(self.relative_position_bias_table, tp).float(),
            self.relative_position_index)


class BeitAttention(nn.Module):
    def __init__(self, c: VisionConfig):
        super().__init__()
        self.c = c
        C, H = c.embed_dim, c.num_heads
        self.qkv = nn.Linear(C, 3 * C, bias=False)
        if c.qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(C))
            self.v_bias = nn.Parameter(torch.zeros(C))
        if c.use_rel_pos_bias:
            window = (c.grid_size, c.grid_size)
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros(num_relative_distance(window), H))
            self.register_buffer(
                "relative_position_index",
                torch.from_numpy(relative_position_index(window)),
                persistent=False)
        self.proj = nn.Linear(C, C)
        self.tp = None  # the tensor cut (`core/partitioning.cut_model`)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                rel_pos_bias=None, attn_bias=None):
        """x [B, N, C] → [B, N, C]; `rel_pos_bias` the shared table's bias
        [1, H, N, N] f32 (H/T heads under a tensor cut), `attn_bias` the
        region blocks' [B, 1, 1, N]."""
        return self._proj_out(self.attend(x, deterministic, rel_pos_bias,
                                          attn_bias), deterministic)

    def attend(self, x: torch.Tensor, deterministic: bool = True,
               rel_pos_bias=None, attn_bias=None):
        """The attention of this rank's heads before the out-projection,
        [B, N, (H/T)·D] (all heads where the attention is not cut; x a
        rank's rows of the sequence under `seq_shard`, gathered first)."""
        c, tp = self.c, self.tp
        x = column_input(x, tp)
        B, N, C = x.shape
        D = C // c.num_heads
        H = c.num_heads if tp is None else tp.heads(c.num_heads)
        qkv = dense(x, self.qkv, c.dtype)
        if c.qkv_bias:
            qkv = qkv + torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                                   self.v_bias]).to(qkv.dtype)
        window = (c.grid_size, c.grid_size)
        attn_drop = not deterministic and c.attn_drop_rate > 0.0
        if (c.use_rel_pos_bias and rel_pos_bias is None and attn_bias is None
                and not attn_drop and relpos_inkernel_ok(N, window)):
            # N >= 512: K2 expands the compact table in the kernel; the
            # table is rounded to the compute dtype (the JAX package rounds
            # it to bf16 on its accelerator)
            return beit_attention_relpos(
                qkv, head_columns(self.relative_position_bias_table, tp),
                window, D ** -0.5, H, c.dtype)
        bias = rel_pos_bias
        if c.use_rel_pos_bias:
            # the materialized bias is f32, as in the JAX package (a bf16
            # table is widened first)
            rpb = beit_rel_pos_bias(
                head_columns(self.relative_position_bias_table, tp).float(),
                self.relative_position_index)
            bias = rpb if bias is None else bias + rpb
        if attn_bias is not None:
            bias = attn_bias if bias is None else bias + attn_bias
        if (bias is not None and bias.shape[0] == 1 and not attn_drop
                and N < MAX_N):
            return flash_attention_packed(qkv, bias, D ** -0.5, H)
        # no bias, a bias with a batch axis (the region blocks) or live
        # attention dropout: the plain attention (K3 from N = 512) over
        # views of the packed projection
        q, k, v = (t.reshape(B, N, H, D) for t in qkv.split(H * D, -1))
        return dot_product_attention(
            q, k, v, bias=bias, deterministic=deterministic,
            dropout_rate=c.attn_drop_rate, remat=attention_remat(c),
            heads=None if tp is None else tp.head_range(c.num_heads)
        ).reshape(B, N, H * D)

    def proj_partial(self, out):
        """This rank's partial sum of the out-projection of `attend`'s
        output, without the bias: the compute dtype's product in f32."""
        return dense_partial(out, self.proj, self.c.dtype)

    def _proj_out(self, out, deterministic: bool):
        """The out-projection and its dropout, the attention output tagged
        for the `attn_out` policy first; under a tensor cut the partial
        sums reduced over the group, then the bias."""
        c = self.c
        if names_attn_out(c):
            out = name_attn_out(out)
        y = row_dense(out, self.proj, c.dtype, self.tp)
        return dropout(y, c.drop_rate, deterministic,
                       rows=row_range(self.tp))


class _Mlp(nn.Module):
    def __init__(self, c: VisionConfig):
        super().__init__()
        self.c = c
        self.fc1 = nn.Linear(c.embed_dim, int(c.embed_dim * c.mlp_ratio))
        self.fc2 = nn.Linear(int(c.embed_dim * c.mlp_ratio), c.embed_dim)
        self.tp = None  # the tensor cut (`core/partitioning.cut_model`)

    def partial(self, h):
        """fc1, the activation and fc2 without its bias: under a tensor
        cut this rank's partial sum (K5 at K = 4C/T on the fused route)."""
        c = self.c
        h = dense(column_input(h, self.tp), self.fc1, c.dtype)
        return act_dense(h, self.fc2, c.hidden_act, c.dtype, c.fused_mlp,
                         bias=False)

    def forward(self, h):
        c = self.c
        h = dense(column_input(h, self.tp), self.fc1, c.dtype)
        return act_row_dense(h, self.fc2, c.hidden_act, c.dtype, c.fused_mlp,
                             self.tp)


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

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                rel_pos_bias=None, attn_bias=None):
        c = self.c
        h = layer_norm(x, self.norm1, c.dtype)
        h = self.attn(h, deterministic, rel_pos_bias, attn_bias)
        if self.use_ls:
            h = self.gamma_1.to(h.dtype) * h
        # drop-path on the branch before the residual add (K4's x + y on the
        # fused route)
        x, h = add_layer_norm(drop_path(h, self.drop_path, deterministic), x,
                              self.norm2, c.dtype, c.fused_ln)
        h = dropout(self.mlp(h), c.drop_rate, deterministic,
                    rows=row_range(self.mlp.tp))
        if self.use_ls:
            h = self.gamma_2.to(h.dtype) * h
        return x + drop_path(h, self.drop_path, deterministic)


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
        if c.use_abs_pos_emb:
            self.pos_embed = nn.Parameter(torch.zeros(1, c.num_patches + 1, C))
        if c.use_shared_rel_pos_bias:
            self.rel_pos_bias = _RelPosTable(c)
        dpr = np.linspace(0, c.drop_path_rate, c.depth)
        self.blocks = nn.ModuleList(BeitBlock(c, float(dpr[i]))
                                    for i in range(c.depth))
        self.tp = None  # the tensor cut (the shared table's heads, seq_shard)
        if c.use_mean_pooling:
            self.fc_norm = nn.LayerNorm(C, eps=c.layer_norm_eps)
        else:
            self.norm = nn.LayerNorm(C, eps=c.layer_norm_eps)

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
        x = torch.cat([cls, x], dim=1)
        if self.c.use_abs_pos_emb:
            x = x + self.pos_embed.to(x.dtype)
        return x

    def _shared_rpb(self):
        """The shared table's bias [1, H, N, N] f32, or None."""
        return (self.rel_pos_bias(self.tp)
                if self.c.use_shared_rel_pos_bias else None)

    def _final_norm(self) -> nn.LayerNorm:
        return self.fc_norm if self.c.use_mean_pooling else self.norm

    def embed(self, images, mask=None):
        x = self._patch_tokens(images)
        if mask is not None:
            x = self._apply_mim_mask(x, mask)
        return self._add_cls(x)

    def _block(self, blk, x, deterministic, shared, bias=None):
        """One block, checkpointed where the config's `remat` asks."""
        return checkpoint_block(self.c, blk, x, deterministic, shared, bias)

    def _sequence_loop(self, x, body):
        """`body(x)` (a loop over blocks) → its output; under `seq_shard`
        and a tensor group on the rank's rows of x, scattered before and
        gathered after (its gradient the rank's rows: every rank runs
        what reads it alike)."""
        tp = sequence_cut(self.tp, self.c.seq_shard)
        if tp is None:
            return body(x)
        n = x.shape[1]
        with sequence(n):
            x = body(scatter_to_sequence(x, tp))
        return gather_from_sequence(x, tp, n, to_column=False)

    def _encode(self, x, deterministic: bool = True):
        shared = self._shared_rpb()

        def body(x):
            for blk in self.blocks:
                x = self._block(blk, x, deterministic, shared)
            return x

        return self.readout(self._sequence_loop(x, body))

    def readout(self, x):
        """Drop cls, normalize the patches (`fc_norm` or `norm`), prepend
        their mean."""
        patches = layer_norm(x[:, 1:, :], self._final_norm(), self.c.dtype)
        pooled = patches.mean(dim=1, keepdim=True)
        return torch.cat([pooled, patches], dim=1), patches

    def intermediate_layers(self, images, layer_ids=None,
                            deterministic: bool = True) -> list:
        """The patch rows [B, num_patches, C] after each block of
        `layer_ids` (every block by default), in the order and with the
        repeats of `layer_ids`."""
        x = self.embed(images)
        shared = self._shared_rpb()
        ids = (list(range(len(self.blocks))) if layer_ids is None
               else list(layer_ids))
        tp = sequence_cut(self.tp, self.c.seq_shard)
        by_block = {}

        def body(x):
            for i, blk in enumerate(self.blocks):
                x = self._block(blk, x, deterministic, shared)
                if i in ids:
                    by_block[i] = (x if tp is None else gather_from_sequence(
                        x, tp, to_column=False))[:, 1:, :]
            return x

        self._sequence_loop(x, body)
        return [by_block[i] for i in ids]

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

    def forward_localattn(self, images, idx_to_group_img, image_atts,
                          deterministic: bool = True):
        """Region mode with `local_attn_depth` k > 0: the first depth − k
        blocks on the B images (K1 with a rel-pos bias), then each region's
        copy of its image's rows gathered, and the last k blocks over
        [R regions ‖ B images] with the region's patch mask added to the
        bias (a batch axis, so the plain attention); readout the final norm
        over every row. → (region rows [R, 1+N, C], image rows
        [B, 1+N, C])."""
        c = self.c
        x = self._add_cls(self._patch_tokens(images))
        shared = self._shared_rpb()
        split = c.depth - c.local_attn_depth
        atts = torch.cat([image_atts.float(),
                          torch.ones(x.shape[:2], device=x.device)])
        bias = mask_to_bias(atts)

        def body(x):
            for blk in self.blocks[:split]:
                x = self._block(blk, x, deterministic, shared)
            # the regions' copies, rows of the batch: a rank's own rows
            xall = torch.cat([x[idx_to_group_img], x])
            for blk in self.blocks[split:]:
                xall = self._block(blk, xall, deterministic, shared, bias)
            return xall

        xall = self._sequence_loop(x, body)
        out = layer_norm(xall, self._final_norm(), c.dtype)
        R = idx_to_group_img.shape[0]
        return out[:R], out[R:]

    def forward(self, images, mask=None, idx_to_group_img=None,
                image_atts=None, deterministic: bool = True):
        """NHWC images [B, H, W, 3] → [B, 1+num_patches, C]
        ([avgpool ‖ patches]). Region mode (`idx_to_group_img` [R], the
        image of each region, and `image_atts` [R, 1+num_patches], its patch
        mask) → (grouped, full): with `local_attn_depth` > 0 those of
        `forward_localattn`; otherwise each region's copy of its image's
        patches with their mean over the region's mask in the first slot,
        and the images' rows, both from one pass over the B images."""
        if idx_to_group_img is not None and self.c.local_attn_depth > 0:
            return self.forward_localattn(images, idx_to_group_img,
                                          image_atts, deterministic)
        full, patches = self._encode(self.embed(images, mask), deterministic)
        if idx_to_group_img is None:
            return full
        xg = patches[idx_to_group_img]
        w = image_atts[:, 1:].to(xg.dtype)[..., None]
        pooled = (xg * w).sum(dim=1, keepdim=True) / torch.clamp(
            w.sum(dim=1, keepdim=True), min=1e-6)
        return torch.cat([pooled, xg], dim=1), full
