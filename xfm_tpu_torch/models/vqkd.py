"""The VQ-KD visual tokenizer (`xfm_tpu/models/vqkd.py`).

It gives MIM its discrete targets when a pretrain YAML sets
`use_vision_tokenizer`: a BEiT encoder (absolute positions, no rel-pos bias,
no LayerScale, `fc_norm` over the patches) → a two-layer tanh projection in
f32 → the nearest code of an l2-normalized codebook → one id a patch. The
tokenizer's own training (a decoder regressing a frozen teacher's features
with a cosine loss, plus the commitment loss) is here too.

Where the JAX package returns the quantizer's EMA statistics as updates of
its `vq_stats` collection, the port keeps them as buffers
(`quantize.embedding.weight`, the codebook, and `quantize.embedding.
cluster_size`, the reference's names) and updates them in place under
`no_grad`. The k-means initialization (`kmeans_init_vq_stats`) draws its
first means from an explicit `torch.Generator`; its update step is the JAX
package's. The encoder runs in f32 (`VQKDConfig.dtype`); on the card its
matmuls stay true f32 only with TF32 off, which is torch's default.
"""
from __future__ import annotations

import dataclasses
import re

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import dense, layer_norm
from ..data.device_aug import maybe_normalize
from .beit2 import BeitBlock, BeitVisionTransformer, VisionConfig


def l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


@dataclasses.dataclass(frozen=True)
class VQKDConfig:
    # the reference encoder (abs pos embed, no rel-pos bias, no LayerScale,
    # fc_norm over the patch tokens)
    encoder: VisionConfig = VisionConfig(
        image_res=224, patch_size=16, embed_dim=768, depth=12, num_heads=12,
        init_values=0.0, use_rel_pos_bias=False,
        use_shared_rel_pos_bias=False, use_abs_pos_emb=True,
        use_mean_pooling=True, drop_path_rate=0.0)
    decoder_depth: int = 3
    codebook_size: int = 8192
    codebook_dim: int = 32
    teacher_dim: int = 512          # CLIP ViT-B/16's projected width
    ema_decay: float = 0.99
    beta: float = 1.0               # commitment weight
    dtype: torch.dtype = torch.float32


def vqkd_config_from_yaml(config: dict) -> VQKDConfig:
    """The YAML's `tokenizer_model` (its name gives the decoder's depth and
    the teacher: `..._decoder_<depth>x768x12_<clip|dino>`), `codebook_size`,
    `codebook_dim`, `image_res`, `patch_size`, and the small-model keys
    `tokenizer_embed_dim` / `tokenizer_depth` / `tokenizer_num_heads`."""
    name = str(config.get("tokenizer_model",
                          "vqkd_encoder_base_decoder_3x768x12_clip"))
    m = re.search(r"decoder_(\d+)x\d+x\d+_(clip|dino)", name)
    dec_depth = int(m.group(1)) if m else 3
    teacher = m.group(2) if m else "clip"
    base = VQKDConfig()
    enc = dataclasses.replace(
        base.encoder,
        image_res=config.get("image_res", 224),
        patch_size=config.get("patch_size", 16),
        embed_dim=config.get("tokenizer_embed_dim", 768),
        depth=config.get("tokenizer_depth", 12),
        num_heads=config.get("tokenizer_num_heads", 12))
    return VQKDConfig(
        encoder=enc, decoder_depth=dec_depth,
        codebook_size=config.get("codebook_size", 8192),
        codebook_dim=config.get("codebook_dim", 32),
        teacher_dim=512 if teacher == "clip" else 768)


def cosine_kmeans(generator: torch.Generator, samples: torch.Tensor,
                  num_clusters: int, num_iters: int = 10,
                  means: torch.Tensor | None = None):
    """Cosine k-means: the first means are rows of the l2-normalized
    samples drawn from `generator` (a permutation's first `num_clusters`,
    or with replacement where there are fewer samples), unless `means` is
    given; each iteration assigns by the largest dot product and moves
    each mean to its members' normalized mean (an empty cluster keeps its
    mean). → (means [num_clusters, D], counts [num_clusters])."""
    samples = l2norm(samples.float())
    n = samples.shape[0]
    if means is None:
        dev = generator.device
        idx = (torch.randperm(n, generator=generator, device=dev)
               [:num_clusters] if n >= num_clusters
               else torch.randint(0, n, (num_clusters,), generator=generator,
                                  device=dev))
        means = samples[idx.to(samples.device)]
    means = means.float()
    for _ in range(num_iters):
        onehot = F.one_hot((samples @ means.T).argmax(-1),
                           num_clusters).float()
        bins = onehot.sum(0)
        new = l2norm(onehot.T @ samples / torch.clamp(bins, min=1.0)[:, None])
        means = torch.where((bins == 0)[:, None], means, new)
    bins = F.one_hot((samples @ means.T).argmax(-1),
                     num_clusters).float().sum(0)
    return means, bins


def kmeans_init_vq_stats(generator: torch.Generator, z_samples: torch.Tensor,
                         num_codes: int, num_iters: int = 10,
                         means: torch.Tensor | None = None) -> dict:
    """The data-driven codebook: cosine k-means over the projections
    `z_samples` [..., code_dim] → {"quantize": {"codebook",
    "cluster_size"}}, for `VQKD.load_vq_stats` before the first step."""
    flat = z_samples.reshape(-1, z_samples.shape[-1])
    cb, bins = cosine_kmeans(generator, flat, num_codes, num_iters, means)
    return {"quantize": {"codebook": cb, "cluster_size": bins}}


def load_codebook_init(path) -> torch.Tensor:
    """`codebook_init_path`: a torch-saved [num_codes, code_dim] tensor,
    read with `weights_only=True` → an f32 tensor."""
    w = torch.load(path, map_location="cpu", weights_only=True)
    if not torch.is_tensor(w):
        raise ValueError("codebook_init_path must hold a tensor")
    return w.detach().float()


class _Codebook(nn.Module):
    """The reference's `quantize.embedding`: the codebook and its EMA
    cluster sizes, as buffers."""

    def __init__(self, num_codes: int, code_dim: int):
        super().__init__()
        # drawn on the host wherever the module is built: one codebook
        g = torch.Generator().manual_seed(0)
        self.register_buffer("weight", l2norm(
            torch.randn(num_codes, code_dim, generator=g, device="cpu")))
        self.register_buffer("cluster_size", torch.zeros(num_codes))


class NormEMAQuantizer(nn.Module):
    """l2-normalized codebook with EMA updates (reference
    models/norm_ema_quantizer.py)."""

    def __init__(self, num_codes: int, code_dim: int, decay: float = 0.99,
                 beta: float = 1.0):
        super().__init__()
        self.num_codes, self.code_dim = num_codes, code_dim
        self.decay, self.beta = decay, beta
        self.embedding = _Codebook(num_codes, code_dim)

    def indices(self, z: torch.Tensor) -> torch.Tensor:
        """The nearest code's id of each [..., code_dim] input (its
        l2-normalized copy; squared distances in f32, the first of ties)."""
        flat = l2norm(z.float()).reshape(-1, self.code_dim)
        cb = self.embedding.weight
        d = ((flat ** 2).sum(-1, keepdim=True) - 2 * flat @ cb.T
             + (cb ** 2).sum(-1)[None])
        return d.argmin(-1).reshape(z.shape[:-1])

    def forward(self, z: torch.Tensor, update_ema: bool = False):
        """→ (quantized, commitment loss, ids), the quantized input passing
        the gradient straight through; with `update_ema` the codebook and
        the cluster sizes take one EMA step from this batch (the codes no
        row chose keep their value)."""
        zf = l2norm(z.float())
        ids = self.indices(zf)
        cb = self.embedding.weight
        zq = cb[ids.reshape(-1)].reshape(zf.shape)
        loss = self.beta * ((zq.detach() - zf) ** 2).mean()
        if update_ema:
            with torch.no_grad():
                flat = zf.reshape(-1, self.code_dim)
                onehot = F.one_hot(ids.reshape(-1), self.num_codes).float()
                counts = onehot.sum(0)
                mean = onehot.T @ flat / torch.clamp(counts[:, None], min=1.0)
                new_cb = l2norm(cb * self.decay
                                + l2norm(mean) * (1 - self.decay))
                cs = self.embedding.cluster_size
                cs.copy_(cs * self.decay + counts * (1 - self.decay))
                cb.copy_(torch.where((counts == 0)[:, None], cb, new_cb))
        return zf + (zq - zf).detach(), loss, ids


class BeitVisionTransformerBody(nn.Module):
    """The decoder's trunk: an input projection (where `in_dim` differs from
    the width), pre-LN BEiT blocks with no rel-pos bias over the given
    tokens, and a final `norm`."""

    def __init__(self, c: VisionConfig, in_dim: int):
        super().__init__()
        self.c = c
        if in_dim != c.embed_dim:
            self.in_proj = nn.Linear(in_dim, c.embed_dim)
        block_cfg = dataclasses.replace(c, use_rel_pos_bias=False)
        self.blocks = nn.ModuleList(BeitBlock(block_cfg)
                                    for _ in range(c.depth))
        self.norm = nn.LayerNorm(c.embed_dim, eps=c.layer_norm_eps)

    def forward(self, x: torch.Tensor, deterministic: bool = True):
        c = self.c
        if hasattr(self, "in_proj"):
            x = dense(x, self.in_proj, c.dtype)
        for blk in self.blocks:
            x = blk(x, deterministic)
        return layer_norm(x, self.norm, c.dtype)


def _task_layer(in_dim: int, out_dim: int) -> nn.Sequential:
    """Linear → tanh → Linear (the reference's `*_task_layer.{0,2}`)."""
    return nn.Sequential(nn.Linear(in_dim, in_dim), nn.Tanh(),
                         nn.Linear(in_dim, out_dim))


class VQKD(nn.Module):
    def __init__(self, c: VQKDConfig):
        super().__init__()
        self.config = c
        E = c.encoder.embed_dim
        self.encoder = BeitVisionTransformer(c.encoder)
        self.encode_task_layer = _task_layer(E, c.codebook_dim)
        self.quantize = NormEMAQuantizer(c.codebook_size, c.codebook_dim,
                                         c.ema_decay, c.beta)
        self.decoder = BeitVisionTransformerBody(
            dataclasses.replace(c.encoder, depth=c.decoder_depth),
            c.codebook_dim)
        self.decode_task_layer = _task_layer(E, c.teacher_dim)

    @torch.no_grad()
    def load_vq_stats(self, stats: dict) -> None:
        """Install `kmeans_init_vq_stats`'s codebook and cluster sizes."""
        q = stats["quantize"]
        self.quantize.embedding.weight.copy_(q["codebook"])
        self.quantize.embedding.cluster_size.copy_(q["cluster_size"])

    def _encode_z(self, images: torch.Tensor, deterministic: bool = True):
        """Images (uint8 ones CLIP-normalized first) → the encoder's
        normalized patch rows → the f32 tanh projection [B, P, code_dim]."""
        feats = self.encoder(maybe_normalize(images),
                             deterministic=deterministic)
        t = self.encode_task_layer
        h = torch.tanh(dense(feats[:, 1:, :].float(), t[0], torch.float32))
        return dense(h, t[2], torch.float32)

    def get_codebook_indices(self, images: torch.Tensor,
                             deterministic: bool = True) -> torch.Tensor:
        """The code ids [B, num_patches] of MIM's cross-entropy."""
        return self.quantize.indices(self._encode_z(images, deterministic))

    def forward(self, images, teacher_features, deterministic: bool = True,
                update_ema: bool = True):
        """The tokenizer's training step: the decoder's projection of the
        quantized codes against the teacher's features [B, P, teacher_dim]
        by cosine, plus the commitment loss → (loss, {rec_loss, vq_loss,
        ids})."""
        z = self._encode_z(images, deterministic)
        zq, vq_loss, ids = self.quantize(z, update_ema=update_ema)
        dec = self.decoder(zq.to(self.config.dtype), deterministic)
        t = self.decode_task_layer
        pred = dense(torch.tanh(dense(dec.float(), t[0], torch.float32)),
                     t[2], torch.float32)
        target = l2norm(teacher_features.float())
        rec_loss = (1.0 - (l2norm(pred) * target).sum(-1)).mean()
        return rec_loss + vq_loss, {"rec_loss": rec_loss,
                                    "vq_loss": vq_loss, "ids": ids}
