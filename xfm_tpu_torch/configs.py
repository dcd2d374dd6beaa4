"""The XFM-base pretrain configuration, its synthetic batch and its FLOP
count: copies of `__graft_entry__._xfm_config` / `_batch` and
`bench.pretrain_step_flops` (those modules import JAX)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.beit2 import VisionConfig
from .models.task_models import XFMForPretrain
from .models.text_encoder import TextConfig
from .models.xfm import XFMConfig
from .train.checkpoint import init_weights
from .train.optim import create_optimizer
from .train.schedules import linear_warmup_decay
from .train.train_state import TrainState, make_train_step, pretrain_loss_fn


def xfm_base_pretrain_config(hidden=768, layers=12, heads=12, inter=3072,
                             image_res=224, vocab=50265,
                             dtype=torch.bfloat16,
                             act="gelu_tanh") -> XFMConfig:
    """XFM-base (327M) as the JAX package benchmarks it: 224 px, patch 16,
    tanh-GELU, bf16 compute, drop-path off; smaller widths for tests."""
    vis = VisionConfig(image_res=image_res, patch_size=16, embed_dim=hidden,
                       depth=layers, num_heads=heads, drop_path_rate=0.0,
                       hidden_act=act, dtype=dtype)
    txt = TextConfig.roberta_base(
        vocab_size=vocab, hidden_size=hidden, num_hidden_layers=layers,
        num_attention_heads=heads, intermediate_size=inter,
        fusion_layer=layers, encoder_width=hidden, hidden_act=act,
        dtype=dtype)
    fus = TextConfig.roberta_base(
        vocab_size=vocab, hidden_size=hidden, num_hidden_layers=layers,
        num_attention_heads=heads, intermediate_size=inter, fusion_layer=0,
        encoder_width=hidden, hidden_act=act, dtype=dtype)
    return XFMConfig(vision=vis, text=txt, fusion=fus, embed_dim=256,
                     use_contrastive_loss=True, use_matching_loss=True,
                     use_mlm_loss=True, use_bbox_loss=True, dtype=dtype)


def make_batch(B: int, T: int, M: int, image_res: int, num_patches: int,
               vocab: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded synthetic pretrain batch, value for value `_batch`'s."""
    r = np.random.RandomState(seed)
    mask = np.zeros((B, num_patches), bool)
    mask[:, : num_patches // 3] = True
    return dict(
        images=r.randn(B, image_res, image_res, 3).astype(np.float32),
        text_ids=r.randint(3, vocab - 1, (B, T)).astype(np.int64),
        text_atts=np.ones((B, T), np.int64),
        text_ids_masked=r.randint(3, vocab - 1, (B, T)).astype(np.int64),
        masked_pos=np.tile(np.arange(M, dtype=np.int64)[None], (B, 1)),
        masked_ids=r.randint(3, vocab - 1, (B, M)).astype(np.int64),
        image_mask=mask,
    )


def batch_to_torch(batch: Dict[str, np.ndarray],
                   device="cuda") -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def make_pretrain_run(B: int = 48, T: int = 30, M: int = 15,
                      device="cuda", seed: int = 0):
    """The XFM-base pretrain step as `bench.py` drives it: random weights
    from `seed`, the seeded batch, HF-AdamW on
    linear_warmup_decay(1e-4, 1000, 100). → (state, batch, step) with
    step(state, batch, generator) -> (state, loss)."""
    cfg = xfm_base_pretrain_config()
    model = XFMForPretrain(cfg).to(device)
    init_weights(model, seed)
    state = TrainState.create(model, create_optimizer(
        model, linear_warmup_decay(1e-4, 1000, 100)))
    batch = batch_to_torch(make_batch(B, T, M, cfg.vision.image_res,
                                      cfg.vision.num_patches,
                                      cfg.text.vocab_size), device)
    return state, batch, make_train_step(pretrain_loss_fn)


def _transformer_flops(n_layers, hidden, inter, seq, batch, cross_kv=0):
    """Forward FLOPs of one encoder stack (matmuls only)."""
    per_tok = 4 * hidden * hidden + 2 * hidden * inter
    attn = 2 * 2 * seq * seq * hidden
    cross = 0
    if cross_kv:
        per_tok += 2 * hidden * hidden
        cross = (2 * 2 * hidden * hidden * cross_kv
                 + 2 * 2 * seq * cross_kv * hidden)
    return n_layers * (2 * seq * per_tok + attn + cross) * batch


def pretrain_step_flops(B, T, M, patches, hidden=768, inter=3072, layers=12,
                        vocab=50265) -> float:
    """Model FLOPs of one pretrain step (forward + backward ≈ 3× forward):
    two vision passes, two text passes, four fusion passes, the MLM head."""
    Nv = patches + 1
    fwd = (2 * _transformer_flops(layers, hidden, inter, Nv, B)
           + 2 * _transformer_flops(layers, hidden, inter, T, B)
           + 4 * _transformer_flops(layers, hidden, inter, T, B, cross_kv=Nv)
           + 2 * B * M * hidden * vocab)
    return 3 * fwd
