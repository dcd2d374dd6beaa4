"""The XFM-base pretrain and retrieval fine-tune configurations (BEiT-2 or
CLIP-ViT-B/16 vision tower), their synthetic batches and their FLOP counts:
copies of `__graft_entry__._xfm_config` / `_batch`,
`bench.pretrain_step_flops`, `scripts/bench_finetune.py`'s retrieval step
and `config_from_yaml`'s CLIP branch (those modules import JAX); and the
retrieval eval's configuration (`configs/xfm-ft/Retrieval_coco.yaml`, kept
here as a dict so that no YAML reader is needed) and a seeded in-memory
corpus with `RetrievalEvalData`'s interface."""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .models.beit2 import VisionConfig
from .models.clip_vit import ClipVisionConfig
from .models.task_models import XFMForPretrain, XFMForRetrieval
from .models.text_encoder import TextConfig
from .models.xfm import XFMConfig, config_from_yaml
from .train.checkpoint import init_weights
from .train.optim import create_optimizer, create_optimizer_from_config
from .train.schedules import linear_warmup_decay, schedule_from_config
from .train.train_state import (TrainState, make_train_step,
                                pretrain_loss_fn, retrieval_loss_fn)


def _env_flag(value: Optional[bool], name: str) -> bool:
    """An explicit flag, or the JAX package's environment switch `name`."""
    return os.environ.get(name, "0") == "1" if value is None else bool(value)


def xfm_base_pretrain_config(hidden=768, layers=12, heads=12, inter=3072,
                             image_res=224, vocab=50265,
                             dtype=torch.bfloat16, act="gelu_tanh",
                             fused_ln: Optional[bool] = None,
                             fused_mlp: Optional[bool] = None) -> XFMConfig:
    """XFM-base (327M) as the JAX package benchmarks it: 224 px, patch 16,
    tanh-GELU, bf16 compute, drop-path off; smaller widths for tests.
    `fused_ln` / `fused_mlp` take the residual LayerNorms through K4 and the
    MLPs' second projections through K5; None reads `XFM_FUSED_LN` /
    `XFM_MLP_FUSED` == "1", as the JAX package does."""
    fused = dict(fused_ln=_env_flag(fused_ln, "XFM_FUSED_LN"),
                 fused_mlp=_env_flag(fused_mlp, "XFM_MLP_FUSED"))
    vis = VisionConfig(image_res=image_res, patch_size=16, embed_dim=hidden,
                       depth=layers, num_heads=heads, drop_path_rate=0.0,
                       hidden_act=act, dtype=dtype, **fused)
    txt = TextConfig.roberta_base(
        vocab_size=vocab, hidden_size=hidden, num_hidden_layers=layers,
        num_attention_heads=heads, intermediate_size=inter,
        fusion_layer=layers, encoder_width=hidden, hidden_act=act,
        dtype=dtype, **fused)
    fus = TextConfig.roberta_base(
        vocab_size=vocab, hidden_size=hidden, num_hidden_layers=layers,
        num_attention_heads=heads, intermediate_size=inter, fusion_layer=0,
        encoder_width=hidden, hidden_act=act, dtype=dtype, **fused)
    return XFMConfig(vision=vis, text=txt, fusion=fus, embed_dim=256,
                     use_contrastive_loss=True, use_matching_loss=True,
                     use_mlm_loss=True, use_bbox_loss=True, dtype=dtype)


def xfm_base_retrieval_config(image_res=384, act="gelu",
                              **kw) -> XFMConfig:
    """XFM-base as `scripts/bench_finetune.py` runs the retrieval fine-tune:
    384 px (N = 577), erf-GELU (the released weights' activation), bf16
    compute, drop-path off; the heads of the pretrain config."""
    return xfm_base_pretrain_config(image_res=image_res, act=act, **kw)


# configs/model/config_clipvitB.json (clip-vit-base-patch16), copied: the
# port reads no file of the JAX package
CLIP_VIT_B16 = dict(vision_width=768, patch_size=16, hidden_act="quick_gelu",
                    num_attention_heads=12, attention_dropout=0.0,
                    intermediate_size=3072, num_hidden_layers=12,
                    local_attn_depth=4)


def xfm_clip_retrieval_config(image_res=384, hidden=None, layers=None,
                              heads=None, inter=None, vocab=50265,
                              dtype=torch.bfloat16,
                              fused_ln: Optional[bool] = None,
                              fused_mlp: Optional[bool] = None) -> XFMConfig:
    """XFM with the CLIP-ViT-B/16 tower as `xfm_tpu/models/xfm.py`
    `config_from_yaml` builds it for `configs/xfm-ft/Retrieval_coco.yaml`
    with `use_clip_vit: true` and `config_clipvitB.json`, and as
    `tasks/retrieval.py` asks (ITC + ITM heads): 384 px (N = 577), the
    json's tower (quick-GELU, LN eps 1e-5), RoBERTa-base text and fusion
    (erf-GELU, 12 + 12 layers, text_fusion_start_at 12). `hidden`, `layers`,
    `heads` and `inter` cut every encoder alike for tests and slices.
    `fused_ln` / `fused_mlp` (None reads `XFM_FUSED_LN` / `XFM_MLP_FUSED`
    == "1") take the text and fusion encoders' post-LNs through K4 and
    their MLPs' second projections through K5; the CLIP tower's LNs and
    quick-GELU MLPs stay plain, as in the JAX package."""
    v = CLIP_VIT_B16
    fused = dict(fused_ln=_env_flag(fused_ln, "XFM_FUSED_LN"),
                 fused_mlp=_env_flag(fused_mlp, "XFM_MLP_FUSED"))
    hidden = hidden or v["vision_width"]
    layers = layers or v["num_hidden_layers"]
    heads = heads or v["num_attention_heads"]
    inter = inter or v["intermediate_size"]
    vis = ClipVisionConfig(
        image_res=image_res, patch_size=v["patch_size"], hidden_size=hidden,
        num_hidden_layers=layers, num_attention_heads=heads,
        intermediate_size=inter, hidden_act=v["hidden_act"],
        attention_dropout=v["attention_dropout"],
        local_attn_depth=v["local_attn_depth"], dtype=dtype)
    txt = TextConfig.roberta_base(
        vocab_size=vocab, hidden_size=hidden, num_hidden_layers=layers,
        num_attention_heads=heads, intermediate_size=inter,
        fusion_layer=layers, encoder_width=hidden, dtype=dtype, **fused)
    fus = TextConfig.roberta_base(
        vocab_size=vocab, hidden_size=hidden, num_hidden_layers=layers,
        num_attention_heads=heads, intermediate_size=inter, fusion_layer=0,
        encoder_width=hidden, dtype=dtype, **fused)
    return XFMConfig(vision=vis, text=txt, fusion=fus,
                     vision_backbone="clip_vit", embed_dim=256,
                     use_contrastive_loss=True, use_matching_loss=True,
                     dtype=dtype)


# configs/xfm-ft/Retrieval_coco.yaml, key for key (a CPU test holds the two
# equal)
RETRIEVAL_COCO = {
    "train_file": ["data/finetune/coco_train.json"],
    "val_file": "data/finetune/coco_val.json",
    "test_file": "data/finetune/coco_test.json",
    "image_root": "data/coco",
    "use_beit_v2": True,
    "vision_config": "configs/model/config_beit2_base.json",
    "image_res": 384, "patch_size": 16, "local_attn_depth": -1,
    "text_encoder": "data/roberta-base",
    "text_num_hidden_layers": 12, "text_fusion_start_at": 12,
    "fusion_num_hidden_layers": 12, "fusion_fusion_start_at": 0,
    "embed_dim": 256, "temp": 0.07, "learnable_temp": True,
    "max_tokens": 40, "k_test": 256,
    "batch_size_train": 24, "batch_size_test": 64,
    "parallel": {"data": -1, "fsdp": 1, "tensor": 1},
    "optimizer": {"opt": "adamW", "lr": 3.0e-5, "weight_decay": 0.01,
                  "lr_mult": 2},
    "schedular": {"sched": "linear", "lr": 3.0e-5, "epochs": 10,
                  "num_warmup_steps": 0.1},
    "accelerator": {"RNG_SEED": 42},
}


def retrieval_eval_yaml(image_res: int = 384, layers: Optional[int] = None,
                        clip: bool = False, **keys) -> dict:
    """`RETRIEVAL_COCO` at `image_res`, every encoder cut to `layers` where
    given, with the CLIP-ViT-B/16 tower (`use_clip_vit` and
    config_clipvitB.json read into `_vision`) where `clip`; `keys` set on
    top."""
    cfg = dict(RETRIEVAL_COCO, image_res=image_res, **keys)
    if clip:
        cfg["use_clip_vit"] = True
        cfg["_vision"] = dict(CLIP_VIT_B16)
    if layers:
        cfg.update(text_num_hidden_layers=layers, text_fusion_start_at=layers,
                   fusion_num_hidden_layers=layers)
        if clip:
            cfg["_vision"]["num_hidden_layers"] = layers
        else:
            cfg["vision_depth"] = layers
    return cfg


def xfm_retrieval_eval_config(dtype=None, **kw) -> XFMConfig:
    """The eval's model: `config_from_yaml` of `retrieval_eval_yaml(**kw)`
    with the ITC and ITM heads, as `tasks/retrieval.main` builds it."""
    return config_from_yaml(retrieval_eval_yaml(**kw), dtype=dtype,
                            use_contrastive_loss=True, use_matching_loss=True)


class SyntheticRetrievalEvalData:
    """A seeded in-memory corpus with `data/finetune_data.RetrievalEvalData`'s
    interface (`image_batches`, `text_batches`, `img2txt`, `txt2img`):
    `n_img` normal-random NHWC images and `per_image` captions each (image
    i owns captions per_image·i ...), token ids drawn from [3, vocab - 1),
    each caption min_tokens..max_tokens long with the cls and sep ids at its
    ends and padded with `pad_id` to max_tokens."""

    def __init__(self, n_img: int, per_image: int, image_res: int,
                 vocab: int, max_tokens: int = 40, min_tokens: int = 8,
                 pad_id: int = 1, seed: int = 0):
        r = np.random.RandomState(seed)
        self.images = r.randn(n_img, image_res, image_res, 3).astype(
            np.float32)
        n_txt = n_img * per_image
        lens = r.randint(min_tokens, max_tokens + 1, n_txt)
        ids = r.randint(3, vocab - 1, (n_txt, max_tokens)).astype(np.int32)
        pos = np.arange(max_tokens)[None]
        atts = (pos < lens[:, None]).astype(np.int32)
        ids[:, 0] = 0
        ids[np.arange(n_txt), lens - 1] = 2
        self.ids = np.where(atts == 1, ids, pad_id).astype(np.int32)
        self.atts = atts
        self.img2txt = {i: list(range(per_image * i, per_image * (i + 1)))
                        for i in range(n_img)}
        self.txt2img = {t: t // per_image for t in range(n_txt)}

    def image_batches(self, batch_size):
        for s in range(0, len(self.images), batch_size):
            yield self.images[s:s + batch_size]

    def text_batches(self, batch_size):
        for s in range(0, len(self.ids), batch_size):
            yield self.ids[s:s + batch_size], self.atts[s:s + batch_size]


def retrieval_eval_flops(n_img: int, n_txt: int, k_test: int, T: int,
                         patches: int, hidden=768, inter=3072, layers=12
                         ) -> dict:
    """Forward model FLOPs of the eval's parts (matmuls only): stage 1
    (every image, every text), image → text grouped (cross k/v projected
    once per image) and text → image in the repeat form (cross k/v
    projected for every row)."""
    Nv = patches + 1
    stage1 = (_transformer_flops(layers, hidden, inter, Nv, n_img)
              + _transformer_flops(layers, hidden, inter, T, n_txt))
    fusion_rows = _transformer_flops(layers, hidden, inter, T, 1,
                                     cross_kv=Nv)
    kv_proj = layers * 2 * 2 * hidden * hidden * Nv
    i2t = n_img * k_test * (fusion_rows - kv_proj) + n_img * kv_proj
    t2i = n_txt * k_test * fusion_rows
    return {"stage1": stage1, "i2t": i2t, "t2i": t2i}


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


def make_retrieval_batch(B: int, T: int, image_res: int, vocab: int,
                         seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded synthetic retrieval batch, value for value
    `bench_finetune.retrieval_train`'s: images, then ids; atts all ones."""
    r = np.random.RandomState(seed)
    return dict(
        images=r.randn(B, image_res, image_res, 3).astype(np.float32),
        text_ids=r.randint(3, vocab - 1, (B, T)).astype(np.int64),
        text_atts=np.ones((B, T), np.int64),
    )


def batch_to_torch(batch: Dict[str, np.ndarray],
                   device="cuda") -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def make_pretrain_run(B: int = 48, T: int = 30, M: int = 15,
                      device="cuda", seed: int = 0,
                      fused_ln: Optional[bool] = None,
                      fused_mlp: Optional[bool] = None):
    """The XFM-base pretrain step as `bench.py` drives it: random weights
    from `seed`, the seeded batch, HF-AdamW on
    linear_warmup_decay(1e-4, 1000, 100); the fused routes as
    `xfm_base_pretrain_config` takes them. → (state, batch, step) with
    step(state, batch, generator) -> (state, metrics)."""
    cfg = xfm_base_pretrain_config(fused_ln=fused_ln, fused_mlp=fused_mlp)
    model = XFMForPretrain(cfg).to(device)
    init_weights(model, seed)
    state = TrainState.create(model, create_optimizer(
        model, linear_warmup_decay(1e-4, 1000, 100)))
    batch = batch_to_torch(make_batch(B, T, M, cfg.vision.image_res,
                                      cfg.vision.num_patches,
                                      cfg.text.vocab_size), device)
    return state, batch, make_train_step(pretrain_loss_fn)


def make_retrieval_run(B: int = 32, T: int = 40, device="cuda",
                       seed: int = 0):
    """The XFM-base retrieval fine-tune step at 384 px as
    `scripts/bench_finetune.py` drives it: random weights from `seed`, the
    seeded batch, HF-AdamW on linear_warmup_decay(1e-4, 1000, 100) with no
    gradient clip. → (state, batch, step) with step(state, batch,
    generator) -> (state, metrics)."""
    return _retrieval_run(xfm_base_retrieval_config(), B, T, device, seed)


def make_clip_retrieval_run(B: int = 32, T: int = 40, device="cuda",
                            seed: int = 0, **config_kw):
    """The retrieval fine-tune step of `make_retrieval_run` with the
    CLIP-ViT-B/16 vision tower at 384 px (`xfm_clip_retrieval_config`, whose
    arguments `config_kw` passes on, `fused_ln` and `fused_mlp` among
    them): its 12 vision self-attentions go through K3. → (state, batch,
    step)."""
    return _retrieval_run(xfm_clip_retrieval_config(**config_kw), B, T,
                          device, seed)


def make_retrieval_train_run(B: int = 32, T: int = 40, device="cuda",
                             seed: int = 0, steps_per_epoch: int = 1000):
    """The step of the retrieval fine-tune as `tasks/retrieval.main` takes
    it on `Retrieval_coco.yaml` (`xfm_retrieval_eval_config`: 384 px,
    drop-path 0.1, text dropout 0.1, bf16): dropout and drop-path live,
    the batch's image ids `idx` all distinct, HF-AdamW and the schedule
    from the YAML's blocks at `steps_per_epoch` optimizer steps an epoch.
    → (state, batch, step) as `make_retrieval_run`'s."""
    import functools

    model = XFMForRetrieval(xfm_retrieval_eval_config()).to(device)
    init_weights(model, seed)
    sched = schedule_from_config(RETRIEVAL_COCO, steps_per_epoch)
    state = TrainState.create(model, create_optimizer_from_config(
        model, RETRIEVAL_COCO, sched))
    cfg = model.config
    batch = batch_to_torch(make_retrieval_batch(
        B, T, cfg.vision.image_res, cfg.text.vocab_size), device)
    batch["idx"] = torch.arange(B, device=device)
    return state, batch, make_train_step(functools.partial(
        retrieval_loss_fn, deterministic=False))


def _retrieval_run(cfg: XFMConfig, B: int, T: int, device, seed: int):
    model = XFMForRetrieval(cfg).to(device)
    init_weights(model, seed)
    state = TrainState.create(model, create_optimizer(
        model, linear_warmup_decay(1e-4, 1000, 100), clip_grad_norm=None))
    batch = batch_to_torch(make_retrieval_batch(
        B, T, cfg.vision.image_res, cfg.text.vocab_size), device)
    return state, batch, make_train_step(retrieval_loss_fn)


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


def retrieval_step_flops(B, T, patches, hidden=768, inter=3072,
                         layers=12) -> float:
    """Model FLOPs of one retrieval fine-tune step (forward + backward ≈ 3×
    forward): one vision pass, one text pass, the fusion passes over 3B
    rows (the positive and the two hard-negative sets)."""
    Nv = patches + 1
    fwd = (_transformer_flops(layers, hidden, inter, Nv, B)
           + _transformer_flops(layers, hidden, inter, T, B)
           + _transformer_flops(layers, hidden, inter, T, 3 * B, cross_kv=Nv))
    return 3 * fwd
