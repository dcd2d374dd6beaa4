"""The XFM-base pretrain and retrieval fine-tune configurations (BEiT-2 or
CLIP-ViT-B/16 vision tower), their synthetic batches and their FLOP counts:
copies of `__graft_entry__._xfm_config` / `_batch`,
`bench.pretrain_step_flops`, `scripts/bench_finetune.py`'s retrieval step
and `config_from_yaml`'s CLIP branch (those modules import JAX); and the
retrieval eval's configuration (`configs/xfm-ft/Retrieval_coco.yaml`, kept
here as a dict so that no YAML reader is needed) and a seeded in-memory
corpus with `RetrievalEvalData`'s interface; the pretrain task's
configuration (`configs/xfm-pt/Pretrain_base_4m.yaml`, read as data) and
its four-stream step on seeded device batches at the YAML's sizes; and
VQA's (`configs/xfm-ft/VQA.yaml`, kept as a dict), its fine-tune step and
its answer ranking on seeded device batches at the YAML's sizes; and COCO
captioning's (`configs/xfm-ft/Captioning.yaml` and `Captioning_pretrain.yaml`,
kept as dicts): its fine-tune step, beam eval, SCST step and domain-pretrain
step on seeded device batches at the YAMLs' sizes; and NLVR2's and RefCOCO
grounding's (`configs/xfm-ft/NLVR.yaml`, `Grounding_bbox.yaml` and
`Grounding_bbox_pretrain.yaml`, kept as dicts): their fine-tune steps and
a GradCAM batch on seeded device batches at the YAMLs' sizes; and the
classifiers' (`configs/xfm-ft/imagenet1k.yaml`, `imagenet1k_lp.yaml` and
`glue_mrpc.yaml`, kept as dicts): the ImageNet fine-tune step, the linear
probe's step and the GLUE step on seeded device batches at the YAMLs'
sizes; and the keys of the pretrain task's optional branches
(`PRETRAIN_VQKD_KEYS`, the VQ-KD tokenizer with region attention in the
last 3 blocks; `bf16_params`), which `make_pretrain_streams_run` takes, with
the FLOP count of that step (`pretrain_streams_flops`); and the retrieval
fine-tune with the Swin-B tower (`configs/model/config_swinB_384.json`,
read as data) and BERT-base text and fusion encoders, or with the DeiT-B/16
tower (`xfm_swin_retrieval_config`, `xfm_deit_retrieval_config`), their
train steps and their FLOP counts (Swin's windows and patch merging counted
on their own, `swin_flops`)."""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from .models.beit2 import VisionConfig
from .models.clip_vit import ClipVisionConfig
from .models.generation import XFMForCaptioning, XFMForVQA
from .models.task_models import (XFMForClassification, XFMForGrounding,
                                 XFMForNLVR, XFMForPretrain,
                                 XFMForRetrieval)
from .models.text_encoder import TextConfig
from .models.xfm import XFMConfig, config_from_yaml
from .train.checkpoint import init_weights
from .train.optim import create_optimizer, create_optimizer_from_config
from .train.schedules import (half_cosine, linear_warmup_decay,
                              schedule_from_config)
from .train.train_state import (TrainState, caption_loss_fn,
                                grounding_loss_fn, make_train_step,
                                nlvr_loss_fn, pretrain_loss_fn,
                                retrieval_loss_fn, vqa_loss_fn)


def _env_flag(value: Optional[bool], name: str) -> bool:
    """An explicit flag, or the JAX package's environment switch `name`."""
    return os.environ.get(name, "0") == "1" if value is None else bool(value)


def new_model(make, device, seed: int) -> torch.nn.Module:
    """`make()` constructed with its parameters allocated on `device` (not
    built on the host and copied: seconds of host time a full-width model),
    its host-built buffers moved there, and the weights of
    `init_weights(model, seed)`, which sets every parameter."""
    with torch.device(device):
        model = make()
    model = model.to(device)
    init_weights(model, seed)
    return model


def xfm_base_pretrain_config(hidden=768, layers=12, heads=12, inter=3072,
                             image_res=224, vocab=50265,
                             dtype=torch.bfloat16, act="gelu_tanh",
                             fused_ln: Optional[bool] = None,
                             fused_mlp: Optional[bool] = None) -> XFMConfig:
    """XFM-base (327M) as the JAX package benchmarks it: 224 px, patch 16,
    tanh-GELU, bf16 compute, drop-path off; smaller widths for tests.
    `fused_ln` / `fused_mlp` take the residual LayerNorms through K4 and the
    MLPs' second projections through K5; None reads `XFM_FUSED_LN` /
    `XFM_MLP_FUSED` == "1", as the JAX package does, and `XFM_ATTN_REMAT`
    == "1" checkpoints the plain attention (`attn_remat`)."""
    fused = dict(fused_ln=_env_flag(fused_ln, "XFM_FUSED_LN"),
                 fused_mlp=_env_flag(fused_mlp, "XFM_MLP_FUSED"),
                 attn_remat=_env_flag(None, "XFM_ATTN_REMAT"))
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
                 fused_mlp=_env_flag(fused_mlp, "XFM_MLP_FUSED"),
                 attn_remat=_env_flag(None, "XFM_ATTN_REMAT"))
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
                      fused_mlp: Optional[bool] = None,
                      parallel: Optional[dict] = None,
                      dtype: torch.dtype = torch.bfloat16):
    """The XFM-base pretrain step as `bench.py` drives it: random weights
    from `seed`, the seeded batch, HF-AdamW on
    linear_warmup_decay(1e-4, 1000, 100); the fused routes as
    `xfm_base_pretrain_config` takes them, computing in `dtype`; with
    `parallel` (a YAML's `parallel` block) the state placed as a task
    places it (`tasks.common.place_state`: cut where `tensor` > 1, sharded
    where `fsdp` > 1; with its `seq_shard`, the BEiT-2 tower and the text
    and fusion stacks sharded over the sequence). → (state, batch, step)
    with step(state, batch, generator) -> (state, metrics)."""
    cfg = xfm_base_pretrain_config(fused_ln=fused_ln, fused_mlp=fused_mlp,
                                   dtype=dtype)
    if (parallel or {}).get("seq_shard"):
        cfg = dataclasses.replace(cfg, **{
            k: dataclasses.replace(getattr(cfg, k), seq_shard=True)
            for k in ("vision", "text", "fusion")})
    model = new_model(lambda: XFMForPretrain(cfg), device, seed)
    sched = linear_warmup_decay(1e-4, 1000, 100)
    if parallel is None:
        state = TrainState.create(model, create_optimizer(model, sched))
    else:
        from .tasks.common import TaskContext, place_state

        state = place_state(
            TaskContext(config={"parallel": parallel}, out_dir="",
                        device=device), model, sched,
            lambda m, named: create_optimizer(m, sched, named_params=named))
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
                            seed: int = 0, parallel: Optional[dict] = None,
                            **config_kw):
    """The retrieval fine-tune step of `make_retrieval_run` with the
    CLIP-ViT-B/16 vision tower at 384 px (`xfm_clip_retrieval_config`, whose
    arguments `config_kw` passes on, `fused_ln` and `fused_mlp` among
    them): its 12 vision self-attentions go through K3. With `parallel`
    the state placed as `make_pretrain_run` places it. → (state, batch,
    step)."""
    return _retrieval_run(xfm_clip_retrieval_config(**config_kw), B, T,
                          device, seed, parallel)


def make_retrieval_train_run(B: int = 32, T: int = 40, device="cuda",
                             seed: int = 0, steps_per_epoch: int = 1000,
                             config: Optional[XFMConfig] = None):
    """The step of the retrieval fine-tune as `tasks/retrieval.main` takes
    it on `Retrieval_coco.yaml` (`xfm_retrieval_eval_config`: 384 px,
    drop-path 0.1, text dropout 0.1, bf16; or `config`): dropout and
    drop-path live, the batch's image ids `idx` all distinct, HF-AdamW and
    the schedule from the YAML's blocks at `steps_per_epoch` optimizer
    steps an epoch. → (state, batch, step) as `make_retrieval_run`'s."""
    import functools

    model = new_model(lambda: XFMForRetrieval(
        config or xfm_retrieval_eval_config()), device, seed)
    sched = schedule_from_config(RETRIEVAL_COCO, steps_per_epoch)
    state = TrainState.create(model, create_optimizer_from_config(
        model, RETRIEVAL_COCO, sched))
    cfg = model.config
    batch = batch_to_torch(make_retrieval_batch(
        B, T, cfg.vision.image_res, cfg.text.vocab_size), device)
    batch["idx"] = torch.arange(B, device=device)
    return state, batch, make_train_step(functools.partial(
        retrieval_loss_fn, deterministic=False))


def _retrieval_run(cfg: XFMConfig, B: int, T: int, device, seed: int,
                   parallel: Optional[dict] = None):
    model = new_model(lambda: XFMForRetrieval(cfg), device, seed)
    sched = linear_warmup_decay(1e-4, 1000, 100)
    if parallel is None:
        state = TrainState.create(model, create_optimizer(
            model, sched, clip_grad_norm=None))
    else:
        from .tasks.common import TaskContext, place_state

        state = place_state(
            TaskContext(config={"parallel": parallel}, out_dir="",
                        device=device), model, sched,
            lambda m, named: create_optimizer(m, sched, clip_grad_norm=None,
                                              named_params=named))
    batch = batch_to_torch(make_retrieval_batch(
        B, T, cfg.vision.image_res, cfg.text.vocab_size), device)
    return state, batch, make_train_step(retrieval_loss_fn)


def _transformer_flops(n_layers, hidden, inter, seq, batch, cross_kv=0,
                       kv_width=None):
    """Forward FLOPs of one encoder stack (matmuls only); with `cross_kv`
    tokens of width `kv_width` (the hidden width by default) to
    cross-attend to."""
    per_tok = 4 * hidden * hidden + 2 * hidden * inter
    attn = 2 * 2 * seq * seq * hidden
    cross = 0
    if cross_kv:
        per_tok += 2 * hidden * hidden
        cross = (2 * 2 * hidden * (kv_width or hidden) * cross_kv
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
                         layers=12, vision_fwd=None,
                         vision_width=None) -> float:
    """Model FLOPs of one retrieval fine-tune step (forward + backward ≈ 3×
    forward): one vision pass (a ViT of the text's sizes over `patches` + 1
    tokens, or `vision_fwd` FLOPs), one text pass, the fusion passes over
    3B rows (the positive and the two hard-negative sets) cross-attending
    to `patches` + 1 tokens of width `vision_width` (the text's by
    default)."""
    Nv = patches + 1
    if vision_fwd is None:
        vision_fwd = _transformer_flops(layers, hidden, inter, Nv, B)
    fwd = (vision_fwd + _transformer_flops(layers, hidden, inter, T, B)
           + _transformer_flops(layers, hidden, inter, T, 3 * B,
                                cross_kv=Nv, kv_width=vision_width))
    return 3 * fwd


# configs/model/config_swinB_384.json: Swin-B at 384 px, window 12
SWIN_B_384_JSON = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "model", "config_swinB_384.json")


def swin_retrieval_yaml(layers: Optional[int] = None, depths=None,
                        **keys) -> dict:
    """`RETRIEVAL_COCO` with `use_swin` (`config_swinB_384.json` read into
    `_vision`) and `text_encoder: data/bert-base-uncased`; `depths` (a
    tuple of 4) cuts the tower's stages, `layers` the text and fusion
    encoders; `keys` set on top."""
    from .core.config import load_json

    vision = load_json(SWIN_B_384_JSON)
    if depths:
        vision["depths"] = list(depths)
    cfg = dict(RETRIEVAL_COCO, use_beit_v2=False, use_swin=True,
               vision_config="configs/model/config_swinB_384.json",
               _vision=vision, image_res=vision["image_res"],
               text_encoder="data/bert-base-uncased", **keys)
    if layers:
        cfg.update(text_num_hidden_layers=layers, text_fusion_start_at=layers,
                   fusion_num_hidden_layers=layers)
    return cfg


def xfm_swin_retrieval_config(dtype=None, **kw) -> XFMConfig:
    """The retrieval model of `swin_retrieval_yaml(**kw)` as
    `tasks/retrieval.main` builds it (ITC + ITM heads): Swin-B, window 12,
    width 1024, drop-path 0.1; BERT-base text and fusion encoders (LN eps
    1e-12, pad 0, absolute positions), 12 + 12 layers."""
    return config_from_yaml(swin_retrieval_yaml(**kw), dtype=dtype,
                            use_contrastive_loss=True, use_matching_loss=True)


# the DeiT-B/16 tower's sizes in `config_from_yaml`'s `use_deit` keys
DEIT_B16 = dict(vision_width=768, num_hidden_layers=12,
                num_attention_heads=12)


def deit_retrieval_yaml(image_res: int = 384, layers: Optional[int] = None,
                        **keys) -> dict:
    """`RETRIEVAL_COCO` with `use_deit` (DeiT-B/16, patch 16, at
    `image_res`: 577 tokens at 384 px) and its RoBERTa text side; `layers`
    cuts every encoder; `keys` set on top."""
    vision = dict(DEIT_B16)
    cfg = dict(RETRIEVAL_COCO, use_beit_v2=False, use_deit=True,
               _vision=vision, image_res=image_res, **keys)
    if layers:
        vision["num_hidden_layers"] = layers
        cfg.update(text_num_hidden_layers=layers, text_fusion_start_at=layers,
                   fusion_num_hidden_layers=layers)
    return cfg


def xfm_deit_retrieval_config(dtype=None, **kw) -> XFMConfig:
    """The retrieval model of `deit_retrieval_yaml(**kw)` (ITC + ITM
    heads): its 12 blocks at 384 px go to K3 with no bias."""
    return config_from_yaml(deit_retrieval_yaml(**kw), dtype=dtype,
                            use_contrastive_loss=True, use_matching_loss=True)


def make_deit_retrieval_run(B: int = 32, T: int = 40, device="cuda",
                            seed: int = 0, parallel: Optional[dict] = None,
                            **kw):
    """The retrieval fine-tune step of `make_clip_retrieval_run` with
    `xfm_deit_retrieval_config(**kw)`: DeiT-B/16 + RoBERTa-base at 384 px,
    K3 forward and backward with no bias in each of the tower's blocks.
    → (state, batch, step)."""
    return _retrieval_run(xfm_deit_retrieval_config(**kw), B, T, device,
                          seed, parallel)


def make_swin_retrieval_train_run(B: int = 32, T: int = 40, device="cuda",
                                  seed: int = 0, **kw):
    """`make_retrieval_train_run` with `xfm_swin_retrieval_config(**kw)`:
    Swin-B + BERT-base at 384 px, bf16, dropout and drop-path live."""
    return make_retrieval_train_run(B, T, device, seed,
                                    config=xfm_swin_retrieval_config(**kw))


def make_deit_retrieval_train_run(B: int = 32, T: int = 40, device="cuda",
                                  seed: int = 0, **kw):
    """`make_retrieval_train_run` with `xfm_deit_retrieval_config(**kw)`:
    DeiT-B/16 + RoBERTa-base at 384 px, bf16; K3 forward and backward in
    each of the tower's blocks."""
    return make_retrieval_train_run(B, T, device, seed,
                                    config=xfm_deit_retrieval_config(**kw))


def swin_flops(vc, B: int) -> float:
    """Forward FLOPs of the Swin tower `vc` (a `SwinConfig`) on B images
    (matmuls only): the patch embedding, then in each block the qkv,
    output and MLP projections on every token and the scores and the
    weighted sum inside each window of ws² tokens, and the patch merging's
    4C → 2C reduction between stages."""
    H = vc.image_res // vc.patch_size
    L = H * H
    fl = 2 * L * vc.patch_size ** 2 * 3 * vc.embed_dim
    for si, depth in enumerate(vc.depths):
        C = vc.embed_dim * 2 ** si
        ws = min(vc.window_size, H)
        hid = int(C * vc.mlp_ratio)
        per_block = 2 * L * (4 * C * C + 2 * C * hid) + 2 * 2 * L * ws * ws * C
        fl += depth * per_block
        if si < len(vc.depths) - 1:
            fl += 2 * (L // 4) * 4 * C * 2 * C
            H //= 2
            L = H * H
    return fl * B


def tower_retrieval_step_flops(cfg: XFMConfig, B: int, T: int) -> float:
    """`retrieval_step_flops` of a Swin or DeiT retrieval model `cfg`: the
    Swin tower counted by `swin_flops` (its 1 + (res/32)² output rows of
    width `num_features` cross-attended), DeiT as a ViT of its sizes."""
    t = cfg.text
    kw = dict(hidden=t.hidden_size, inter=t.intermediate_size,
              layers=t.num_hidden_layers)
    vc = cfg.vision
    if cfg.vision_backbone == "swin":
        tokens = (vc.image_res // vc.patch_size // 2 ** (len(vc.depths)
                                                          - 1)) ** 2
        return retrieval_step_flops(B, T, tokens, vision_fwd=swin_flops(
            vc, B), vision_width=vc.num_features, **kw)
    vision_fwd = _transformer_flops(vc.depth, vc.embed_dim,
                                    int(vc.embed_dim * vc.mlp_ratio),
                                    vc.num_patches + 1, B)
    return retrieval_step_flops(B, T, vc.num_patches, vision_fwd=vision_fwd,
                                vision_width=vc.embed_dim, **kw)


PRETRAIN_YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "xfm-pt", "Pretrain_base_4m.yaml")


def pretrain_yaml(**keys) -> dict:
    """`configs/xfm-pt/Pretrain_base_4m.yaml` with `keys` set on top and
    its vision JSON read in (PyYAML needed)."""
    from .core.config import load_config, resolve_vision_config

    root = os.path.join(os.path.dirname(PRETRAIN_YAML), os.pardir, "model")
    cfg = load_config(PRETRAIN_YAML)
    cfg.update(keys)
    return resolve_vision_config(cfg, config_root=os.path.normpath(root))


# the pretrain YAML with the BEiT-2-large tower (24 blocks, width 1024, 16
# heads) and activation checkpointing on: the one shipped vision JSON whose
# pair pass at the YAML's batch needs the room
PRETRAIN_LARGE_KEYS = {
    "vision_config": "configs/model/config_beit2_large.json",
    "gradient_checkpointing": True}


def pretrain_large_yaml(**keys) -> dict:
    """`pretrain_yaml` with `PRETRAIN_LARGE_KEYS` (and `keys`) on top."""
    return pretrain_yaml(**{**PRETRAIN_LARGE_KEYS, **keys})


def vision_sizes(cfg: dict, hidden: int, inter: int, layers: int) -> tuple:
    """(width, MLP width, depth) of a pretrain YAML's BEiT-2 tower: the
    large tower's where `vision_config` names "large" (as
    `config_from_yaml` reads it), else the given ones."""
    if "large" in str(cfg.get("vision_config", "base")):
        return 1024, 4096, 24
    return hidden, inter, layers


def stream_batch_sizes(cfg: dict) -> dict:
    """The per-stream batch keys of a pretrain YAML: rows a step of each
    stream, region images and regions an image, text lengths and masks."""
    reg, txt = cfg.get("regions") or {}, cfg.get("texts") or {}
    return dict(image=(cfg.get("images") or {}).get("batch_size", 32),
                imagenet=(cfg.get("images_imagenet") or {}).get(
                    "batch_size", 32),
                regions=reg.get("batch_size", 32),
                max_images=reg.get("max_images", 16),
                max_regions=reg.get("max_regions", 5),
                text=txt.get("batch_size", 64),
                T=cfg.get("max_tokens", 30), M=cfg.get("max_masks", 15),
                text_T=txt.get("max_tokens", 128),
                text_M=txt.get("max_masks", 20),
                masked_patches=cfg.get("num_masking_patches", 75))


def make_stream_batches(sizes: dict, image_res: int, vocab: int,
                        patch: int = 16, seed: int = 0) -> dict:
    """Seeded synthetic batches of the four streams with the streams'
    shapes ({name: numpy batch}): normal-random images; texts of 4 tokens
    to full length, cls and sep at their ends, pads after; the masked
    copy with up to M positions (labels -100 past the real ones); block
    masks of exactly `masked_patches` patches; the region stream's
    images padded with zeros to `max_images`, each real image holding
    `max_regions` regions with a random box, its patch mask and cxcywh
    target."""
    r = np.random.RandomState(seed)
    G = image_res // patch
    P = G * G

    def images(n):
        return r.randn(n, image_res, image_res, 3).astype(np.float32)

    def texts(B, T, M):
        lens = r.randint(4, T + 1, B)
        atts = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
        ids = r.randint(5, vocab - 1, (B, T)).astype(np.int64)
        ids[:, 0] = 0
        ids[np.arange(B), lens - 1] = 2
        ids = np.where(atts == 1, ids, 1)
        pos = np.zeros((B, M), np.int64)
        lab = np.full((B, M), -100, np.int64)
        masked = ids.copy()
        for b in range(B):
            k = min(M, max(1, (lens[b] - 2) // 2))
            p = np.sort(r.choice(np.arange(1, lens[b] - 1), k,
                                 replace=False))
            pos[b, :k], lab[b, :k] = p, ids[b, p]
            masked[b, p] = 3
        return dict(text_ids=ids, text_atts=atts, text_ids_masked=masked,
                    masked_pos=pos, masked_ids=lab)

    def block_mask(B):
        m = np.zeros((B, P), bool)
        for b in range(B):
            m[b, r.choice(P, sizes["masked_patches"], replace=False)] = True
        return m

    B, R = sizes["image"], sizes["regions"]
    n_img = min(sizes["max_images"], -(-R // sizes["max_regions"]))
    idx = np.arange(R) // sizes["max_regions"] % n_img
    x0, y0 = r.randint(0, G, (2, R))
    x1 = np.minimum(G, x0 + r.randint(1, G // 2 + 1, R))
    y1 = np.minimum(G, y0 + r.randint(1, G // 2 + 1, R))
    grid_y, grid_x = np.mgrid[0:G, 0:G]
    inside = ((grid_x[None] >= x0[:, None, None])
              & (grid_x[None] < x1[:, None, None])
              & (grid_y[None] >= y0[:, None, None])
              & (grid_y[None] < y1[:, None, None])).reshape(R, P)
    region_images = np.zeros((sizes["max_images"], image_res, image_res, 3),
                             np.float32)
    region_images[:n_img] = images(n_img)
    box = np.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)
    return {
        "image": dict(images=images(B), image_mask=block_mask(B),
                      **texts(B, sizes["T"], sizes["M"])),
        "region": dict(images=region_images,
                       idx_to_group_img=idx.astype(np.int64),
                       image_atts=np.concatenate(
                           [np.ones((R, 1), np.int64),
                            inside.astype(np.int64)], 1),
                       target_bbox=(box / G).astype(np.float32),
                       is_image=np.zeros(R, np.float32),
                       **texts(R, sizes["T"], sizes["M"])),
        "imagenet": dict(images=images(sizes["imagenet"]),
                         image_mask=block_mask(sizes["imagenet"])),
        "text": texts(sizes["text"], sizes["text_T"], sizes["text_M"]),
    }


# the pretrain task's optional branches as this repository runs them on the
# card: the released tokenizer's layout (random weights from the task's
# fixed seed) and region attention in the last quarter of the blocks
PRETRAIN_VQKD_KEYS = {
    "use_vision_tokenizer": True,
    "tokenizer_model": "vqkd_encoder_base_decoder_3x768x12_clip",
    "codebook_size": 8192, "codebook_dim": 32, "local_attn_depth": 3}


# the streams whose images the shipped YAML decodes through the C++ loader
# (`num_workers`) and, under `device_randaug`, augments on the card
RANDAUG_STREAMS = ("image", "imagenet")


def make_pretrain_streams_run(device="cuda", seed: int = 0,
                              steps_per_epoch: int = 1000,
                              device_randaug: bool = False,
                              bs: Optional[int] = None, **keys):
    """The step of `run.py --task pretrain_DIY` on
    `Pretrain_base_4m.yaml` (`keys` set on top): XFM-base from the YAML
    (BEiT-2 at 224 px, tanh-GELU, drop-path 0.1, text dropout 0.1, bf16
    compute, the full RoBERTa vocabulary), HF-AdamW with the clip and the
    schedule from its blocks, the four streams' batches at its sizes on
    the device, each stream's loss under its flags at step 0 with dropout
    live; the state placed as the task places it
    (`tasks.common.place_state`: with `bf16_params` bf16 parameters and
    f32 masters, with a `parallel` block whose `fsdp` > 1 the model
    sharded); with `use_vision_tokenizer` the frozen tokenizer's code ids
    as MIM's targets (`tasks.pretrain.frozen_tokenizer`); with
    `device_randaug` the image and ImageNet streams' images seeded uint8,
    as the loader hands them
    over, and each step first runs RandAugment on them on the device
    (`tasks.pretrain.device_randaugment`, their generators under
    ("randaug", name)); with `bs` every stream's batch that size, as
    `--bs` sets it (`tasks/common.scale_batch`). → (state, batches, step,
    generators) with
    step(state, batches, generators) -> (state, metrics) and
    generators(i) the streams' generators of step i."""
    from .tasks.common import TaskContext, place_state, scale_batch
    from .tasks.pretrain import (RANDAUG_KEY, device_randaugment,
                                 frozen_tokenizer, stream_flags,
                                 stream_loss_fn)
    from .train.train_state import make_stream_step

    cfg = pretrain_yaml(**keys)
    if bs:
        scale_batch(cfg, bs, 1)
    if device_randaug:
        for block in ("images", "images_imagenet"):
            cfg[block] = dict(cfg[block], device_randaug=True)
    mcfg = config_from_yaml(cfg, use_contrastive_loss=True,
                            use_matching_loss=True, use_mlm_loss=True,
                            use_bbox_loss=True)
    model = new_model(lambda: XFMForPretrain(mcfg), device, seed)
    sched = schedule_from_config(cfg, steps_per_epoch)
    state = place_state(TaskContext(config=cfg, out_dir="", device=device),
                        model, sched)
    code_ids_fn = None
    if cfg.get("use_vision_tokenizer", False):
        _, code_ids_fn = frozen_tokenizer(cfg, device)
    nb = make_stream_batches(stream_batch_sizes(cfg), mcfg.vision.image_res,
                             mcfg.text.vocab_size, seed=seed)
    if device_randaug:
        r = np.random.RandomState(seed + 1)
        for name in RANDAUG_STREAMS:
            nb[name]["images"] = r.randint(
                0, 256, nb[name]["images"].shape).astype(np.uint8)
    batches = {k: batch_to_torch(v, device) for k, v in nb.items()}
    order = sorted(batches)
    loss_fn = stream_loss_fn({n: stream_flags(n, 0, cfg) for n in order},
                             {n: cfg.get(f"w{n}", 1.0) for n in order},
                             code_ids_fn=code_ids_fn)
    step = make_stream_step(loss_fn)
    augmented = RANDAUG_STREAMS if device_randaug else ()

    def generators(i):
        gens = {n: torch.Generator(device=device).manual_seed(
            seed * 1000 + 10 * i + j) for j, n in enumerate(order)}
        gens.update({("randaug", n): torch.Generator(
            device=device).manual_seed(seed * 1000 + 10 * i + RANDAUG_KEY
                                       + order.index(n))
            for n in augmented})
        return gens

    def stream_step(state, batches, gens):
        batches = device_randaugment(batches, {
            n: gens[("randaug", n)] for n in augmented if n in batches})
        return step(state, batches, gens)

    return state, batches, stream_step if augmented else step, generators


def pretrain_streams_flops(cfg: dict, hidden=768, inter=3072, layers=12,
                           vocab=50265, code_dim=32) -> float:
    """Model FLOPs (matmuls) of one four-stream pretrain step at the
    YAML's sizes (`stream_batch_sizes(cfg)`), forward + backward ≈ 3×
    forward: the image-text stream's pair pass (2B rows), clean and masked
    text passes, the 4B-row fusion pass and the MLM head; the region
    stream's tower over `max_images` rows (with `local_attn_depth` k, the
    last k blocks over regions + images), its text passes, the 4R-row
    fusion pass, the bbox pass and the MLM head; ImageNet's pair pass; the
    text stream's encoder and MLM head; MIM's code head under the
    tokenizer; plus the frozen tokenizer's forward alone (its encoder over
    the MIM streams' images, the projection and the code distances). The
    BEiT-2 passes take the tower's sizes (`vision_sizes`)."""
    sz = stream_batch_sizes(cfg)
    Nv = (cfg.get("image_res", 224) // cfg.get("patch_size", 16)) ** 2 + 1
    T, M = sz["T"], sz["M"]
    tf = _transformer_flops
    tokenizer = cfg.get("use_vision_tokenizer", False)
    K = cfg.get("codebook_size", 8192)
    vh, vi, vl = vision_sizes(cfg, hidden, inter, layers)

    def image_text(B):
        return (tf(vl, vh, vi, Nv, 2 * B)
                + 2 * tf(layers, hidden, inter, T, B)
                + tf(layers, hidden, inter, T, 4 * B, cross_kv=Nv,
                     kv_width=vh)
                + 2 * B * M * hidden * vocab)

    def mim_head(B):
        return 2 * B * (Nv - 1) * vh * K if tokenizer else 0

    B, R, I = sz["image"], sz["regions"], sz["max_images"]
    k = max(0, cfg.get("local_attn_depth", -1))
    region = (tf(vl - k, vh, vi, Nv, I)
              + tf(k, vh, vi, Nv, I + R)
              + 2 * tf(layers, hidden, inter, T, R)
              + tf(layers, hidden, inter, T, 5 * R, cross_kv=Nv,
                   kv_width=vh)
              + 2 * R * M * hidden * vocab)
    imagenet = tf(vl, vh, vi, Nv, 2 * sz["imagenet"])
    text = (tf(layers, hidden, inter, sz["text_T"], sz["text"])
            + 2 * sz["text"] * sz["text_M"] * hidden * vocab)
    fwd = (image_text(B) + mim_head(B) + region + imagenet
           + mim_head(sz["imagenet"]) + text)
    tok = 0
    if tokenizer:
        n = B + sz["imagenet"]
        tok = (tf(layers, hidden, inter, Nv, n)
               + 2 * n * (Nv - 1) * (hidden * hidden + hidden * code_dim
                                     + code_dim * K))
    return 3 * fwd + tok


# configs/xfm-ft/VQA.yaml, key for key (a CPU test holds the two equal)
VQA = {
    "train_file": ["data/finetune/vqa_train.json",
                   "data/finetune/vqa_nominival.json",
                   "data/finetune/vg_qa.json"],
    "test_file": ["data/finetune/vqa_test.json"],
    "answer_list": "data/finetune/answer_list.json",
    "vqa_root": "data/coco", "vg_root": "data/visualgenome",
    "use_beit_v2": True,
    "vision_config": "configs/model/config_beit2_base.json",
    "image_res": 480, "patch_size": 16, "local_attn_depth": -1,
    "text_encoder": "data/roberta-base",
    "text_num_hidden_layers": 12, "text_fusion_start_at": 12,
    "fusion_num_hidden_layers": 12, "fusion_fusion_start_at": 0,
    "num_dec_layers": 12, "decoder_fusion_start_at": 0, "pad_token_id": 1,
    "k_test": 128, "batch_size_train": 16, "batch_size_test": 16,
    "parallel": {"data": -1, "fsdp": 1, "tensor": 1},
    "optimizer": {"opt": "adamW", "lr": 3.0e-5, "weight_decay": 0.01,
                  "lr_mult": 2},
    "schedular": {"sched": "linear", "lr": 3.0e-5, "epochs": 8,
                  "num_warmup_steps": 0.1},
    "accelerator": {"RNG_SEED": 42},
}


def vqa_yaml(image_res: int = 480, layers: Optional[int] = None,
             **keys) -> dict:
    """`VQA` at `image_res`, every encoder and the decoder cut to `layers`
    where given, `keys` set on top."""
    cfg = dict(VQA, image_res=image_res)
    if layers:
        cfg.update(text_num_hidden_layers=layers, text_fusion_start_at=layers,
                   fusion_num_hidden_layers=layers, num_dec_layers=layers,
                   vision_depth=layers)
    cfg.update(keys)
    return cfg


def _token_rows(r, n: int, T: int, vocab: int, min_len: int,
                pad_id: int = 1):
    """n rows of cls (0), 1..T-2 tokens from [5, vocab - 1), sep (2) and
    pads, each row min_len..T long → (ids, atts) int32."""
    lens = r.randint(min_len, T + 1, n)
    atts = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    ids = r.randint(5, vocab - 1, (n, T)).astype(np.int32)
    ids[:, 0] = 0
    ids[np.arange(n), lens - 1] = 2
    return np.where(atts == 1, ids, pad_id).astype(np.int32), atts


def make_vqa_batch(B: int = 16, T: int = 40, max_answers: int = 4,
                   L: int = 10, image_res: int = 480, vocab: int = 50265,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """A seeded batch of `VQAData`'s train layout: normal-random images,
    questions of 6..T tokens, B · max_answers answers of 3..L tokens, each
    question with 1..max_answers real answers weighted by count / n (their
    weights summing to 1) and pads of weight 0 after them, `ques_idx` each
    row's question."""
    r = np.random.RandomState(seed)
    q_ids, q_atts = _token_rows(r, B, T, vocab, 6)
    a_ids, a_atts = _token_rows(r, B * max_answers, L, vocab, 3)
    weights = np.zeros((B, max_answers), np.float32)
    for b in range(B):
        n = r.randint(1, max_answers + 1)
        weights[b, :n] = r.dirichlet(np.ones(n))
    pad = weights.reshape(-1) == 0
    a_ids[pad, 1:], a_atts[pad, 2:] = 1, 0
    a_ids[pad, 1] = 2
    return dict(images=r.randn(B, image_res, image_res, 3).astype(np.float32),
                q_ids=q_ids, q_atts=q_atts, answer_ids=a_ids,
                answer_atts=a_atts, weights=weights.reshape(-1),
                ques_idx=np.repeat(np.arange(B, dtype=np.int32),
                                   max_answers))


def make_answer_list(n: int = 3129, L: int = 10, vocab: int = 50265,
                     seed: int = 0):
    """A seeded answer list as `VQAData.encode_answer_list` returns one:
    (ids, atts) [n, L], 1..L-2 tokens between cls and sep."""
    return _token_rows(np.random.RandomState(seed), n, L, vocab, 3)


def make_vqa_run(B: int = 16, T: int = 40, max_answers: int = 4,
                 L: int = 10, k_test: int = 128, n_answers: int = 3129,
                 device="cuda", seed: int = 0, steps_per_epoch: int = 1000,
                 **keys):
    """The step and the eval batch of `run.py --task vqa` on `VQA.yaml`
    (`keys` set on top): XFM-base with its 12-layer answer decoder at
    480 px, the full RoBERTa vocabulary, bf16 compute, random weights from
    `seed`; HF-AdamW and the schedule from the YAML's blocks; the step with
    dropout and drop-path live on a `make_vqa_batch` on the device; the
    rank of that batch's questions against a `make_answer_list` of
    `n_answers`, top `k_test`. → (state, batch, step, rank) with
    step(state, batch, generator) -> (state, metrics) and rank() ->
    (top-k ids, their probabilities)."""
    import functools

    cfg = vqa_yaml(**keys)
    model = new_model(lambda: XFMForVQA.from_yaml(cfg), device, seed)
    sched = schedule_from_config(cfg, steps_per_epoch)
    state = TrainState.create(model, create_optimizer_from_config(
        model, cfg, sched))
    c = model.config
    batch = batch_to_torch(make_vqa_batch(B, T, max_answers, L,
                                          c.vision.image_res,
                                          c.text.vocab_size, seed), device)
    ans_ids, ans_atts = (torch.from_numpy(a).long().to(device) for a in
                         make_answer_list(n_answers, L, c.text.vocab_size,
                                          seed + 1))

    def rank():
        return model.rank(batch["images"], batch["q_ids"], batch["q_atts"],
                          ans_ids, ans_atts, k_test)

    return state, batch, make_train_step(functools.partial(
        vqa_loss_fn, deterministic=False)), rank


def vqa_step_flops(B: int, T: int, n_answers: int, L: int, patches: int,
                   hidden=768, inter=3072, layers=12, dec_layers=12,
                   vocab=50265) -> float:
    """Model FLOPs of one VQA fine-tune step (forward + backward ≈ 3×
    forward): the vision, text and fusion passes over B questions, the
    decoder over the n_answers answers cross-attending to the T question
    states, and the LM head over every answer position."""
    Nv = patches + 1
    fwd = (_transformer_flops(layers, hidden, inter, Nv, B)
           + _transformer_flops(layers, hidden, inter, T, B)
           + _transformer_flops(layers, hidden, inter, T, B, cross_kv=Nv)
           + _transformer_flops(dec_layers, hidden, inter, L, n_answers,
                                cross_kv=T)
           + 2 * n_answers * L * hidden * (hidden + vocab))
    return 3 * fwd


# configs/xfm-ft/Captioning.yaml and Captioning_pretrain.yaml, key for key
# (a CPU test holds them equal)
CAPTIONING = {
    "train_file": ["data/finetune/coco_karpathy_train.json"],
    "val_file": "data/finetune/coco_karpathy_val.json",
    "test_file": "data/finetune/coco_karpathy_test.json",
    "image_root": "data/coco",
    "use_beit_v2": True,
    "vision_config": "configs/model/config_beit2_base.json",
    "image_res": 384, "patch_size": 16,
    "text_encoder": "data/roberta-base",
    "text_num_hidden_layers": 12, "text_fusion_start_at": 12,
    "fusion_num_hidden_layers": 12, "fusion_fusion_start_at": 0,
    "num_dec_layers": 12, "decoder_fusion_start_at": 0, "pad_token_id": 1,
    "prompt": "a picture of ", "prompt_length": 4, "max_tokens": 30,
    "max_length": 20, "min_length": 5, "num_beams": 3,
    "batch_size_train": 16, "batch_size_test": 32,
    "parallel": {"data": -1, "fsdp": 1, "tensor": 1},
    "optimizer": {"opt": "adamW", "lr": 1.0e-5, "weight_decay": 0.01,
                  "lr_mult": 2},
    "schedular": {"sched": "linear", "lr": 1.0e-5, "epochs": 5,
                  "num_warmup_steps": 0.1},
}
CAPTIONING_PRETRAIN = {
    "domain_pretrain": True,
    "train_file": ["data/pretrain/caption_pairs.jsonl"],
    "images": {"image_key": "binary", "is_image_rpath": False,
               "caption_key": "desc", "batch_size": 64},
    "image_root": "",
    "use_beit_v2": True,
    "vision_config": "configs/model/config_beit2_base.json",
    "image_res": 224, "patch_size": 16,
    "text_encoder": "data/roberta-base",
    "text_num_hidden_layers": 12, "text_fusion_start_at": 12,
    "fusion_num_hidden_layers": 12, "fusion_fusion_start_at": 0,
    "num_dec_layers": 12, "decoder_fusion_start_at": 0,
    "max_tokens": 30, "max_words": 30, "mask_prob": 0.5, "max_masks": 15,
    "max_steps": 100000,
    "parallel": {"data": -1, "fsdp": 1, "tensor": 1},
    "optimizer": {"opt": "adamW", "lr": 1.0e-4, "weight_decay": 0.01},
    "schedular": {"sched": "linear", "lr": 1.0e-4, "epochs": 1,
                  "num_warmup_steps": 2500},
}


def caption_yaml(image_res: Optional[int] = None,
                 layers: Optional[int] = None, pretrain: bool = False,
                 **keys) -> dict:
    """`CAPTIONING` (or with `pretrain` `CAPTIONING_PRETRAIN`) at
    `image_res` where given, every encoder and the decoder cut to `layers`
    where given, `keys` set on top."""
    cfg = dict(CAPTIONING_PRETRAIN if pretrain else CAPTIONING)
    if image_res:
        cfg["image_res"] = image_res
    if layers:
        cfg.update(text_num_hidden_layers=layers, text_fusion_start_at=layers,
                   fusion_num_hidden_layers=layers, num_dec_layers=layers,
                   vision_depth=layers)
    cfg.update(keys)
    return cfg


def make_caption_batch(B: int = 16, T: int = 30, image_res: int = 384,
                       vocab: int = 50265, prompt_ids=(), seed: int = 0
                       ) -> Dict[str, np.ndarray]:
    """A seeded batch of `CaptioningData`'s train layout: normal-random
    images, captions of 6..T tokens (cls, the prompt's ids where given,
    tokens, sep, pads) and image ids 0..B-1."""
    r = np.random.RandomState(seed)
    ids, atts = _token_rows(r, B, T, vocab, 6 + len(prompt_ids))
    if prompt_ids:
        ids[:, 1:1 + len(prompt_ids)] = prompt_ids
    return dict(images=r.randn(B, image_res, image_res, 3).astype(np.float32),
                text_ids=ids, text_atts=atts,
                image_id=np.arange(B, dtype=np.int64))


def make_caption_run(unit: str, B: Optional[int] = None, device="cuda",
                     seed: int = 0, **keys):
    """One unit of `run.py --task coco_captioning` at the YAMLs' sizes
    (`keys` set on top): XFM captioning (the BEiT-2 tower and a 12-layer
    decoder cross-attending from layer 0), the full RoBERTa vocabulary,
    bf16 compute, random weights from `seed`, HF-AdamW and the schedule
    from the YAML's blocks, seeded batches on the device:
    - "caption_train": the fine-tune's step at B = 16, T = 30, 384 px,
      dropout and drop-path live;
    - "caption_beam": the beam eval of B = 32 images (beam 3, `min_length`
      5, `max_length` 20, the prompt forced);
    - "caption_scst": an SCST step at B = 16, 5 samples an image, the
      greedy baseline, CIDEr-D rewards against seeded token references;
    - "caption_pretrain": the domain pretrain's step at B = 64, 224 px
      (`Captioning_pretrain.yaml`), dropout live.
    → (state, call) with call(i) running the unit once with the
    generators of i → its metrics (or the sequences of the beam)."""
    import functools

    from .models.generation import beam_generate

    pretrain = unit == "caption_pretrain"
    cfg = caption_yaml(pretrain=pretrain, **keys)
    model = new_model(lambda: XFMForCaptioning.from_yaml(cfg), device,
                      seed)
    sched = schedule_from_config(cfg, 1000)
    state = TrainState.create(model, create_optimizer_from_config(
        model, cfg, sched))
    c = model.config
    V, res = c.text.vocab_size, c.vision.image_res
    prompt = (10, 11, 12, 13)[: cfg.get("prompt_length", 0)]
    B = B or {"caption_beam": cfg.get("batch_size_test", 32),
              "caption_pretrain": (cfg.get("images") or {}).get(
                  "batch_size", 64)}.get(unit, cfg.get("batch_size_train",
                                                       16))
    batch = batch_to_torch(make_caption_batch(
        B, cfg.get("max_tokens", 30), res, V, prompt, seed), device)

    def gen(i):
        return torch.Generator(device=device).manual_seed(seed * 1000 + i)

    if unit in ("caption_train", "caption_pretrain"):
        step = make_train_step(functools.partial(caption_loss_fn,
                                                 deterministic=False))

        def call(i):
            nonlocal state
            state, m = step(state, batch, gen(i))
            return m
    elif unit == "caption_beam":
        def call(i):
            return beam_generate(
                model, batch["images"], bos_id=0, eos_id=2, pad_id=1,
                max_len=cfg["max_length"], min_len=cfg["min_length"],
                num_beams=cfg["num_beams"], prompt_ids=prompt)
    elif unit == "caption_scst":
        from .eval.cider import CiderD
        from .tasks.captioning import make_scst_step

        r = np.random.RandomState(seed + 1)
        refs = {str(b): [" ".join(map(str, r.randint(5, V - 1, 10)))
                         for _ in range(5)] for b in range(B)}
        step = make_scst_step(cfg, CiderD(refs), None, (0, 2, 1, prompt))
        iids = [str(b) for b in range(B)]

        def call(i):
            nonlocal state
            state, m = step(state, batch["images"], iids, gen(i))
            return m
    else:
        raise ValueError(f"unit {unit!r}")
    return state, call


def caption_step_flops(B: int, T: int, patches: int, hidden=768,
                       inter=3072, layers=12, dec_layers=12,
                       vocab=50265) -> float:
    """Model FLOPs of one caption fine-tune step (forward + backward ≈ 3×
    forward): the vision pass over B images, the decoder over B captions
    of T tokens cross-attending to the image tokens, and the LM head over
    every caption position."""
    Nv = patches + 1
    fwd = (_transformer_flops(layers, hidden, inter, Nv, B)
           + _transformer_flops(dec_layers, hidden, inter, T, B,
                                cross_kv=Nv)
           + 2 * B * T * hidden * (hidden + vocab))
    return 3 * fwd


_FT_COMMON = {
    "use_beit_v2": True,
    "vision_config": "configs/model/config_beit2_base.json",
    "image_res": 384, "patch_size": 16,
    "text_encoder": "data/roberta-base",
    "text_num_hidden_layers": 12, "text_fusion_start_at": 12,
    "fusion_num_hidden_layers": 12, "fusion_fusion_start_at": 0,
    "parallel": {"data": -1, "fsdp": 1, "tensor": 1},
    "optimizer": {"opt": "adamW", "lr": 3.0e-5, "weight_decay": 0.01,
                  "lr_mult": 2},
    "schedular": {"sched": "linear", "lr": 3.0e-5, "epochs": 10,
                  "num_warmup_steps": 0.1},
}
# configs/xfm-ft/NLVR.yaml, Grounding_bbox.yaml and
# Grounding_bbox_pretrain.yaml, key for key (a CPU test holds them equal)
NLVR = dict(_FT_COMMON,
            train_file=["data/finetune/nlvr_train.json"],
            val_file="data/finetune/nlvr_dev.json",
            test_file="data/finetune/nlvr_test.json",
            image_root="data/nlvr2", local_attn_depth=-1, max_tokens=40,
            batch_size=24, accelerator={"RNG_SEED": 42})
GROUNDING = dict(_FT_COMMON,
                 train_file=["data/finetune/refcoco_train.json"],
                 test_file="data/finetune/refcoco_val.json",
                 image_root="data/coco", max_tokens=30, batch_size=24)
GROUNDING_PRETRAIN = {
    "train_file_regions": ["data/pretrain/regions.jsonl"],
    "regions": {"image_key": "binary", "is_image_rpath": False,
                "caption_key": "caption", "batch_size": 96,
                "max_images": 80, "max_regions": 5,
                "min_perc_in_image": 0.5},
    "ret_bbox_loss": True, "ret_bbox_giou": True,
    "use_beit_v2": True,
    "vision_config": "configs/model/config_beit2_base.json",
    "image_res": 224, "patch_size": 16,
    "text_encoder": "data/roberta-base",
    "text_num_hidden_layers": 12, "text_fusion_start_at": 12,
    "fusion_num_hidden_layers": 12, "fusion_fusion_start_at": 0,
    "embed_dim": 256, "temp": 0.07, "learnable_temp": True,
    "max_tokens": 30, "max_words": 30, "mask_prob": 0.5, "max_masks": 15,
    "max_steps": 50000,
    "parallel": {"data": -1, "fsdp": 1, "tensor": 1},
    "optimizer": {"opt": "adamW", "lr": 1.0e-4, "weight_decay": 0.01,
                  "lr_mult": 2},
    "schedular": {"sched": "linear", "lr": 1.0e-4, "epochs": 1,
                  "num_warmup_steps": 1000},
}


def _cut(cfg: dict, image_res, layers) -> dict:
    if image_res:
        cfg["image_res"] = image_res
    if layers:
        cfg.update(text_num_hidden_layers=layers, text_fusion_start_at=layers,
                   fusion_num_hidden_layers=layers, vision_depth=layers)
    return cfg


def nlvr_yaml(image_res: Optional[int] = None, layers: Optional[int] = None,
              **keys) -> dict:
    """`NLVR` at `image_res` where given, every encoder cut to `layers`
    where given, `keys` set on top."""
    return dict(_cut(dict(NLVR), image_res, layers), **keys)


def grounding_yaml(image_res: Optional[int] = None,
                   layers: Optional[int] = None, pretrain: bool = False,
                   **keys) -> dict:
    """`GROUNDING` (or with `pretrain` `GROUNDING_PRETRAIN`) at `image_res`
    where given, every encoder cut to `layers` where given, `keys` set on
    top."""
    cfg = dict(GROUNDING_PRETRAIN if pretrain else GROUNDING)
    return dict(_cut(cfg, image_res, layers), **keys)


def make_pair_batch(B: int = 24, T: int = 40, image_res: int = 384,
                    vocab: int = 50265, seed: int = 0
                    ) -> Dict[str, np.ndarray]:
    """A seeded batch of `NLVRData`'s layout: 2B normal-random images (the
    pairs' first images, then their second ones), sentences of 6..T tokens
    and 0 / 1 targets."""
    r = np.random.RandomState(seed)
    ids, atts = _token_rows(r, B, T, vocab, 6)
    return dict(
        images=r.randn(2 * B, image_res, image_res, 3).astype(np.float32),
        text_ids=ids, text_atts=atts,
        targets=r.randint(0, 2, B).astype(np.int64))


def make_grounding_batch(B: int = 24, T: int = 30, image_res: int = 384,
                         vocab: int = 50265, seed: int = 0
                         ) -> Dict[str, np.ndarray]:
    """A seeded batch of `GroundingData`'s layout: normal-random images,
    phrases of 4..T tokens and target boxes (normalized cxcywh, each side
    0.1..0.6, inside the image)."""
    r = np.random.RandomState(seed)
    ids, atts = _token_rows(r, B, T, vocab, 4)
    wh = r.uniform(0.1, 0.6, (B, 2))
    c = wh / 2 + r.uniform(0.0, 1.0, (B, 2)) * (1.0 - wh)
    return dict(
        images=r.randn(B, image_res, image_res, 3).astype(np.float32),
        text_ids=ids, text_atts=atts,
        target_bbox=np.concatenate([c, wh], 1).astype(np.float32))


def _step_call(model, cfg, batch, loss_fn, device, seed):
    """HF-AdamW and the schedule from the YAML's blocks over `model`, and
    call(i): one step of `loss_fn` (dropout and drop-path live) on `batch`
    with the generator of i → (state, call)."""
    import functools

    state = TrainState.create(model, create_optimizer_from_config(
        model, cfg, schedule_from_config(cfg, 1000)))
    step = make_train_step(functools.partial(loss_fn, deterministic=False))
    return _stepper(state, step, batch, device, seed)


def _stepper(state, step, batch, device, seed):
    """→ (state, call) with call(i) running `step` on `batch` with the
    generator of i → its metrics."""

    def call(i):
        nonlocal state
        gen = torch.Generator(device=device).manual_seed(seed * 1000 + i)
        state, m = step(state, batch, gen)
        return m

    return state, call


def make_nlvr_run(B: Optional[int] = None, T: Optional[int] = None,
                  device="cuda", seed: int = 0, **keys):
    """The step of `run.py --task nlvr` on `NLVR.yaml` (`keys` set on top):
    XFM-base at 384 px, the full RoBERTa vocabulary, bf16 compute, random
    weights from `seed`, HF-AdamW and the schedule from the YAML's blocks,
    dropout and drop-path live, on a `make_pair_batch` of the YAML's
    `batch_size` pairs (24: 48 images) and `max_tokens` (40) on the
    device. → (state, call) with call(i) running one step with the
    generator of i → its metrics."""
    cfg = nlvr_yaml(**keys)
    model = new_model(lambda: XFMForNLVR(config_from_yaml(cfg)), device,
                      seed)
    c = model.config
    batch = batch_to_torch(make_pair_batch(
        B or cfg["batch_size"], T or cfg["max_tokens"], c.vision.image_res,
        c.text.vocab_size, seed), device)
    return _step_call(model, cfg, batch, nlvr_loss_fn, device, seed)


def make_grounding_run(unit: str = "grounding_train",
                       B: Optional[int] = None, device="cuda",
                       seed: int = 0, **keys):
    """One unit of `run.py --task refcoco_bbox` on `Grounding_bbox.yaml`
    (`keys` set on top), XFM-base at 384 px, the full RoBERTa vocabulary,
    bf16 compute, random weights from `seed`, on seeded device batches:
    - "grounding_train": the bbox fine-tune's step (`XFMForGrounding`,
      HF-AdamW and the schedule from the YAML's blocks, dropout and
      drop-path live) on a `make_grounding_batch` of the YAML's
      `batch_size` (24) phrases of `max_tokens` (30);
    - "gradcam": `itm_gradcam` of an `XFMForRetrieval` (no optimizer)
      over a batch of B = 8 (`main_weakly_supervised`'s default) at
      fusion layer `block_num` (8).
    → (state, call) with call(i) running the unit once with the generator
    of i → its metrics (the step's) or the cam [B, num_patches]."""
    from .models.gradcam import itm_gradcam

    cfg = grounding_yaml(**keys)
    gradcam = unit == "gradcam"
    if unit not in ("grounding_train", "gradcam"):
        raise ValueError(f"unit {unit!r}")
    if gradcam:
        model = new_model(lambda: XFMForRetrieval(config_from_yaml(
            cfg, use_contrastive_loss=True, use_matching_loss=True)),
            device, seed)
    else:
        model = new_model(lambda: XFMForGrounding(config_from_yaml(
            cfg, use_bbox_loss=True)), device, seed)
    c = model.config
    B = B or (8 if gradcam else cfg["batch_size"])
    batch = batch_to_torch(make_grounding_batch(
        B, cfg["max_tokens"], c.vision.image_res, c.text.vocab_size, seed),
        device)
    if not gradcam:
        return _step_call(model, cfg, batch, grounding_loss_fn, device, seed)
    block = cfg.get("block_num", 8)

    def call(i):
        return itm_gradcam(model, batch["images"], batch["text_ids"],
                           batch["text_atts"], block_num=block)

    return TrainState.create(model, None), call


def nlvr_step_flops(B: int, T: int, patches: int, hidden=768, inter=3072,
                    layers=12) -> float:
    """Model FLOPs of one NLVR fine-tune step (forward + backward ≈ 3×
    forward): the vision pass over 2B images, the text pass over B
    sentences and the two fusion passes (2B rows) cross-attending to the
    image tokens."""
    Nv = patches + 1
    fwd = (_transformer_flops(layers, hidden, inter, Nv, 2 * B)
           + _transformer_flops(layers, hidden, inter, T, B)
           + _transformer_flops(layers, hidden, inter, T, 2 * B,
                                cross_kv=Nv))
    return 3 * fwd


def grounding_step_flops(B: int, T: int, patches: int, hidden=768,
                         inter=3072, layers=12) -> float:
    """Model FLOPs of one grounding fine-tune step (forward + backward ≈ 3×
    forward): one vision, one text and one fusion pass over B rows."""
    Nv = patches + 1
    fwd = (_transformer_flops(layers, hidden, inter, Nv, B)
           + _transformer_flops(layers, hidden, inter, T, B)
           + _transformer_flops(layers, hidden, inter, T, B, cross_kv=Nv))
    return 3 * fwd


def gradcam_flops(B: int, T: int, patches: int, block_num: int = 8,
                  hidden=768, inter=3072, layers=12) -> float:
    """Model FLOPs of one GradCAM batch: the vision, text and fusion
    forwards over B rows, and the backward (≈ 2× forward) of the fusion
    layers from `block_num` on."""
    Nv = patches + 1
    fusion = _transformer_flops(1, hidden, inter, T, B, cross_kv=Nv)
    return (_transformer_flops(layers, hidden, inter, Nv, B)
            + _transformer_flops(layers, hidden, inter, T, B)
            + layers * fusion + 2 * (layers - block_num) * fusion)


_IMAGENET_COMMON = {
    "train_root": "data/imagenet/train", "val_root": "data/imagenet/val",
    "task_name": "imagenet", "num_labels": 1000,
    "use_beit_v2": True,
    "vision_config": "configs/model/config_beit2_base.json",
    "image_res": 224, "patch_size": 16,
    "text_encoder": "data/roberta-base",
    "text_num_hidden_layers": 12, "text_fusion_start_at": 12,
    "fusion_num_hidden_layers": 0, "fusion_fusion_start_at": 0,
    "parallel": {"data": -1, "fsdp": 1, "tensor": 1},
}
# configs/xfm-ft/imagenet1k.yaml, imagenet1k_lp.yaml and glue_mrpc.yaml,
# key for key (a CPU test holds them equal)
IMAGENET = dict(_IMAGENET_COMMON, is_lp=False, batch_size=128,
                warmup_epochs=5, mixup=0.8, label_smoothing=0.1,
                optimizer={"opt": "adamW", "lr": 1.0e-3, "min_lr": 1.0e-6,
                           "weight_decay": 0.05},
                schedular={"sched": "cosine", "lr": 1.0e-3, "epochs": 30})
IMAGENET_LP = dict(_IMAGENET_COMMON, is_lp=True, batch_size=512,
                   warmup_epochs=2, mixup=0.0,
                   optimizer={"opt": "lars", "lr": 0.4, "weight_decay": 0.0},
                   schedular={"sched": "cosine", "lr": 0.4, "epochs": 50})
GLUE_MRPC = {
    "train_file": None, "validation_file": None, "test_file": None,
    "glue_datasets": "data/glue_datasets",
    "task_name": "mrpc", "num_labels": 2, "max_length": 128,
    "per_device_train_batch_size": 32, "per_device_eval_batch_size": 8,
    "learning_rate": 5.0e-5, "weight_decay": 0.0, "num_train_epochs": 20,
    "max_train_steps": None, "num_warmup_steps": 0, "seed": 42,
    "lr_scheduler_type": "linear",
    "use_beit_v2": True,
    "vision_config": "configs/model/config_beit2_base.json",
    "image_res": 384, "patch_size": 16,
    "text_encoder": "data/roberta-base",
    "text_num_hidden_layers": 12, "text_fusion_start_at": 12,
    "fusion_num_hidden_layers": 0, "fusion_fusion_start_at": 0,
    "parallel": {"data": -1, "fsdp": 1, "tensor": 1},
}


def imagenet_yaml(lp: bool = False, image_res: Optional[int] = None,
                  layers: Optional[int] = None, **keys) -> dict:
    """`IMAGENET` (or with `lp` `IMAGENET_LP`) at `image_res` where given,
    the vision tower cut to `layers` where given, `keys` set on top."""
    cfg = dict(IMAGENET_LP if lp else IMAGENET)
    if image_res:
        cfg["image_res"] = image_res
    if layers:
        cfg["vision_depth"] = layers
    return dict(cfg, **keys)


def glue_yaml(layers: Optional[int] = None, **keys) -> dict:
    """`GLUE_MRPC` with the text encoder cut to `layers` where given, `keys`
    set on top."""
    cfg = dict(GLUE_MRPC)
    if layers:
        cfg.update(text_num_hidden_layers=layers, text_fusion_start_at=layers)
    return dict(cfg, **keys)


IMAGENET_UNITS = ("imagenet_train", "imagenet_lp")


def make_imagenet_run(unit: str = "imagenet_train", B: Optional[int] = None,
                      device="cuda", seed: int = 0, **keys):
    """One step of `run.py --task imagenet` at the YAML's batch, 224 px,
    bf16 compute, random weights from `seed`, on a seeded device batch of
    normal-random images (`keys` set on top of the YAML):
    - "imagenet_train" (`imagenet1k.yaml`, B = 128): the fine-tune step,
      HF-AdamW at decay 0.05 on the half-cosine schedule, soft CE on
      targets `mixup_cutmix` drew once on the host, dropout and drop-path
      live;
    - "imagenet_lp" (`imagenet1k_lp.yaml`, B = 512): the linear probe's
      step, the tower frozen, LARS on the head, hard CE.
    → (state, call) with call(i) running one step with the generator of i
    → its metrics."""
    from .tasks import imagenet

    if unit not in IMAGENET_UNITS:
        raise ValueError(f"unit {unit!r}")
    cfg = imagenet_yaml(lp=unit == "imagenet_lp", **keys)
    model = new_model(lambda: XFMForClassification(
        config_from_yaml(cfg), num_labels=cfg["num_labels"],
        task_name="imagenet", is_lp=cfg["is_lp"]), device, seed)
    B = B or cfg["batch_size"]
    res = model.config.vision.image_res
    r = np.random.RandomState(seed)
    batch = {"images": r.randn(B, res, res, 3).astype(np.float32),
             "targets": r.randint(0, cfg["num_labels"], B).astype(np.int64)}
    batch = next(imagenet.mixed([batch], cfg, np.random.default_rng(seed),
                                cfg["num_labels"]))
    opt = cfg["optimizer"]
    sched = half_cosine(opt["lr"], opt.get("min_lr", 1e-6),
                        cfg["schedular"]["epochs"], cfg["warmup_epochs"],
                        1000)
    state = TrainState.create(model, imagenet.build_optimizer(model, cfg,
                                                              sched))
    return _stepper(state, make_train_step(imagenet.make_loss_fn(cfg)),
                    batch_to_torch(batch, device), device, seed)


def make_glue_run(B: Optional[int] = None, T: Optional[int] = None,
                  device="cuda", seed: int = 0, **keys):
    """The step of `run.py --task glue` on `glue_mrpc.yaml` (`keys` set on
    top): the 12-layer RoBERTa text encoder and `MLPHead`, the full
    vocabulary, bf16 compute, random weights from `seed`, HF-AdamW (decay
    0, clip 1) on the linear schedule, dropout live, on a seeded device
    batch of the YAML's `per_device_train_batch_size` (32) sentence pairs
    of `max_length` (128) tokens at most. → (state, call) with call(i)
    running one step with the generator of i → its metrics."""
    import functools

    from .tasks.glue import glue_loss_fn

    cfg = glue_yaml(**keys)
    model = new_model(lambda: XFMForClassification(
        config_from_yaml(cfg), num_labels=cfg["num_labels"],
        task_name="glue"), device, seed)
    r = np.random.RandomState(seed)
    B = B or cfg["per_device_train_batch_size"]
    ids, atts = _token_rows(r, B, T or cfg["max_length"],
                            model.config.text.vocab_size, 16)
    batch = batch_to_torch(dict(text_ids=ids.astype(np.int64),
                                text_atts=atts.astype(np.int64),
                                targets=r.randint(0, cfg["num_labels"], B)
                                .astype(np.int64)), device)
    state = TrainState.create(model, create_optimizer(
        model, linear_warmup_decay(cfg["learning_rate"], 1000, 0),
        weight_decay=cfg["weight_decay"], clip_grad_norm=1.0))
    step = make_train_step(functools.partial(glue_loss_fn,
                                             deterministic=False))
    return _stepper(state, step, batch, device, seed)


def deep_head_flops(B: int, in_dim: int = 1536,
                    num_labels: int = 1000) -> float:
    """Forward FLOPs of `DeepMLPHead` over B rows (its five matmuls)."""
    d = in_dim // 2
    dims = [in_dim, 4 * d, 8 * d, 4 * d, 2 * d, num_labels]
    return 2 * B * sum(a * b for a, b in zip(dims, dims[1:]))


def imagenet_step_flops(B: int, patches: int, lp: bool = False,
                        hidden=768, inter=3072, layers=12,
                        num_labels=1000) -> float:
    """Model FLOPs of one ImageNet step (forward + backward ≈ 3× forward):
    the tower over B images and the 48.7 M-parameter `DeepMLPHead`; under
    `lp` the tower's forward alone and the head's three."""
    tower = _transformer_flops(layers, hidden, inter, patches + 1, B)
    head = deep_head_flops(B, 2 * hidden, num_labels)
    return (tower if lp else 3 * tower) + 3 * head


def glue_step_flops(B: int, T: int, hidden=768, inter=3072, layers=12,
                    num_labels=2) -> float:
    """Model FLOPs of one GLUE step (forward + backward ≈ 3× forward): the
    text encoder over B rows of T tokens and the `MLPHead` on the cls."""
    head = 2 * B * (hidden * 2 * hidden + 2 * hidden * num_labels)
    return 3 * (_transformer_flops(layers, hidden, inter, T, B) + head)
