"""Weights carried across, loaded and initialized.

- `state_dict_from_jax`: the JAX package's param tree (nested dicts of numpy
  arrays) → a state_dict the port loads with `load_state_dict(strict=True)`.
  It is the port's own copy of `xfm_tpu/train/checkpoint.py`
  `export_xfm_checkpoint`: Dense kernels transposed, the decoder tied to the
  word embeddings; the patch kernel stays in the port's matmul layout
  [P·P·3, C] (the export writes the reference's Conv2d layout). The CLIP-ViT
  tower (`clip_vit_from_jax`) is the inverse of `import_clip_vit`, the Swin
  tower's (`swin_from_jax`) of `import_swin`; the DeiT tower
  (`deit_from_jax`) takes the reference's timm names.
- `load_reference_state_dict`: a reference-named torch state dict (e.g. a
  released checkpoint or a golden fixture) into a port module.
- `vqkd_from_jax`, `clip_teacher_from_jax`, `dino_teacher_from_jax`: the
  JAX VQ-KD tokenizer (with its `vq_stats`) and teachers → the port's.
- The importers of the tokenizer's checkpoints (`import_vqkd_checkpoint`,
  `load_vqkd_checkpoint`) and of its teachers' released weights
  (`import_openai_clip_visual`, `import_clip_teacher`,
  `import_dino_teacher`).
- The load half of `xfm_tpu/train/checkpoint.py`: `load_torch_state_dict`,
  `strip_prefix`, `choose_layers`, the resolution-change interpolations
  (`interpolate_abs_pos_embed`, `interpolate_rel_pos_bias_table`, Swin's
  `_interp_swin_table`) and
  `load_xfm_checkpoint`, which overlays a reference checkpoint on a port
  model as `import_xfm_checkpoint` + `merge_params` do; `vqa_checkpoint`,
  VQA's two routes to its decoder (`xfm_tpu/tasks/vqa.py`), and
  `caption_checkpoint`, captioning's three; and
  `reference_state_dict`, a port model's weights under the reference's
  names and layouts. A BERT text or fusion encoder keeps the port's
  RoBERTa names (`roberta.*`, `lm_head.*`); its reference names
  (`bert.*`, `cls.predictions.*`) are mapped on load and on export.
- `init_weights`: random weights that follow the JAX package's initializers.
- The save/restore half of `xfm_tpu/train/checkpoint.py`: `save_checkpoint`,
  `restore_checkpoint`, `latest_step`, `load_params_from_checkpoint`. A
  train state goes to `<ckpt_dir>/<step>/state.pt`, written by
  `torch.save`: the model's parameters by name (a frozen tower's too),
  the optimizer's state (HF-AdamW's moments `mu` and `nu` by name and its
  `count`; LARS's `mu` and `count`), and the state's `step`. The JAX
  package writes Orbax directories instead; the two formats do not read
  each other. The file holds whole tensors whatever the layout: a model
  sharded over `fsdp` (`core/partitioning`) writes what one process
  writes and restores from it, and the reverse.
"""
from __future__ import annotations

import math
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.patch_embed import patch_kernel_from_conv
from ..ops.relpos import num_relative_distance


def _t(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _pre(prefix: str) -> str:
    return f"{prefix}." if prefix else ""


def text_encoder_from_jax(p: Dict[str, Any], num_layers: int,
                          prefix: str = "") -> Dict[str, np.ndarray]:
    """JAX TextTransformer params → reference names under `prefix`."""
    sd: Dict[str, np.ndarray] = {}
    r = f"{_pre(prefix)}roberta"
    emb = p["embeddings"]
    for nm in ("word_embeddings", "position_embeddings",
               "token_type_embeddings"):
        sd[f"{r}.embeddings.{nm}.weight"] = _t(emb[nm]["embedding"])

    def dense(dst, sub):
        sd[f"{dst}.weight"] = _t(sub["kernel"]).T
        sd[f"{dst}.bias"] = _t(sub["bias"])

    def ln(dst, sub):
        sd[f"{dst}.weight"] = _t(sub["scale"])
        sd[f"{dst}.bias"] = _t(sub["bias"])

    ln(f"{r}.embeddings.LayerNorm", emb["LayerNorm"])
    for i in range(num_layers):
        lp = p[f"layer_{i}"]
        b = f"{r}.encoder.layer.{i}"
        for att in ("attention", "crossattention"):
            if att not in lp:
                continue
            for qkv in ("query", "key", "value"):
                dense(f"{b}.{att}.self.{qkv}", lp[att][qkv])
            dense(f"{b}.{att}.output.dense", lp[att]["attn_out"])
            ln(f"{b}.{att}.output.LayerNorm", lp[att]["output_LayerNorm"])
        dense(f"{b}.intermediate.dense", lp["intermediate_dense"])
        dense(f"{b}.output.dense", lp["output_dense"])
        ln(f"{b}.output.LayerNorm", lp["ffn_LayerNorm"])
    if "mlm_head" in p:
        h = f"{_pre(prefix)}lm_head"
        dense(f"{h}.dense", p["mlm_head"]["dense"])
        ln(f"{h}.layer_norm", p["mlm_head"]["layer_norm"])
        sd[f"{h}.bias"] = _t(p["mlm_head"]["bias"])
        sd[f"{h}.decoder.weight"] = sd[
            f"{r}.embeddings.word_embeddings.weight"]
        sd[f"{h}.decoder.bias"] = _t(p["mlm_head"]["bias"])
    return sd


def _beit_block_from_jax(bp: Dict[str, Any], b: str,
                         sd: Dict[str, np.ndarray]) -> None:
    """One JAX BeitBlock's params → reference names under `b`."""
    for nm in ("norm1", "norm2"):
        sd[f"{b}.{nm}.weight"] = _t(bp[nm]["scale"])
        sd[f"{b}.{nm}.bias"] = _t(bp[nm]["bias"])
    if "gamma_1" in bp:
        sd[f"{b}.gamma_1"] = _t(bp["gamma_1"])
        sd[f"{b}.gamma_2"] = _t(bp["gamma_2"])
    a = bp["attn"]
    sd[f"{b}.attn.qkv.weight"] = _t(a["qkv"]["kernel"]).T
    sd[f"{b}.attn.q_bias"] = _t(a["q_bias"])
    sd[f"{b}.attn.v_bias"] = _t(a["v_bias"])
    sd[f"{b}.attn.proj.weight"] = _t(a["proj"]["kernel"]).T
    sd[f"{b}.attn.proj.bias"] = _t(a["proj"]["bias"])
    if "relative_position_bias_table" in a:
        sd[f"{b}.attn.relative_position_bias_table"] = _t(
            a["relative_position_bias_table"])
    for fc in ("fc1", "fc2"):
        sd[f"{b}.mlp.{fc}.weight"] = _t(bp[fc]["kernel"]).T
        sd[f"{b}.mlp.{fc}.bias"] = _t(bp[fc]["bias"])


def _ln_from_jax(p: Dict[str, Any], dst: str,
                 sd: Dict[str, np.ndarray]) -> None:
    sd[f"{dst}.weight"] = _t(p["scale"])
    sd[f"{dst}.bias"] = _t(p["bias"])


def beit2_from_jax(p: Dict[str, Any], depth: int,
                   prefix: str = "") -> Dict[str, np.ndarray]:
    """JAX BeitVisionTransformer params → reference names under `prefix`
    (patch kernel kept in matmul layout): the optional forms where the
    tree has them (the mask token, `pos_embed`, per-block tables, the
    shared table as `rel_pos_bias.relative_position_bias_table`, `fc_norm`
    or the final norm as `norm`)."""
    sd: Dict[str, np.ndarray] = {}
    v = _pre(prefix)
    sd[f"{v}patch_embed.proj.weight"] = _t(p["patch_embed_kernel"])
    sd[f"{v}patch_embed.proj.bias"] = _t(p["patch_embed_bias"])
    sd[f"{v}cls_token"] = _t(p["cls_token"])
    for src, dst in (("mask_token", "mask_token"), ("pos_embed", "pos_embed"),
                     ("shared_rel_pos_table",
                      "rel_pos_bias.relative_position_bias_table")):
        if src in p:
            sd[f"{v}{dst}"] = _t(p[src])
    for i in range(depth):
        _beit_block_from_jax(p[f"block_{i}"], f"{v}blocks.{i}", sd)
    if "fc_norm" in p:
        _ln_from_jax(p["fc_norm"], f"{v}fc_norm", sd)
    if "final_norm" in p:
        _ln_from_jax(p["final_norm"], f"{v}norm", sd)
    return sd


def clip_vit_from_jax(p: Dict[str, Any], num_layers: int,
                      prefix: str = "") -> Dict[str, np.ndarray]:
    """JAX ClipVisionTransformer params → reference names under `prefix`
    (the inverse of `xfm_tpu/train/checkpoint.py` `import_clip_vit`; patch
    kernel kept in matmul layout)."""
    sd: Dict[str, np.ndarray] = {}
    v = _pre(prefix)

    def dense(dst, sub):
        sd[f"{dst}.weight"] = _t(sub["kernel"]).T
        sd[f"{dst}.bias"] = _t(sub["bias"])

    def ln(dst, sub):
        sd[f"{dst}.weight"] = _t(sub["scale"])
        sd[f"{dst}.bias"] = _t(sub["bias"])

    sd[f"{v}class_embedding"] = _t(p["class_embedding"])
    sd[f"{v}patch_embed.weight"] = _t(p["patch_embed_kernel"])
    sd[f"{v}pos_embed.weight"] = _t(p["position_embedding"])
    ln(f"{v}pre_layrnorm", p["pre_layrnorm"])
    for i in range(num_layers):
        lp = p[f"layer_{i}"]
        b = f"{v}encoder.layers.{i}"
        ln(f"{b}.layer_norm1", lp["layer_norm1"])
        ln(f"{b}.layer_norm2", lp["layer_norm2"])
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{b}.self_attn.{proj}", lp[proj])
        dense(f"{b}.mlp.fc1", lp["fc1"])
        dense(f"{b}.mlp.fc2", lp["fc2"])
    ln(f"{v}post_layernorm", p["post_layernorm"])
    return sd


def swin_from_jax(p: Dict[str, Any], config,
                  prefix: str = "") -> Dict[str, np.ndarray]:
    """JAX SwinTransformer params (`patch_embed`, `patch_norm`,
    `stage{s}_block{b}`, `merge{s}`, `norm`) → reference names under
    `prefix` (the inverse of `xfm_tpu/train/checkpoint.py` `import_swin`;
    patch kernel kept in matmul layout)."""
    sd: Dict[str, np.ndarray] = {}
    v = _pre(prefix)
    sd[f"{v}patch_embed.proj.weight"] = _t(p["patch_embed"]["kernel"])
    sd[f"{v}patch_embed.proj.bias"] = _t(p["patch_embed"]["bias"])
    _ln_from_jax(p["patch_norm"], f"{v}patch_embed.norm", sd)
    for si, depth in enumerate(config.depths):
        for bi in range(depth):
            bp, b = p[f"stage{si}_block{bi}"], f"{v}layers.{si}.blocks.{bi}"
            _ln_from_jax(bp["norm1"], f"{b}.norm1", sd)
            _ln_from_jax(bp["norm2"], f"{b}.norm2", sd)
            _dense_from_jax(bp["qkv"], f"{b}.attn.qkv", sd)
            _dense_from_jax(bp["proj"], f"{b}.attn.proj", sd)
            sd[f"{b}.attn.relative_position_bias_table"] = _t(
                bp["relative_position_bias_table"])
            _dense_from_jax(bp["fc1"], f"{b}.mlp.fc1", sd)
            _dense_from_jax(bp["fc2"], f"{b}.mlp.fc2", sd)
        if si < len(config.depths) - 1:
            d = f"{v}layers.{si}.downsample"
            _ln_from_jax(p[f"merge{si}"]["norm"], f"{d}.norm", sd)
            sd[f"{d}.reduction.weight"] = _t(
                p[f"merge{si}"]["reduction"]["kernel"]).T
    _ln_from_jax(p["norm"], f"{v}norm", sd)
    return sd


def deit_from_jax(p: Dict[str, Any], depth: int,
                  prefix: str = "") -> Dict[str, np.ndarray]:
    """JAX DeitVisionTransformer params (`patch_embed_kernel`,
    `patch_embed_bias`, `cls_token`, `pos_embed`, `block_{i}`, `norm`) →
    the reference's timm names under `prefix` (patch kernel kept in matmul
    layout)."""
    sd: Dict[str, np.ndarray] = {}
    v = _pre(prefix)
    sd[f"{v}patch_embed.proj.weight"] = _t(p["patch_embed_kernel"])
    sd[f"{v}patch_embed.proj.bias"] = _t(p["patch_embed_bias"])
    sd[f"{v}cls_token"] = _t(p["cls_token"])
    sd[f"{v}pos_embed"] = _t(p["pos_embed"])
    for i in range(depth):
        bp, b = p[f"block_{i}"], f"{v}blocks.{i}"
        _ln_from_jax(bp["norm1"], f"{b}.norm1", sd)
        _ln_from_jax(bp["norm2"], f"{b}.norm2", sd)
        _dense_from_jax(bp["qkv"], f"{b}.attn.qkv", sd)
        _dense_from_jax(bp["proj"], f"{b}.attn.proj", sd)
        _dense_from_jax(bp["fc1"], f"{b}.mlp.fc1", sd)
        _dense_from_jax(bp["fc2"], f"{b}.mlp.fc2", sd)
    _ln_from_jax(p["norm"], f"{v}norm", sd)
    return sd


def _mlp_head(p: Dict[str, Any], prefix: str,
              sd: Dict[str, np.ndarray]) -> None:
    """An `MLPHead` (fc1, ln, fc2 → indices 0, 1, 3) or a `DeepMLPHead`
    (fc0…fc3, ln0…ln3, out → 0, 1, 3, 4, 6, 7, 9, 10, 12)."""
    if "fc0" in p:
        pairs = [(f"fc{j}", 3 * j) for j in range(4)] + [
            (f"ln{j}", 3 * j + 1) for j in range(4)] + [("out", 12)]
    else:
        pairs = [("fc1", 0), ("ln", 1), ("fc2", 3)]
    for src, idx in pairs:
        if "kernel" in p[src]:
            sd[f"{prefix}.{idx}.weight"] = _t(p[src]["kernel"]).T
        else:
            sd[f"{prefix}.{idx}.weight"] = _t(p[src]["scale"])
        sd[f"{prefix}.{idx}.bias"] = _t(p[src]["bias"])


def state_dict_from_jax(params: Dict[str, Any],
                        config) -> Dict[str, torch.Tensor]:
    """JAX XFM param tree (with or without the `backbone` level) → port
    state_dict for `XFMBase` and its heads, either vision tower, the
    `cls_head` of NLVR or of a classifier (`MLPHead` or `DeepMLPHead`),
    and the `text_decoder` of `XFMForVQA` or `XFMForCaptioning` where the
    tree has one; any of the four vision towers (a BERT text tree is
    RoBERTa's in both packages). A tree may lack towers: the caption tree's backbone
    holds the vision tower alone, an image classifier's too, a text
    classifier's the text encoder alone (`TextClassifier`'s with no
    backbone level; its `config` the text config)."""
    bb = params["backbone"] if "backbone" in params else params
    sd: Dict[str, np.ndarray] = {}
    if "vision_encoder" in bb:
        kind, vc = config.vision_backbone, config.vision
        if kind == "clip_vit":
            sd = clip_vit_from_jax(bb["vision_encoder"],
                                   vc.num_hidden_layers, "vision_encoder")
        elif kind == "swin":
            sd = swin_from_jax(bb["vision_encoder"], vc, "vision_encoder")
        elif kind == "deit":
            sd = deit_from_jax(bb["vision_encoder"], vc.depth,
                               "vision_encoder")
        else:
            sd = beit2_from_jax(bb["vision_encoder"], vc.depth,
                                "vision_encoder")
    texts = (("text_encoder", config),) if not hasattr(config, "text") \
        else (("text_encoder", config.text), ("fusion_encoder",
                                              config.fusion))
    for name, tc in texts:
        if name in bb:
            sd.update(text_encoder_from_jax(bb[name], tc.num_hidden_layers,
                                            name))
    for name in ("vision_proj", "text_proj", "fusion_proj"):
        if name in bb:
            sd[f"{name}.weight"] = _t(bb[name]["kernel"]).T
            sd[f"{name}.bias"] = _t(bb[name]["bias"])
    if "temp" in bb:
        sd["temp"] = _t(bb["temp"]).reshape(())
    for head in ("itm_head", "bbox_head"):
        if head in bb:
            _mlp_head(bb[head], head, sd)
    if "mim_lm_head" in bb:  # the MIM code head
        sd["lm_head.weight"] = _t(bb["mim_lm_head"]["kernel"]).T
        sd["lm_head.bias"] = _t(bb["mim_lm_head"]["bias"])
    if "cls_head" in params:  # beside the backbone
        _mlp_head(params["cls_head"], "cls_head", sd)
    if "text_decoder" in params:  # the answer or caption decoder
        dec = params["text_decoder"]
        sd.update(text_encoder_from_jax(
            dec, sum(1 for k in dec if k.startswith("layer_")),
            "text_decoder"))
    return to_torch(sd)


def _dense_from_jax(p: Dict[str, Any], dst: str,
                    sd: Dict[str, np.ndarray]) -> None:
    sd[f"{dst}.weight"] = _t(p["kernel"]).T
    sd[f"{dst}.bias"] = _t(p["bias"])


def vqkd_from_jax(variables: Dict[str, Any],
                  config) -> Dict[str, torch.Tensor]:
    """JAX VQKD variables ({'params', 'vq_stats'}) → the port's `VQKD`
    state_dict: the encoder, `encode_task_layer.{0,2}`, the decoder
    (`in_proj`, blocks, `norm`), `decode_task_layer.{0,2}`, and the
    codebook and cluster sizes as `quantize.embedding.{weight,
    cluster_size}`."""
    p = variables["params"]
    sd = beit2_from_jax(p["encoder"], config.encoder.depth, "encoder")
    for j, idx in ((0, 0), (1, 2)):
        _dense_from_jax(p[f"encode_task_layer_{j}"],
                        f"encode_task_layer.{idx}", sd)
        _dense_from_jax(p[f"decode_task_layer_{j}"],
                        f"decode_task_layer.{idx}", sd)
    dec = p["decoder"]
    if "in_proj" in dec:
        _dense_from_jax(dec["in_proj"], "decoder.in_proj", sd)
    for i in range(config.decoder_depth):
        _beit_block_from_jax(dec[f"block_{i}"], f"decoder.blocks.{i}", sd)
    _ln_from_jax(dec["norm"], "decoder.norm", sd)
    q = variables["vq_stats"]["quantize"]
    sd["quantize.embedding.weight"] = _t(q["codebook"])
    sd["quantize.embedding.cluster_size"] = _t(q["cluster_size"])
    return to_torch(sd)


def clip_teacher_from_jax(params: Dict[str, Any],
                          config) -> Dict[str, torch.Tensor]:
    """JAX CLIPTeacher params → the port's: `visual.*` and `proj`."""
    sd = clip_vit_from_jax(params["visual"], config.num_hidden_layers,
                           "visual")
    sd["proj"] = _t(params["proj"])
    return to_torch(sd)


def dino_teacher_from_jax(params: Dict[str, Any],
                          config) -> Dict[str, torch.Tensor]:
    """JAX DINOTeacher params → the port's `backbone.*`."""
    return to_torch(beit2_from_jax(params["backbone"], config.depth,
                                   "backbone"))


def to_torch(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


# buffers the reference saves that the port rebuilds itself
_REFERENCE_BUFFERS = ("relative_position_index", "position_ids",
                      "attn_mask")


def _port_layout(sd) -> Dict[str, torch.Tensor]:
    """Reference entries (numpy or torch values) as the port holds them:
    the reference's buffers dropped, its Conv2d patch weights [C, 3, P, P]
    (BEiT's `patch_embed.proj.weight`, CLIP's `patch_embed.weight`) made
    matmul kernels, floats in f32."""
    out = {}
    for k, v in sd.items():
        if k.rsplit(".", 1)[-1] in _REFERENCE_BUFFERS:
            continue
        v = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if k.endswith(("patch_embed.proj.weight", "patch_embed.weight")) \
                and v.dim() == 4:
            v = patch_kernel_from_conv(v)
        out[k] = v.float() if v.is_floating_point() else v
    return out


def load_reference_state_dict(model: torch.nn.Module, sd, strict=True):
    """Load a reference-named state dict in the port's layout
    (`_port_layout`). → load_state_dict's result."""
    return model.load_state_dict(_port_layout(sd), strict=strict)


# ---------------------------------------------------------------------------
# the load half: reference checkpoints onto a port model

def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint file → {name: float32 numpy array}, unwrapped from
    a `model` and then a `module` entry where it has them, or from the
    `params` of a train state that `save_checkpoint` wrote. A zip-format
    file is mapped, not read through, so a train state's optimizer moments
    are never read."""
    import zipfile

    ckpt = torch.load(path, map_location="cpu", weights_only=False,
                      mmap=zipfile.is_zipfile(path))
    for key in ("model", "module", "params"):
        if isinstance(ckpt, dict) and isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
    return {k: v.detach().float().numpy() for k, v in ckpt.items()
            if hasattr(v, "numpy")}


def strip_prefix(sd: Dict[str, np.ndarray], prefix: str
                 ) -> Dict[str, np.ndarray]:
    """The entries under `prefix`, with it cut off."""
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}


def choose_layers(sd: Dict[str, np.ndarray], prefix: str,
                  mapper: Dict[int, int]) -> Dict[str, np.ndarray]:
    """`<prefix>.{src}.` keys become `<prefix>.{mapper[src]}.`; layers
    under `prefix` that `mapper` does not name are dropped (an N-layer
    encoder from an M-layer checkpoint)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if not k.startswith(prefix + "."):
            out[k] = v
            continue
        head, _, tail = k[len(prefix) + 1:].partition(".")
        if not head.isdigit():
            out[k] = v
        elif int(head) in mapper:
            out[f"{prefix}.{mapper[int(head)]}.{tail}"] = v
    return out


def _bicubic_axis_weights(src_len: int, dst_len: int):
    """Per-output-row 4-tap indices and weights of torch's bicubic resize
    (`F.interpolate(mode='bicubic', align_corners=False)`): half-pixel
    source coordinates, the Keys kernel with A = −0.75, replicated
    borders."""
    scale = src_len / dst_len
    x = (np.arange(dst_len, dtype=np.float64) + 0.5) * scale - 0.5
    x0 = np.floor(x).astype(np.int64)
    A = -0.75

    def k(d):
        d = np.abs(d)
        return np.where(
            d <= 1.0, ((A + 2.0) * d - (A + 3.0)) * d * d + 1.0,
            np.where(d < 2.0, (((d - 5.0) * d + 8.0) * d - 4.0) * A, 0.0))

    taps = x0[:, None] + np.arange(-1, 3)[None, :]
    w = k(taps - x[:, None]).astype(np.float32)
    return np.clip(taps, 0, src_len - 1), w


def interpolate_abs_pos_embed(pos: np.ndarray, num_patches: int,
                              num_extra_tokens: int = 1) -> np.ndarray:
    """Absolute position embeddings [1, extra + g², C] (or without the
    leading 1) resized to `num_patches` by separable bicubic interpolation
    of the square grid; the extra tokens are kept."""
    if pos.ndim == 2:
        pos = pos[None]
    n_old = pos.shape[1] - num_extra_tokens
    if n_old == num_patches:
        return pos
    g_old = int(round(n_old ** 0.5))
    g_new = int(round(num_patches ** 0.5))
    extra = pos[:, :num_extra_tokens]
    grid = np.asarray(pos[:, num_extra_tokens:], np.float32).reshape(
        1, g_old, g_old, -1)
    idx, w = _bicubic_axis_weights(g_old, g_new)
    grid = np.einsum("ia,biawc->biwc", w, grid[:, idx])
    grid = np.einsum("ja,bijac->bijc", w, grid[:, :, idx])
    return np.concatenate([extra, grid.reshape(1, g_new * g_new, -1)],
                          axis=1)


def interpolate_rel_pos_bias_table(table: np.ndarray,
                                   dst_window: Tuple[int, int]
                                   ) -> np.ndarray:
    """A BEiT rel-pos table [(2w-1)² + 3, H] resampled to `dst_window` by
    cubic splines over geometrically spaced source points (the reference's
    resolution change); the 3 cls distances are kept. scipy is imported
    only where the window changes."""
    src_num, heads = table.shape
    if src_num == num_relative_distance(dst_window):
        return table
    src_size = int(round((src_num - 3) ** 0.5))
    dst_size = 2 * dst_window[0] - 1
    extra = table[-3:]
    body = table[:-3].reshape(src_size, src_size, heads)

    # the reference's binary search for the progression's ratio q (bounds
    # 1.01 / 1.5, stopping at an interval of 1e-6, its last midpoint used):
    # a tighter search lands on another q and moves the table ~2e-4
    def geometric_points(n, target_half):
        left, right = 1.01, 1.5
        q = (left + right) / 2.0
        while right - left > 1e-6:
            q = (left + right) / 2.0
            gp = (1.0 - q ** (n // 2)) / (1.0 - q)
            if gp > target_half:
                right = q
            else:
                left = q
        dis, cur = [], 1.0
        for i in range(n // 2):
            dis.append(cur)
            cur += q ** (i + 1)
        r = [-d for d in reversed(dis)]
        return np.array(r + [0.0] + dis) if n % 2 == 1 else np.array(
            r + dis)

    if src_size != dst_size:
        src_x = geometric_points(src_size, (dst_size // 2) * 1.0)
        dst_x = np.arange(-(dst_size // 2), dst_size // 2 + 1,
                          dtype=np.float64)
    else:
        src_x = dst_x = np.arange(src_size, dtype=np.float64)

    from scipy import interpolate as si

    out = np.zeros((dst_size, dst_size, heads), np.float32)
    for h in range(heads):
        f = si.RectBivariateSpline(src_x, src_x,
                                   body[:, :, h].astype(np.float64),
                                   kx=min(3, src_size - 1),
                                   ky=min(3, src_size - 1))
        out[:, :, h] = f(dst_x, dst_x).astype(np.float32)
    return np.concatenate([out.reshape(dst_size * dst_size, heads), extra],
                          axis=0)


def _keys_cubic_weights(src_len: int, dst_len: int) -> np.ndarray:
    """[src_len, dst_len] weights of `jax.image.resize(..., "cubic")` along
    one axis when it upsamples: the Keys kernel with a = −0.5 at half-pixel
    centres, taps outside the input dropped and each column renormalized
    to sum 1."""
    x = (np.arange(dst_len) + 0.5) * (src_len / dst_len) - 0.5
    d = np.abs(x[None, :] - np.arange(src_len)[:, None])
    w = np.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0,
                 ((1.5 * d - 2.5) * d) * d + 1.0)
    w = np.where(d >= 2.0, 0.0, w)
    return w / w.sum(axis=0, keepdims=True)


def _interp_swin_table(table: np.ndarray, dst_num: int) -> np.ndarray:
    """A Swin rel-pos table [(2w−1)², H] resized to `dst_num` rows as
    `xfm_tpu/train/checkpoint.py` `_interp_swin_table` does it: its
    (2w−1) × (2w−1) grid by the cubic of `jax.image.resize` (Keys, a =
    −0.5; not torch's bicubic, a = −0.75), separably, in float64."""
    src = int(round(table.shape[0] ** 0.5))
    dst = int(round(dst_num ** 0.5))
    grid = np.asarray(table, np.float64).reshape(src, src, -1)
    w = _keys_cubic_weights(src, dst)
    out = np.einsum("ai,bj,abh->ijh", w, w, grid)
    return out.reshape(dst * dst, -1).astype(np.float32)


# a text tower's names: the port's (RoBERTa's) and BERT's reference ones,
# each prefix before any shorter one it starts with
_BERT_NAMES = (
    ("roberta.", "bert."),
    ("lm_head.layer_norm.", "cls.predictions.transform.LayerNorm."),
    ("lm_head.dense.", "cls.predictions.transform.dense."),
    ("lm_head.", "cls.predictions."))


def _from_bert_name(rest: str) -> Optional[str]:
    """A text tower's entry name under BERT's reference names (`bert.*`,
    `cls.predictions.*`) → the port's (`roberta.*`, `lm_head.*`); None for
    a name of neither form."""
    for port, ref in _BERT_NAMES:
        if rest.startswith(ref):
            return port + rest[len(ref):]
    return None


def _to_bert_name(rest: str) -> str:
    """The inverse of `_from_bert_name` on the port's names."""
    for port, ref in _BERT_NAMES:
        if rest.startswith(port):
            return ref + rest[len(port):]
    return rest


# the CLIP tower's Hugging Face names → the port's
_CLIP_ALIASES = (("vision_model.", ""), ("embeddings.", ""),
                 ("patch_embedding.weight", "patch_embed.weight"),
                 ("position_embedding.weight", "pos_embed.weight"))


def _reference_names(sd: Dict[str, Any], model) -> Dict[str, torch.Tensor]:
    """Reference names and layouts → the port's: the CLIP tower's Hugging
    Face names and the text towers' BERT names mapped, rel-pos tables
    (BEiT's by `interpolate_rel_pos_bias_table`, Swin's by
    `_interp_swin_table`) and position embeddings interpolated to the
    model's grid, then `_port_layout`."""
    c = model.config

    def host(v):
        return np.asarray(v.detach().float().cpu().numpy()
                          if torch.is_tensor(v) else v, np.float32)

    out = {}
    if not hasattr(model, "vision_encoder"):  # a text classifier's
        return _port_layout(sd)
    for k, v in sd.items():
        if k.startswith("vision_encoder.") and c.vision_backbone == "clip_vit":
            rest = k[len("vision_encoder."):]
            for old, new in _CLIP_ALIASES:
                if rest.startswith(old):
                    rest = new + rest[len(old):]
            k = "vision_encoder." + rest
        tower, _, rest = k.partition(".")
        if tower in ("text_encoder", "fusion_encoder"):
            k = f"{tower}.{_from_bert_name(rest) or rest}"
        if k.endswith("relative_position_bias_table") and \
                c.vision_backbone == "swin":
            dst = (2 * c.vision.window_size - 1) ** 2
            if v.shape[0] != dst:
                v = _interp_swin_table(host(v), dst)
        elif k.endswith("relative_position_bias_table"):
            g = c.vision.grid_size
            v = interpolate_rel_pos_bias_table(host(v), (g, g))
        elif k in ("vision_encoder.pos_embed.weight",
                   "vision_encoder.pos_embed"):
            v, n = host(v), c.vision.num_patches
            v = interpolate_abs_pos_embed(v, n).reshape(
                v.shape[:-2] + (n + 1, v.shape[-1]))
        out[k] = v
    return _port_layout(out)


@torch.no_grad()
def load_xfm_checkpoint(model, sd: Dict[str, Any]
                        ) -> Tuple[List[str], List[str]]:
    """Overlay a reference-named XFM state dict (numpy or torch values, e.g.
    `load_torch_state_dict`'s) on `model` in place, with the semantics of
    `xfm_tpu/train/checkpoint.py` `import_xfm_checkpoint` + `merge_params`:
    strict=False; rel-pos tables (BEiT's, or Swin's to the config's
    window) and position embeddings (BEiT's, CLIP's, DeiT's) interpolated
    where the model's grid differs; a BERT text or fusion encoder's
    `bert.*` / `cls.predictions.*` names taken as the port's; a shape that differs only by sizes of
    1 reshaped, any other shape mismatch (a vocabulary of another size, an
    untransposed kernel) refused with ValueError. → (missing, unexpected):
    the model's entries the checkpoint does not hold, and the checkpoint's
    entries the model does not have."""
    target = model.state_dict()
    ref = _reference_names(sd, model)

    def squeezed(shape):
        return tuple(d for d in shape if d != 1)

    for k, v in ref.items():
        if k in target and v.shape != target[k].shape:
            if squeezed(v.shape) != squeezed(target[k].shape):
                raise ValueError(
                    f"shape mismatch for {k!r}: checkpoint "
                    f"{tuple(v.shape)} vs model {tuple(target[k].shape)} — "
                    f"refusing to reinterpret")
            ref[k] = v.reshape(target[k].shape)
    for k, v in ref.items():
        if k in target:
            target[k].copy_(v.to(target[k].dtype))
    missing = [k for k in target if k not in ref]
    unexpected = [k for k in ref if k not in target]
    return missing, unexpected


def import_vqkd_checkpoint(sd: Dict[str, Any], vqkd_config
                           ) -> Dict[str, torch.Tensor]:
    """A torch VQ-KD tokenizer checkpoint → the entries of the port's `VQKD`
    that the tokenizer reads (`xfm_tpu/train/checkpoint.py`
    `import_vqkd_checkpoint`): the encoder (its patch kernel made a matmul
    kernel, its position embedding interpolated to the config's grid),
    `encode_task_layer.{0,2}` and the codebook with its cluster sizes
    (`quantize.embedding.{weight, cluster_size}`). The teacher, scaling
    and loss entries and the decoder are dropped (the decoder stays at its
    init, as in the JAX package)."""
    keep = ("encoder.", "encode_task_layer.", "quantize.embedding.weight",
            "quantize.embedding.cluster_size")
    out = {}
    for k, v in sd.items():
        if not k.startswith(keep):
            continue
        if k == "encoder.pos_embed":
            v = interpolate_abs_pos_embed(
                np.asarray(torch.as_tensor(v).float()),
                vqkd_config.encoder.num_patches)
        out[k] = v
    return _port_layout(out)


def load_vqkd_checkpoint(model, sd: Dict[str, Any]
                         ) -> Tuple[List[str], List[str]]:
    """`import_vqkd_checkpoint` loaded into a port `VQKD` in place
    (strict=False: what the checkpoint lacks stays at init) → (missing,
    unexpected)."""
    res = model.load_state_dict(import_vqkd_checkpoint(sd, model.config),
                                strict=False)
    return list(res.missing_keys), list(res.unexpected_keys)


def import_openai_clip_visual(sd: Dict[str, Any], config
                              ) -> Dict[str, torch.Tensor]:
    """An OpenAI CLIP image tower (`conv1`, `ln_pre`, `transformer.
    resblocks.{i}` with the fused `attn.in_proj_*`, `ln_post`; rooted at
    `visual.`) → the port's `ClipVisionTransformer` names: the fused q/k/v
    split, the position embedding interpolated to the config's grid."""
    def t(k):
        return torch.as_tensor(np.asarray(sd[k]) if not torch.is_tensor(
            sd[k]) else sd[k]).float()

    pos = t("positional_embedding").numpy()
    if pos.shape[0] - 1 != config.num_patches:
        pos = interpolate_abs_pos_embed(pos[None], config.num_patches)[0]
    out = {"class_embedding": t("class_embedding").reshape(-1),
           "patch_embed.weight": patch_kernel_from_conv(t("conv1.weight")),
           "pos_embed.weight": torch.from_numpy(np.asarray(pos, np.float32))}
    for dst, src in (("pre_layrnorm", "ln_pre"),
                     ("post_layernorm", "ln_post")):
        out[f"{dst}.weight"], out[f"{dst}.bias"] = (t(f"{src}.weight"),
                                                    t(f"{src}.bias"))
    C = config.hidden_size
    for i in range(config.num_hidden_layers):
        b, d = f"transformer.resblocks.{i}", f"encoder.layers.{i}"
        w, bias = t(f"{b}.attn.in_proj_weight"), t(f"{b}.attn.in_proj_bias")
        for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
            out[f"{d}.self_attn.{proj}.weight"] = w[j * C:(j + 1) * C]
            out[f"{d}.self_attn.{proj}.bias"] = bias[j * C:(j + 1) * C]
        for dst, src in (("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
                         ("self_attn.out_proj", "attn.out_proj"),
                         ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj")):
            out[f"{d}.{dst}.weight"] = t(f"{b}.{src}.weight")
            out[f"{d}.{dst}.bias"] = t(f"{b}.{src}.bias")
    return out


def import_clip_teacher(sd: Dict[str, Any], clip_config
                        ) -> Dict[str, torch.Tensor]:
    """A released OpenAI CLIP checkpoint → the port's `CLIPTeacher`
    (`visual.*` and `proj`; the text tower dropped)."""
    vis = strip_prefix(sd, "visual.")
    out = {f"visual.{k}": v for k, v in
           import_openai_clip_visual(vis, clip_config).items()}
    out["proj"] = torch.as_tensor(np.asarray(vis["proj"]) if not
                                  torch.is_tensor(vis["proj"])
                                  else vis["proj"]).float()
    return out


def import_dino_teacher(sd: Dict[str, Any], config
                        ) -> Dict[str, torch.Tensor]:
    """A DINO ViT-B/16 checkpoint (timm names, `module.` stripped) → the
    port's `DINOTeacher` (`backbone.*`): the fused qkv bias split into
    q_bias and v_bias, its k part dropped (a constant on every key moves
    each query's scores alike, which softmax ignores), the position
    embedding interpolated to the config's grid, the final `norm`."""
    if any(k.startswith("module.") for k in sd):
        sd = strip_prefix(sd, "module.")

    def a(k):
        v = sd[k]
        return np.asarray(v.detach().float().numpy() if torch.is_tensor(v)
                          else v, np.float32)

    out = {"patch_embed.proj.weight": a("patch_embed.proj.weight"),
           "patch_embed.proj.bias": a("patch_embed.proj.bias"),
           "cls_token": a("cls_token"),
           "pos_embed": interpolate_abs_pos_embed(a("pos_embed"),
                                                  config.num_patches)}
    C = config.embed_dim
    for i in range(config.depth):
        b = f"blocks.{i}"
        bias = a(f"{b}.attn.qkv.bias")
        out[f"{b}.attn.qkv.weight"] = a(f"{b}.attn.qkv.weight")
        out[f"{b}.attn.q_bias"] = bias[:C]
        out[f"{b}.attn.v_bias"] = bias[2 * C:]
        for nm in ("norm1", "norm2", "attn.proj", "mlp.fc1", "mlp.fc2"):
            out[f"{b}.{nm}.weight"] = a(f"{b}.{nm}.weight")
            out[f"{b}.{nm}.bias"] = a(f"{b}.{nm}.bias")
    if "norm.weight" in sd:
        out["norm.weight"], out["norm.bias"] = a("norm.weight"), a(
            "norm.bias")
    return {f"backbone.{k}": v for k, v in _port_layout(out).items()}


def _decoder_entries(sd: Dict[str, Any], src: str) -> Dict[str, Any]:
    """The decoder-shaped entries under `src` (a text, fusion or decoder
    prefix with its dot) as `text_decoder.*` under the port's RoBERTa
    names: `<src>roberta.*` and `<src>lm_head.*` as they are, the
    `<src>bert.*` / `<src>cls.predictions.*` variant renamed."""
    dec = "text_decoder."
    out = {}
    for k, v in sd.items():
        if not k.startswith(src):
            continue
        rest = k[len(src):]
        rest = _from_bert_name(rest) or rest
        if rest.startswith(("roberta.", "lm_head.")):
            out[dec + rest] = v
    return out


def _own_decoder(sd: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """A dict that holds `text_decoder.*`, its decoder under the port's
    names and every other entry as it is; None where it holds none."""
    dec = "text_decoder."
    if not any(k.startswith(dec) for k in sd):
        return None
    out = {k: v for k, v in sd.items() if not k.startswith(dec)}
    out.update(_decoder_entries(sd, dec))
    return out


def vqa_checkpoint(sd: Dict[str, Any], model, own_decoder: bool
                   ) -> Dict[str, Any]:
    """A reference-named state dict made ready for `load_xfm_checkpoint`
    on `XFMForVQA`, as `xfm_tpu/tasks/vqa.py` imports one:
    - `own_decoder` (the eval, or `load_vqa_pretrain`) and the dict holds
      `text_decoder.*` (a VQA checkpoint): its decoder as it is, the
      `text_decoder.bert.*` / `text_decoder.cls.predictions.*` variant
      renamed to the port's RoBERTa names;
    - otherwise any `text_decoder.*` dropped and, where the dict holds the
      fusion encoder (a pretrain or retrieval checkpoint), the decoder
      copied from it, its MLM head included. The fusion encoder's cross
      k/v take the vision width, the decoder's the text width: where the
      two differ this raises ValueError."""
    own = _own_decoder(sd) if own_decoder else None
    if own is not None:
        return own
    out = {k: v for k, v in sd.items() if not k.startswith("text_decoder.")}
    fusion = _decoder_entries(sd, "fusion_encoder.")
    if fusion:
        c = model.config
        if c.fusion.encoder_width != c.text.hidden_size:
            raise ValueError(
                f"the decoder cannot start from the fusion encoder: its "
                f"cross k/v take width {c.fusion.encoder_width}, the "
                f"decoder's {c.text.hidden_size}")
        out.update(fusion)
    return out


def caption_checkpoint(sd: Dict[str, Any], decoder_from: str = "fusion"
                       ) -> Dict[str, Any]:
    """A reference-named state dict made ready for `load_xfm_checkpoint`
    on `XFMForCaptioning` (`xfm_tpu/tasks/captioning.py` `load_ckpt_into`):
    - a dict that holds `text_decoder.*` (a caption checkpoint) loads its
      own decoder (`vqa_checkpoint`'s own-decoder names). The JAX package
      reads no `text_decoder.*` there and decodes with the fusion weights
      or an untrained decoder;
    - `decoder_from="fusion"`: the decoder copied from the fusion encoder,
      its MLM head included (both cross-attend to the vision width);
    - `decoder_from="text"` (the caption-domain pretrain): the decoder
      copied from the text encoder with its `lm_head` (or the `bert.` /
      `cls.` variant); its cross-attention, which the text encoder lacks,
      stays at init."""
    if decoder_from not in ("fusion", "text"):
        raise ValueError(f"decoder_from {decoder_from!r}: 'fusion' or "
                         "'text'")
    own = _own_decoder(sd)
    if own is not None:
        return own
    out = dict(sd)
    out.update(_decoder_entries(sd, f"{decoder_from}_encoder."))
    return out


def reference_state_dict(model) -> Dict[str, torch.Tensor]:
    """The model's weights under the reference's names and layouts
    (`reference_names` of its state dict)."""
    return reference_names(model.state_dict(),
                           getattr(model, "config", None))


def reference_names(state: Dict[str, torch.Tensor], config
                    ) -> Dict[str, torch.Tensor]:
    """A port state dict (a model's, or the parameters of a saved train
    state) under the reference's names and layouts, f32 on the CPU: the
    patch kernels back in Conv2d layout [C, 3, P, P], a BERT text or
    fusion encoder of `config` (an `XFMConfig`) under `bert.*` /
    `cls.predictions.*`; a `DeepMLPHead` stays `cls_head.{0…12}`, the
    indices `load_xfm_checkpoint` reads."""
    bert = {f"{name}_encoder" for name in ("text", "fusion")
            if getattr(getattr(config, name, None), "position_style",
                       None) == "bert"}
    out = {}
    for k, v in state.items():
        v = v.detach().float().cpu().clone()
        if k.endswith(("patch_embed.proj.weight", "patch_embed.weight")):
            ppc, C = v.shape
            P = int(round((ppc // 3) ** 0.5))
            v = v.reshape(P, P, 3, C).permute(3, 2, 0, 1).contiguous()
        tower, _, rest = k.partition(".")
        if tower in bert:
            k = f"{tower}.{_to_bert_name(rest)}"
        out[k] = v
    return out


def _trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator):
    """Standard normal truncated to [-2, 2], times `std` (flax
    `truncated_normal`)."""
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = torch.empty_like(t).uniform_(lo, 1 - lo, generator=g)
    t.copy_((torch.erfinv(2 * u - 1) * math.sqrt(2)).clamp_(-2, 2) * std)


@torch.no_grad()
def init_weights(model: torch.nn.Module, seed: int = 0) -> None:
    """Random weights following the JAX package's initializers: Dense
    lecun-normal (truncated), zero biases, LayerNorm ones, embeddings
    normal(1/√width), BEiT's patch kernel and cls/mask tokens trunc-normal
    0.02, BEiT proj/fc2 trunc-normal 0.02/√(2·layer) (`fix_init`),
    LayerScale at its init value, zero rel-pos tables, BEiT's absolute
    position embedding trunc-normal 0.02, CLIP's class embedding, patch
    kernel and position embedding and the CLIP teacher's `proj`
    normal(0.02), temp at its init value.
    The `fix_init` rescale takes every BEiT block stack of the model (the
    vision tower's; a tokenizer's encoder and decoder). A Swin tower's
    patch kernel is lecun-normal (a Dense in the JAX tower) and its
    rel-pos tables trunc-normal 0.02."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            _trunc_normal_(m.weight, math.sqrt(1.0 / m.in_features)
                           / 0.87962566103423978, g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, torch.nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in model.modules():  # after Linear: the tied decoder shares these
        if isinstance(m, torch.nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim),
                             generator=g)
    for name, p in model.named_parameters():
        last = name.rsplit(".", 1)[-1]
        if last in ("cls_token", "mask_token", "pos_embed") or name.endswith(
                "patch_embed.proj.weight"):
            _trunc_normal_(p, 0.02, g)
        elif last in ("class_embedding", "proj") or name.endswith(
                ("patch_embed.weight", "pos_embed.weight")):
            p.normal_(0.0, 0.02, generator=g)
        elif last in ("q_bias", "v_bias", "relative_position_bias_table") \
                or name.endswith("patch_embed.proj.bias") \
                or name.endswith("lm_head.bias"):
            p.zero_()
    cfg = getattr(model, "config", None)
    for m in model.modules():
        blocks = getattr(m, "blocks", None)
        if not (isinstance(blocks, torch.nn.ModuleList) and len(blocks)
                and hasattr(blocks[0], "use_ls")):
            continue
        for i, blk in enumerate(blocks):
            std = 0.02 / math.sqrt(2.0 * (i + 1))
            _trunc_normal_(blk.attn.proj.weight, std, g)
            _trunc_normal_(blk.mlp.fc2.weight, std, g)
            if blk.use_ls:
                blk.gamma_1.fill_(blk.c.init_values)
                blk.gamma_2.fill_(blk.c.init_values)
    from ..models.swin import SwinTransformer

    for m in model.modules():
        if isinstance(m, SwinTransformer):
            w = m.patch_embed.proj.weight
            _trunc_normal_(w, math.sqrt(1.0 / w.shape[0])
                           / 0.87962566103423978, g)
            for name, p in m.named_parameters():
                if name.endswith("relative_position_bias_table"):
                    _trunc_normal_(p, 0.02, g)
    if cfg is not None and hasattr(model, "temp"):
        model.temp.fill_(cfg.temp)


_STATE_FILE = "state.pt"


def _steps(ckpt_dir: str) -> List[int]:
    """The saved steps under `ckpt_dir`, in order."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit()
                  and os.path.isfile(os.path.join(ckpt_dir, d, _STATE_FILE)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step saved under `ckpt_dir`, or None."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _place(ckpt_dir: str, step: int, keep: int, write) -> str:
    """`write(path)` makes `<ckpt_dir>/<step>/state.pt` beside its place,
    which it is then renamed into; only the newest `keep` steps stay. →
    the step's directory."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    final = os.path.join(ckpt_dir, str(step))
    tmp = f"{final}.tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    write(os.path.join(tmp, _STATE_FILE))
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    for old in _steps(ckpt_dir)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    return final


def save_checkpoint(ckpt_dir: str, state, step: Optional[int] = None,
                    keep: int = 3) -> Optional[str]:
    """`state` (a `train_state.TrainState`) → `<ckpt_dir>/<step>/state.pt`
    (step: the state's own by default), written beside and renamed into
    place; then only the newest `keep` steps stay. → the step's
    directory. Under a process group every rank calls it and rank 0 alone
    writes (the others get None): on a sharded model
    (`core/partitioning`) every rank takes part in gathering the whole
    parameters and optimizer state, so that the file is the one a single
    process writes, whatever the layout."""
    from ..core import mesh, partitioning

    step = int(state.step if step is None else step)
    with torch.no_grad():
        payload = {"params": partitioning.full_parameters(state.model),
                   "optimizer": state.optimizer.state_dict(),
                   "step": int(state.step)}
        if mesh.rank() != 0:
            return None
        return _place(ckpt_dir, step, keep,
                      lambda path: torch.save(payload, path))


def link_checkpoint(src_dir: str, ckpt_dir: str, step: int,
                    keep: int = 3) -> str:
    """The step saved under `src_dir` placed under `ckpt_dir` too, as a
    hard link of its file (a copy where the file system has none), so
    that its bytes are not written again; then only the newest `keep`
    steps stay there. → the step's directory."""
    src = os.path.join(os.path.abspath(src_dir), str(step), _STATE_FILE)

    def write(path):
        try:
            os.link(src, path)
        except OSError:
            shutil.copyfile(src, path)

    return _place(ckpt_dir, step, keep, write)


def _load(ckpt_dir: str, step: Optional[int], device) -> Optional[dict]:
    ckpt_dir = os.path.abspath(ckpt_dir)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None
    # mapped, not read through: each tensor is copied once, to `device`
    return torch.load(os.path.join(ckpt_dir, str(step), _STATE_FILE),
                      map_location=device, weights_only=True, mmap=True)


def load_params_from_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                                device="cpu") -> Dict[str, torch.Tensor]:
    """The parameters alone of a saved step (the newest by default), by
    name."""
    payload = _load(ckpt_dir, step, device)
    if payload is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return payload["params"]


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None):
    """The saved step (the newest by default) copied into `state` in place,
    bit for bit: the model's parameters, the optimizer's state (moments
    and count), and the state's step. On a sharded model each rank copies
    its shards of the whole tensors, so a file written under any layout
    restores under any other. With nothing saved `state` is returned as it
    is."""
    from ..core import partitioning

    named = dict(state.model.named_parameters())
    payload = _load(ckpt_dir, step, partitioning.local(
        next(iter(named.values()))).device)
    if payload is None:
        return state
    params = payload["params"]
    if set(params) != set(named):
        raise KeyError(f"checkpoint parameters differ from the model's: "
                       f"{sorted(set(params) ^ set(named))[:5]}")
    for name, p in named.items():
        partitioning.local(p).copy_(partitioning.shard_of(params[name], p))
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state
