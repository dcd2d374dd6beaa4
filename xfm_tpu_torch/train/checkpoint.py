"""Weights carried across, loaded and initialized.

- `state_dict_from_jax`: the JAX package's param tree (nested dicts of numpy
  arrays) → a state_dict the port loads with `load_state_dict(strict=True)`.
  It is the port's own copy of `xfm_tpu/train/checkpoint.py`
  `export_xfm_checkpoint`: Dense kernels transposed, the decoder tied to the
  word embeddings; the patch kernel stays in the port's matmul layout
  [P·P·3, C] (the export writes the reference's Conv2d layout). The CLIP-ViT
  tower (`clip_vit_from_jax`) is the inverse of `import_clip_vit`.
- `load_reference_state_dict`: a reference-named torch state dict (e.g. a
  released checkpoint or a golden fixture) into a port module.
- The load half of `xfm_tpu/train/checkpoint.py`: `load_torch_state_dict`,
  `strip_prefix`, `choose_layers`, the resolution-change interpolations
  (`interpolate_abs_pos_embed`, `interpolate_rel_pos_bias_table`) and
  `load_xfm_checkpoint`, which overlays a reference checkpoint on a port
  model as `import_xfm_checkpoint` + `merge_params` do; and
  `reference_state_dict`, a port model's weights under the reference's
  names and layouts.
- `init_weights`: random weights that follow the JAX package's initializers.
- The save/restore half of `xfm_tpu/train/checkpoint.py`: `save_checkpoint`,
  `restore_checkpoint`, `latest_step`, `load_params_from_checkpoint`. A
  train state goes to `<ckpt_dir>/<step>/state.pt`, written by
  `torch.save`: the parameters by name, HF-AdamW's moments `mu` and `nu`
  by name and its `count`, and the state's `step`. The JAX package writes
  Orbax directories instead; the two formats do not read each other.
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


def beit2_from_jax(p: Dict[str, Any], depth: int,
                   prefix: str = "") -> Dict[str, np.ndarray]:
    """JAX BeitVisionTransformer params → reference names under `prefix`
    (patch kernel kept in matmul layout)."""
    sd: Dict[str, np.ndarray] = {}
    v = _pre(prefix)
    sd[f"{v}patch_embed.proj.weight"] = _t(p["patch_embed_kernel"])
    sd[f"{v}patch_embed.proj.bias"] = _t(p["patch_embed_bias"])
    sd[f"{v}cls_token"] = _t(p["cls_token"])
    sd[f"{v}mask_token"] = _t(p["mask_token"])
    for i in range(depth):
        bp = p[f"block_{i}"]
        b = f"{v}blocks.{i}"
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
        sd[f"{b}.attn.relative_position_bias_table"] = _t(
            a["relative_position_bias_table"])
        for fc in ("fc1", "fc2"):
            sd[f"{b}.mlp.{fc}.weight"] = _t(bp[fc]["kernel"]).T
            sd[f"{b}.mlp.{fc}.bias"] = _t(bp[fc]["bias"])
    sd[f"{v}fc_norm.weight"] = _t(p["fc_norm"]["scale"])
    sd[f"{v}fc_norm.bias"] = _t(p["fc_norm"]["bias"])
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


def _mlp_head(p: Dict[str, Any], prefix: str,
              sd: Dict[str, np.ndarray]) -> None:
    sd[f"{prefix}.0.weight"] = _t(p["fc1"]["kernel"]).T
    sd[f"{prefix}.0.bias"] = _t(p["fc1"]["bias"])
    sd[f"{prefix}.1.weight"] = _t(p["ln"]["scale"])
    sd[f"{prefix}.1.bias"] = _t(p["ln"]["bias"])
    sd[f"{prefix}.3.weight"] = _t(p["fc2"]["kernel"]).T
    sd[f"{prefix}.3.bias"] = _t(p["fc2"]["bias"])


def state_dict_from_jax(params: Dict[str, Any],
                        config) -> Dict[str, torch.Tensor]:
    """JAX XFM param tree (with or without the `backbone` level) → port
    state_dict for `XFMBase` and its heads, either vision tower."""
    bb = params["backbone"] if "backbone" in params else params
    if config.vision_backbone == "clip_vit":
        sd = clip_vit_from_jax(bb["vision_encoder"],
                               config.vision.num_hidden_layers,
                               "vision_encoder")
    else:
        sd = beit2_from_jax(bb["vision_encoder"], config.vision.depth,
                            "vision_encoder")
    sd.update(text_encoder_from_jax(bb["text_encoder"],
                                    config.text.num_hidden_layers,
                                    "text_encoder"))
    sd.update(text_encoder_from_jax(bb["fusion_encoder"],
                                    config.fusion.num_hidden_layers,
                                    "fusion_encoder"))
    for name in ("vision_proj", "text_proj", "fusion_proj"):
        if name in bb:
            sd[f"{name}.weight"] = _t(bb[name]["kernel"]).T
            sd[f"{name}.bias"] = _t(bb[name]["bias"])
    if "temp" in bb:
        sd["temp"] = _t(bb["temp"]).reshape(())
    for head in ("itm_head", "bbox_head"):
        if head in bb:
            _mlp_head(bb[head], head, sd)
    return to_torch(sd)


def to_torch(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


# buffers the reference saves that the port rebuilds itself
_REFERENCE_BUFFERS = ("relative_position_index", "position_ids")


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
    a `model` and then a `module` entry where it has them."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    if isinstance(ckpt, dict) and "module" in ckpt:
        ckpt = ckpt["module"]
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


# the CLIP tower's Hugging Face names → the port's
_CLIP_ALIASES = (("vision_model.", ""), ("embeddings.", ""),
                 ("patch_embedding.weight", "patch_embed.weight"),
                 ("position_embedding.weight", "pos_embed.weight"))


def _reference_names(sd: Dict[str, Any], model) -> Dict[str, torch.Tensor]:
    """Reference names and layouts → the port's: the CLIP tower's Hugging
    Face names mapped, rel-pos tables and position embeddings interpolated
    to the model's grid, then `_port_layout`."""
    c = model.config

    def host(v):
        return np.asarray(v.detach().float().cpu().numpy()
                          if torch.is_tensor(v) else v, np.float32)

    out = {}
    for k, v in sd.items():
        if k.startswith("vision_encoder.") and c.vision_backbone == "clip_vit":
            rest = k[len("vision_encoder."):]
            for old, new in _CLIP_ALIASES:
                if rest.startswith(old):
                    rest = new + rest[len(old):]
            k = "vision_encoder." + rest
        if k.endswith("relative_position_bias_table"):
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
    strict=False; BEiT rel-pos tables and position embeddings interpolated
    where the model's grid differs; a shape that differs only by sizes of
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


def reference_state_dict(model) -> Dict[str, torch.Tensor]:
    """The model's weights under the reference's names and layouts, on the
    CPU: the patch kernels back in Conv2d layout [C, 3, P, P]."""
    out = {}
    for k, v in model.state_dict().items():
        v = v.detach().float().cpu().clone()
        if k.endswith(("patch_embed.proj.weight", "patch_embed.weight")):
            ppc, C = v.shape
            P = int(round((ppc // 3) ** 0.5))
            v = v.reshape(P, P, 3, C).permute(3, 2, 0, 1).contiguous()
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
    LayerScale at its init value, zero rel-pos tables, CLIP's class
    embedding, patch kernel and position embedding normal(0.02), temp at its
    init value."""
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
        if last in ("cls_token", "mask_token") or name.endswith(
                "patch_embed.proj.weight"):
            _trunc_normal_(p, 0.02, g)
        elif last == "class_embedding" or name.endswith(
                ("patch_embed.weight", "pos_embed.weight")):
            p.normal_(0.0, 0.02, generator=g)
        elif last in ("q_bias", "v_bias", "relative_position_bias_table") \
                or name.endswith("patch_embed.proj.bias") \
                or name.endswith("lm_head.bias"):
            p.zero_()
    cfg = getattr(model, "config", None)
    vision = getattr(model, "vision_encoder", model)
    for i, blk in enumerate(getattr(vision, "blocks", [])):
        std = 0.02 / math.sqrt(2.0 * (i + 1))
        _trunc_normal_(blk.attn.proj.weight, std, g)
        _trunc_normal_(blk.mlp.fc2.weight, std, g)
        if blk.use_ls:
            blk.gamma_1.fill_(blk.c.init_values)
            blk.gamma_2.fill_(blk.c.init_values)
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


def save_checkpoint(ckpt_dir: str, state, step: Optional[int] = None,
                    keep: int = 3) -> str:
    """`state` (a `train_state.TrainState`) → `<ckpt_dir>/<step>/state.pt`
    (step: the state's own by default), written beside and renamed into
    place; then only the newest `keep` steps stay. → the step's
    directory."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    step = int(state.step if step is None else step)
    opt = state.optimizer
    payload = {"params": dict(zip(opt.names, opt.params)),
               "optimizer": opt.state_dict(), "step": int(state.step)}
    final = os.path.join(ckpt_dir, str(step))
    tmp = f"{final}.tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    with torch.no_grad():
        torch.save(payload, os.path.join(tmp, _STATE_FILE))
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    for old in _steps(ckpt_dir)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    return final


def _load(ckpt_dir: str, step: Optional[int], device) -> Optional[dict]:
    ckpt_dir = os.path.abspath(ckpt_dir)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None
    return torch.load(os.path.join(ckpt_dir, str(step), _STATE_FILE),
                      map_location=device, weights_only=True)


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
    bit for bit: parameters, the optimizer's moments and count, and the
    state's step. With nothing saved `state` is returned as it is."""
    opt = state.optimizer
    payload = _load(ckpt_dir, step, opt.params[0].device)
    if payload is None:
        return state
    params = payload["params"]
    if set(params) != set(opt.names):
        raise KeyError(f"checkpoint parameters differ from the model's: "
                       f"{sorted(set(params) ^ set(opt.names))[:5]}")
    for name, p in zip(opt.names, opt.params):
        p.copy_(params[name])
    opt.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state
