"""GradCAM for weakly supervised grounding (`xfm_tpu/models/gradcam.py`).

A multiplicative gate of ones on the cross-attention probabilities of
fusion layer `block_num`; the gradient of the summed ITM-positive logits
with respect to it is attn ⊙ ∂score/∂attn, so cam = ReLU(that gradient),
masked to the text tokens and averaged over them and the heads. Only the
gate is differentiated: no parameter gets a `.grad`.
"""
from __future__ import annotations

import numpy as np
import torch


def itm_gradcam(model, images, text_ids, text_atts,
                block_num: int = 8) -> torch.Tensor:
    """→ cam [B, num_patches] f32: each patch's relevance to the ITM-positive
    score at fusion layer `block_num`. `model` is an `XFMForRetrieval` (or
    any XFMBase with an `itm_head`). The image and text embeds are computed
    without a graph; the fusion pass builds one for the gate alone."""
    with torch.no_grad():
        image_embeds = model.get_vision_embeds(images)
        text_embeds = model.get_text_embeds(text_ids, text_atts)
    B, Nq = text_ids.shape
    H = model.config.fusion.num_attention_heads
    Nk = image_embeds.shape[1]
    gate = torch.ones(B, H, Nq, Nk, dtype=torch.float32,
                      device=image_embeds.device, requires_grad=True)
    image_atts = torch.ones(image_embeds.shape[:2], dtype=torch.int64,
                            device=image_embeds.device)
    with torch.enable_grad():
        cross = model.fusion_encoder(
            inputs_embeds=text_embeds, attention_mask=text_atts,
            encoder_hidden_states=image_embeds,
            encoder_attention_mask=image_atts, cross_gate=gate,
            cross_gate_layer=block_num)
        score = model.itm_head(cross[:, 0, :])[:, 1].float().sum()
        (grad,) = torch.autograd.grad(score, gate, allow_unused=True)
    if grad is None:  # no such fusion layer: a zero cam, as in JAX
        grad = torch.zeros_like(gate)
    cam = grad.clamp(min=0.0)                        # [B, H, Nq, Nk]
    tmask = text_atts.float()[:, None, :, None]
    cam = (cam * tmask).sum(dim=2) / tmask.sum(dim=2).clamp(min=1.0)
    return cam.mean(dim=1)[:, 1:]                    # patches only


def rank_boxes_by_cam(cam_patch, boxes, image_res: int,
                      patch_size: int) -> np.ndarray:
    """Each box's mean cam over the patches it covers. cam_patch:
    [num_patches]; boxes: [N, 4] xyxy in pixels of the image_res frame,
    their edges floored to patches and at least one patch a side → [N]."""
    G = image_res // patch_size
    cam = np.asarray(cam_patch).reshape(G, G)
    scores = []
    for (x0, y0, x1, y1) in np.asarray(boxes):
        i0, i1 = int(y0) // patch_size, max(int(y1) // patch_size, 1)
        j0, j1 = int(x0) // patch_size, max(int(x1) // patch_size, 1)
        i1 = min(max(i1, i0 + 1), G)
        j1 = min(max(j1, j0 + 1), G)
        scores.append(float(cam[i0:i1, j0:j1].mean()))
    return np.asarray(scores)
