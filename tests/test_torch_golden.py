"""Golden fixtures for the port: state dicts and outputs recorded from the
original torch reference modules (tests/fixtures/*.npz), loaded natively
into the port's modules. The bounds are those of tests/test_golden_parity.py
(atol 2e-4 / rtol 1e-3 for activations, atol 5e-4 for MLM logits, rtol
2e-3 / atol 2e-4 for losses)."""
import os

import numpy as np
import pytest
import torch

from xfm_tpu_torch.models.beit2 import BeitVisionTransformer, VisionConfig
from xfm_tpu_torch.models.text_encoder import TextConfig, TextTransformer
from xfm_tpu_torch.models.xfm import XFMBase, XFMConfig
from xfm_tpu_torch.train.checkpoint import load_reference_state_dict
from _torch_threads import one_intra_op_thread  # noqa: F401

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def load_fixture(name):
    z = np.load(os.path.join(FIX, name))
    sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")}
    rest = {k: z[k] for k in z.files if not k.startswith("sd::")}
    return sd, rest


def _load(model, sd):
    """Load natively; only the reference's captioning head (`lm_cap_head`,
    not part of these modules) may be left over."""
    res = load_reference_state_dict(model, sd, strict=False)
    assert not res.missing_keys, res.missing_keys
    assert all("lm_cap_head" in k for k in res.unexpected_keys), \
        res.unexpected_keys


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x))
    return t.to(dtype) if dtype is not None else t


VISION = dict(image_res=64, patch_size=16, embed_dim=96, depth=3,
              num_heads=4, drop_path_rate=0.0, init_values=0.1)
TEXT = dict(vocab_size=99, hidden_size=48, num_hidden_layers=4,
            num_attention_heads=4, intermediate_size=96,
            max_position_embeddings=40, encoder_width=96, pad_token_id=1,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            layer_norm_eps=1e-5)


def test_beit2_forward_matches_reference():
    sd, io = load_fixture("golden_beit2.npz")
    m = BeitVisionTransformer(VisionConfig(**VISION))
    _load(m, sd)
    out = m(_t(io["images"].transpose(0, 2, 3, 1)))  # NCHW → NHWC
    np.testing.assert_allclose(out.detach().numpy(), io["out"], atol=2e-4,
                               rtol=1e-3)


def test_xroberta_text_and_mlm_match_reference():
    sd, io = load_fixture("golden_xroberta.npz")
    m = TextTransformer(TextConfig(fusion_layer=2, **TEXT), with_mlm=True)
    _load(m, sd)
    ids, atts = _t(io["ids"]), _t(io["atts"])
    text_out = m(ids, attention_mask=atts, mode="text")
    np.testing.assert_allclose(text_out.detach().numpy(), io["text_out"],
                               atol=2e-4, rtol=1e-3)
    hidden = m(ids, attention_mask=atts, encoder_hidden_states=_t(io["enc"]),
               mode="multi_modal")
    np.testing.assert_allclose(m.mlm_logits(hidden).detach().numpy(),
                               io["mlm_logits"], atol=5e-4, rtol=1e-3)


def test_xfm_losses_match_reference():
    """ITC (plain and idx soft labels), ITM with the reference's recorded
    hard negatives, fusion-MLM, MIM, and the bbox head's coords with their
    L1 and GIoU losses."""
    sd, io = load_fixture("golden_xfm_losses.npz")
    cfg = XFMConfig(
        vision=VisionConfig(**VISION),
        text=TextConfig(fusion_layer=4, **TEXT),
        fusion=TextConfig(**{**TEXT, "num_hidden_layers": 2,
                             "fusion_layer": 0}),
        embed_dim=32, temp=0.07, use_contrastive_loss=True,
        use_matching_loss=True, use_mlm_loss=True, use_bbox_loss=True)
    m = XFMBase(cfg)
    _load(m, sd)
    images = _t(io["image"].transpose(0, 2, 3, 1))
    ids, atts = _t(io["ids"]), _t(io["atts"])
    mask = _t(io["mask"])
    with torch.no_grad():
        image_embeds = m.get_vision_embeds(images)
        image_atts = torch.ones(image_embeds.shape[:2], dtype=torch.int64)
        embeds_masked = m.get_vision_embeds(images, mask=mask)
        text_embeds = m.get_text_embeds(ids, atts)
        image_feat, text_feat = m.get_features(image_embeds, text_embeds)
        got = {
            "loss_itc": m.get_contrastive_loss(image_feat, text_feat),
            "loss_itc_idx": m.get_contrastive_loss(image_feat, text_feat,
                                                   idx=_t(io["idx"])),
            "loss_itm": m.get_matching_loss(
                None, image_embeds, image_atts, image_feat, atts, text_feat,
                text_embeds, fixed_negatives=(_t(io["image_neg"]),
                                              _t(io["text_neg"]))),
            "loss_mlm": m.get_fuse_mlm_loss(
                _t(io["ids_masked"]), atts, image_embeds, image_atts,
                _t(io["masked_pos"]), _t(io["masked_ids"])),
            "loss_mim": m.get_mim_loss(embeds_masked, image_embeds, mask),
        }
        coords = m.predict_bbox(image_embeds, atts, text_embeds)
        got["loss_bbox"], got["loss_giou"] = m.get_bbox_loss(
            coords, _t(io["target_bbox"]))
    for k, v in got.items():
        np.testing.assert_allclose(v.item(), float(io[k]), rtol=2e-3,
                                   atol=2e-4, err_msg=k)
    np.testing.assert_allclose(coords.numpy(), io["coords"], atol=2e-4,
                               rtol=1e-3)


def test_vqkd_tokenizer_matches_reference():
    """The reference VQ-KD tokenizer's encode (encoder → f32 tanh task
    layer → nearest normalized code) through the port's
    `import_vqkd_checkpoint`: the projections z and the quantized vectors
    to the bounds of tests/test_golden_parity.py, the code ids equal. Only
    the decoder (unused by the tokenizer) and the mask token stay at
    init."""
    from xfm_tpu_torch.models.vqkd import VQKD, vqkd_config_from_yaml
    from xfm_tpu_torch.train.checkpoint import load_vqkd_checkpoint

    sd, io = load_fixture("golden_vqkd.npz")
    m = VQKD(vqkd_config_from_yaml(
        {"tokenizer_model": "vqkd_encoder_base_decoder_1x768x12_clip",
         "image_res": 32, "patch_size": 16, "tokenizer_embed_dim": 32,
         "tokenizer_depth": 1, "tokenizer_num_heads": 2,
         "codebook_size": 16, "codebook_dim": 8}))
    missing, _ = load_vqkd_checkpoint(m, sd)
    assert not [k for k in missing if not k.startswith(
        ("decoder.", "decode_task_layer.")) and k != "encoder.mask_token"]
    images = _t(io["images"].transpose(0, 2, 3, 1))
    with torch.no_grad():
        z = m._encode_z(images)
        ids = m.get_codebook_indices(images)
    np.testing.assert_allclose(z.numpy(), io["z"], atol=2e-4, rtol=1e-3)
    np.testing.assert_array_equal(ids.numpy(), io["ids"])
    zq = m.quantize.embedding.weight[ids.reshape(-1)].reshape(io["zq"].shape)
    np.testing.assert_allclose(zq.numpy(), io["zq"], atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("name", ["golden_beit2.npz", "golden_xroberta.npz",
                                  "golden_xfm_losses.npz"])
def test_reference_rel_pos_index_equals_the_ports(name):
    """The reference saves its rel-pos index buffers; the loader drops them
    because the port rebuilds the same index."""
    from xfm_tpu_torch.ops.relpos import relative_position_index

    sd, _ = load_fixture(name)
    for k, v in sd.items():
        if k.endswith("relative_position_index"):
            np.testing.assert_array_equal(relative_position_index((4, 4)), v)
