"""The load half of checkpoints, the eval's data layer and its configs,
against the JAX package.

- The resolution-change interpolations against the reference's values
  (`fixtures/golden_interpolation.npz`, the tolerances of
  `test_interpolation_golden.py`) and bit for bit against the JAX
  package's functions (the same numpy code).
- `load_xfm_checkpoint` of a 224 px reference checkpoint into a 384 px
  model against JAX `import_xfm_checkpoint` + `merge_params`: the same
  tensors, bit for bit.
- `TestTransform`, `pre_caption`, `_encode_texts`, `SimpleTokenizer` and
  `RetrievalEvalData` bit-equal to the JAX package's on the same files.
- `config_from_yaml` field by field against the JAX package's for every
  `configs/xfm-ft/Retrieval_*.yaml`.
"""
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax

from xfm_tpu_torch import configs
from xfm_tpu_torch.models import XFMForRetrieval, config_from_yaml
from xfm_tpu_torch.train import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "golden_interpolation.npz")
RETRIEVAL_YAMLS = sorted(glob.glob(os.path.join(
    REPO, "configs", "xfm-ft", "Retrieval_*.yaml")))
TINY = dict(layers=2, vision_embed_dim=64, vision_num_heads=2,
            text_hidden_size=64, text_num_attention_heads=2,
            text_intermediate_size=128, text_vocab_size=99, embed_dim=32,
            compute_dtype="float32")


@pytest.mark.parametrize("res,window", [(384, 24), (480, 30)])
def test_rel_pos_bias_table_matches_reference_and_jax(res, window):
    from xfm_tpu.train.checkpoint import interpolate_rel_pos_bias_table as j

    fx = np.load(FIX)
    got = ck.interpolate_rel_pos_bias_table(fx["src_table"],
                                            (window, window))
    np.testing.assert_allclose(got, fx[f"table_{res}"], atol=5e-5, rtol=1e-4)
    np.testing.assert_array_equal(got[-3:], fx["src_table"][-3:])
    np.testing.assert_array_equal(got, j(fx["src_table"], (window, window)))


@pytest.mark.parametrize("res", [384, 480])
def test_abs_pos_embed_matches_reference_and_jax(res):
    from xfm_tpu.train.checkpoint import interpolate_abs_pos_embed as j

    fx = np.load(FIX)
    n = (res // 16) ** 2
    got = ck.interpolate_abs_pos_embed(fx["src_pos"], n)
    np.testing.assert_allclose(got, fx[f"pos_{res}"], atol=5e-5, rtol=1e-4)
    np.testing.assert_array_equal(got[:, :1], fx["src_pos"][:, :1])
    np.testing.assert_array_equal(got, j(fx["src_pos"], n))


def test_prefix_and_layer_surgery_match_jax():
    from xfm_tpu.train.checkpoint import choose_layers, strip_prefix

    sd = {f"text_encoder.roberta.encoder.layer.{i}.w": np.full(2, i, "f4")
          for i in range(4)}
    sd["text_encoder.roberta.encoder.layer.x"] = np.zeros(1, "f4")
    sd["vision_encoder.cls_token"] = np.ones(3, "f4")
    for got, want in (
            (ck.strip_prefix(sd, "text_encoder.roberta."),
             strip_prefix(sd, "text_encoder.roberta.")),
            (ck.choose_layers(sd, "text_encoder.roberta.encoder.layer",
                              {1: 0, 3: 1}),
             choose_layers(sd, "text_encoder.roberta.encoder.layer",
                           {1: 0, 3: 1}))):
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def _jax_retrieval(res, seed):
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.models.task_models import XFMForRetrieval as JRetrieval

    jcfg = jconfig_from_yaml(configs.retrieval_eval_yaml(image_res=res,
                                                         **TINY),
                             use_contrastive_loss=True,
                             use_matching_loss=True)
    jm = JRetrieval(jcfg)
    x = jax.numpy.zeros((2, res, res, 3))
    ids = jax.numpy.ones((2, 8), jax.numpy.int32)
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(seed)},
                                     x, ids, ids,
                                     method=JRetrieval.init_all)["params"])()
    r = np.random.RandomState(seed)
    leaves, tree = jax.tree.flatten(params)
    return jcfg, jax.tree.unflatten(tree, [
        np.asarray(v) + 0.02 * np.asarray(r.randn(*v.shape), np.float32)
        for v in leaves])


def _port_retrieval(res):
    return XFMForRetrieval(config_from_yaml(
        configs.retrieval_eval_yaml(image_res=res, **TINY),
        use_contrastive_loss=True, use_matching_loss=True))


def test_checkpoint_load_matches_jax_import_and_merge(tmp_path):
    """A 224 px reference checkpoint (the JAX package's export, written as
    `{"model": state_dict}`) into the 384 px model: every tensor equals the
    JAX import + merge's; the rel-pos tables are interpolated from window
    14 to 24, the patch kernels converted from Conv2d layout."""
    from xfm_tpu.train.checkpoint import (export_xfm_checkpoint,
                                          import_xfm_checkpoint,
                                          merge_params, to_jax)

    jcfg224, p224 = _jax_retrieval(224, 0)
    jcfg384, p384 = _jax_retrieval(384, 1)
    sd = export_xfm_checkpoint(p224, jcfg224)
    path = tmp_path / "ckpt.pth"
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}}, path)
    merged, jmissing, _ = merge_params(
        p384, to_jax(import_xfm_checkpoint(sd, jcfg384)))
    assert jmissing == []
    model = _port_retrieval(384)
    missing, unexpected = ck.load_xfm_checkpoint(
        model, ck.load_torch_state_dict(str(path)))
    assert missing == [] and unexpected == []
    want = ck.state_dict_from_jax(jax.tree.map(np.asarray, merged), jcfg384)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    table = "vision_encoder.blocks.1.attn.relative_position_bias_table"
    assert sd[table].shape == (27 * 27 + 3, 2) \
        and got[table].shape == (47 * 47 + 3, 2)


def test_checkpoint_load_refuses_shape_mismatches():
    """A squeeze-only difference is reshaped; a vocabulary of another size
    or an untransposed kernel is refused, as `merge_params` refuses them;
    names the model lacks come back as unexpected."""
    model = _port_retrieval(224)
    sd = ck.reference_state_dict(model)
    sd["temp"] = torch.full((1, 1), 0.25)
    sd["text_encoder.extra.weight"] = torch.zeros(3)
    missing, unexpected = ck.load_xfm_checkpoint(model, sd)
    assert missing == [] and unexpected == ["text_encoder.extra.weight"]
    assert model.temp.item() == 0.25
    emb = "text_encoder.roberta.embeddings.word_embeddings.weight"
    fc = "fusion_encoder.roberta.encoder.layer.0.intermediate.dense.weight"
    for k, v in ((emb, torch.zeros(98, 64)), (fc, sd[fc].T.contiguous())):
        with pytest.raises(ValueError, match="shape mismatch"):
            ck.load_xfm_checkpoint(model, dict(sd, **{k: v}))


def test_clip_checkpoint_interpolates_position_embedding():
    """The CLIP tower's position embedding (also under its Hugging Face
    names) is interpolated from a 14² to a 24² grid."""
    kw = dict(TINY, clip=True)
    m224 = XFMForRetrieval(config_from_yaml(configs.retrieval_eval_yaml(
        image_res=224, **kw), use_contrastive_loss=True,
        use_matching_loss=True))
    ck.init_weights(m224, 0)
    sd = ck.reference_state_dict(m224)
    sd["vision_encoder.vision_model.embeddings.position_embedding.weight"] = \
        sd.pop("vision_encoder.pos_embed.weight")
    m384 = XFMForRetrieval(config_from_yaml(configs.retrieval_eval_yaml(
        image_res=384, **kw), use_contrastive_loss=True,
        use_matching_loss=True))
    missing, unexpected = ck.load_xfm_checkpoint(m384, sd)
    assert missing == [] and unexpected == []
    want = ck.interpolate_abs_pos_embed(
        m224.vision_encoder.pos_embed.weight.detach().numpy(), 576)[0]
    np.testing.assert_array_equal(
        m384.vision_encoder.pos_embed.weight.detach().numpy(), want)


def test_reference_state_dict_matches_jax_export():
    from xfm_tpu.train.checkpoint import export_xfm_checkpoint

    jcfg, params = _jax_retrieval(224, 2)
    model = _port_retrieval(224)
    model.load_state_dict(ck.state_dict_from_jax(params, jcfg), strict=True)
    got = ck.reference_state_dict(model)
    want = export_xfm_checkpoint(params, jcfg)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


CAPTIONS = ["A man riding a wave on top of a surfboard.",
            "Two dogs -- playing/running in the <person>'s yard!!",
            "  a   CAT\non a (red) couch; looking: at ~the camera?  ",
            "one two three four five six seven eight nine ten eleven twelve "
            "thirteen fourteen fifteen sixteen seventeen eighteen",
            "#hashtag*star \"quoted\" words"]


def _write_corpus(root):
    from PIL import Image

    rng = np.random.default_rng(3)
    ann = []
    for i in range(5):
        h, w = 30 + 7 * i, 50 - 4 * i
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)) \
            .save(root / f"im{i}.png")
        caps = CAPTIONS[i:] + CAPTIONS[:i]
        ann.append({"image": f"im{i}.png",
                    "caption": caps[0] if i % 2 else caps[:2 + i % 3]})
    path = root / "ann.json"
    path.write_text(json.dumps(ann))
    return str(path)


def test_data_layer_is_bit_equal_to_jax(tmp_path):
    from xfm_tpu.data import finetune_data as jfd
    from xfm_tpu.data import pretrain_data as jpd
    from xfm_tpu.data import tokenization as jtok
    from xfm_tpu.data import transforms as jtr
    from xfm_tpu_torch.data import finetune_data as fd
    from xfm_tpu_torch.data import tokenization as tok
    from xfm_tpu_torch.data import transforms as tr

    for c in CAPTIONS:
        for n in (5, 30):
            assert tok.pre_caption(c, n) == jpd.pre_caption(c, n)
    texts = [tok.pre_caption(c, 30) for c in CAPTIONS]
    t, jt = (tok.SimpleTokenizer.from_texts(texts, max_vocab=12),
             jtok.SimpleTokenizer.from_texts(texts, max_vocab=12))
    assert t.itos == jt.itos and t.vocab_size == jt.vocab_size
    for c in CAPTIONS + ["unseen words here"]:
        assert t.tokenize(c) == jt.tokenize(c)
    for got, want in zip(t(CAPTIONS, max_length=9).values(),
                         jt(CAPTIONS, max_length=9).values()):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(fd._encode_texts(t, texts, 7),
                         jfd._encode_texts(jt, texts, 7)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    ann = _write_corpus(tmp_path)
    png = str(tmp_path / "im2.png")
    raw = open(png, "rb").read()
    gray = np.random.default_rng(4).integers(0, 255, (9, 11), np.uint8)
    for src in (png, raw, gray):
        np.testing.assert_array_equal(np.asarray(tr.decode_image(src)),
                                      np.asarray(jtr.decode_image(src)))
    for res in (32, 384):
        got = tr.TestTransform(res)(tr.decode_image(png))
        want = jtr.TestTransform(res)(jtr.decode_image(png))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)

    data = fd.RetrievalEvalData(ann, tr.TestTransform(48), str(tmp_path), t,
                                max_tokens=12)
    jdata = jfd.RetrievalEvalData(ann, jtr.TestTransform(48),
                                  str(tmp_path), jt, max_tokens=12)
    assert (data.text, data.img2txt, data.txt2img, data.num_images) == \
        (jdata.text, jdata.img2txt, jdata.txt2img, jdata.num_images)
    for got, want in zip(data.image_batches(2), jdata.image_batches(2)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(data.text_batches(4), jdata.text_batches(4)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# fields the JAX configs have and the port's do not, at the values the
# port implements (remat_policy means nothing without remat); the
# tokenizer's and the BEiT tower's optional fields are the port's too
# since the pretrain task's branches were ported, and compared as fields
JAX_ONLY = {
    "top": {},
    "vision": {"remat": False, "remat_policy": None, "seq_shard": False},
    "text": {"position_style": "roberta", "remat": False,
             "remat_policy": None, "seq_shard": False},
}


def _same_fields(port, jax_cfg, part):
    for f in dataclasses.fields(port):
        got = getattr(port, f.name)
        if dataclasses.is_dataclass(got):
            continue
        if f.name in ("fused_ln", "fused_mlp"):
            assert got is False, (part, f.name)
            continue
        want = getattr(jax_cfg, f.name)
        if isinstance(got, torch.dtype):
            got, want = str(got)[6:], np.dtype(want).name
        assert got == want, (part, f.name, got, want)
    extra = {f.name for f in dataclasses.fields(jax_cfg)} - {
        f.name for f in dataclasses.fields(port)}
    assert extra == set(JAX_ONLY[part])
    for name, value in JAX_ONLY[part].items():
        if value is not None:
            assert getattr(jax_cfg, name) == value, (part, name)


@pytest.mark.parametrize("path", RETRIEVAL_YAMLS,
                         ids=[os.path.basename(p) for p in RETRIEVAL_YAMLS])
def test_config_from_yaml_matches_jax(path, monkeypatch):
    from xfm_tpu.core import config as jconfig
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu_torch.core import config as pconfig

    monkeypatch.delenv("XFM_FUSED_LN", raising=False)
    monkeypatch.delenv("XFM_MLP_FUSED", raising=False)
    root = os.path.join(REPO, "configs", "model")
    ycfg = pconfig.resolve_vision_config(pconfig.load_config(path), root)
    assert ycfg == jconfig.resolve_vision_config(jconfig.load_config(path),
                                                 root)
    kw = dict(use_contrastive_loss=True, use_matching_loss=True)
    port, jcfg = config_from_yaml(ycfg, **kw), jconfig_from_yaml(ycfg, **kw)
    _same_fields(port, jcfg, "top")
    _same_fields(port.vision, jcfg.vision, "vision")
    _same_fields(port.text, jcfg.text, "text")
    _same_fields(port.fusion, jcfg.fusion, "text")


def test_config_from_yaml_is_the_retrieval_config():
    """`Retrieval_coco.yaml` builds `xfm_base_retrieval_config()`'s model:
    the same widths, depths, activation, resolution and dtype. The bench
    config turns drop-path off and carries the pretrain step's MLM and bbox
    heads; the eval runs deterministic and uses neither head."""
    from xfm_tpu_torch.core.config import load_config

    got = config_from_yaml(load_config(RETRIEVAL_YAMLS[0]),
                           use_contrastive_loss=True, use_matching_loss=True,
                           dtype=torch.bfloat16)
    want = configs.xfm_base_retrieval_config()
    want = dataclasses.replace(
        want, vision=dataclasses.replace(want.vision, drop_path_rate=0.1),
        use_mlm_loss=False, use_bbox_loss=False)
    assert got == want


def test_retrieval_coco_dict_is_the_yaml():
    """`configs.RETRIEVAL_COCO` (what `chip_smoke.py` builds the eval from,
    where PyYAML may be missing) is `configs/xfm-ft/Retrieval_coco.yaml`."""
    import yaml

    with open(os.path.join(REPO, "configs", "xfm-ft",
                           "Retrieval_coco.yaml")) as f:
        assert configs.RETRIEVAL_COCO == yaml.safe_load(f)
