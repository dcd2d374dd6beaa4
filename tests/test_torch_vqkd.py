"""The VQ-KD tokenizer of the port (`xfm_tpu_torch/models/vqkd.py`), its
teachers (`models/teachers.py`), their importers and MIM's cross-entropy
branch, against the JAX package (`tests/test_vqkd.py`'s cases).

Weights are carried across by `vqkd_from_jax`, `clip_teacher_from_jax`,
`dino_teacher_from_jax` and `state_dict_from_jax`; f32 on both sides (JAX
matmuls at 'highest'). Tolerances: projections and features atol 1e-5;
code ids equal; losses rtol 1e-5; codebook and cluster sizes after an EMA
step atol 1e-6; gradients within 1e-3 of each tensor's largest |value|
(+ 1e-7 for the key biases, zero up to f32 noise).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.models import vqkd as tv
from xfm_tpu_torch.models import teachers as tt
from xfm_tpu_torch.models.beit2 import VisionConfig
from xfm_tpu_torch.models.clip_vit import ClipVisionConfig
from xfm_tpu_torch.train import checkpoint as tck

ENC = dict(image_res=32, patch_size=16, embed_dim=32, depth=1, num_heads=2,
           init_values=0.0, use_rel_pos_bias=False,
           use_shared_rel_pos_bias=True, use_abs_pos_emb=True,
           use_mean_pooling=False, drop_path_rate=0.0)
VQ = dict(decoder_depth=1, codebook_size=16, codebook_dim=8, teacher_dim=12)
CLIP = dict(image_res=32, patch_size=16, hidden_size=16, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=32)


def _perturb(tree, seed, scale=0.05):
    r = np.random.RandomState(seed)
    leaves, td = jax.tree.flatten(tree)
    return jax.tree.unflatten(td, [
        np.asarray(x) + scale * np.asarray(r.randn(*np.shape(x)), np.float32)
        for x in leaves])


def _images(seed, n=2):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def _close_grads(model, want, extra=1e-7):
    for name, p in model.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        ref = want[name].numpy().reshape(got.shape)
        tol = 1e-3 * np.abs(ref).max() + extra
        assert np.abs(got - ref).max() <= tol, name


@pytest.fixture(scope="module")
def tokenizers():
    from xfm_tpu.models.beit2 import VisionConfig as JVision
    from xfm_tpu.models.vqkd import VQKD as JVQKD, VQKDConfig as JCfg

    jcfg = JCfg(encoder=JVision(**ENC), **VQ)
    jm = JVQKD(jcfg)
    images = _images(0)
    teacher = np.random.RandomState(1).randn(2, 4, 12).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(images),
                        jnp.asarray(teacher))
    params = _perturb(variables["params"], 3)
    stats = jax.tree.map(np.asarray, variables["vq_stats"])
    cfg = tv.VQKDConfig(encoder=VisionConfig(**ENC), **VQ)
    tm = tv.VQKD(cfg)
    tm.load_state_dict(tck.vqkd_from_jax(
        {"params": params, "vq_stats": stats}, cfg), strict=True)
    return dict(jm=jm, params=params, stats=stats, tm=tm, cfg=cfg,
                images=images, teacher=teacher)


def test_quantizer_matches_jax():
    """Ids, the quantized vectors, the commitment loss, its gradient
    (straight through) and one EMA step of codebook and cluster sizes."""
    from xfm_tpu.models.vqkd import NormEMAQuantizer as JQ

    r = np.random.RandomState(0)
    z = r.randn(2, 3, 4).astype(np.float32)
    g = r.randn(2, 3, 4).astype(np.float32)
    jq = JQ(num_codes=8, code_dim=4, decay=0.5)
    vars0 = jq.init(jax.random.PRNGKey(1), jnp.asarray(z))

    def f(zz):
        (zq, loss, ids), new = jq.apply(vars0, zz, update_ema=True,
                                        mutable=["vq_stats"])
        return jnp.sum(zq * g) + loss, (zq, loss, ids, new)

    (_, (jzq, jloss, jids, jnew)), jgrad = jax.value_and_grad(
        f, has_aux=True)(jnp.asarray(z))
    tq = tv.NormEMAQuantizer(8, 4, decay=0.5)
    tq.embedding.weight.copy_(torch.tensor(
        np.asarray(vars0["vq_stats"]["codebook"])))
    zt = torch.from_numpy(z).requires_grad_(True)
    zq, loss, ids = tq(zt, update_ema=True)
    (torch.sum(zq * torch.from_numpy(g)) + loss).backward()
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(zq.detach().numpy(), np.asarray(jzq),
                               atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jgrad), atol=1e-6)
    for mine, theirs in ((tq.embedding.weight, "codebook"),
                         (tq.embedding.cluster_size, "cluster_size")):
        np.testing.assert_allclose(mine.numpy(), np.asarray(
            jnew["vq_stats"][theirs]), atol=1e-6, err_msg=theirs)
    np.testing.assert_allclose(np.linalg.norm(tq.embedding.weight.numpy(),
                                              axis=-1), 1.0, atol=1e-5)


def test_tokenize_and_train_step_match_jax(tokenizers):
    """The tiny tokenizer (shared table, absolute positions, the final
    norm): z, ids, the training step's losses, its EMA step and every
    gradient."""
    s = tokenizers
    from xfm_tpu.models.vqkd import VQKD as JVQKD

    images, teacher = jnp.asarray(s["images"]), jnp.asarray(s["teacher"])
    jv = {"params": s["params"], "vq_stats": s["stats"]}
    jz = s["jm"].apply(jv, images, method=JVQKD._encode_z)
    jids = s["jm"].apply(jv, images, method=JVQKD.get_codebook_indices)

    def f(p):
        (loss, aux), new = s["jm"].apply({"params": p,
                                          "vq_stats": s["stats"]},
                                         images, teacher,
                                         mutable=["vq_stats"])
        return loss, (aux, new)

    (jloss, (jaux, jnew)), jgrads = jax.value_and_grad(f, has_aux=True)(
        s["params"])
    tm = s["tm"]
    ti = torch.from_numpy(s["images"])
    with torch.no_grad():
        z = tm._encode_z(ti)
        ids = tm.get_codebook_indices(ti)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    tm.zero_grad(set_to_none=True)
    loss, aux = tm(ti, torch.from_numpy(s["teacher"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("rec_loss", "vq_loss"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(aux["ids"].numpy(), np.asarray(jaux["ids"]))
    q = jnew["vq_stats"]["quantize"]
    np.testing.assert_allclose(tm.quantize.embedding.weight.numpy(),
                               np.asarray(q["codebook"]), atol=1e-6)
    np.testing.assert_allclose(tm.quantize.embedding.cluster_size.numpy(),
                               np.asarray(q["cluster_size"]), atol=1e-6)
    want = tck.vqkd_from_jax({"params": jax.tree.map(np.asarray, jgrads),
                              "vq_stats": s["stats"]}, s["cfg"])
    _close_grads(tm, want)
    # the tokenizer is deterministic given its weights
    torch.testing.assert_close(tm.get_codebook_indices(ti), aux["ids"])


def _clip_teacher_pair(seed=4):
    from xfm_tpu.models.clip_vit import ClipVisionConfig as JClip
    from xfm_tpu.models.teachers import CLIPTeacher as JT

    jt = JT(JClip(**CLIP), proj_dim=12)
    jp = _perturb(jt.init(jax.random.PRNGKey(seed),
                          jnp.zeros((1, 32, 32, 3)))["params"], seed)
    tcfg = ClipVisionConfig(**CLIP)
    t = tt.CLIPTeacher(tcfg, proj_dim=12)
    t.load_state_dict(tck.clip_teacher_from_jax(jp, tcfg), strict=True)
    return jt, jp, t


def _dino_pair(seed=5):
    import flax.linen as fnn

    from xfm_tpu.models.beit2 import BeitVisionTransformer as JBeit
    from xfm_tpu.models.teachers import dino_vit_base as jdino

    jcfg = dataclasses.replace(jdino(32), embed_dim=32, depth=1, num_heads=2)

    class TinyDINO(fnn.Module):  # the JAX DINOTeacher at a small size
        @fnn.compact
        def __call__(self, images, deterministic=True):
            tower = JBeit(jcfg, name="backbone")
            return tower(images, deterministic=deterministic)[:, 1:, :]

    jt = TinyDINO()
    jp = _perturb(jt.init(jax.random.PRNGKey(seed),
                          jnp.zeros((1, 32, 32, 3)))["params"], seed)
    cfg = dataclasses.replace(tt.dino_vit_base(32), embed_dim=32, depth=1,
                              num_heads=2)
    t = tt.DINOTeacher(config=cfg)
    t.load_state_dict(tck.dino_teacher_from_jax(jp, cfg), strict=True)
    return jt, jp, t, cfg


def test_teachers_and_training_step_through_them(tokenizers):
    """`teacher_features` of both teachers (the DINO one renormalized to
    ImageNet's statistics) against JAX's, and the tokenizer's training
    step on the CLIP teacher's features."""
    from xfm_tpu.models.teachers import teacher_features as jfeat
    from xfm_tpu.models.vqkd import VQKD as JVQKD

    s = tokenizers
    images = s["images"]
    jt, jp, t = _clip_teacher_pair()
    jf = jfeat(jt, {"params": jp}, jnp.asarray(images))
    f = tt.teacher_features(t, torch.from_numpy(images))
    assert f.shape == (2, 4, 12) and not f.requires_grad
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5)
    djt, djp, dt, _ = _dino_pair()
    djf = jfeat(djt, {"params": djp}, jnp.asarray(images), pipeline="dino")
    df = tt.teacher_features(dt, torch.from_numpy(images), pipeline="dino")
    np.testing.assert_allclose(df.numpy(), np.asarray(djf), atol=1e-5)

    (jloss, jaux), _ = s["jm"].apply(
        {"params": s["params"], "vq_stats": s["stats"]}, jnp.asarray(images),
        jf, mutable=["vq_stats"])
    tm = tv.VQKD(s["cfg"])
    tm.load_state_dict(s["tm"].state_dict())
    tm.load_state_dict(tck.vqkd_from_jax(
        {"params": s["params"], "vq_stats": s["stats"]}, s["cfg"]))
    loss, aux = tm(torch.from_numpy(images), f)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux["rec_loss"].item(),
                               float(jaux["rec_loss"]), rtol=1e-5)
    # renormalize's round trip
    x = torch.from_numpy(_images(6, 1))
    y = tt.renormalize(tt.renormalize(x, tt.CLIP_MEAN, tt.CLIP_STD,
                                      tt.IMAGENET_MEAN, tt.IMAGENET_STD),
                       tt.IMAGENET_MEAN, tt.IMAGENET_STD, tt.CLIP_MEAN,
                       tt.CLIP_STD)
    torch.testing.assert_close(x, y, atol=1e-5, rtol=0)


def test_dino_config_and_no_layerscale():
    from xfm_tpu.models.teachers import dino_vit_base as jdino

    a, b = tt.dino_vit_base(32), jdino(32)
    for f in dataclasses.fields(a):
        if f.name not in ("dtype", "fused_ln", "fused_mlp"):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
    m = tt.DINOTeacher(config=dataclasses.replace(a, embed_dim=16, depth=1,
                                                  num_heads=2))
    names = {n for n, _ in m.named_parameters()}
    assert not any("gamma" in n or "relative_position" in n for n in names)
    assert {"backbone.pos_embed", "backbone.norm.weight"} <= names


@pytest.mark.parametrize("name", [
    "vqkd_encoder_base_decoder_1x768x12_dino",
    "vqkd_encoder_base_decoder_3x768x12_clip", "something_else"])
def test_vqkd_config_from_yaml_matches_jax(name):
    from xfm_tpu.models.vqkd import vqkd_config_from_yaml as jfrom

    y = {"tokenizer_model": name, "codebook_size": 128, "codebook_dim": 16,
         "image_res": 224, "tokenizer_depth": 2}
    a, b = tv.vqkd_config_from_yaml(y), jfrom(y)
    for f in ("decoder_depth", "codebook_size", "codebook_dim", "teacher_dim",
              "ema_decay", "beta"):
        assert getattr(a, f) == getattr(b, f), f
    for f in dataclasses.fields(a.encoder):
        if f.name not in ("dtype", "fused_ln", "fused_mlp"):
            assert getattr(a.encoder, f.name) == getattr(b.encoder, f.name)
    assert a.dtype == torch.float32 and a.encoder.dtype == torch.float32


def _vqkd_state_dict(r, D=32, I=128, G=4, extra=True):
    """A reference-named tokenizer checkpoint (`tests/test_vqkd.py`'s)."""
    def lin(dout, din):
        return {"weight": r.randn(dout, din).astype(np.float32) * 0.02,
                "bias": r.randn(dout).astype(np.float32) * 0.02}

    sd = {"encoder.cls_token": r.randn(1, 1, D).astype(np.float32) * 0.02,
          "encoder.pos_embed": r.randn(1, G + 1, D).astype(np.float32) * 0.02,
          "encoder.patch_embed.proj.weight":
              r.randn(D, 3, 16, 16).astype(np.float32) * 0.02,
          "encoder.patch_embed.proj.bias": np.zeros(D, np.float32)}
    b = "encoder.blocks.0"
    for nm in ("norm1", "norm2"):
        sd[f"{b}.{nm}.weight"] = 1 + 0.1 * r.randn(D).astype(np.float32)
        sd[f"{b}.{nm}.bias"] = 0.1 * r.randn(D).astype(np.float32)
    sd[f"{b}.attn.qkv.weight"] = r.randn(3 * D, D).astype(np.float32) * 0.02
    sd[f"{b}.attn.q_bias"] = r.randn(D).astype(np.float32) * 0.02
    sd[f"{b}.attn.v_bias"] = r.randn(D).astype(np.float32) * 0.02
    for pre, (o, i) in (("attn.proj", (D, D)), ("mlp.fc1", (I, D)),
                        ("mlp.fc2", (D, I))):
        for k, v in lin(o, i).items():
            sd[f"{b}.{pre}.{k}"] = v
    sd["encoder.fc_norm.weight"] = np.ones(D, np.float32)
    sd["encoder.fc_norm.bias"] = np.zeros(D, np.float32)
    for k, v in lin(D, D).items():
        sd[f"encode_task_layer.0.{k}"] = v
    for k, v in lin(8, D).items():
        sd[f"encode_task_layer.2.{k}"] = v
    cb = r.randn(16, 8).astype(np.float32)
    sd["quantize.embedding.weight"] = cb / np.linalg.norm(cb, axis=-1,
                                                          keepdims=True)
    sd["quantize.embedding.cluster_size"] = r.rand(16).astype(np.float32)
    if extra:  # entries the tokenizer's load drops
        sd["teacher_model.whatever"] = np.zeros(3, np.float32)
        sd["scaling_layer.shift"] = np.zeros(3, np.float32)
        sd["decoder.blocks.0.norm1.weight"] = np.ones(D, np.float32)
    return sd


YAML_TINY = {"tokenizer_model": "vqkd_encoder_base_decoder_1x768x12_clip",
             "image_res": 32, "patch_size": 16, "tokenizer_embed_dim": 32,
             "tokenizer_depth": 1, "tokenizer_num_heads": 2,
             "codebook_size": 16, "codebook_dim": 8}


def test_import_vqkd_checkpoint_matches_jax():
    """A torch tokenizer checkpoint through both importers: the same ids
    and projections; the codebook and cluster sizes loaded; only the
    decoder and the mask token left at init."""
    from xfm_tpu.models.vqkd import VQKD as JVQKD
    from xfm_tpu.models.vqkd import vqkd_config_from_yaml as jfrom
    from xfm_tpu.train.checkpoint import (import_vqkd_checkpoint,
                                          merge_params, to_jax)

    sd = _vqkd_state_dict(np.random.RandomState(0))
    jcfg = jfrom(YAML_TINY)
    jm = JVQKD(jcfg)
    vars0 = jm.init({"params": jax.random.PRNGKey(0)},
                    jnp.zeros((2, 32, 32, 3)),
                    method=JVQKD.get_codebook_indices)
    imp = to_jax(import_vqkd_checkpoint(sd, jcfg))
    params, _, _ = merge_params(dict(vars0["params"]), imp["params"])
    jv = {"params": params, "vq_stats": imp["vq_stats"]}
    images = _images(1)
    jz = jm.apply(jv, jnp.asarray(images), method=JVQKD._encode_z)
    jids = jm.apply(jv, jnp.asarray(images),
                    method=JVQKD.get_codebook_indices)

    tm = tv.VQKD(tv.vqkd_config_from_yaml(YAML_TINY))
    missing, unexpected = tck.load_vqkd_checkpoint(tm, sd)
    assert not unexpected, unexpected
    assert all(k.startswith("decoder.") or k.startswith("decode_task_layer")
               or k == "encoder.mask_token" for k in missing), missing
    with torch.no_grad():
        z = tm._encode_z(torch.from_numpy(images))
        ids = tm.get_codebook_indices(torch.from_numpy(images))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tm.quantize.embedding.weight.numpy(),
                                  sd["quantize.embedding.weight"])
    np.testing.assert_array_equal(tm.quantize.embedding.cluster_size.numpy(),
                                  sd["quantize.embedding.cluster_size"])


def test_import_clip_teacher_matches_jax():
    """OpenAI CLIP names (fused in_proj, `visual.proj`) through both
    importers: every entry lands and the features agree."""
    from xfm_tpu.models.clip_vit import ClipVisionConfig as JClip
    from xfm_tpu.models.teachers import CLIPTeacher as JT
    from xfm_tpu.train.checkpoint import (import_clip_teacher, merge_params,
                                          to_jax)

    r = np.random.RandomState(0)
    D, I, P = 32, 128, 16
    cfg = dict(CLIP, hidden_size=D, intermediate_size=I)
    sd = {"visual.class_embedding": r.randn(D).astype(np.float32) * 0.02,
          "visual.positional_embedding":
              r.randn(5, D).astype(np.float32) * 0.02,
          "visual.conv1.weight": r.randn(D, 3, P, P).astype(np.float32) * 0.02,
          "visual.proj": r.randn(D, 12).astype(np.float32) * 0.02,
          "transformer.resblocks.0.attn.in_proj_weight":
              np.zeros((3, 3), np.float32)}  # the text tower's, dropped
    for nm in ("ln_pre", "ln_post"):
        sd[f"visual.{nm}.weight"] = 1 + 0.1 * r.randn(D).astype(np.float32)
        sd[f"visual.{nm}.bias"] = 0.1 * r.randn(D).astype(np.float32)
    b = "visual.transformer.resblocks.0"
    for nm in ("ln_1", "ln_2"):
        sd[f"{b}.{nm}.weight"] = 1 + 0.1 * r.randn(D).astype(np.float32)
        sd[f"{b}.{nm}.bias"] = 0.1 * r.randn(D).astype(np.float32)
    sd[f"{b}.attn.in_proj_weight"] = r.randn(3 * D, D).astype(
        np.float32) * 0.1
    sd[f"{b}.attn.in_proj_bias"] = r.randn(3 * D).astype(np.float32) * 0.1
    for pre, (o, i) in (("attn.out_proj", (D, D)), ("mlp.c_fc", (I, D)),
                        ("mlp.c_proj", (D, I))):
        sd[f"{b}.{pre}.weight"] = r.randn(o, i).astype(np.float32) * 0.05
        sd[f"{b}.{pre}.bias"] = r.randn(o).astype(np.float32) * 0.05
    jt = JT(JClip(**cfg), proj_dim=12)
    init = jt.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    params, missing, unexpected = merge_params(init, to_jax(
        import_clip_teacher(sd, JClip(**cfg))))
    assert not missing and not unexpected
    images = _images(2)
    want = jt.apply({"params": params}, jnp.asarray(images))
    t = tt.CLIPTeacher(ClipVisionConfig(**cfg), proj_dim=12)
    t.load_state_dict(tck.import_clip_teacher(sd, ClipVisionConfig(**cfg)),
                      strict=True)
    got = t(torch.from_numpy(images))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


def test_import_dino_teacher_matches_jax():
    """timm DINO names (fused qkv bias, `module.` prefix, final `norm`)
    through both importers: the features agree (the dropped k bias is
    exact, as the JAX test shows against a full-bias attention)."""
    from xfm_tpu.train.checkpoint import (import_dino_teacher, merge_params,
                                          to_jax)

    jt, jp, t, cfg = _dino_pair()
    r = np.random.RandomState(1)
    D, I = 32, 128
    sd = {"module.cls_token": r.randn(1, 1, D).astype(np.float32) * 0.02,
          "module.pos_embed": r.randn(1, 5, D).astype(np.float32) * 0.02,
          "module.patch_embed.proj.weight":
              r.randn(D, 3, 16, 16).astype(np.float32) * 0.02,
          "module.patch_embed.proj.bias": r.randn(D).astype(np.float32) * .02,
          "module.norm.weight": 1 + 0.1 * r.randn(D).astype(np.float32),
          "module.norm.bias": 0.1 * r.randn(D).astype(np.float32)}
    b = "module.blocks.0"
    for nm in ("norm1", "norm2"):
        sd[f"{b}.{nm}.weight"] = 1 + 0.1 * r.randn(D).astype(np.float32)
        sd[f"{b}.{nm}.bias"] = 0.1 * r.randn(D).astype(np.float32)
    sd[f"{b}.attn.qkv.weight"] = r.randn(3 * D, D).astype(np.float32) * 0.1
    sd[f"{b}.attn.qkv.bias"] = r.randn(3 * D).astype(np.float32) * 0.1
    for pre, (o, i) in (("attn.proj", (D, D)), ("mlp.fc1", (I, D)),
                        ("mlp.fc2", (D, I))):
        sd[f"{b}.{pre}.weight"] = r.randn(o, i).astype(np.float32) * 0.05
        sd[f"{b}.{pre}.bias"] = r.randn(o).astype(np.float32) * 0.05
    import xfm_tpu.models.teachers as jteach

    jcfg = dataclasses.replace(jteach.dino_vit_base(32), embed_dim=32,
                               depth=1, num_heads=2)
    params, missing, _ = merge_params(jp, to_jax(import_dino_teacher(
        sd, jcfg)))
    assert [m for m in missing if "mask_token" not in m] == []
    images = _images(3)
    want = jt.apply({"params": params}, jnp.asarray(images))
    missing, unexpected = t.load_state_dict(
        tck.import_dino_teacher(sd, cfg), strict=False)
    assert missing == ["backbone.mask_token"] and not unexpected
    got = t(torch.from_numpy(images))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


@pytest.fixture(scope="module")
def mim_models():
    from __graft_entry__ import _xfm_config
    from xfm_tpu.models import XFMForPretrain as JPretrain

    from xfm_tpu_torch.configs import xfm_base_pretrain_config
    from xfm_tpu_torch.models import XFMForPretrain

    kw = dict(hidden=64, layers=2, heads=2, inter=128, image_res=32,
              vocab=40)
    jcfg = dataclasses.replace(_xfm_config(dtype=jnp.float32, **kw),
                               use_vision_tokenizer=True, codebook_size=16)
    jm = JPretrain(jcfg)
    r = np.random.RandomState(0)
    images = r.randn(4, 32, 32, 3).astype(np.float32)
    ids = r.randint(3, 39, (4, 8))
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(images),
                     jnp.asarray(ids), jnp.ones((4, 8), jnp.int32),
                     method=JPretrain.init_all)["params"]
    assert "mim_lm_head" in params["backbone"]
    params = _perturb(params, 1, 0.02)
    cfg = dataclasses.replace(xfm_base_pretrain_config(dtype=torch.float32,
                                                       **kw),
                              use_vision_tokenizer=True, codebook_size=16)
    model = XFMForPretrain(cfg)
    model.load_state_dict(tck.state_dict_from_jax(params, jcfg), strict=True)
    return jm, params, jcfg, model


@pytest.mark.parametrize("kind", ["image", "imagenet"])
def test_mim_ce_branch_loss_and_grads_match_jax(mim_models, kind):
    """`XFMForPretrain.loss` with the tokenizer's code ids: the image
    stream (ITC, ITM with fixed negatives, fusion-MLM, MIM CE) and the
    ImageNet stream (MIM CE alone); every loss and every gradient, the
    `lm_head` (JAX `mim_lm_head`) among them."""
    import xfm_tpu.models.losses as jlosses

    from xfm_tpu_torch.models.task_models import LOSS_KEYS

    jm, params, jcfg, model = mim_models
    r = np.random.RandomState(2)
    B, T, M = 4, 8, 3
    batch = dict(images=r.randn(B, 32, 32, 3).astype(np.float32),
                 image_mask=r.rand(B, 4) < 0.5)
    flags = dict(ret_itc=False, ret_match=False, ret_mlm=False, ret_mim=True,
                 data_source="imagenet")
    if kind == "image":
        ids = r.randint(3, 39, (B, T))
        batch.update(text_ids=ids, text_atts=np.ones((B, T), np.int64),
                     text_ids_masked=np.where(r.rand(B, T) < 0.3, 3, ids),
                     masked_pos=r.randint(1, 7, (B, M)),
                     masked_ids=r.randint(3, 39, (B, M)))
        flags = dict(ret_itc=True, ret_match=True, ret_mlm=True,
                     ret_mim=True, data_source="image")
    codes = r.randint(0, 16, (B, 4))
    neg = (np.array([1, 2, 3, 0]), np.array([2, 3, 0, 1]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if kind == "imagenet":
        jb.update(text_ids=None, text_atts=None)

    def jloss(p):
        out = jm.apply({"params": p}, **jb, **flags,
                       vqkd_code_ids=jnp.asarray(codes), deterministic=True,
                       rngs={"hardneg": jax.random.PRNGKey(0)})
        return sum(out[k] for k in LOSS_KEYS), out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlosses, "hard_negative_indices",
                   lambda *a, **k: tuple(jnp.asarray(n) for n in neg))
        (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model.zero_grad(set_to_none=True)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    out = model.loss(**tb, **flags, vqkd_code_ids=torch.from_numpy(codes),
                     hard_negatives=tuple(torch.from_numpy(n) for n in neg))
    sum(out[k] for k in LOSS_KEYS).backward()
    for k in LOSS_KEYS:
        np.testing.assert_allclose(out[k].item(), float(jout[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert out["loss_mim"].item() > 0
    _close_grads(model, tck.state_dict_from_jax(
        jax.tree.map(np.asarray, jgrads), jcfg))
    assert model.lm_head.weight.grad.abs().max() > 0
    with pytest.raises(ValueError, match="vqkd_code_ids"):
        model.loss(**tb, **flags,
                   hard_negatives=tuple(torch.from_numpy(n) for n in neg))


def test_lm_head_loads_and_boosts_under_the_tokenizer(mim_models):
    """`load_xfm_checkpoint` reads `lm_head.*` into a tokenizer model (the
    JAX import's `mim_lm_head`) and a model without one leaves it
    unexpected; the optimizer boosts and decays it as JAX does
    `mim_lm_head`, and the text encoder's `lm_head` is not boosted."""
    from xfm_tpu_torch.configs import xfm_base_pretrain_config
    from xfm_tpu_torch.models import XFMForPretrain
    from xfm_tpu_torch.train.optim import boosted, decays

    _, _, _, model = mim_models
    sd = {k: v.detach().clone() + 1.0 for k, v in model.state_dict().items()
          if k.startswith("lm_head.")}
    fresh = XFMForPretrain(model.config)
    missing, unexpected = tck.load_xfm_checkpoint(fresh, sd)
    assert not unexpected
    torch.testing.assert_close(fresh.lm_head.weight, sd["lm_head.weight"])
    plain = XFMForPretrain(xfm_base_pretrain_config(
        dtype=torch.float32, hidden=64, layers=2, heads=2, inter=128,
        image_res=32, vocab=40))
    _, unexpected = tck.load_xfm_checkpoint(plain, sd)
    assert sorted(unexpected) == ["lm_head.bias", "lm_head.weight"]
    assert boosted("lm_head.weight") and boosted("lm_head.bias")
    assert not boosted("text_encoder.lm_head.dense.weight")
    assert decays("lm_head.weight") and not decays("lm_head.bias")


def test_cosine_kmeans_update_matches_jax():
    """From the means JAX's permutation draws (injected), the port's ten
    iterations reach JAX's means and counts; and the installed codebook
    drives the tokenizer."""
    from xfm_tpu.models.vqkd import cosine_kmeans as jkm
    from xfm_tpu.models.vqkd import l2norm as jl2

    r = np.random.RandomState(0)
    x = r.randn(60, 8).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jmeans, jbins = jkm(key, jnp.asarray(x), 6)
    idx = np.asarray(jax.random.permutation(key, 60)[:6])
    means0 = torch.from_numpy(np.asarray(jl2(jnp.asarray(x)))[idx])
    g = torch.Generator().manual_seed(0)
    means, bins = tv.cosine_kmeans(g, torch.from_numpy(x), 6, means=means0)
    np.testing.assert_allclose(means.numpy(), np.asarray(jmeans), atol=1e-6)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jbins))
    stats = tv.kmeans_init_vq_stats(g, torch.from_numpy(x).reshape(6, 10, 8),
                                    6, means=means0)
    torch.testing.assert_close(stats["quantize"]["codebook"], means)
    cfg = tv.VQKDConfig(encoder=VisionConfig(**ENC), decoder_depth=1,
                        codebook_size=6, codebook_dim=8, teacher_dim=12)
    m = tv.VQKD(cfg)
    m.load_vq_stats(stats)
    torch.testing.assert_close(m.quantize.embedding.weight, means)
    ids = m.get_codebook_indices(torch.from_numpy(_images(7)))
    assert ids.shape == (2, 4) and int(ids.max()) < 6


def test_cosine_kmeans_recovers_separated_clusters():
    """Three well-separated directions with small noise (the JAX test's
    data): from the generator's own draw, every direction is one mean
    (cosine > 0.98) and the counts sum to n; fewer samples than clusters
    draw with replacement."""
    rng = np.random.default_rng(0)
    dirs = np.eye(3, 8, dtype=np.float32)
    pts = np.repeat(dirs, 40, axis=0) + 0.05 * rng.standard_normal((120, 8))
    pts = pts[rng.permutation(120)].astype(np.float32)
    g = torch.Generator().manual_seed(0)
    means, bins = tv.cosine_kmeans(g, torch.from_numpy(pts), 3)
    assert bins.sum().item() == 120
    np.testing.assert_allclose(np.linalg.norm(means.numpy(), axis=-1), 1.0,
                               atol=1e-5)
    sims = dirs @ means.numpy().T
    assert (sims.max(axis=1) > 0.98).all()
    few, fbins = tv.cosine_kmeans(g, torch.from_numpy(pts[:2]), 5)
    assert few.shape == (5, 8) and fbins.sum().item() == 2


def test_load_codebook_init(tmp_path):
    from xfm_tpu.models.vqkd import load_codebook_init as jload

    w = torch.randn(16, 8)
    torch.save(w, tmp_path / "cb.pth")
    cb = tv.load_codebook_init(tmp_path / "cb.pth")
    torch.testing.assert_close(cb, w)
    np.testing.assert_allclose(cb.numpy(), np.asarray(jload(
        tmp_path / "cb.pth")), atol=0)
    torch.save({"w": w}, tmp_path / "bad.pth")
    with pytest.raises(ValueError):
        tv.load_codebook_init(tmp_path / "bad.pth")


def test_frozen_tokenizer_is_seeded_and_frozen(tmp_path):
    """The pretrain task's tokenizer: the same weights from the fixed seed
    each time (the JAX package's PRNGKey(7) cannot be matched bit for bit,
    so the pin is the seed's own), no parameter trainable, eval mode; a
    `tokenizer_weight` file overlays the encoder and the codebook."""
    from xfm_tpu_torch.tasks.pretrain import frozen_tokenizer

    a, fa = frozen_tokenizer(YAML_TINY, "cpu")
    b, _ = frozen_tokenizer(YAML_TINY, "cpu")
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
    assert not any(p.requires_grad for p in a.parameters())
    assert not a.training
    ids = fa(torch.from_numpy(_images(8)))
    assert ids.shape == (2, 4) and not ids.requires_grad
    sd = _vqkd_state_dict(np.random.RandomState(3))
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "vqkd.pth")
    c, _ = frozen_tokenizer(dict(YAML_TINY,
                                 tokenizer_weight=str(tmp_path / "vqkd.pth")),
                            "cpu")
    np.testing.assert_array_equal(c.quantize.embedding.weight.numpy(),
                                  sd["quantize.embedding.weight"])
    np.testing.assert_allclose(
        c.encoder.blocks[0].attn.qkv.weight.numpy(),
        sd["encoder.blocks.0.attn.qkv.weight"])
