"""The retrieval fine-tune slice with the Swin tower and BERT text and fusion
encoders, against the JAX package, and `python3 -m xfm_tpu_torch.run --task
itr_coco` on a `use_swin` YAML.

The JAX side is built by `config_from_yaml`'s Swin branch and its BERT
text branch (a `text_encoder` without "roberta"); the port's by its own.
Tiny sizes: Swin at 32 px, patch 4, embed 16, depths (2, 2), window 4
(stage 0's second block shifted), so vision width 32 and 17 output rows;
BERT width 48, 2 + 2 layers, vocabulary 99; B = 4, T = 8, one caption
padded. The vision width differs from the text's, as Swin-B's 1024 does
from BERT-base's 768, so the fusion cross-attention projects k/v from 32
and `fusion_proj` exists (and gets no gradient, on both sides).

Both sides run f32 (JAX matmuls at 'highest', exact erf) on the same
weights (carried by `state_dict_from_jax`), batch and hard negatives.
Tolerances are tests/test_torch_clip_retrieval.py's: losses rtol 1e-4,
gradients rtol 1e-3 / atol 1e-5, encoder outputs atol 1e-5 / rtol 1e-4.
"""
import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from xfm_tpu_torch.configs import batch_to_torch, make_retrieval_batch
from xfm_tpu_torch.models import XFMForRetrieval, config_from_yaml
from xfm_tpu_torch.train.checkpoint import (load_torch_state_dict,
                                            load_xfm_checkpoint,
                                            state_dict_from_jax)
from xfm_tpu_torch.train.train_state import retrieval_loss_fn
from _torch_threads import one_intra_op_thread  # noqa: F401

B, T, RES, VOCAB = 4, 8, 32, 99
NEG = (np.array([1, 2, 3, 0]), np.array([2, 3, 0, 1]))
SWIN = dict(image_res=RES, embed_dim=16, depths=[2, 2], num_heads=[2, 4],
            window_size=4)


def _yaml_config():
    return dict(use_swin=True, image_res=RES, _vision=dict(SWIN),
                text_encoder="data/bert-base-uncased",
                text_num_hidden_layers=2, text_fusion_start_at=2,
                fusion_num_hidden_layers=2, text_hidden_size=48,
                text_num_attention_heads=2, text_intermediate_size=96,
                text_vocab_size=VOCAB, embed_dim=16, temp=0.07)


@pytest.fixture(scope="module")
def slice_setup():
    import xfm_tpu.models.losses as jlosses
    from xfm_tpu.models.task_models import XFMForRetrieval as JRetrieval
    from xfm_tpu.models.xfm import config_from_yaml as jconfig_from_yaml

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_EXACT_ERF", "1")
        mp.setattr(jlosses, "hard_negative_indices",
                   lambda *a, **k: tuple(jnp.asarray(n) for n in NEG))
        jcfg = jconfig_from_yaml(_yaml_config(), use_contrastive_loss=True,
                                 use_matching_loss=True, dtype=jnp.float32)
        assert jcfg.vision_backbone == "swin"
        jm = JRetrieval(jcfg)
        nb = make_retrieval_batch(B, T, RES, VOCAB)
        nb["text_atts"][1, -3:] = 0
        nb["text_ids"][1, -3:] = 0  # BERT's pad id
        jb = (jnp.asarray(nb["images"]),
              jnp.asarray(nb["text_ids"], jnp.int32),
              jnp.asarray(nb["text_atts"], jnp.int32))
        # (not under jit: the JAX Swin block builds its shift mask in numpy)
        params = jm.init({"params": jax.random.PRNGKey(0)}, *jb,
                         method=JRetrieval.init_all)["params"]
        r = np.random.RandomState(0)
        leaves, tree = jax.tree.flatten(params)
        params = jax.tree.unflatten(tree, [
            np.asarray(x) + 0.02 * np.asarray(r.randn(*x.shape), np.float32)
            for x in leaves])

        def loss(p):
            itc, itm = jm.apply({"params": p}, *jb, deterministic=True,
                                rngs={"hardneg": jax.random.PRNGKey(0)})
            return itc + itm, (itc, itm)

        yield dict(jcfg=jcfg, jm=jm, jb=jb, nb=nb, params=params,
                   value_and_grad=jax.value_and_grad(loss, has_aux=True))


def _port_model(setup):
    cfg = config_from_yaml(_yaml_config(), use_contrastive_loss=True,
                           use_matching_loss=True, dtype=torch.float32)
    model = XFMForRetrieval(cfg)
    model.load_state_dict(state_dict_from_jax(setup["params"], cfg),
                          strict=True)
    return model


def test_config_is_the_yaml_swin_and_bert_branch(slice_setup):
    """The port's config carries the JAX config's Swin tower and BERT
    encoders field for field (dtypes aside)."""
    cfg = _port_model(slice_setup).config
    j = slice_setup["jcfg"]
    assert cfg.vision_backbone == "swin"
    assert cfg.vision_width == j.vision_width == 32
    for name in ("image_res", "patch_size", "embed_dim", "depths",
                 "num_heads", "window_size", "mlp_ratio", "drop_path_rate",
                 "layer_norm_eps", "num_features"):
        assert getattr(cfg.vision, name) == getattr(j.vision, name), name
    for enc in ("text", "fusion"):
        for name in ("vocab_size", "hidden_size", "num_hidden_layers",
                     "fusion_layer", "encoder_width", "hidden_act",
                     "layer_norm_eps", "pad_token_id", "position_style",
                     "type_vocab_size", "max_position_embeddings"):
            assert (getattr(getattr(cfg, enc), name)
                    == getattr(getattr(j, enc), name)), (enc, name)


def test_swin_bert_retrieval_losses_and_grads_match_jax(slice_setup):
    s = slice_setup
    (_, (jitc, jitm)), jgrads = s["value_and_grad"](s["params"])
    model = _port_model(s)
    batch = batch_to_torch(s["nb"], "cpu")
    batch["hard_negatives"] = tuple(torch.from_numpy(n) for n in NEG)
    total, out = retrieval_loss_fn(model, batch)
    total.backward()
    np.testing.assert_allclose(out["loss_itc"].item(), float(jitc),
                               rtol=1e-4)
    np.testing.assert_allclose(out["loss_itm"].item(), float(jitm),
                               rtol=1e-4)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads),
                               model.config)
    for name, p in model.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        np.testing.assert_allclose(got, want[name].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    # the tower trains through ITC and ITM, the shifted block's table too
    for name in ("vision_encoder.layers.0.blocks.1.attn."
                 "relative_position_bias_table",
                 "vision_encoder.layers.0.downsample.reduction.weight",
                 "fusion_encoder.roberta.encoder.layer.0.crossattention."
                 "self.key.weight"):
        assert np.abs(want[name].numpy()).max() > 0, name


def test_encode_images_gives_the_avgpool_features(slice_setup):
    """The eval's first stage: [mean ‖ 16 final-stage tokens] of width 32
    and the features of the mean row, as the JAX package gives them."""
    from xfm_tpu.models.task_models import XFMForRetrieval as JRetrieval

    s = slice_setup
    jimg = s["jm"].apply({"params": s["params"]}, s["jb"][0],
                         method=JRetrieval.encode_images)
    model = _port_model(s)
    with torch.no_grad():
        img = model.encode_images(batch_to_torch(s["nb"], "cpu")["images"])
    assert img[0].shape == (B, 17, 32)
    for got, want in zip(img, jimg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-4)


def test_region_mode_through_get_vision_embeds(slice_setup):
    """XFMBase's region mode with the Swin tower: each region's copy of
    its image's 16 tokens with their mean over its mask in the first slot,
    and its image's full rows, as the JAX package gives them."""
    s = slice_setup
    idx = np.array([3, 0, 0, 2, 1])
    atts = (np.random.RandomState(5).rand(5, 17) < 0.5).astype(np.int64)
    jg, jf = s["jm"].apply({"params": s["params"]}, s["jb"][0],
                           idx_to_group_img=jnp.asarray(idx),
                           image_atts=jnp.asarray(atts),
                           method=lambda m, *a, **k:
                           m.backbone.get_vision_embeds(*a, **k))
    model = _port_model(s)
    with torch.no_grad():
        g, f = model.get_vision_embeds(
            batch_to_torch(s["nb"], "cpu")["images"],
            idx_to_group_img=torch.from_numpy(idx),
            image_atts=torch.from_numpy(atts))
    assert g.shape == f.shape == (5, 17, 32)
    for got, want in ((g, jg), (f, jf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-4)


def _corpus(root, n=6):
    from PIL import Image

    rng = np.random.default_rng(0)
    words = ["a", "red", "dog", "on", "grass", "blue", "sky", "cat"]
    train, test = [], []
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (40 + 4 * i, 48, 3),
                                     dtype=np.uint8)).save(
            root / f"img{i}.png")
        caps = [" ".join(rng.choice(words, 3 + (i + j) % 4))
                + f" number {i}." for j in range(2)]
        test.append({"image": f"img{i}.png", "caption": caps})
        train += [{"image": f"img{i}.png", "caption": c, "image_id": i}
                  for c in caps]
    (root / "train.json").write_text(json.dumps(train))
    (root / "test.json").write_text(json.dumps(test))
    (root / "swin_tiny.json").write_text(json.dumps(dict(
        SWIN, vision_width=32)))
    cfg = dict(_yaml_config(), use_beit_v2=False,
               vision_config=str(root / "swin_tiny.json"),
               train_file=[str(root / "train.json")],
               test_file=str(root / "test.json"), image_root=str(root),
               max_tokens=T, k_test=4, batch_size_train=12,
               batch_size_test=4, compute_dtype="float32",
               optimizer={"opt": "adamW", "lr": 1e-4, "weight_decay": 0.01,
                          "lr_mult": 2},
               schedular={"sched": "linear", "lr": 1e-4, "epochs": 1,
                          "num_warmup_steps": 0.1})
    del cfg["_vision"], cfg["text_vocab_size"]
    path = root / "Retrieval_coco.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_itr_coco_runs_with_a_swin_yaml(tmp_path, monkeypatch):
    """`python3 -m xfm_tpu_torch.run --task itr_coco` on a `use_swin` YAML
    (its `vision_config` a tiny Swin JSON, `text_encoder:
    data/bert-base-uncased`, which is absent, so the tokenizer falls back
    to the SimpleTokenizer over the captions: its pad id, 0, is the
    `bert_base` config's): one epoch of one step of 12 pairs, a zero-shot
    and an epoch eval, `ckpt/0`, which loads into the model with nothing
    missing but the tied decoder's entries; then `--evaluate --checkpoint`
    from it gives the epoch's metrics."""
    from xfm_tpu_torch import run
    from xfm_tpu_torch.data.tokenization import SimpleTokenizer
    from xfm_tpu_torch.models.text_encoder import TextConfig

    assert SimpleTokenizer().pad_token_id == TextConfig.bert_base(
    ).pad_token_id == 0
    cfg = _corpus(tmp_path)
    out = tmp_path / "out"
    argv = ["--task", "itr_coco", "--config", cfg, "--output_dir", str(out),
            "--device", "cpu", "--seed", "0"]
    res = run.main(argv)
    log = [json.loads(line)
           for line in (out / "log.txt").read_text().splitlines()]
    assert [e["epoch"] for e in log] == [-1, 0]
    assert np.isfinite(log[1]["loss_itc"]) and np.isfinite(log[1]["loss_itm"])
    assert os.path.isfile(out / "ckpt" / "0" / "state.pt")
    assert res["best_r_mean"] >= log[0]["r_mean"]
    # a saved state holds each parameter once: the fusion MLM decoder's
    # weight and bias are the word embeddings and `lm_head.bias`, tied
    sd = load_torch_state_dict(str(out / "ckpt" / "0" / "state.pt"))
    vocab = sd["text_encoder.roberta.embeddings.word_embeddings.weight"]
    model = XFMForRetrieval(config_from_yaml(
        dict(_yaml_config(), text_vocab_size=vocab.shape[0]),
        use_contrastive_loss=True, use_matching_loss=True,
        dtype=torch.float32))
    missing, unexpected = load_xfm_checkpoint(model, sd)
    assert sorted(missing) == ["fusion_encoder.lm_head.decoder.bias",
                               "fusion_encoder.lm_head.decoder.weight"]
    assert not unexpected
    metrics = run.main(argv + ["--evaluate", "--checkpoint",
                               str(out / "ckpt" / "0" / "state.pt")])
    for k, v in metrics.items():
        assert v == log[1][k], k
