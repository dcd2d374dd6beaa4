"""COCO captioning's data, metrics, SCST and checkpoint routes in the port
against the JAX package (`xfm_tpu_torch/data/finetune_data.py`
`CaptioningData`, `xfm_tpu_torch/eval/` caption metrics,
`tasks/captioning.py`, `train/checkpoint.caption_checkpoint`).

- `CaptioningData`: train and eval batches bit-equal to the JAX class's,
  from one tokenizer instance and seeded transforms on both sides (the
  port reseeds its own from [epoch_seed, 1] each epoch; the JAX package's
  is built with that seed): the prompt prefix, the shuffle, the image ids
  parsed from "coco_<n>" strings and from file names, the short last eval
  batch.
- The metric copies (BLEU-1..4, ROUGE-L, METEOR, CIDEr-D, the PTB
  tokenization, `coco_caption_eval`) equal to `xfm_tpu.eval`'s, exactly.
- SCST: its references keyed by the batches' image ids and the
  tokenizer's own special ids (two faults of the JAX task the port does
  not copy); `_reward` equal to the JAX task's; the advantages of both
  baselines equal to the JAX task's lines; the loss and every gradient
  for fixed sequences and advantages against the JAX task's `logp_fn`
  (its lines, f32, 'highest' precision): loss rtol 1e-5, gradients atol
  1e-5 + 1e-3 of each tensor's largest value.
- The checkpoint routes: the decoder from the fusion encoder and from the
  text encoder (RoBERTa and BERT names) equal, bit for bit, to the JAX
  task's `load_ckpt_into`; a caption checkpoint's own decoder loads (the
  JAX task's route drops it: a fault the port does not copy), so the
  loaded model captions as the model that saved it.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.configs import caption_yaml
from xfm_tpu_torch.models import XFMForCaptioning, config_from_yaml
from xfm_tpu_torch.train.checkpoint import (init_weights,
                                            reference_state_dict,
                                            state_dict_from_jax)
from _torch_threads import one_intra_op_thread  # noqa: F401

C, V = 32, 100
WORDS = ["a", "man", "dog", "cat", "on", "the", "red", "street", "table",
         "with", "two", "people", "riding", "sitting", "of", "picture",
         "blue", "bus", "near", "grass"]


def _png(path, r, h, w):
    from PIL import Image

    Image.fromarray(r.randint(0, 255, (h, w, 3)).astype(np.uint8)).save(path)


def write_caption_corpus(root, n_train=10, n_val=5, seed=0):
    """PNGs under root/images; Karpathy-style train rows (one caption each,
    two rows an image, `image_id` "coco_<n>"), val rows with a list of 3-5
    captions (`image_id` "coco_<n>"; the last one without, its id in its
    file name) → {train, val}."""
    r = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)

    def cap():
        return " ".join(r.choice(WORDS, r.randint(3, 9))) + "."

    train, val = [], []
    for i in range(n_train + n_val):
        name = f"COCO_val2014_{1000 + i:012d}.png"
        _png(os.path.join(root, "images", name), r, 24 + 2 * i, 40 - i)
        if i < n_train:
            train += [{"image": name, "caption": cap(),
                       "image_id": f"coco_{1000 + i}"} for _ in range(2)]
        else:
            row = {"image": name, "caption": [cap() for _ in
                                              range(3 + i % 3)]}
            if i < n_train + n_val - 1:
                row["image_id"] = f"coco_{1000 + i}"
            val.append(row)
    paths = {}
    for name, obj in (("train", train), ("val", val)):
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    return paths


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("caption"))
    return root, write_caption_corpus(root)


def _tokenizer(paths):
    from xfm_tpu_torch.data.tokenization import SimpleTokenizer
    from xfm_tpu_torch.tasks.captioning import caption_texts

    return SimpleTokenizer.from_texts(caption_texts(
        {"train_file": [paths["train"]], "val_file": paths["val"],
         "prompt": "a picture of "}))


@pytest.mark.parametrize("epoch_seed", [0, 43])
def test_captioning_data_bit_equal_to_jax(corpus, epoch_seed):
    from xfm_tpu.data.finetune_data import CaptioningData as JData
    from xfm_tpu.data.transforms import TestTransform as JTest
    from xfm_tpu.data.transforms import TrainTransform as JTrain

    from xfm_tpu_torch.data.finetune_data import CaptioningData
    from xfm_tpu_torch.data.transforms import TestTransform, TrainTransform

    root, paths = corpus
    images = os.path.join(root, "images")
    tok = _tokenizer(paths)
    ours = CaptioningData([paths["train"]],
                          TrainTransform(48, hflip=False, seed=7), images,
                          tok, max_tokens=12, batch_size=6, train=True,
                          prompt="a picture of ")
    theirs = JData([paths["train"]], JTrain(48, hflip=False,
                                            seed=[epoch_seed, 1]),
                   images, tok, max_tokens=12, batch_size=6, train=True,
                   prompt="a picture of ")
    got, want = list(ours.epoch(epoch_seed)), list(theirs.epoch(epoch_seed))
    assert len(got) == len(want) == 3  # 20 rows, the last 2 dropped
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["image_id", "images", "text_atts",
                                          "text_ids"]
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    prompt = tok.convert_tokens_to_ids(["a", "picture", "of"])
    assert (got[0]["text_ids"][:, 1:4] == prompt).all()
    assert set(np.concatenate([b["image_id"] for b in got])) <= set(
        range(1000, 1010))
    ours_v = CaptioningData(paths["val"], TestTransform(48), images, tok,
                            batch_size=2, train=False)
    theirs_v = JData(paths["val"], JTest(48), images, tok, batch_size=2,
                     train=False)
    got, want = list(ours_v.epoch()), list(theirs_v.epoch())
    assert [len(b["image_id"]) for b in got] == [2, 2, 1]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["image_id", "images"]
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    assert np.concatenate([b["image_id"] for b in got]).tolist() == list(
        range(1010, 1015))


def test_caption_metric_copies_match_jax():
    from xfm_tpu.eval import caption_metrics as jm
    from xfm_tpu.eval import cider as jc
    from xfm_tpu.eval import meteor as jmet
    from xfm_tpu.eval import ptb_tokenizer as jptb

    from xfm_tpu_torch.eval import caption_metrics as tm
    from xfm_tpu_torch.eval import cider as tc
    from xfm_tpu_torch.eval import meteor as tmet
    from xfm_tpu_torch.eval import ptb_tokenizer as tptb

    r = np.random.RandomState(0)
    extra = ["photo", "picture", "sofa", "couch", "kid", "child", "running",
             "runs", "isn't", "(two)", "dogs'", "--", "A", "Man's", "..."]

    def cap():
        return " ".join(r.choice(WORDS + extra, r.randint(2, 12)))

    refs = {str(i): [cap() for _ in range(1 + i % 5)] for i in range(30)}
    hypos = {str(i): cap() for i in range(30)}
    hypos["0"] = refs["0"][0]
    assert tptb.ptb_tokenize(refs) == jptb.ptb_tokenize(refs)
    assert tm.bleu(hypos, refs) == jm.bleu(hypos, refs)
    assert tm.rouge_l(hypos, refs) == jm.rouge_l(hypos, refs)
    assert tmet.meteor(hypos, refs) == jmet.meteor(hypos, refs)
    assert tc.CiderD(refs).score(hypos) == jc.CiderD(refs).score(hypos)
    assert tc.CiderD(refs).score_one("3", hypos["3"]) == \
        jc.CiderD(refs).score_one("3", hypos["3"])
    got = tm.coco_caption_eval(hypos, refs)
    assert got == jm.coco_caption_eval(hypos, refs)
    assert got["SPICE"] is None and "SPICE_note" in got
    assert {"Bleu_1", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr"} <= set(got)


# --- SCST --------------------------------------------------------------------

def test_scst_rewards_and_advantages_match_jax(corpus):
    from xfm_tpu.eval.cider import CiderD as JCider
    from xfm_tpu.tasks.captioning import _reward as jreward

    from xfm_tpu_torch.eval.cider import CiderD
    from xfm_tpu_torch.tasks.captioning import _reward, scst_advantages

    _, paths = corpus
    tok = _tokenizer(paths)
    train = json.load(open(paths["train"]))
    refs = {}
    for a in train:
        refs.setdefault(a["image_id"].split("_")[-1], []).append(a["caption"])
    iids = sorted(refs)[:3]
    n = 4
    r = np.random.RandomState(1)
    seqs = r.randint(5, tok.vocab_size, (3 * n, 8)).astype(np.int64)
    seqs[1, 3:] = 2  # EOS, then pads
    seqs[2, 5:] = 0
    seqs[5] = tok.convert_tokens_to_ids(tok.tokenize(refs[iids[1]][0])
                                        + ["</s>"] * 8)[:8]
    got = _reward(CiderD(refs), tok, torch.from_numpy(seqs), iids, 2, 0, n)
    want = jreward(JCider(refs), tok, jnp.asarray(seqs), iids, 2, 0, n)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert got[5] > got[4]  # a copy of a reference scores
    greedy = jreward(JCider(refs), tok, jnp.asarray(seqs[::n]), iids, 2, 0,
                     1)
    # the JAX task's two baselines, its lines
    want_g = got - np.repeat(greedy, n)
    sc = got.reshape(-1, n)
    want_s = (sc - (sc.sum(1, keepdims=True) - sc) / (n - 1)).reshape(-1)
    np.testing.assert_array_equal(scst_advantages(got, n, greedy), want_g)
    np.testing.assert_array_equal(scst_advantages(got, n), want_s)


def test_scst_references_and_special_ids(corpus):
    """SCST's references are keyed by the image id the batches carry: of a
    "coco_<n>" id the number, which the JAX task's keys (the raw id) miss,
    so every JAX reward would be 0 on such files. The special ids are the
    tokenizer's own: the SimpleTokenizer's pad 0 stays 0, where the JAX
    task's `or` defaults read 1 (its bos)."""
    from xfm_tpu.tasks.captioning import _special_ids as jspecial

    from xfm_tpu_torch.data.finetune_data import CaptioningData
    from xfm_tpu_torch.tasks.captioning import scst_references, special_ids

    root, paths = corpus
    tok = _tokenizer(paths)
    data = CaptioningData([paths["train"]], _Fixed(),
                          os.path.join(root, "images"), tok, batch_size=20,
                          prompt="a picture of ")
    (batch,) = list(data.epoch(0))
    refs = scst_references(data.ann)
    assert {str(i) for i in batch["image_id"]} == set(refs)
    assert all(len(v) == 2 for v in refs.values())
    jax_keys = {str(a.get("image_id", a.get("image"))) for a in data.ann}
    assert not jax_keys & {str(i) for i in batch["image_id"]}
    assert special_ids(tok) == (1, 2, 0)
    assert jspecial(tok) == (1, 2, 1)


class _Fixed:
    def reseed(self, seed):
        pass

    def __call__(self, img):
        return np.zeros((2, 2, 3), np.float32)


@pytest.mark.parametrize("prompt_len", [0, 4])
def test_scst_loss_and_grads_match_jax(prompt_len, monkeypatch):
    """−mean(log p · advantage) for fixed sampled sequences (n = 3 an
    image, contiguous; EOS and pads inside) and advantages, and every
    gradient, against the JAX task's `logp_fn` lines."""
    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.models.generation import XFMForCaptioning as JCap
    from xfm_tpu.models.generation import shift_lm_loss as jshift

    from xfm_tpu_torch.tasks.captioning import scst_loss

    ycfg = caption_yaml(image_res=32, layers=2, vision_embed_dim=C,
                        vision_num_heads=2, text_hidden_size=C,
                        text_num_attention_heads=2,
                        text_intermediate_size=64, text_vocab_size=V,
                        compute_dtype="float32", drop_path_rate=0.0)
    jcfg = jconfig_from_yaml(ycfg)
    jm = JCap(jcfg, num_dec_layers=2, pad_token_id=1)
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(3)}, jnp.zeros((2, 32, 32, 3)),
        jnp.ones((2, 6), jnp.int32), jnp.ones((2, 6), jnp.int32),
        method=JCap.init_all)["params"])()
    model = XFMForCaptioning.from_yaml(ycfg)
    model.load_state_dict(state_dict_from_jax(params, jcfg), strict=True)
    n, bos, pad = 3, 0, 1
    r = np.random.RandomState(4)
    images = r.randn(2, 32, 32, 3).astype(np.float32)
    seqs = r.randint(5, V - 1, (2 * n, 8)).astype(np.int32)
    seqs[:, :prompt_len] = (10, 11, 12, 13)[:prompt_len]
    seqs[0, 6], seqs[0, 7:] = 2, pad
    seqs[4, 5], seqs[4, 6:] = 2, pad
    adv = r.randn(2 * n).astype(np.float32)

    def logp_fn(p):
        def run(m, images, full):
            image_embeds = m.backbone.get_vision_embeds(images)
            atts = jnp.ones(image_embeds.shape[:2], jnp.int32)
            hidden = m.text_decoder(full, attention_mask=None,
                                    encoder_hidden_states=image_embeds,
                                    encoder_attention_mask=atts,
                                    encoder_group_size=n)
            return m.text_decoder.mlm_logits(hidden, None)

        full = jnp.concatenate([jnp.full((seqs.shape[0], 1), bos,
                                         jnp.int32), seqs], axis=1)
        logits = jm.apply({"params": p}, jnp.asarray(images), full,
                          method=run)
        labels = jnp.where(full == pad, -100, full)
        if prompt_len:
            pos = jnp.arange(labels.shape[1])[None]
            labels = jnp.where(pos <= prompt_len, -100, labels)
        return -jshift(logits, labels)

    jloss, jgrads = jax.value_and_grad(
        lambda p: -jnp.mean(logp_fn(p) * jnp.asarray(adv)))(params)
    loss = scst_loss(model, torch.from_numpy(images),
                     torch.from_numpy(seqs).long(), torch.from_numpy(adv),
                     bos, pad, prompt_len, n)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = state_dict_from_jax(jgrads, jcfg)
    for name, p in model.named_parameters():
        g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        w = want[name].numpy().reshape(g.shape)
        assert np.abs(g - w).max() <= 1e-5 + 1e-3 * np.abs(w).max(), name


# --- the checkpoint routes --------------------------------------------------

def _small_yaml(**keys):
    return caption_yaml(image_res=32, layers=2, **{**dict(
        vision_embed_dim=C, vision_num_heads=2, text_hidden_size=C,
        text_num_attention_heads=2, text_intermediate_size=64,
        text_vocab_size=V, compute_dtype="float32"), **keys})


def _source_sd(seed=5):
    """A pretrain-format reference state dict: the vision tower, the text
    encoder with its MLM head, the fusion encoder with its own."""
    from xfm_tpu_torch.models import XFMBase

    src = XFMBase(config_from_yaml(_small_yaml(), use_mlm_loss=True))
    init_weights(src, seed)
    return {k: v.numpy() for k, v in reference_state_dict(src).items()}


def _bert_text_names(sd):
    out = {}
    for k, v in sd.items():
        k = k.replace("text_encoder.roberta.", "text_encoder.bert.")
        for a, b in (("lm_head.dense.", "cls.predictions.transform.dense."),
                     ("lm_head.layer_norm.",
                      "cls.predictions.transform.LayerNorm."),
                     ("lm_head.bias", "cls.predictions.bias"),
                     ("lm_head.decoder.", "cls.predictions.decoder.")):
            k = k.replace("text_encoder." + a, "text_encoder." + b)
        out[k] = v
    return out


class _State:
    def __init__(self, params):
        self.params = params

    def replace(self, params):
        return _State(params)


@pytest.mark.parametrize("route", ["fusion", "text", "text_bert"])
def test_checkpoint_routes_match_jax(route, tmp_path):
    """The decoder copied from the fusion encoder (the fine-tune's route,
    its MLM head and cross-attention included) or from the text encoder
    (the domain pretrain's: its `lm_head` or `cls.predictions`, the
    cross-attention left at init), against the JAX task's `load_ckpt_into`
    on the same file, bit for bit."""
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.models.generation import XFMForCaptioning as JCap
    from xfm_tpu.tasks.captioning import load_ckpt_into as jload

    from xfm_tpu_torch.tasks.captioning import load_ckpt_into

    sd = _source_sd()
    if route == "text_bert":
        sd = _bert_text_names(sd)
    path = str(tmp_path / "pretrain.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    jcfg = jconfig_from_yaml(_small_yaml())
    jm = JCap(jcfg, num_dec_layers=2, pad_token_id=1)
    init = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)),
        jnp.ones((1, 5), jnp.int32), jnp.ones((1, 5), jnp.int32),
        method=JCap.init_all)["params"])()
    decoder_from = route.split("_")[0]
    jparams = jload(_State(init), jcfg, path, decoder_from).params
    model = XFMForCaptioning.from_yaml(_small_yaml())
    model.load_state_dict(state_dict_from_jax(init, jcfg), strict=True)
    missing = load_ckpt_into(model, path, decoder_from)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jparams), jcfg)
    got = model.state_dict()
    for k in got:
        assert torch.equal(got[k], want[k].reshape(got[k].shape)), k
    cross = "text_decoder.roberta.encoder.layer.1.crossattention.self."
    src = f"{decoder_from}_encoder.roberta.encoder.layer.1."
    assert torch.equal(got[cross + "key.weight"], torch.from_numpy(
        sd[src + "crossattention.self.key.weight"])) \
        if decoder_from == "fusion" else (cross + "key.weight") in missing
    assert torch.equal(got["text_decoder.lm_head.dense.weight"],
                       torch.from_numpy(sd[
                           f"{decoder_from}_encoder.lm_head.dense.weight"
                           if route != "text_bert" else
                           "text_encoder.cls.predictions.transform.dense."
                           "weight"]))


def test_caption_checkpoint_loads_its_own_decoder(tmp_path):
    """A caption checkpoint (a fine-tuned decoder, a fusion encoder beside
    it) loads its own decoder: the loaded model captions as the model that
    saved it. The JAX task's route reads no `text_decoder.*` and copies
    the fusion encoder into the decoder, which captions otherwise."""
    from xfm_tpu_torch.models import generate
    from xfm_tpu_torch.tasks.captioning import load_ckpt_into

    tuned = XFMForCaptioning.from_yaml(_small_yaml())
    init_weights(tuned, 7)
    with torch.no_grad():  # a fine-tuned decoder: far from its init
        for p in tuned.text_decoder.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=torch.Generator(
            ).manual_seed(p.numel())))
    sd = {k: v for k, v in reference_state_dict(tuned).items()}
    sd.update({k: torch.from_numpy(v) for k, v in _source_sd().items()
               if k.startswith("fusion_encoder.")})
    path = str(tmp_path / "caption.pth")
    torch.save({"model": sd}, path)
    images = torch.from_numpy(np.random.RandomState(2).randn(
        3, 32, 32, 3).astype(np.float32))
    kw = dict(bos_id=0, eos_id=2, pad_id=1, max_len=8)
    want, _ = generate(tuned, images, **kw)
    loaded = XFMForCaptioning.from_yaml(_small_yaml())
    init_weights(loaded, 9)
    assert load_ckpt_into(loaded, path) == []
    got, _ = generate(loaded, images, **kw)
    assert torch.equal(got, want)
    # the JAX task's route: the decoder from the fusion encoder
    fused = XFMForCaptioning.from_yaml(_small_yaml())
    init_weights(fused, 9)
    from xfm_tpu_torch.train.checkpoint import (caption_checkpoint,
                                                load_xfm_checkpoint)

    load_xfm_checkpoint(fused, caption_checkpoint(
        {k: v for k, v in sd.items() if not k.startswith("text_decoder.")}))
    other, _ = generate(fused, images, **kw)
    assert not torch.equal(other, want)
