"""NLVR2 in the port against the JAX package: `XFMForNLVR`, its parameter
tree and optimizer groups, `NLVRData`, the reference state-dict load with
its `cls_head`, `--bs` (Queue 3B fault (a)), the fallback tokenizer, and
`python3 -m xfm_tpu_torch.run --task nlvr --device cpu`
(`xfm_tpu/models/task_models.py`, `xfm_tpu/data/finetune_data.py`,
`xfm_tpu/tasks/nlvr.py`, `xfm_tpu/tasks/common.py`).

Both models run f32 (JAX at 'highest' precision, exact erf-GELU) on the
same weights, carried across by `state_dict_from_jax`, at width 32, 2
vision, text and fusion layers and 32 px images. Tolerances: loss rtol
1e-5; logits atol 1e-5; gradients atol 1e-5 + 1e-3 of each tensor's
largest value; two optimizer updates rtol 1e-6; batches and loaded
weights bit for bit.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from xfm_tpu_torch.configs import nlvr_yaml
from xfm_tpu_torch.models import XFMForNLVR, config_from_yaml
from xfm_tpu_torch.train.checkpoint import state_dict_from_jax
from _torch_threads import one_intra_op_thread  # noqa: F401

C, V = 32, 60
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["the", "left", "image", "shows", "two", "dogs", "right", "one",
         "has", "more", "birds", "than", "a", "red", "car", "in", "both"]


def small_yaml(**keys):
    return nlvr_yaml(image_res=32, layers=2, vision_embed_dim=C,
                     vision_num_heads=2, text_hidden_size=C,
                     text_num_attention_heads=2, text_intermediate_size=64,
                     text_vocab_size=V, compute_dtype="float32",
                     drop_path_rate=0.0, **keys)


def _models(seed=0, scale=0.1):
    """The JAX XFMForNLVR, its perturbed params, and the port's model with
    them."""
    from xfm_tpu.models import XFMForNLVR as JNLVR
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml

    ycfg = small_yaml()
    jcfg = jconfig_from_yaml(ycfg)
    jm = JNLVR(jcfg)
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((4, 32, 32, 3)),
        jnp.ones((2, 6), jnp.int32), jnp.ones((2, 6), jnp.int32),
        method=JNLVR.init_all)["params"])()
    r = np.random.RandomState(seed)
    params = jax.tree.map(lambda x: np.asarray(
        np.asarray(x) + scale * r.randn(*np.shape(x)), np.float32), params)
    model = XFMForNLVR(config_from_yaml(ycfg))
    model.load_state_dict(state_dict_from_jax(params, jcfg), strict=True)
    return jm, jcfg, params, model


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_EXACT_ERF", "1")
        yield _models()


def _batch(B=3, T=8, seed=0):
    r = np.random.RandomState(seed)
    images = r.randn(2 * B, 32, 32, 3).astype(np.float32)
    ids = r.randint(5, V - 1, (B, T)).astype(np.int32)
    ids[:, 0] = 1
    atts = np.ones((B, T), np.int32)
    for b in range(B):
        n = T - 2 * b
        ids[b, n - 1], ids[b, n:], atts[b, n:] = 2, 0, 0
    return images, ids, atts, np.asarray([1, 0, 1][:B], np.int32)


def _t(images, ids, atts):
    return (torch.from_numpy(images), torch.from_numpy(ids).long(),
            torch.from_numpy(atts).long())


def test_nlvr_loss_and_grads_match_jax(pair, monkeypatch):
    """The mean cross-entropy over the concatenated cls pair and every
    parameter's gradient (the vision tower's, both encoders', the
    cls_head's)."""
    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    jm, jcfg, params, model = pair
    images, ids, atts, targets = _batch()

    def loss(p):
        return jm.apply({"params": p}, jnp.asarray(images), jnp.asarray(ids),
                        jnp.asarray(atts), targets=jnp.asarray(targets),
                        train=True)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    model.zero_grad(set_to_none=True)
    got = model.loss(*_t(images, ids, atts), torch.from_numpy(targets).long())
    got.backward()
    np.testing.assert_allclose(got.item(), float(jloss), rtol=1e-5)
    want = state_dict_from_jax(jgrads, jcfg)
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for name, p in named.items():
        g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        w = want[name].numpy().reshape(g.shape)
        assert np.abs(g - w).max() <= 1e-5 + 1e-3 * np.abs(w).max(), name
    model.zero_grad(set_to_none=True)


def test_nlvr_logits_match_jax_and_follow_the_pair_order(pair, monkeypatch):
    """`train=False` gives the logits [B, 2], equal to JAX's; the batch
    holds [all first images; all second images], so swapping the halves
    (each pair's images exchanged) changes them, on both sides alike."""
    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    jm, _, params, model = pair
    images, ids, atts, _ = _batch(seed=1)
    B = ids.shape[0]
    swapped = np.concatenate([images[B:], images[:B]])
    logits = jax.jit(lambda p, imgs: jm.apply(
        {"params": p}, imgs, jnp.asarray(ids), jnp.asarray(atts),
        train=False))
    outs = []
    for imgs in (images, swapped):
        want = np.asarray(logits(params, jnp.asarray(imgs)))
        with torch.no_grad():
            got = model.loss(*_t(imgs, ids, atts), train=False).numpy()
        assert got.shape == (B, 2)
        np.testing.assert_allclose(got, want, atol=1e-5)
        outs.append(got)
    assert np.abs(outs[0] - outs[1]).max() > 1e-3


def _config():
    return {"optimizer": {"opt": "adamW", "lr": 1e-3, "weight_decay": 0.02,
                          "lr_mult": 2},
            "schedular": {"sched": "linear", "lr": 1e-3, "epochs": 2,
                          "num_warmup_steps": 0.25}}


def check_tree_and_groups(params, jcfg, model, tops, boosted):
    """The port's parameters are the JAX tree's, name for name and in
    count, under the top-level modules `tops`; HF-AdamW decays the set
    JAX's `decay_mask` decays and boosts the names under `boosted`, and two
    updates of the same gradients through both packages'
    `create_optimizer_from_config` (lr_mult 2) agree."""
    import optax

    from xfm_tpu.train.optim import create_optimizer_from_config as jcreate
    from xfm_tpu.train.optim import boost_mask, decay_mask
    from xfm_tpu.train.schedules import schedule_from_config as jsched

    from xfm_tpu_torch.train.optim import create_optimizer_from_config
    from xfm_tpu_torch.train.schedules import schedule_from_config

    named = dict(model.named_parameters())
    assert {n.split(".")[0] for n in named} == set(tops)
    assert sum(p.numel() for p in named.values()) == sum(
        np.size(x) for x in jax.tree.leaves(params))
    sd = state_dict_from_jax(params, jcfg)
    assert set(sd) == set(model.state_dict())
    config = _config()
    opt = create_optimizer_from_config(model, config,
                                       schedule_from_config(config, 2))
    dmask = state_dict_from_jax(jax.tree.map(np.float32, decay_mask(params)),
                                jcfg)
    bmask = state_dict_from_jax(jax.tree.map(
        np.float32, boost_mask(params)), jcfg)
    assert {opt.names[i] for i in opt.decay_idx} == {
        n for n in opt.names if dmask[n].reshape(-1)[0] == 1.0}
    got_boost = {opt.names[i] for i in opt.boost_idx}
    assert got_boost == {n for n in opt.names
                         if bmask[n].reshape(-1)[0] == 1.0}
    assert {n.split(".")[0] for n in got_boost} == set(boosted)
    jp = jax.tree.map(jnp.asarray, params)
    tx = jcreate(jp, config, jsched(config, 2))
    st = tx.init(jp)
    r = np.random.RandomState(3)
    leaves, tree = jax.tree.flatten(params)
    for _ in range(2):
        g = jax.tree.unflatten(tree, [np.asarray(0.3 * r.randn(
            *np.shape(x)), np.float32) for x in leaves])
        upd, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)
        tg = state_dict_from_jax(g, jcfg)
        for name, p in named.items():
            p.grad = tg[name].clone()
        opt.step()
    want = state_dict_from_jax(jax.tree.map(np.asarray, jp), jcfg)
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=name)


def test_parameter_tree_and_optimizer_groups_match_jax(pair):
    """NLVR's tree: the three encoders (the fusion one with its MLM head,
    which JAX's `init_all` touches) and `cls_head` beside the backbone; no
    ITM head, projections or temperature. Only `cls_head` is boosted."""
    _, jcfg, params, _ = pair
    assert set(params) == {"backbone", "cls_head"}
    assert set(params["backbone"]) == {"vision_encoder", "text_encoder",
                                       "fusion_encoder"}
    model = XFMForNLVR(config_from_yaml(small_yaml()))
    model.load_state_dict(state_dict_from_jax(params, jcfg), strict=True)
    assert model.cls_head[0].in_features == 2 * C
    check_tree_and_groups(params, jcfg, model, ("vision_encoder",
                                                "text_encoder",
                                                "fusion_encoder",
                                                "cls_head"), ("cls_head",))


def test_reference_load_takes_the_cls_head(pair, tmp_path):
    """A reference-named state dict with `cls_head.{0,1,3}.*` (and an
    `itm_head` NLVR has no place for) loads as JAX's
    `import_xfm_checkpoint(..., head="cls_mlp")` + `merge_params` do."""
    from xfm_tpu.train.checkpoint import (import_xfm_checkpoint,
                                          load_torch_state_dict,
                                          merge_params, to_jax)

    from xfm_tpu_torch.train.checkpoint import (init_weights,
                                                load_torch_state_dict as tl,
                                                load_xfm_checkpoint,
                                                reference_state_dict)

    _, jcfg, params, model = pair
    src = XFMForNLVR(config_from_yaml(small_yaml()))
    init_weights(src, 5)
    sd = reference_state_dict(src)
    sd.update({f"itm_head.{i}.{w}": torch.ones(3) for i in (0, 1, 3)
               for w in ("weight", "bias")})
    path = str(tmp_path / "nlvr.pth")
    torch.save({"model": sd}, path)
    merged, missing, _ = merge_params(jax.tree.map(jnp.asarray, params),
                                      to_jax(import_xfm_checkpoint(
                                          load_torch_state_dict(path), jcfg,
                                          head="cls_mlp")))
    assert missing == []
    want = state_dict_from_jax(jax.tree.map(np.asarray, merged), jcfg)
    dst = XFMForNLVR(config_from_yaml(small_yaml()))
    miss, unexpected = load_xfm_checkpoint(dst, tl(path))
    assert miss == [] and sorted(unexpected) == sorted(
        k for k in sd if k.startswith("itm_head"))
    for k, v in dst.state_dict().items():
        assert torch.equal(v, want[k].reshape(v.shape)), k
    assert torch.equal(dst.cls_head[3].weight, src.cls_head[3].weight)


def _png(path, r, lo=36, hi=60):
    from PIL import Image

    h, w = r.randint(lo, hi, 2)
    Image.fromarray(r.randint(0, 255, (h, w, 3)).astype(np.uint8)).save(path)


def _corpus(root, seed=0):
    """PNG pairs and train (10), val (3) and test (5) rows with 'True' /
    'False' labels (some as booleans, some in other cases)."""
    r = np.random.RandomState(seed)
    img = os.path.join(root, "images")
    os.makedirs(img, exist_ok=True)
    paths, n = {"image_root": img}, 0
    for split, rows in (("train", 10), ("val", 3), ("test", 5)):
        ann = []
        for i in range(rows):
            names = []
            for _ in range(2):
                names.append(f"img{n:03d}.png")
                _png(os.path.join(img, names[-1]), r)
                n += 1
            label = ["True", "False", True, "false", "TRUE"][i % 5]
            ann.append({"images": names, "label": label, "sentence":
                        " ".join(r.choice(WORDS, r.randint(4, 12)))})
        paths[split] = os.path.join(root, f"{split}.json")
        with open(paths[split], "w") as f:
            json.dump(ann, f)
    return paths


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nlvr"))
    return root, _corpus(root)


def _tokenizer(paths):
    from xfm_tpu_torch.data.tokenization import SimpleTokenizer
    from xfm_tpu_torch.tasks.nlvr import nlvr_texts

    return SimpleTokenizer.from_texts(nlvr_texts(
        {"train_file": [paths["train"]], "val_file": paths["val"],
         "test_file": paths["test"]}))


@pytest.mark.parametrize("epoch_seed", [0, 43])
def test_nlvr_data_bit_equal_to_jax(corpus, epoch_seed):
    """Train batches (the port reseeds its transform from [epoch_seed, 1];
    JAX's is built with that seed) and eval batches, the short last one
    kept, bit for bit; the labels parsed as `str(label).lower() ==
    "true"`; the images [first; second]."""
    from xfm_tpu.data.finetune_data import NLVRData as JData
    from xfm_tpu.data.transforms import TestTransform as JTest
    from xfm_tpu.data.transforms import TrainTransform as JTrain

    from xfm_tpu_torch.data.finetune_data import NLVRData
    from xfm_tpu_torch.data.transforms import TestTransform, TrainTransform

    root, paths = corpus
    tok = _tokenizer(paths)
    for train, ann, mk, jmk, n in (
            (True, [paths["train"]], lambda: TrainTransform(32, seed=7),
             lambda: JTrain(32, seed=[epoch_seed, 1]), 2),
            (False, paths["test"], lambda: TestTransform(32),
             lambda: JTest(32), 2)):
        ours = NLVRData(ann, mk(), paths["image_root"], tok, max_tokens=12,
                        batch_size=4, train=train)
        theirs = JData(ann, jmk(), paths["image_root"], tok, max_tokens=12,
                       batch_size=4, train=train)
        got = list(ours.epoch(epoch_seed))
        want = list(theirs.epoch(epoch_seed))
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == ["images", "targets",
                                              "text_atts", "text_ids"]
            for k in g:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k],
                                                                   w[k]), k
    ann = json.load(open(paths["test"]))
    assert got[0]["targets"].tolist() == [1, 0, 1, 0]
    assert got[1]["images"].shape == (2, 32, 32, 3)  # the short last batch
    from xfm_tpu_torch.data.transforms import decode_image

    first = TestTransform(32)(decode_image(os.path.join(
        paths["image_root"], ann[1]["images"][0])))
    second = TestTransform(32)(decode_image(os.path.join(
        paths["image_root"], ann[1]["images"][1])))
    assert np.array_equal(got[0]["images"][1], first)
    assert np.array_equal(got[0]["images"][4 + 1], second)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("name", ["NLVR", "Grounding_bbox"])
def test_bs_scales_the_top_level_batch_size(name, n, monkeypatch):
    """Queue 3B fault (a): NLVR.yaml and Grounding_bbox.yaml set a
    top-level `batch_size`, which JAX's `_scale_batch` leaves as it is, so
    `--bs` changes nothing there; the port's divides it over the
    processes."""
    import xfm_tpu.tasks.common as jcommon

    from xfm_tpu_torch.tasks.common import scale_batch

    with open(os.path.join(REPO, "configs", "xfm-ft", f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    ours, theirs = dict(cfg), dict(cfg)
    monkeypatch.setattr(jax, "device_count", lambda: n)
    jcommon._scale_batch(theirs, 48)
    scale_batch(ours, 48, n)
    assert theirs == cfg and cfg["batch_size"] == 24
    assert ours == dict(cfg, batch_size=48 // n)


def _task_yaml(root, paths, **keys):
    cfg = small_yaml(
        train_file=[paths["train"]], val_file=paths["val"],
        test_file=paths["test"], image_root=paths["image_root"],
        max_tokens=12, resume=True,
        optimizer={"opt": "adamW", "lr": 1e-3, "weight_decay": 0.01,
                   "lr_mult": 2},
        schedular={"sched": "linear", "lr": 1e-3, "epochs": 2,
                   "num_warmup_steps": 0.1}, **keys)
    path = os.path.join(root, f"nlvr{len(os.listdir(root))}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(x) for x in f.read().splitlines()]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_nlvr_on_the_cpu(corpus, tmp_path, one_thread):
    """The fine-tune at `--bs 4` (2 epochs of 2 steps; val and test
    accuracies each epoch; `ckpt/` and `ckpt_best/`), its resume bit-equal
    after `ckpt/1` is deleted, and `--evaluate --checkpoint` from its own
    checkpoint giving the last epoch's test accuracy."""
    from xfm_tpu_torch import run

    root, paths = corpus
    cfg = _task_yaml(root, paths)
    out = str(tmp_path / "out")
    argv = ["--task", "nlvr", "--config", cfg, "--output_dir", out,
            "--device", "cpu", "--bs", "4", "--seed", "3"]
    res = run.main(argv)
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["0", "1"]
    assert os.listdir(os.path.join(out, "ckpt_best"))
    log = _log(out)
    assert [e["epoch"] for e in log] == [0, 1]
    for e in log:
        assert np.isfinite(e["loss"])
        assert 0 <= e["val_acc"] <= 1 and 0 <= e["test_acc"] <= 1
    assert res == {"best_val_acc": max(e["val_acc"] for e in log)}
    final = torch.load(os.path.join(out, "ckpt", "1", "state.pt"),
                       weights_only=True)
    assert final["step"] == 4
    shutil.rmtree(os.path.join(out, "ckpt", "1"))
    run.main(argv)
    resumed = torch.load(os.path.join(out, "ckpt", "1", "state.pt"),
                         weights_only=True)
    assert resumed["step"] == final["step"]
    for name, p in final["params"].items():
        assert torch.equal(p, resumed["params"][name]), name
    assert _log(out)[-1] == log[-1]
    ev = run.main(["--task", "nlvr", "--config", cfg, "--output_dir",
                   str(tmp_path / "ev"), "--device", "cpu", "--evaluate",
                   "--checkpoint", os.path.join(out, "ckpt", "1",
                                                "state.pt")])
    assert ev == {"acc": log[-1]["test_acc"]}


def test_run_nlvr_falls_back_to_the_default_config(monkeypatch, tmp_path):
    from xfm_tpu_torch import configs, run
    from xfm_tpu_torch.tasks import nlvr

    seen = []
    monkeypatch.setattr(nlvr, "main", lambda args: seen.append(args.config))
    for extra in ([], ["--config", str(tmp_path / "missing.yaml")]):
        run.main(["--task", "nlvr", "--output_dir", str(tmp_path)] + extra)
    want = os.path.join(REPO, "configs", "xfm-ft", "NLVR.yaml")
    assert seen == [want, want]
    with open(want) as f:
        assert configs.NLVR == yaml.safe_load(f)


def test_fallback_tokenizer_holds_the_sentences(corpus, monkeypatch):
    """Without the RoBERTa files JAX builds its fallback over no text
    (`xfm_tpu/tasks/nlvr.py:41`): every word reads as unknown. The port's
    holds every word of the train, val and test sentences."""
    from xfm_tpu.tasks.retrieval import build_tokenizer_or_fallback as jbuild

    from xfm_tpu_torch.tasks import nlvr

    root, paths = corpus
    with open(_task_yaml(root, paths)) as f:
        cfg = yaml.safe_load(f)
    assert jbuild(cfg).vocab_size == 5  # the specials alone
    tok = nlvr.build_tokenizer_or_fallback(cfg,
                                           lambda: nlvr.nlvr_texts(cfg))
    words = {w for s in ("train", "val", "test")
             for a in json.load(open(paths[s]))
             for w in a["sentence"].split()}
    unk = tok.convert_tokens_to_ids(["<unk>"])[0]
    assert unk not in tok.convert_tokens_to_ids(sorted(words))
