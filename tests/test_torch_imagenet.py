"""ImageNet and the linear probes in the port (`xfm_tpu_torch/tasks/
imagenet.py`, `data/probe_datasets.py`) against the JAX package
(`xfm_tpu/tasks/imagenet.py`, `xfm_tpu/data/probe_datasets.py`): mixup /
cutmix and their soft targets bit for bit from the same generator,
`soft_ce` within 1e-6, the manifests, the probe splits, the batches, the
top-1 `evaluate` on the same weights and PNGs; then `python3 -m
xfm_tpu_torch.run --task imagenet --device cpu` end to end (the fine-tune,
the linear probe with its frozen tower and LARS, `--evaluate` from a
checkpoint), `--bs`, the default YAMLs and `--model`.

The models run f32 at vision width 128 (two heads of 64), 2 blocks, 32 px
(the JAX tower through K1 in interpret mode)."""
import json
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import jax
import jax.numpy as jnp

import xfm_tpu.tasks.imagenet as jim
from test_torch_classification import (SMALL, jax_k1_interpret,  # noqa: F401
                                       small_yaml)
from xfm_tpu_torch import configs
from xfm_tpu_torch.tasks import imagenet as im
from _torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images(B=6, H=20, W=24, seed=0):
    return np.random.RandomState(seed).randn(B, H, W, 3).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(),  # the shipped recipe: mixup 0.8 and cutmix 1.0, switched
    dict(cutmix_alpha=0.0),  # mixup alone
    dict(mixup_alpha=0.0),  # cutmix alone
    dict(cutmix_minmax=(0.2, 0.8), mixup_alpha=0.0),
    dict(prob=0.3, label_smoothing=0.0),
    dict(mixup_alpha=0.0, cutmix_alpha=0.0)])
def test_mixup_cutmix_matches_jax(kw):
    """Eight batches in a row from one generator each side: the images and
    the soft targets bit-equal, the targets' rows summing to 1."""
    labels = np.array([0, 3, 1, 4, 2, 3])
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    for i in range(8):
        imgs = _images(seed=i)
        got = im.mixup_cutmix(r1, imgs, labels, 5, **kw)
        want = jim.mixup_cutmix(r2, imgs, labels, 5, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), (kw, i)
        np.testing.assert_allclose(got[1].sum(-1), 1.0, rtol=1e-6)


def test_mixed_loader_casts_like_the_device_copy():
    """The task's loader mixes each batch with the YAML's keys in the JAX
    task's order and hands f32 images and targets on (JAX's device copy
    makes them f32); off under `is_lp` or with every mode off."""
    batch = {"images": _images(), "targets": np.array([0, 3, 1, 4, 2, 3])}
    cfg = dict(configs.IMAGENET, num_labels=5)
    got = next(im.mixed([batch], cfg, np.random.default_rng(1), 5))
    want = jim.mixup_cutmix(np.random.default_rng(1), batch["images"],
                            batch["targets"], 5, 0.8, 1.0, 1.0, 0.5, None,
                            0.1)
    assert got["images"].dtype == got["targets"].dtype == np.float32
    assert np.array_equal(got["images"], want[0].astype(np.float32))
    assert np.array_equal(got["targets"], want[1].astype(np.float32))
    for off in (configs.IMAGENET_LP, dict(cfg, mixup=0.0, cutmix=0.0)):
        assert next(im.mixed([batch], off, np.random.default_rng(1),
                             5)) is batch


def test_soft_ce_matches_jax():
    r = np.random.RandomState(0)
    logits = r.randn(6, 7).astype(np.float32) * 3
    t = r.dirichlet(np.ones(7), 6).astype(np.float32)
    got = im.soft_ce(torch.from_numpy(logits), torch.from_numpy(t)).item()
    want = float(jim.soft_ce(jnp.asarray(logits), jnp.asarray(t)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _png_tree(root, n_classes=5, per_class=2, seed=0):
    """Class folders of seeded PNGs (40-56 px a side) under root."""
    r = np.random.RandomState(seed)
    for c in range(n_classes):
        d = os.path.join(root, f"class{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            h, w = r.randint(40, 57, 2)
            Image.fromarray(r.randint(0, 256, (h, w, 3), np.uint8)).save(
                os.path.join(d, f"{i}.png"))
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagenet")
    train = _png_tree(str(root / "train"), per_class=2, seed=0)
    val = _png_tree(str(root / "val"), per_class=2, seed=1)
    manifest = root / "val.jsonl"
    with open(manifest, "w") as f:
        for c in range(5):
            for i in range(2):
                f.write(json.dumps({"image": f"class{c}/{i}.png",
                                    "label": c}) + "\n")
    (root / "broken").mkdir()
    (root / "broken" / "bad.png").write_bytes(b"not a png")
    return dict(root=str(root), train=train, val=val,
                manifest=str(manifest))


def test_manifests_and_batches_match_jax(corpus):
    """Class folders and a JSONL manifest give JAX's rows; the batches
    (shuffled or not, a last partial batch kept or dropped) its arrays; a
    row that cannot be read is skipped on both sides."""
    from xfm_tpu.data.timm_aug import ImagenetEvalTransform as JEval

    from xfm_tpu_torch.data.timm_aug import ImagenetEvalTransform

    for src in (corpus["val"], corpus["manifest"]):
        assert im.load_manifest(src) == jim.load_manifest(src)
    rows, n = im.load_manifest(corpus["manifest"])
    assert n == 5
    rows = rows + [(os.path.join(corpus["root"], "broken", "bad.png"), 0)]
    for kw in (dict(shuffle=True, seed=3), dict(shuffle=False,
                                                drop_last=False)):
        got = list(im.batches(rows, ImagenetEvalTransform(32),
                              corpus["val"], 4, **kw))
        want = list(jim.batches(rows, JEval(32), corpus["val"], 4, **kw))
        assert len(got) == len(want) == (3 if "drop_last" in kw else 2)
        for g, w in zip(got, want):
            assert np.array_equal(g["images"], w["images"])
            assert np.array_equal(g["targets"], w["targets"])


def test_probe_splits_match_jax(tmp_path):
    """A probe set's JSONL and npz splits ([N, H, W] uint8, grey) load as
    JAX's, an npz row decodes to RGB, a class tree too; an unknown name is
    a KeyError, a missing split a FileNotFoundError."""
    import xfm_tpu.data.probe_datasets as jpd

    from xfm_tpu_torch.data import probe_datasets as pd
    from xfm_tpu_torch.data.transforms import decode_image

    assert pd.PROBE_DATASETS == {k: pd.ProbeSpec(**v.__dict__)
                                 for k, v in jpd.PROBE_DATASETS.items()}
    r = np.random.RandomState(0)
    root = str(tmp_path)
    np.savez(os.path.join(root, "train.npz"),
             images=r.randint(0, 256, (4, 12, 10), np.uint8),
             labels=np.array([0, 9, 3, 3]))
    _png_tree(os.path.join(root, "test"), n_classes=3, per_class=1)
    with open(os.path.join(root, "val.jsonl"), "w") as f:
        f.write(json.dumps({"image": "test/class1/0.png", "label": 7}) + "\n")
    for split in ("train", "val", "test"):
        got, n = pd.load_probe_split("cifar10", root, split)
        want, jn = jpd.load_probe_split("cifar10", root, split)
        assert n == jn == 10 and len(got) == len(want)
        for (a, la), (b, lb) in zip(got, want):
            assert la == lb
            assert np.array_equal(a, b) if isinstance(a, np.ndarray) \
                else a == b
    img = decode_image(pd.load_probe_split("cifar10", root,
                                           "train")[0][0][0])
    assert img.mode == "RGB" and img.size == (10, 12)
    assert decode_image(np.zeros((5, 6, 1), np.uint8)).size == (6, 5)
    with pytest.raises(KeyError):
        pd.load_probe_split("imagenet22k", root, "train")
    with pytest.raises(FileNotFoundError):
        pd.load_probe_split("cifar10", root, "holdout")


def test_evaluate_matches_jax(corpus, jax_k1_interpret):  # noqa: F811
    """`evaluate`'s top-1 on the same weights (perturbed, so that the
    classes differ) over 10 PNGs in batches of 4 (the last partial) equals
    JAX `evaluate`'s."""
    from xfm_tpu.data.timm_aug import ImagenetEvalTransform as JEval
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.models.task_models import XFMForClassification as JCls

    from xfm_tpu_torch.data.timm_aug import ImagenetEvalTransform
    from xfm_tpu_torch.models import XFMForClassification, config_from_yaml
    from xfm_tpu_torch.train.checkpoint import state_dict_from_jax

    cfg = small_yaml("image")
    jcfg = jconfig_from_yaml(cfg)
    jm = JCls(jcfg, num_labels=5, task_name="imagenet")
    params = jm.init({"params": jax.random.PRNGKey(3)},
                     images=jnp.zeros((2, 32, 32, 3)),
                     method=JCls.init_all)["params"]
    r = np.random.RandomState(2)
    params = jax.tree.map(lambda x: np.asarray(
        np.asarray(x) + 0.5 * r.randn(*np.shape(x)), np.float32), params)
    model = XFMForClassification(config_from_yaml(cfg), num_labels=5,
                                 task_name="imagenet")
    model.load_state_dict(state_dict_from_jax(params, jcfg), strict=True)
    rows, _ = im.load_manifest(corpus["val"])
    got = im.evaluate(model, rows, ImagenetEvalTransform(32), None, 4)
    want = jim.evaluate(jm, params, rows, JEval(32), None, 4)
    assert got == want and 0 < got["acc1"] < 1


def _task_yaml(corpus, tmp_path, lp: bool, **keys):
    cfg = configs.imagenet_yaml(
        lp=lp, layers=2, **dict(SMALL, batch_size=4,
                                train_root=corpus["train"],
                                val_root=corpus["val"], warmup_epochs=1,
                                schedular={"sched": "cosine", "lr": 1e-3,
                                           "epochs": 2}, **keys))
    path = tmp_path / f"imagenet_{lp}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def test_run_imagenet_finetune_and_evaluate(corpus, tmp_path):
    """`run.py --task imagenet` on the CPU: 2 epochs of 2 steps on 10 PNGs
    of 5 classes (mixup / cutmix soft targets, HF-AdamW on the half-cosine
    schedule), the top-1 each epoch, ckpt/<epoch> where it improved; then
    `--evaluate --checkpoint` from the best one gives its top-1; a `--bs`
    of 2 halves the batch (4 steps an epoch)."""
    from xfm_tpu_torch import run

    path = _task_yaml(corpus, tmp_path, lp=False)
    out = str(tmp_path / "ft")
    res = run.main(["--task", "imagenet", "--config", path, "--device",
                    "cpu", "--output_dir", out, "--seed", "1"])
    log = _log(out)
    assert [e["epoch"] for e in log] == [0, 1]
    assert all(np.isfinite(e["loss"]) and 0 <= e["acc1"] <= 1 for e in log)
    best = max(e["acc1"] for e in log)
    assert res == {"best_acc1": best}
    saved = sorted(os.listdir(os.path.join(out, "ckpt")))
    first_best = [e["epoch"] for e in log if e["acc1"] == best][0]
    assert saved[-1] == str(first_best)
    ckpt = os.path.join(out, "ckpt", saved[-1], "state.pt")
    ev = run.main(["--task", "imagenet", "--config", path, "--device", "cpu",
                   "--output_dir", out + "_ev", "--evaluate", "--checkpoint",
                   ckpt])
    assert ev == {"acc1": best}
    state = torch.load(ckpt, weights_only=True)
    assert set(state["optimizer"]) == {"mu", "nu", "count"}
    assert state["optimizer"]["count"] == 2 * (first_best + 1)
    run.main(["--task", "imagenet", "--config", path, "--device", "cpu",
              "--output_dir", out + "_bs", "--bs", "2", "--epoch", "1"])
    with open(os.path.join(out + "_bs", "config.yaml")) as f:
        assert yaml.safe_load(f)["batch_size"] == 2
    assert len(_log(out + "_bs")) == 1


def test_run_imagenet_linear_probe_freezes_the_tower(corpus, tmp_path):
    """`is_lp` with `opt: lars`: the head alone trains (LARS momenta for
    `cls_head.*` alone, its count the steps taken), the tower's parameters
    bit-equal to the seed's init after 2 epochs, hard CE (no mixup); a
    weight decay above 0 leaves the tower as it is too."""
    from xfm_tpu_torch import run
    from xfm_tpu_torch.models import XFMForClassification, config_from_yaml
    from xfm_tpu_torch.train.checkpoint import init_weights

    for wd in (0.0, 0.1):
        path = _task_yaml(corpus, tmp_path, lp=True,
                          optimizer={"opt": "lars", "lr": 0.4,
                                     "weight_decay": wd})
        out = str(tmp_path / f"lp{wd}")
        run.main(["--task", "imagenet", "--config", path, "--device", "cpu",
                  "--output_dir", out, "--seed", "5"])
        log = _log(out)
        assert all(np.isfinite(e["loss"]) for e in log)
        ckpt_dir = os.path.join(out, "ckpt")
        step = sorted(os.listdir(ckpt_dir))[-1]
        state = torch.load(os.path.join(ckpt_dir, step, "state.pt"),
                           weights_only=True)
        assert set(state["optimizer"]) == {"mu", "count"}
        assert set(state["optimizer"]["mu"]) == {
            k for k in state["params"] if k.startswith("cls_head.")}
        assert state["optimizer"]["count"] == 2 * (int(step) + 1)
        init = XFMForClassification(
            config_from_yaml(yaml.safe_load(open(path))), num_labels=5,
            task_name="imagenet", is_lp=True)
        init_weights(init, 5)
        moved = []
        for k, v in init.state_dict().items():
            same = torch.equal(v, state["params"][k])
            assert same or k.startswith("cls_head."), k
            moved += [k] if not same else []
        assert moved


def test_run_imagenet_refuses_what_is_not_ported(corpus, tmp_path):
    from xfm_tpu_torch import run

    for keys in (dict(parallel={"pipe": 2}), dict(mixup_mode="pair")):
        path = _task_yaml(corpus, tmp_path, lp=False, **keys)
        with pytest.raises(NotImplementedError):
            run.main(["--task", "imagenet", "--config", path, "--device",
                      "cpu", "--output_dir", str(tmp_path / "x")])


def test_default_yamls_and_model(monkeypatch, tmp_path):
    """With no `--config` (or one naming no file) `imagenet` takes
    configs/<--model>/imagenet1k.yaml, `xfm-ft` by default, as the
    repository's `run.py`; a model with no such file exits. The configs'
    dicts are the shipped YAMLs."""
    from xfm_tpu_torch import run

    seen = []
    monkeypatch.setattr(im, "main", lambda args: seen.append(args.config))
    for extra in ([], ["--config", str(tmp_path / "missing.yaml")],
                  ["--model", "xfm-ft"]):
        run.main(["--task", "imagenet", "--output_dir", str(tmp_path)]
                 + extra)
    ft = os.path.join(REPO, "configs", "xfm-ft")
    assert seen == [os.path.join(ft, "imagenet1k.yaml")] * 3
    with pytest.raises(SystemExit):
        run.main(["--task", "imagenet", "--model", "xfm-nope",
                  "--output_dir", str(tmp_path)])
    for name, want in (("imagenet1k", configs.IMAGENET),
                       ("imagenet1k_lp", configs.IMAGENET_LP)):
        with open(os.path.join(ft, f"{name}.yaml")) as f:
            assert yaml.safe_load(f) == want


def test_step_flops_count_the_head():
    """`imagenet_step_flops` counts the tower and the 48.7 M-parameter
    `DeepMLPHead` (its matmul weights, 2 FLOPs each a row); the probe's
    step runs the tower forward alone."""
    from xfm_tpu_torch.models import DeepMLPHead

    head = DeepMLPHead(1536, 1000, torch.float32)
    weights = sum(m.weight.numel() for m in head
                  if isinstance(m, torch.nn.Linear))
    assert configs.deep_head_flops(1) == 2 * weights
    assert abs(weights - 48.7e6) < 0.1e6
    ft = configs.imagenet_step_flops(128, 196)
    lp = configs.imagenet_step_flops(128, 196, lp=True)
    tower = configs._transformer_flops(12, 768, 3072, 197, 128)
    assert ft - lp == 2 * tower
