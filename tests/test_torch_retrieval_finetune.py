"""The retrieval fine-tune as a whole (`python3 -m xfm_tpu_torch.run --task
itr_coco` without `--evaluate`, on the CPU) against the JAX package's
`xfm_tpu.tasks.retrieval.main`, on one tiny YAML: width 64, 2 + 2 + 2
layers, 384 px (N = 577, so the port's BEiT attention takes K2's
dispatch), f32, 12 PNGs of 2 captions each, batch 8 (3 steps an epoch), 2
epochs.

Both start from the same checkpoint, which the JAX package exports from a
seeded, perturbed init, with the dropout rates and drop-path at 0. On both
sides the train transform is replaced by the same deterministic one (the
test transform's resize) and the hard-negative draw by the same fixed rule
(each row's negative is the next row of another image). Nothing in
`xfm_tpu/` changes for it.

Equal: the zero-shot metrics, each epoch's R@K and `best_r_mean`; each
epoch's logged `loss_itc` and `loss_itm` at rtol 1e-4 (f32 on both sides,
the JAX batch split over 8 CPU devices). Then on the port alone: with the
YAML's dropouts and drop-path live the run trains and writes `ckpt/` (the
two newest epochs) and `ckpt_best/` (one); deleting `ckpt/1` and running
again with `resume: true` starts at epoch 1 and ends bit-equal to the
uninterrupted run (the CPU is deterministic on one thread: with several,
its reductions may split differently from run to run, and two runs differ
in the last bits).
"""
import json
import os
import shutil
import types

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from test_torch_retrieval_eval import YCFG, _jax_params
from _torch_threads import one_intra_op_thread  # noqa: F401

RES, BS, EPOCHS = 384, 8, 2


def _corpus(root):
    """12 PNGs of mixed sizes, 2 captions each: the train file holds one
    annotation a caption (with its image_id), the test file one an
    image."""
    from PIL import Image

    rng = np.random.default_rng(0)
    words = ["a", "photo", "of", "the", "red", "blue", "dog", "cat", "on",
             "grass", "with", "sky"]
    train, test = [], []
    for i in range(12):
        arr = rng.integers(0, 255, (40 + 3 * i, 56 - 2 * i, 3),
                           dtype=np.uint8)
        Image.fromarray(arr).save(root / f"img{i}.png")
        caps = [" ".join(rng.choice(words, 3 + (i + j) % 7))
                + f" number {i}." for j in range(2)]
        test.append({"image": f"img{i}.png", "caption": caps})
        train += [{"image": f"img{i}.png", "caption": c, "image_id": i}
                  for c in caps]
    (root / "train.json").write_text(json.dumps(train))
    (root / "test.json").write_text(json.dumps(test))
    return str(root / "train.json"), str(root / "test.json")


def _yaml(root, train, test, **keys):
    cfg = {k: v for k, v in YCFG.items() if k not in ("val_file", "_vision")}
    cfg.update(train_file=[train], test_file=test, image_root=str(root),
               batch_size_train=BS, batch_size_test=6, k_test=12,
               optimizer={"opt": "adamW", "lr": 1e-3, "weight_decay": 0.01,
                          "lr_mult": 2},
               schedular={"sched": "linear", "lr": 1e-3, "epochs": EPOCHS,
                          "num_warmup_steps": 0.1}, **keys)
    path = root / f"ret{len(list(root.glob('ret*.yaml')))}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


NO_DROPOUT = dict(drop_path_rate=0.0, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)


def _next_other_image(n, idx, xp):
    """Each row's negative: the nearest following row (cyclically) of
    another image, for both directions."""
    i = xp.arange(n)[:, None]
    j = xp.arange(n)[None, :]
    same = idx.reshape(-1, 1) == idx.reshape(1, -1)
    score = xp.where(same, -1, n - (j - i) % n)
    neg = xp.argmax(score, 1)
    return neg, neg


def _jax_negatives(rng, image_feat, text_feat, temp, idx=None):
    return _next_other_image(image_feat.shape[0], idx, jnp)


def _port_negatives(generator, image_feat, text_feat, temp, idx=None):
    return _next_other_image(image_feat.shape[0], idx, torch)


def _run_port(cfg_path, out, ckpt, monkeypatch):
    from xfm_tpu_torch import run
    from xfm_tpu_torch.data.transforms import TestTransform
    from xfm_tpu_torch.models import losses
    from xfm_tpu_torch.tasks import retrieval

    class Fixed(TestTransform):
        def reseed(self, seed):
            pass

    monkeypatch.setattr(retrieval, "TrainTransform", Fixed)
    monkeypatch.setattr(losses, "hard_negative_indices", _port_negatives)
    argv = ["--task", "itr_coco", "--config", cfg_path, "--output_dir",
            str(out), "--device", "cpu", "--seed", "0"]
    return run.main(argv + (["--checkpoint", str(ckpt)] if ckpt else []))


def _log(out):
    return [json.loads(line)
            for line in (out / "log.txt").read_text().splitlines()]


def _check_layout(out, log):
    """ckpt/ holds the two newest epochs; ckpt_best/ the last epoch whose
    R_mean beat every earlier eval's (the zero-shot's included), or is
    absent where none did."""
    assert sorted(os.listdir(out / "ckpt")) == ["0", "1"]
    assert os.listdir(out / "ckpt" / "1") == ["state.pt"]
    best, best_epoch = log[0]["r_mean"], None
    for e in log[1:]:
        if e["r_mean"] > best:
            best, best_epoch = e["r_mean"], e["epoch"]
    if best_epoch is None:
        assert not (out / "ckpt_best").exists()
    else:
        assert os.listdir(out / "ckpt_best") == [str(best_epoch)]
    return best_epoch


R_KEYS = ("txt_r1", "txt_r5", "txt_r10", "img_r1", "img_r5", "img_r10",
          "txt_r_mean", "img_r_mean", "r_mean")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("ft")
    train, test = _corpus(root)
    return types.SimpleNamespace(root=root, train=train, test=test)


def test_finetune_matches_jax(corpus, monkeypatch):
    import xfm_tpu.models.losses as jlosses
    from xfm_tpu.data.transforms import TestTransform as JTest
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.models.task_models import XFMForRetrieval as JRetrieval
    from xfm_tpu.tasks import retrieval as jret
    from xfm_tpu.train.checkpoint import (export_xfm_checkpoint,
                                          save_torch_checkpoint)

    root = corpus.root
    cfg_path = _yaml(root, corpus.train, corpus.test, **NO_DROPOUT)
    ycfg = yaml.safe_load(open(cfg_path))
    tok = jret.build_tokenizer_or_fallback(
        ycfg, lambda: jret._ann_texts(ycfg["train_file"]))
    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    jcfg = jret._maybe_shrink_vocab(jconfig_from_yaml(
        ycfg, use_contrastive_loss=True, use_matching_loss=True), tok)
    assert jcfg.vision.drop_path_rate == 0.0
    ckpt = root / "start.th"
    save_torch_checkpoint(str(ckpt), export_xfm_checkpoint(
        _jax_params(JRetrieval(jcfg), RES, 3), jcfg))

    monkeypatch.setattr(jret, "TrainTransform", lambda res: JTest(res))
    monkeypatch.setattr(jlosses, "hard_negative_indices", _jax_negatives)
    want = jret.main(types.SimpleNamespace(
        config=cfg_path, output_dir=str(root / "jax"), checkpoint=str(ckpt),
        evaluate=False, bs=None, epoch=None, seed=0))
    got = _run_port(cfg_path, root / "port", ckpt, monkeypatch)

    jlog, log = _log(root / "jax"), _log(root / "port")
    assert [e["epoch"] for e in log] == [-1, 0, 1] == \
        [e["epoch"] for e in jlog]
    for w, g in zip(jlog, log):
        for k in R_KEYS:
            assert g[k] == w[k], (g["epoch"], k)
        if g["epoch"] >= 0:
            for k in ("loss_itc", "loss_itm"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                           err_msg=f"{g['epoch']} {k}")
            assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
    assert got["best_r_mean"] == want["best_r_mean"]
    assert _check_layout(root / "port", log) is not None
    # the training moved the losses
    assert abs(log[2]["loss_itc"] - log[1]["loss_itc"]) > 1e-3


def _state(out, epoch):
    return torch.load(os.path.join(out, "ckpt", str(epoch), "state.pt"),
                      weights_only=True)


def test_finetune_dropout_live_and_resume_bit_equal(corpus, monkeypatch,
                                                    one_thread):
    """The YAML's dropouts and drop-path at 0.1 (the recipes'): the run
    trains and writes its checkpoints; a resume after deleting ckpt/1
    starts at epoch 1 and ends bit-equal to the uninterrupted run."""
    root = corpus.root
    cfg_path = _yaml(root, corpus.train, corpus.test, resume=True,
                     drop_path_rate=0.1, hidden_dropout_prob=0.1,
                     attention_probs_dropout_prob=0.1)
    full = root / "live"
    _run_port(cfg_path, full, None, monkeypatch)
    log = _log(full)
    assert [e["epoch"] for e in log] == [-1, 0, 1]
    assert all(np.isfinite(e[k]) for e in log[1:]
               for k in ("loss", "loss_itc", "loss_itm", "grad_norm"))
    _check_layout(full, log)
    saved = _state(full, 1)
    assert saved["step"] == 2 * (24 // BS) == saved["optimizer"]["count"]

    resumed = root / "resumed"
    shutil.copytree(full, resumed)
    shutil.rmtree(resumed / "ckpt" / "1")
    (resumed / "log.txt").unlink()
    _run_port(cfg_path, resumed, None, monkeypatch)
    rlog = _log(resumed)
    # the zero-shot eval of the restored epoch-0 state, then epoch 1 only
    assert [e["epoch"] for e in rlog] == [-1, 1]
    assert rlog[0]["r_mean"] == log[1]["r_mean"]
    assert rlog[1] == log[2]
    again = _state(resumed, 1)
    assert again["step"] == saved["step"]
    for name, t in saved["params"].items():
        assert torch.equal(again["params"][name], t), name
    for key in ("mu", "nu"):
        for name, t in saved["optimizer"][key].items():
            assert torch.equal(again["optimizer"][key][name], t), name
