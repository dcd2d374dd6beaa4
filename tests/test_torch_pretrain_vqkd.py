"""The pretrain task (`python3 -m xfm_tpu_torch.run --task pretrain_DIY`)
with every optional branch on: the frozen VQ-KD tokenizer's code ids as
MIM's targets, region attention in the last block, bf16 parameters with
f32 masters and the redispatch probe, over all six streams (the `web` and
`aux` streams among them, which the shipped YAMLs leave out), on the CPU
at a tiny size: finite losses where each stream's flags ask, the
checkpoint's bf16 parameters and f32 masters, the resume bit for bit, and
the code ids each stream receives.
"""
import math
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_pretrain_data import write_corpus
from test_torch_pretrain_task import TINY_TOKENIZER, _run, _task_config
from xfm_tpu_torch.models.task_models import LOSS_KEYS
from xfm_tpu_torch.tasks import pretrain
from xfm_tpu_torch.train.checkpoint import _load


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(tmp_path):
    files = write_corpus(str(tmp_path / "data"))
    cfg = _task_config(
        files, train_file_web=files["pairs"], train_file_aux=files["pairs"],
        wweb=0.5, waux=0.5, vision_depth=2, local_attn_depth=1,
        use_vision_tokenizer=True, bf16_params=True, bench_redispatch=2,
        **TINY_TOKENIZER)
    cfg["images"]["aux_caption_key"] = "desc"  # the aux stream's captions
    return cfg


ON = {"image": ("itc", "itm", "mlm", "mim"), "web": ("itc", "itm", "mlm",
                                                    "mim"),
      "aux": ("mlm",), "region": ("itc", "itm", "mlm", "bbox", "giou"),
      "imagenet": ("mim",), "text": ("mlm",)}


def test_every_new_key_runs_saves_and_resumes(tmp_path, monkeypatch, capsys,
                                              one_thread):
    cfg = _config(tmp_path)
    stats = _run(tmp_path, cfg, "out")
    for name, on in ON.items():
        for k in LOSS_KEYS:
            v = stats[f"{name}_{k}"]
            assert math.isfinite(v) and (v != 0.0) == (k[5:] in on), \
                (name, k, v)
    # MIM's CE over K = 16 codes from random weights: unit-variance logits
    # (lecun-normal head over LayerNorm rows) give ln K + 1/2
    for name in ("image", "web", "imagenet"):
        assert abs(stats[f"{name}_loss_mim"] - math.log(16) - 0.5) < 1.0
    assert stats["redispatch_samples_per_sec"] > 0
    assert "### redispatch" in capsys.readouterr().out
    out = tmp_path / "out"
    assert sorted(os.listdir(out / "ckpt")) == ["2", "3"]
    saved = _load(str(out / "ckpt"), 3, "cpu")
    assert all(p.dtype == torch.bfloat16 for p in saved["params"].values())
    masters = saved["optimizer"]["master"]
    assert set(masters) == set(saved["params"])
    for n, m in masters.items():
        assert m.dtype == torch.float32
        assert torch.equal(m.to(torch.bfloat16), saved["params"][n]), n
    assert "lm_head.weight" in masters and any(
        "rel_pos_bias" not in n for n in masters)

    shutil.rmtree(out / "ckpt" / "3")
    restored = {}
    real = pretrain.restore_latest

    def record(ctx, state):
        state, step = real(ctx, state)
        opt = state.optimizer
        restored.update(step=step, state=opt.state_dict(),
                        params={n: p.detach().clone() for n, p in
                                zip(opt.names, opt.params)})
        restored["state"] = {
            "master": {n: t.clone() for n, t in
                       restored["state"]["master"].items()},
            "mu": {n: t.clone() for n, t in
                   restored["state"]["inner"]["mu"].items()},
            "count": restored["state"]["inner"]["count"]}
        return state, step

    monkeypatch.setattr(pretrain, "restore_latest", record)
    _run(tmp_path, dict(cfg, resume=True), "out")
    want = _load(str(out / "ckpt"), 2, "cpu")
    assert restored["step"] == 2 and restored["state"]["count"] == 2
    for n, p in restored["params"].items():
        assert torch.equal(p, want["params"][n]), n
    for n, m in restored["state"]["master"].items():
        assert torch.equal(m, want["optimizer"]["master"][n]), n
    for n, m in restored["state"]["mu"].items():
        assert torch.equal(m, want["optimizer"]["inner"]["mu"][n]), n


def test_code_ids_reach_the_streams_with_mim(tmp_path, monkeypatch,
                                            one_thread):
    """Each stream with MIM on and images (image, web, ImageNet) gets the
    frozen tokenizer's ids of its unmasked images, [B, patches]; the
    region, aux and text streams get none."""
    from xfm_tpu_torch.models import XFMForPretrain

    seen = {}
    tokenizers = []
    real_loss, real_tok = XFMForPretrain.loss, pretrain.frozen_tokenizer

    def loss(self, **kw):
        ids = kw.get("vqkd_code_ids")
        seen.setdefault(kw.get("data_source") or "text", []).append(
            (ids, kw.get("images")))
        return real_loss(self, **kw)

    def frozen(cfg, device):
        vq, fn = real_tok(cfg, device)
        tokenizers.append(vq)
        return vq, fn

    monkeypatch.setattr(XFMForPretrain, "loss", loss)
    monkeypatch.setattr(pretrain, "frozen_tokenizer", frozen)
    cfg = dict(_config(tmp_path), max_steps=1, ckpt_frequent_step=1,
               bench_redispatch=0)
    _run(tmp_path, cfg, "out")
    assert set(seen) == set(ON)
    (vq,) = tokenizers
    for name, calls in seen.items():
        ids, images = calls[0]
        if name in ("image", "web", "imagenet"):
            assert ids.shape == (images.shape[0], 4)
            assert torch.equal(ids, vq.get_codebook_indices(images))
        else:
            assert ids is None, name
