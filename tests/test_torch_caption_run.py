"""`python3 -m xfm_tpu_torch.run --task coco_captioning` and `--task
infer_caption` on the CPU (`tasks/captioning.py`), on a tiny YAML (width
32, 2 BEiT blocks and 2 decoder layers, 32 px, f32, the SimpleTokenizer
fallback) over synthetic PNGs and Karpathy-style JSONs:

- the fine-tune (2 epochs of 5 steps, `resume: true`): its checkpoints,
  finite losses, the final beam-2 captions of the val images (one an
  image, the prompt stripped, none longer than `max_length`) and their
  metrics (SPICE None); the resume after deleting `ckpt/1` bit-equal to
  the uninterrupted run on one CPU thread; `--evaluate --checkpoint` from
  the run's own checkpoint giving the run's captions and metrics (its own
  decoder loaded);
- `scst: true` (both baselines), `domain_pretrain: true` on an image-text
  JSONL, `--load_ckpt_from`, `infer_caption`, and the default YAMLs.
"""
import base64
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from test_torch_caption_task import write_caption_corpus
from xfm_tpu_torch.configs import caption_yaml
from _torch_threads import one_intra_op_thread  # noqa: F401

C, V = 32, 100


def _yaml(root, paths, **keys):
    cfg = caption_yaml(
        image_res=32, layers=2, vision_embed_dim=C, vision_num_heads=2,
        text_hidden_size=C, text_num_attention_heads=2,
        text_intermediate_size=64, compute_dtype="float32",
        train_file=[paths["train"]], val_file=paths["val"],
        image_root=os.path.join(root, "images"), **{**dict(
            max_tokens=12, max_length=8, min_length=2, num_beams=2,
            batch_size_test=2, resume=True,
            optimizer={"opt": "adamW", "lr": 1e-3, "weight_decay": 0.01,
                       "lr_mult": 2},
            schedular={"sched": "linear", "lr": 1e-3, "epochs": 2,
                       "num_warmup_steps": 0.1}), **keys})
    path = os.path.join(root, f"cap{len(os.listdir(root))}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("caption_run"))
    return root, write_caption_corpus(root)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _result(out):
    with open(os.path.join(out, "result", "caption_result.json")) as f:
        return json.load(f)


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(x) for x in f.read().splitlines()]


def test_run_captioning_on_the_cpu(corpus, tmp_path, one_thread):
    from xfm_tpu_torch import run

    root, paths = corpus
    cfg = _yaml(root, paths)
    out = str(tmp_path / "out")
    argv = ["--task", "coco_captioning", "--config", cfg, "--output_dir",
            out, "--device", "cpu", "--bs", "4", "--seed", "3"]
    metrics = run.main(argv)
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["0", "1"]
    log = _log(out)
    assert [e["epoch"] for e in log if "loss" in e] == [0, 1]
    assert all(np.isfinite(e["loss"]) for e in log if "loss" in e)
    assert log[-1] == {"final": metrics}
    assert {"Bleu_1", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr"} <= set(metrics)
    assert metrics["SPICE"] is None
    rows = _result(out)
    assert [r["image_id"] for r in rows] == list(range(1010, 1015))
    # max_length 8 less the prompt's 3 forced tokens ("a picture of")
    assert all(len(r["caption"].split()) <= 8 - 3 for r in rows)
    final = torch.load(os.path.join(out, "ckpt", "1", "state.pt"),
                       weights_only=True)
    assert final["step"] == 10
    assert not any(k.startswith(("text_encoder.", "fusion_encoder."))
                   for k in final["params"])

    # the resume: ckpt/1 deleted, the run goes on at epoch 1
    shutil.rmtree(os.path.join(out, "ckpt", "1"))
    again = run.main(argv)
    resumed = torch.load(os.path.join(out, "ckpt", "1", "state.pt"),
                         weights_only=True)
    assert resumed["step"] == 10
    for n, p in final["params"].items():
        assert torch.equal(p, resumed["params"][n]), n
    assert again == metrics and _result(out) == rows

    # --evaluate from the run's own checkpoint: its decoder, its captions
    ev = str(tmp_path / "ev")
    got = run.main(["--task", "coco_captioning", "--config", cfg,
                    "--output_dir", ev, "--device", "cpu", "--evaluate",
                    "--checkpoint", os.path.join(out, "ckpt", "1",
                                                 "state.pt")])
    assert _result(ev) == rows and got == metrics


@pytest.mark.parametrize("baseline", ["greedy", "sample"])
def test_run_scst_on_the_cpu(corpus, tmp_path, baseline):
    """`scst: true` through `--load_ckpt_from`: SCST steps with 2 samples
    an image, finite losses and rewards, a checkpoint each epoch, then the
    captions and metrics."""
    from xfm_tpu_torch import run
    from xfm_tpu_torch.tasks import captioning

    root, paths = corpus
    cfg = _yaml(root, paths, scst=True, sc_train_sample_n=2,
                sc_baseline_type=baseline, sample_top_k=20,
                sample_top_p=0.9,
                schedular={"sched": "linear", "lr": 1e-3, "epochs": 1,
                           "num_warmup_steps": 0.1})
    out = str(tmp_path / "out")
    seen = []
    real = captioning.load_ckpt_into
    captioning.load_ckpt_into = lambda model, path, *a: seen.append(path)
    try:
        metrics = run.main(["--task", "coco_captioning", "--config", cfg,
                            "--output_dir", out, "--device", "cpu", "--bs",
                            "4", "--load_ckpt_from", "ckpt.pth"])
    finally:
        captioning.load_ckpt_into = real
    assert seen == ["ckpt.pth"]
    (e,) = [e for e in _log(out) if e.get("scst")]
    assert e["epoch"] == 0 and np.isfinite(e["loss"]) and e["reward"] >= 0
    assert os.listdir(os.path.join(out, "ckpt")) == ["0"]
    assert "CIDEr" in metrics and len(_result(out)) == 5


def _png_b64(r, h, w):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(r.randint(0, 255, (h, w, 3)).astype(np.uint8)).save(
        buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_run_domain_pretrain_on_the_cpu(corpus, tmp_path):
    """`domain_pretrain: true` (`Captioning_pretrain.yaml`'s keys) on a
    JSONL of base64 PNGs and captions: 3 steps, finite losses, the state
    saved at the end, the decoder started from a checkpoint's text
    encoder."""
    from xfm_tpu_torch import run
    from xfm_tpu_torch.tasks import captioning

    root, _ = corpus
    r = np.random.RandomState(0)
    jsonl = str(tmp_path / "pairs.jsonl")
    with open(jsonl, "w") as f:
        for i in range(10):
            f.write(json.dumps({"binary": _png_b64(r, 30 + i, 40),
                                "desc": "a dog on the street " * (i % 3 + 1)
                                }) + "\n")
    cfg = caption_yaml(
        pretrain=True, image_res=32, layers=2, vision_embed_dim=C,
        vision_num_heads=2, text_hidden_size=C, text_num_attention_heads=2,
        text_intermediate_size=64, compute_dtype="float32",
        train_file=[jsonl], max_steps=3, print_freq=1)
    path = str(tmp_path / "pt.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    seen = []
    real = captioning.load_ckpt_into
    captioning.load_ckpt_into = lambda model, p, decoder_from="fusion": \
        seen.append((p, decoder_from))
    out = str(tmp_path / "out")
    try:
        stats = run.main(["--task", "coco_captioning", "--config", path,
                          "--output_dir", out, "--device", "cpu", "--bs",
                          "4", "--checkpoint", "pre.pth"])
    finally:
        captioning.load_ckpt_into = real
    assert seen == [("pre.pth", "text")]
    assert np.isfinite(stats["loss"])
    assert os.listdir(os.path.join(out, "ckpt")) == ["3"]
    with open(os.path.join(out, "config.yaml")) as f:
        assert yaml.safe_load(f)["images"]["batch_size"] == 4


def test_run_infer_caption_on_the_cpu(corpus, tmp_path):
    from xfm_tpu_torch import run

    root, paths = corpus
    cfg = _yaml(root, paths, image_dir=os.path.join(root, "images"),
                num_beams=1, batch_size_test=4)
    out = str(tmp_path / "out")
    rows = run.main(["--task", "infer_caption", "--config", cfg,
                     "--output_dir", out, "--device", "cpu"])
    with open(os.path.join(out, "captions.json")) as f:
        assert json.load(f) == rows
    assert [r["image"] for r in rows] == sorted(os.listdir(
        os.path.join(root, "images")))
    assert all(isinstance(r["caption"], str) for r in rows)


def test_run_captioning_falls_back_to_the_default_config(monkeypatch,
                                                         tmp_path):
    from xfm_tpu_torch import configs, run
    from xfm_tpu_torch.tasks import captioning

    seen = []
    monkeypatch.setattr(captioning, "main_pipeline",
                        lambda args: seen.append(args.config))
    monkeypatch.setattr(captioning, "main_infer",
                        lambda args: seen.append(args.config))
    for task in ("coco_captioning", "infer_caption"):
        run.main(["--task", task, "--output_dir", str(tmp_path)])
    ft = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "configs", "xfm-ft")
    want = os.path.join(ft, "Captioning.yaml")
    assert seen == [want, want]
    with open(want) as f:
        assert configs.CAPTIONING == yaml.safe_load(f)
    with open(os.path.join(ft, "Captioning_pretrain.yaml")) as f:
        assert configs.CAPTIONING_PRETRAIN == yaml.safe_load(f)
