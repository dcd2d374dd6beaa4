"""The generic classifier in the port (`xfm_tpu_torch/tasks/classify.py`)
against the JAX package (`xfm_tpu/tasks/classify.py`): the rows and the
packed batches (text, image, both; one tokenizer instance and the same
transform on both sides), the branch each kind of row picks, the fallback
tokenizer over the rows' texts (Queue 3B: the JAX task builds it over no
text); then `python3 -m xfm_tpu_torch.run --task classify --device cpu`
end to end on image + text rows, on text rows with `use_text_classifier`
and on image rows, `--evaluate`, and the missing `--config`."""
import json
import os

import numpy as np
import pytest
import yaml
from PIL import Image

import xfm_tpu.tasks.classify as jcls
from test_torch_classification import SMALL
from xfm_tpu_torch import configs
from xfm_tpu_torch.tasks import classify
from _torch_threads import one_intra_op_thread  # noqa: F401

WORDS = "a red car a blue dog runs on the grass near two birds".split()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 + 4 rows of a PNG, a sentence and a label of 3; the same rows
    without images, and without texts."""
    root = tmp_path_factory.mktemp("classify")
    r = np.random.RandomState(0)
    (root / "img").mkdir()
    out = {"image_root": str(root / "img")}
    for split, n in (("train", 8), ("val", 4)):
        rows = []
        for i in range(n):
            name = f"{split}{i}.png"
            h, w = r.randint(30, 50, 2)
            Image.fromarray(r.randint(0, 256, (h, w, 3), np.uint8)).save(
                root / "img" / name)
            rows.append({"image": name, "label": int(r.randint(3)),
                         "text": " ".join(r.choice(WORDS,
                                                   r.randint(3, 9)))})
        for kind, drop in (("both", ()), ("text", ("image",)),
                           ("image", ("text",))):
            path = root / f"{split}_{kind}.jsonl"
            path.write_text("".join(json.dumps(
                {k: v for k, v in row.items() if k not in drop}) + "\n"
                for row in rows))
            out[split, kind] = str(path)
    return out


@pytest.mark.parametrize("kind", ["both", "text", "image"])
def test_rows_and_batches_match_jax(corpus, kind):
    """`load_rows` and the batches (shuffled and drop-last; in order with
    the last partial) equal JAX's."""
    from xfm_tpu_torch.data.tokenization import SimpleTokenizer
    from xfm_tpu_torch.data.transforms import TestTransform

    rows = classify.load_rows(corpus["train", kind])
    assert rows == jcls.load_rows(corpus["train", kind])
    tok = SimpleTokenizer.from_texts(WORDS)
    tf = TestTransform(24)
    for kw in (dict(seed=2), dict(shuffle=False, drop_last=False)):
        got = list(classify.batches(rows, tok, tf, corpus["image_root"], 10,
                                    3, **kw))
        want = list(jcls.batches(rows, tok, tf, corpus["image_root"], 10,
                                 3, **kw))
        assert len(got) == len(want) == (2 if "seed" in kw else 3)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in g:
                assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype
                assert np.array_equal(g[k], w[k]), k


def _cfg(corpus, kind, **keys):
    cfg = configs.glue_yaml(layers=2, **SMALL)
    cfg.update(image_res=32, vision_depth=2, fusion_num_hidden_layers=2,
               num_labels=3, train_file=corpus["train", kind],
               val_file=corpus["val", kind],
               image_root=corpus["image_root"], batch_size=4, max_tokens=12,
               schedular={"sched": "linear", "lr": 1e-4, "epochs": 2},
               optimizer={"opt": "adamW", "lr": 1e-4, "weight_decay": 0.01})
    cfg.update(keys)
    return cfg


@pytest.mark.parametrize("kind,keys,want", [
    ("both", {}, ("fused", "MLPHead")),
    ("image", {}, ("imagenet", "DeepMLPHead")),
    ("text", {}, ("glue", "MLPHead")),
    ("text", {"use_text_classifier": True}, (None, "MLPHead"))])
def test_the_rows_pick_the_branch(corpus, kind, keys, want):
    """Image + text rows build the fused classifier, image rows the image
    branch, text rows the text branch, `use_text_classifier` the
    `TextClassifier` (text encoder and head alone); the fallback tokenizer
    holds every word of the rows, where the JAX task's holds the specials
    alone."""
    from xfm_tpu.tasks.retrieval import build_tokenizer_or_fallback as jbuild

    from xfm_tpu_torch.tasks.retrieval import build_tokenizer_or_fallback

    cfg = _cfg(corpus, kind, **keys)
    rows = classify.load_rows(cfg["train_file"])
    tok = build_tokenizer_or_fallback(cfg, lambda: [r["text"] for r in rows
                                                    if "text" in r])
    model, has_img = classify.build_model(cfg, tok, rows)
    assert getattr(model, "task_name", None) == want[0]
    assert type(model.cls_head).__name__ == want[1]
    assert has_img == (want[0] in ("fused", "imagenet"))
    if kind == "text":
        assert jbuild(cfg).vocab_size == 5  # the specials alone
        words = {w for r in rows for w in r["text"].split()}
        assert words <= set(tok.get_vocab())


@pytest.mark.parametrize("kind,keys", [("both", {}), ("image", {}),
                                       ("text", {"use_text_classifier":
                                                 True})])
def test_run_classify(corpus, kind, keys, tmp_path):
    """`run.py --task classify` on the CPU: 2 epochs of 2 steps, the
    accuracy on the val rows each epoch (in [0, 1], the best returned);
    `--evaluate` alone gives an accuracy."""
    from xfm_tpu_torch import run

    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(_cfg(corpus, kind, **keys)))
    out = str(tmp_path / "out")
    res = run.main(["--task", "classify", "--config", str(path), "--device",
                    "cpu", "--output_dir", out])
    with open(os.path.join(out, "log.txt")) as f:
        log = [json.loads(line) for line in f]
    assert [e["epoch"] for e in log] == [0, 1]
    assert all(np.isfinite(e["loss"]) and 0 <= e["acc"] <= 1 for e in log)
    assert res == {"best_acc": max(e["acc"] for e in log)}
    ev = run.main(["--task", "classify", "--config", str(path), "--device",
                   "cpu", "--output_dir", out + "_ev", "--evaluate"])
    assert 0 <= ev["acc"] <= 1


def test_classify_needs_a_config_and_no_pipe(corpus, tmp_path):
    """`classify` has no default YAML: a missing `--config` exits, as the
    repository's `run.py`; `parallel.pipe > 1` is not ported."""
    from xfm_tpu_torch import run

    for extra in ([], ["--config", str(tmp_path / "missing.yaml")]):
        with pytest.raises(SystemExit):
            run.main(["--task", "classify", "--output_dir", str(tmp_path)]
                     + extra)
    path = tmp_path / "pipe.yaml"
    path.write_text(yaml.safe_dump(_cfg(corpus, "text",
                                        parallel={"pipe": 2})))
    with pytest.raises(NotImplementedError):
        run.main(["--task", "classify", "--config", str(path), "--device",
                  "cpu", "--output_dir", str(tmp_path / "o")])
