"""GLUE in the port (`xfm_tpu_torch/tasks/glue.py`, `eval/glue_metrics.py`)
against the JAX package (`xfm_tpu/tasks/glue.py`,
`xfm_tpu/eval/glue_metrics.py`): the metrics within 1e-12, the JSONL
examples, the tokenization (one SimpleTokenizer instance on both sides),
the batches, and `evaluate`'s metrics on the same weights (text width 64,
2 layers, f32); the `glue_datasets` route's errors; then `python3 -m
xfm_tpu_torch.run --task glue --device cpu` end to end (the fine-tune
with its checkpoints, `ckpt_best`, the resume bit-equal, `--evaluate`,
STS-B's regression, MNLI's mismatched split), `--bs` and the default
YAML."""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import xfm_tpu.eval.glue_metrics as jgm
import xfm_tpu.tasks.glue as jglue
from test_torch_classification import SMALL
from xfm_tpu_torch import configs
from xfm_tpu_torch.data.tokenization import SimpleTokenizer
from xfm_tpu_torch.eval import glue_metrics as gm
from xfm_tpu_torch.tasks import glue
from _torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ("the a cat dog sat on mat runs fast slow big small red blue "
         "is not here there").split()


@pytest.mark.parametrize("task", sorted(gm.TASK_METRICS))
def test_metrics_match_jax(task):
    """Every task's metrics, on labels and predictions with ties (and a
    constant prediction, where Pearson's r is 0 by definition)."""
    r = np.random.RandomState(len(task))
    if task == "stsb":
        labels = r.randint(0, 6, 40).astype(float)
        cases = [labels + r.randn(40), r.randint(0, 4, 40).astype(float),
                 np.full(40, 2.5)]
    else:
        n = 3 if task == "mnli" else 2
        labels = r.randint(0, n, 40)
        cases = [r.randint(0, n, 40), labels, np.zeros(40, int)]
    for preds in cases:
        got, want = gm.compute(task, preds, labels), jgm.compute(
            task, preds, labels)
        assert set(got) == set(want)
        for k in got:
            assert abs(got[k] - want[k]) <= 1e-12, (task, k)


def test_each_metric_matches_jax():
    r = np.random.RandomState(9)
    p, lab = r.randint(0, 2, 50), r.randint(0, 2, 50)
    x, y = r.randn(50), r.randn(50)
    x[::5] = x[0]  # ties
    for fn in ("accuracy", "f1", "matthews_corrcoef"):
        assert abs(getattr(gm, fn)(p, lab) - getattr(jgm, fn)(p, lab)) \
            <= 1e-12
    for fn in ("pearson", "spearman"):
        assert abs(getattr(gm, fn)(x, y) - getattr(jgm, fn)(x, y)) <= 1e-12


def _sent(r):
    return " ".join(r.choice(WORDS, r.randint(3, 10)))


def _write(path, rows):
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seeded JSONL splits: MRPC pairs (train 12, validation 6), STS-B
    scores, MNLI with a mismatched split, SST-2 single sentences."""
    root = tmp_path_factory.mktemp("glue")
    r = np.random.RandomState(0)
    out = {}
    for task, n_train, keys, label in (
            ("mrpc", 12, ("sentence1", "sentence2"), lambda: r.randint(2)),
            ("stsb", 8, ("sentence1", "sentence2"),
             lambda: float(np.round(r.uniform(0, 5), 2))),
            ("mnli", 8, ("premise", "hypothesis"), lambda: r.randint(3)),
            ("sst2", 8, ("sentence",), lambda: r.randint(2))):
        for split, n in (("train", n_train), ("validation", 6),
                         ("validation_mismatched", 4)):
            rows = [dict({k: _sent(r) for k in keys}, label=label())
                    for _ in range(n)]
            out[task, split] = _write(root / f"{task}_{split}.jsonl", rows)
    out["root"] = str(root)
    return out


def _cfg(corpus, task, **keys):
    files = {"train_file": corpus[task, "train"],
             "validation_file": corpus[task, "validation"]}
    if task == "mnli":
        files["validation_mismatched_file"] = corpus[
            task, "validation_mismatched"]
    return configs.glue_yaml(layers=2, **dict(dict(
        SMALL, task_name=task, max_length=16, per_device_train_batch_size=4,
        per_device_eval_batch_size=4, num_train_epochs=2, **files), **keys))


@pytest.mark.parametrize("task", ["mrpc", "stsb", "sst2"])
def test_examples_tokens_and_batches_match_jax(corpus, task):
    """The JSONL examples, the fallback tokenizer's ids of "a </s> b" (one
    instance on both sides), and the batches (shuffled, drop-last; and in
    order, the last partial) equal JAX's."""
    cfg = _cfg(corpus, task)
    for split in ("train", "validation"):
        assert glue.load_glue_examples(cfg, split) == \
            jglue.load_glue_examples(cfg, split)
    ex = glue.load_glue_examples(cfg, "train")
    tok = SimpleTokenizer.from_texts([a + " " + (b or "") for a, b, _ in ex])
    mine, theirs = glue.make_tokenize_fn(tok, 16), jglue.make_tokenize_fn(
        tok, 16)
    for kw in (dict(seed=3), dict(shuffle=False, drop_last=False)):
        got = list(glue.batches(ex, mine, 5, task == "stsb", **kw))
        want = list(jglue.batches(ex, theirs, 5, task == "stsb", **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for k in ("text_ids", "text_atts", "targets"):
                assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype
                assert np.array_equal(g[k], w[k]), k


def test_glue_datasets_route_names_the_jsonl_keys(corpus, tmp_path,
                                                  monkeypatch):
    """Without a JSONL file: a missing `glue_datasets/<task>` is a
    FileNotFoundError, and a present one without the `datasets` package an
    ImportError, each naming the YAML's JSONL key and the task's fields;
    nothing is downloaded (the JAX task would call `load_dataset`)."""
    cfg = dict(configs.GLUE_MRPC, glue_datasets=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="train_file.*sentence1"):
        glue.load_glue_examples(cfg, "train")
    (tmp_path / "mrpc").mkdir()
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="validation_file.*sentence2"):
        glue.load_glue_examples(cfg, "validation")


def test_glue_datasets_route_reads_a_saved_dataset(tmp_path):
    """Where `datasets` imports, `glue_datasets/<task>` is read with
    `load_from_disk`, MNLI's validation as validation_matched."""
    datasets = pytest.importorskip("datasets")
    d = datasets.DatasetDict({
        "train": datasets.Dataset.from_dict(
            {"premise": ["a b", "c"], "hypothesis": ["d", "e f"],
             "label": [0, 2]}),
        "validation_matched": datasets.Dataset.from_dict(
            {"premise": ["g"], "hypothesis": ["h"], "label": [1]})})
    d.save_to_disk(str(tmp_path / "mnli"))
    cfg = dict(configs.GLUE_MRPC, task_name="mnli",
               glue_datasets=str(tmp_path))
    assert glue.load_glue_examples(cfg, "train") == [("a b", "d", 0),
                                                     ("c", "e f", 2)]
    assert glue.load_glue_examples(cfg, "validation") == [("g", "h", 1)]


@pytest.mark.parametrize("task", ["mrpc", "stsb"])
def test_evaluate_matches_jax(corpus, task, monkeypatch):
    """`evaluate`'s metrics (MRPC's accuracy and F1; STS-B's Pearson and
    Spearman of the regressed scores) on the same weights and examples
    equal JAX `evaluate`'s."""
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.models.task_models import XFMForClassification as JCls

    from xfm_tpu_torch.models import XFMForClassification, config_from_yaml
    from xfm_tpu_torch.train.checkpoint import state_dict_from_jax

    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    cfg = _cfg(corpus, task)
    nl = glue.TASK_NUM_LABELS[task]
    ex = glue.load_glue_examples(cfg, "validation")
    tok = SimpleTokenizer.from_texts([a + " " + b for a, b, _ in ex])
    jcfg = jconfig_from_yaml(cfg)
    jm = JCls(jcfg, num_labels=nl, task_name="glue")
    params = jm.init({"params": jax.random.PRNGKey(1)},
                     text_ids=jnp.ones((2, 16), jnp.int32),
                     text_atts=jnp.ones((2, 16), jnp.int32),
                     method=JCls.init_all)["params"]
    r = np.random.RandomState(4)
    params = jax.tree.map(lambda x: np.asarray(
        np.asarray(x) + 0.3 * r.randn(*np.shape(x)), np.float32), params)
    model = XFMForClassification(config_from_yaml(cfg), num_labels=nl,
                                 task_name="glue")
    model.load_state_dict(state_dict_from_jax(params, jcfg), strict=True)
    got = glue.evaluate(model, ex, glue.make_tokenize_fn(tok, 16), task, 4)
    want = jglue.evaluate(None, jm, params, ex,
                          jglue.make_tokenize_fn(tok, 16), task, 4)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


def _run(args):
    from xfm_tpu_torch import run

    return run.main(args + ["--device", "cpu"])


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def test_run_glue_finetune_resume_and_evaluate(corpus, tmp_path):
    """`run.py --task glue` on the CPU (MRPC, 2 epochs of 3 steps, one
    thread): the metrics each epoch, ckpt/0 and ckpt/1, ckpt_best/ a hard
    link of the best epoch's file; with ckpt/1 deleted and `resume: true`
    the run restores ckpt/0 bit for bit and its epoch 1 repeats the first
    run's (loss and metrics); `--evaluate --checkpoint ckpt/1` gives the
    last epoch's metrics."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        path = tmp_path / "mrpc.yaml"
        path.write_text(yaml.safe_dump(_cfg(corpus, "mrpc", resume=True)))
        out = str(tmp_path / "out")
        first = _run(["--task", "glue", "--config", str(path),
                      "--output_dir", out])
        log = _log(out)
        assert [e["epoch"] for e in log] == [0, 1]
        assert set(first) == {"accuracy", "f1"}
        assert first == {k: log[-1][k] for k in first}
        ckpt = os.path.join(out, "ckpt")
        assert sorted(os.listdir(ckpt)) == ["0", "1"]
        best = os.listdir(os.path.join(out, "ckpt_best"))
        assert len(best) == 1 and os.path.samefile(
            os.path.join(out, "ckpt_best", best[0], "state.pt"),
            os.path.join(ckpt, best[0], "state.pt"))
        saved1 = torch.load(os.path.join(ckpt, "1", "state.pt"),
                            weights_only=True)
        shutil.rmtree(os.path.join(ckpt, "1"))
        again = _run(["--task", "glue", "--config", str(path),
                      "--output_dir", out])
        assert again == first
        resumed = _log(out)[-1]
        assert resumed["epoch"] == 1 and resumed["loss"] == log[1]["loss"]
        saved2 = torch.load(os.path.join(ckpt, "1", "state.pt"),
                            weights_only=True)
        for k, v in saved1["params"].items():
            assert torch.equal(v, saved2["params"][k]), k
        ev = _run(["--task", "glue", "--config", str(path), "--output_dir",
                   out + "_ev", "--evaluate", "--checkpoint",
                   os.path.join(ckpt, "1", "state.pt")])
        assert ev == first
    finally:
        torch.set_num_threads(threads)


def test_run_glue_stsb_and_mnli(corpus, tmp_path):
    """STS-B trains one output under the MSE and reports Pearson and
    Spearman; MNLI (3 labels) ends with the mismatched split's metrics."""
    for task, keys in (("stsb", {"pearson", "spearmanr"}),
                       ("mnli", {"accuracy", "mm_accuracy"})):
        path = tmp_path / f"{task}.yaml"
        path.write_text(yaml.safe_dump(_cfg(corpus, task,
                                            num_train_epochs=1)))
        out = str(tmp_path / task)
        res = _run(["--task", "glue", "--config", str(path), "--output_dir",
                    out])
        assert set(res) == keys and all(np.isfinite(v) for v in res.values())
        log = _log(out)
        assert np.isfinite(log[0]["loss"])
        if task == "mnli":
            assert log[-1] == {"mnli_mm": {"accuracy": res["mm_accuracy"]}}


def test_bs_sets_the_global_train_batch(corpus, tmp_path):
    """`--bs` divides over the processes into `per_device_train_batch_size`
    (the JAX task leaves it as it is)."""
    from xfm_tpu_torch.tasks.common import scale_batch

    cfg = dict(configs.GLUE_MRPC)
    scale_batch(cfg, 16, n_processes=4)
    assert cfg["per_device_train_batch_size"] == 4
    path = tmp_path / "mrpc.yaml"
    path.write_text(yaml.safe_dump(_cfg(corpus, "mrpc",
                                        num_train_epochs=1)))
    out = str(tmp_path / "bs")
    _run(["--task", "glue", "--config", str(path), "--output_dir", out,
          "--bs", "6"])
    with open(os.path.join(out, "config.yaml")) as f:
        assert yaml.safe_load(f)["per_device_train_batch_size"] == 6


def test_default_yaml(monkeypatch, tmp_path):
    """With no `--config` `glue` takes configs/xfm-ft/glue_mrpc.yaml, whose
    keys `configs.GLUE_MRPC` holds."""
    from xfm_tpu_torch import run

    seen = []
    monkeypatch.setattr(glue, "main", lambda args: seen.append(args.config))
    run.main(["--task", "glue", "--output_dir", str(tmp_path)])
    want = os.path.join(REPO, "configs", "xfm-ft", "glue_mrpc.yaml")
    assert seen == [want]
    with open(want) as f:
        assert yaml.safe_load(f) == configs.GLUE_MRPC
