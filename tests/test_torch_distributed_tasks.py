"""Data parallelism for NLVR2, grounding, ImageNet and its linear probe,
GLUE and classify on the CPU: two gloo processes against one process on
the global batch, the merged evals, mixup within a rank, the schedule's
horizon under W processes, and `refcoco_bbox` and `glue` under
`torch.distributed.run`.

The cases of `tests/_torch_mp_worker.py`'s `run_task_cases` run in this
process (one process, the global batch of 4) and in two worker processes
(each its 2 rows) on tiny models (2 layers a tower, width 64, 64 px,
f32): NLVR's and ImageNet's weights are the JAX package's initialization
(`state_dict_from_jax`); grounding, GLUE, STS-B and the fused classifier
take NLVR's towers and a seeded head, the probe ImageNet's weights.
Tolerances: losses rtol 1e-5; gradients rtol 1e-5 / atol 1e-6; the
parameters after one step rtol 1e-5 / atol 5e-5 (lr / 20), attention key
biases atol lr (as `tests/test_torch_distributed.py` holds them: Adam's
first step moves an element by about ±lr whatever the size of its
gradient, so a gradient that is zero in exact arithmetic turns its f32
rounding into up to a part of lr). The one-process losses of NLVR and
ImageNet against the JAX modules' on the same batch: rtol 1e-5. The
merged evals, on 5 rows in batches of 2 (3 rows on rank 0, 2 on rank 1),
equal one process's exactly; so do the evals of the two launches'
checkpoints.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import _torch_mp_worker as worker
from test_torch_distributed import WORKER, _env, _free_port, _torchrun2
from test_torch_grounding import _png
from xfm_tpu_torch.core import mesh
from _torch_threads import one_intra_op_thread  # noqa: F401

WORDS = ["the", "left", "image", "shows", "two", "dogs", "right", "one",
         "has", "more", "birds", "than", "a", "red", "car", "in"]


def _sentence(r, lo=3, hi=9):
    return " ".join(r.choice(WORDS, r.randint(lo, hi)))


def _eval_corpus(root, seed=0) -> dict:
    """5 PNGs and each eval's 5 rows over them."""
    r = np.random.RandomState(seed)
    names = [f"img{i}.png" for i in range(5)]
    sizes = [_png(os.path.join(root, n), r) for n in names]
    nlvr = [{"images": [names[i], names[(i + 2) % 5]],
             "label": ["True", "False"][i % 2], "sentence": _sentence(r)}
            for i in range(5)]
    ground = [{"image": names[i], "text": _sentence(r), "ref_id": i,
               "bbox": [4.0, 6.0, w / 2, h / 3]}
              for i, (w, h) in enumerate(sizes)]
    paths = {"root": root, "words": WORDS}
    for key, rows in (("nlvr", nlvr), ("grounding", ground)):
        paths[key] = os.path.join(root, f"{key}.json")
        with open(paths[key], "w") as f:
            json.dump(rows, f)
    paths["rows"] = [(n, i % worker.NL) for i, n in enumerate(names)]
    paths["cls_rows"] = [{"image": n, "text": _sentence(r), "label": i % 2}
                         for i, n in enumerate(names)]
    paths["glue"] = [(_sentence(r), _sentence(r), int(r.randint(2)))
                     for _ in range(5)]
    paths["stsb"] = [(a, b, float(r.uniform(0, 5)))
                     for a, b, _ in paths["glue"]]
    return paths


def _jax_init(name: str):
    """The JAX module of `name` ("nlvr" or "imagenet"), its config and its
    initialized params."""
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.models.task_models import XFMForClassification as JCls
    from xfm_tpu.models.task_models import XFMForNLVR as JNLVR

    jcfg = jconfig_from_yaml(worker.task_yaml(name))
    if name == "nlvr":
        jm, init = JNLVR(jcfg), JNLVR.init_all
        ex = dict(images=jnp.zeros((4, 64, 64, 3)),
                  text_ids=jnp.ones((2, 6), jnp.int32),
                  text_atts=jnp.ones((2, 6), jnp.int32))
    else:
        jm = JCls(jcfg, num_labels=worker.NL, task_name="imagenet")
        init, ex = JCls.init_all, dict(images=jnp.zeros((2, 64, 64, 3)))
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                     **ex, method=init)["params"])()
    return jm, jcfg, jax.tree.map(np.asarray, params)


def _state_dicts(jax_models) -> dict:
    """Every task model's weights: NLVR's and ImageNet's from the JAX
    package, the probe's ImageNet's, the others NLVR's towers over their
    own seeded heads."""
    from xfm_tpu_torch.train.checkpoint import (init_weights,
                                                state_dict_from_jax)

    sds = {n: state_dict_from_jax(jax_models[n][2], jax_models[n][1])
           for n in ("nlvr", "imagenet")}
    sds["probe"] = dict(sds["imagenet"])
    for name in ("grounding", "glue", "stsb", "classify"):
        model = worker.task_model(name)
        init_weights(model, 1)
        sd = model.state_dict()
        towers = [k for k in sd
                  if not k.startswith(("cls_head", "bbox_head"))]
        assert towers and all(k in sds["nlvr"] for k in towers), name
        sd.update({k: sds["nlvr"][k].clone() for k in towers})
        sds[name] = sd
    return sds


@pytest.fixture(scope="module")
def jax_models():
    return {n: _jax_init(n) for n in ("nlvr", "imagenet")}


@pytest.fixture(scope="module")
def runs(jax_models, tmp_path_factory):
    """The task cases on one process and on two: (spec, one, [rank 0,
    rank 1])."""
    d = tmp_path_factory.mktemp("dp_tasks")
    spec = dict(suite="tasks", state_dicts=_state_dicts(jax_models),
                batches=worker.make_task_batches(),
                data=_eval_corpus(str(d)))
    torch.save(spec, d / "spec.pt")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(d / "spec.pt"), str(d)],
        env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    one = worker.run_task_cases(spec, str(d))
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-4000:]
    two = [torch.load(d / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    return spec, one, two


@pytest.mark.parametrize("name", worker.TASKS)
def test_two_rank_step_equals_one_process_step(runs, name):
    """NLVR (the pair's two images on its rank), grounding's L1 + GIoU,
    ImageNet's cross-entropy (mixup off), the probe (LARS, the tower
    frozen), GLUE (MRPC's cross-entropy, STS-B's MSE) and the fused
    classifier: the reduced loss, every gradient and the parameters after
    one step of the two ranks equal one process's step on the global
    batch; both ranks hold the same state; the probe's tower does not
    move."""
    spec, one, two = runs
    want = one[name]
    for r in range(2):
        got = two[r][name]
        np.testing.assert_allclose(got["metrics"]["loss"],
                                   want["metrics"]["loss"], rtol=1e-5,
                                   err_msg=f"{name} rank {r}")
        for n, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy(),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} rank {r} grad {n}")
        for n, p in want["params"].items():
            atol = (worker.LR if n.endswith("self.key.bias")
                    else worker.LR / 20)
            np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(),
                                       rtol=1e-5, atol=atol,
                                       err_msg=f"{name} rank {r} param {n}")
    for n, p in two[0][name]["params"].items():
        assert torch.equal(p, two[1][name]["params"][n]), n
    if name == "probe":
        sd = spec["state_dicts"]["probe"]
        tower = [n for n in sd if n.startswith("vision_encoder.")]
        assert tower
        for r in range(2):
            for n in tower:
                assert torch.equal(two[r][name]["params"][n], sd[n]), n


@pytest.mark.parametrize("name", ["nlvr", "imagenet"])
def test_one_process_global_loss_matches_jax(runs, jax_models, name,
                                             monkeypatch):
    """The one-process loss on the global batch against the JAX module's
    on the same batch and weights (exact erf-GELU)."""
    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    spec, one, _ = runs
    jm, _, params = jax_models[name]
    b = {k: jnp.asarray(v) for k, v in spec["batches"][name].items()}
    if name == "nlvr":
        loss = jax.jit(lambda p: jm.apply(
            {"params": p}, b["images"], b["text_ids"].astype(jnp.int32),
            b["text_atts"].astype(jnp.int32), targets=b["targets"],
            train=True))(params)
    else:
        loss = jax.jit(lambda p: jm.apply(
            {"params": p}, images=b["images"], targets=b["targets"],
            train=True))(params)
    np.testing.assert_allclose(one[name]["metrics"]["loss"], float(loss),
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["nlvr", "grounding", "imagenet", "probe",
                                  "glue", "stsb", "classify"])
def test_merged_eval_equals_one_process(runs, name):
    """Each task's eval on 5 rows in batches of 2, the ranks holding 3 and
    2 of them: the summed counts (NLVR, grounding's IoU@0.5, the top-1s,
    classify) and the GLUE metrics of the gathered predictions (MRPC's
    accuracy and F1, STS-B's Pearson and Spearman) equal one process's
    exactly, on both ranks."""
    _, one, two = runs
    assert [t["evals"]["rows"] for t in two] == [3, 2]
    want = one["evals"][name]
    assert want and all(np.isfinite(v) for v in want.values())
    for r in range(2):
        assert two[r]["evals"][name] == want, (name, r)


def test_each_rank_mixes_its_own_rows(runs):
    """Mixup and cutmix stay within a rank: each rank's loader batch is its
    half of the one-process global batch, mixed by `mixup_cutmix` with the
    generator of [seed, rank] over its own rows alone; one process mixes
    the whole batch with the generator of the seed, as before."""
    from xfm_tpu_torch.tasks.imagenet import mixup_cutmix

    _, one, two = runs

    def mix(rng, b):
        images, targets = mixup_cutmix(
            rng, b["images"], b["targets"], worker.NL,
            mixup_alpha=0.8, cutmix_alpha=1.0, prob=1.0, switch_prob=0.5,
            label_smoothing=0.1)
        return images.astype(np.float32), targets.astype(np.float32)

    glob = one["mixup"]["plain"]
    for r in range(2):
        plain = two[r]["mixup"]["plain"]
        for k in ("images", "targets"):
            np.testing.assert_array_equal(plain[k], glob[k][2 * r:2 * r + 2])
        images, targets = mix(np.random.default_rng([7, r]), plain)
        np.testing.assert_array_equal(two[r]["mixup"]["mixed"]["images"],
                                      images)
        np.testing.assert_array_equal(two[r]["mixup"]["mixed"]["targets"],
                                      targets)
    # rank 1's draws are not the seed's own: the rank is folded in
    assert not np.array_equal(mix(np.random.default_rng(7),
                                  two[1]["mixup"]["plain"])[1],
                              two[1]["mixup"]["mixed"]["targets"])
    images, targets = mix(np.random.default_rng(7), glob)
    np.testing.assert_array_equal(one["mixup"]["mixed"]["images"], images)
    np.testing.assert_array_equal(one["mixup"]["mixed"]["targets"], targets)


@pytest.mark.parametrize("n,bs,w", [(5, 2, 2), (7, 2, 3), (4, 2, 2),
                                    (1, 3, 2), (0, 2, 2)])
def test_rank_batches_round_trip(monkeypatch, n, bs, w):
    """`rank_batches` deals every batch of the one-process eval to one rank
    whole; `merge_rank_batches` puts the ranks' rows back in order."""
    items = np.arange(100, 100 + n)
    parts = []
    monkeypatch.setattr(mesh, "world_size", lambda: w)
    for r in range(w):
        monkeypatch.setattr(mesh, "rank", lambda r=r: r)
        parts.append(mesh.rank_batches(items, bs))
        assert parts[-1].tolist() == mesh.rank_batches(list(items), bs)
    for r, p in enumerate(parts):
        for s in range(0, len(p), bs):
            first = int(p[s]) - 100
            assert first % bs == 0 and (first // bs) % w == r
    np.testing.assert_array_equal(mesh.merge_rank_batches(parts, bs), items)


# --- the schedule's horizon under W processes ------------------------------

class _Horizon(Exception):
    """Raised where a task builds its schedule, which it records."""


def _fake_rows(kind: str, n: int) -> list:
    if kind == "retrieval":
        return [{"image": f"i{i}.png", "caption": f"a red car {i}",
                 "image_id": i} for i in range(n)]
    if kind == "vqa":
        return [{"image": f"i{i}.png", "question": "what is it", "answer":
                 ["yes"] * 10, "dataset": "vqa", "question_id": i}
                for i in range(n)]
    if kind == "caption":
        return [{"image": f"i{i}.png", "caption": "a dog", "image_id": i}
                for i in range(n)]
    if kind == "nlvr":
        return [{"images": ["a.png", "b.png"], "label": "True",
                 "sentence": "two dogs"} for _ in range(n)]
    return [{"image": f"i{i}.png", "text": "the man", "ref_id": i,
             "bbox": [1.0, 1.0, 4.0, 4.0]} for i in range(n)]


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)
    return str(path)


def _schedule_argv(task: str, d) -> list:
    """A tiny config of `task` over 48 training rows (no image is read
    before the schedule) → the launcher's arguments."""
    from xfm_tpu_torch import configs

    tiny = dict(image_res=32, layers=1, vision_embed_dim=32,
                vision_num_heads=2, text_hidden_size=32,
                text_num_attention_heads=2, text_intermediate_size=64,
                compute_dtype="float32")
    sched = {"sched": "linear", "lr": 1e-3, "epochs": 1,
             "num_warmup_steps": 0.1}
    extra = []
    if task == "itr_coco":
        cfg = configs.retrieval_eval_yaml(embed_dim=16, **tiny)
        cfg = {k: v for k, v in cfg.items() if k not in ("val_file",
                                                           "_vision")}
        cfg.update(train_file=[_dump(d / "tr.json",
                                     _fake_rows("retrieval", 48))],
                   test_file=_dump(d / "te.json", [
                       {"image": "i.png", "caption": ["a car"]}]),
                   image_root=str(d))
    elif task == "vqa":
        cfg = configs.vqa_yaml(**tiny)
        cfg.update(train_file=[_dump(d / "tr.json", _fake_rows("vqa", 48))],
                   test_file=[_dump(d / "te.json", _fake_rows("vqa", 2))],
                   answer_list=_dump(d / "answers.json", ["yes", "no"]),
                   vqa_root=str(d), vg_root=str(d))
    elif task == "coco_captioning":
        cfg = configs.caption_yaml(**tiny)
        cfg.update(train_file=[_dump(d / "tr.json",
                                     _fake_rows("caption", 48))],
                   val_file=_dump(d / "va.json", _fake_rows("caption", 2)),
                   image_root=str(d))
    elif task == "pretrain_DIY":
        from test_torch_pretrain_data import write_corpus
        from test_torch_pretrain_task import _task_config

        cfg = _task_config(write_corpus(str(d / "pt"), n=4, shards=2),
                           train_dataset_size=48)
    elif task == "nlvr":
        cfg = configs.nlvr_yaml(**tiny)
        cfg.update(train_file=[_dump(d / "tr.json", _fake_rows("nlvr", 48))],
                   test_file=_dump(d / "te.json", _fake_rows("nlvr", 2)),
                   val_file=None, image_root=str(d))
    elif task == "refcoco_bbox":
        cfg = configs.grounding_yaml(**tiny)
        cfg.update(train_file=[_dump(d / "tr.json",
                                     _fake_rows("grounding", 48))],
                   test_file=_dump(d / "te.json",
                                   _fake_rows("grounding", 2)),
                   image_root=str(d))
        extra = ["--load_ckpt_from", str(d / "stage1")]  # no stage 1
    elif task == "imagenet":
        manifest = d / "rows.jsonl"
        manifest.write_text("".join(json.dumps(
            {"image": f"i{i}.png", "label": i % 3}) + "\n"
            for i in range(48)))
        cfg = configs.imagenet_yaml(
            layers=1, num_labels=3, warmup_epochs=1,
            train_root=str(manifest), val_root=str(manifest),
            schedular={"sched": "cosine", "lr": 1e-3, "epochs": 1},
            **{k: v for k, v in tiny.items() if k != "layers"})
    else:  # classify
        cfg = configs.glue_yaml(layers=1, num_labels=2, **{
            k: v for k, v in tiny.items() if k != "layers"})
        rows = d / "rows.jsonl"
        rows.write_text("".join(json.dumps({"text": "a red car", "label":
                                            i % 2}) + "\n"
                                for i in range(48)))
        cfg.update(train_file=str(rows), val_file=str(rows), batch_size=8)
    if task not in ("imagenet", "pretrain_DIY"):
        cfg["schedular"] = sched
    path = d / "task.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return ["--task", task, "--config", str(path), "--output_dir",
            str(d / "out"), "--device", "cpu", "--bs", "8", "--epoch", "5",
            *extra]


def _horizon(monkeypatch, argv, w: int) -> dict:
    """The task's schedule and steps an epoch, its main run on `w` faked
    processes (rank 0) up to where it builds the schedule."""
    from xfm_tpu_torch import run
    from xfm_tpu_torch.tasks import common, imagenet

    seen = {}
    real_cfg, real_cos = common.schedule_from_config, imagenet.half_cosine

    def from_config(cfg, steps_per_epoch=None):
        seen.update(sched=real_cfg(cfg, steps_per_epoch),
                    spe=steps_per_epoch)
        raise _Horizon

    def cosine(lr, min_lr, epochs, warmup_epochs, steps_per_epoch):
        seen.update(sched=real_cos(lr, min_lr, epochs, warmup_epochs,
                                   steps_per_epoch), spe=steps_per_epoch)
        raise _Horizon

    with monkeypatch.context() as m:
        m.setattr(common, "schedule_from_config", from_config)
        m.setattr(imagenet, "half_cosine", cosine)
        m.setattr(mesh, "world_size", lambda: w)
        with pytest.raises(_Horizon):
            run.main(argv)
    return seen


@pytest.mark.parametrize("task", ["itr_coco", "vqa", "coco_captioning",
                                  "pretrain_DIY", "nlvr", "refcoco_bbox",
                                  "imagenet", "classify"])
def test_schedule_horizon_is_the_global_batch(task, tmp_path, monkeypatch):
    """Each task's schedule at W = 2 and `--bs 8` equals the one-process
    schedule at `--bs 8` at step 0, at the end of warm-up and at the last
    step: an epoch is the rows over the global batch (`epoch_opt_steps`),
    not over the rank's. The pretrain task's steps an epoch are the JAX
    package's (`xfm_tpu/tasks/pretrain.py:152-154`: the dataset size over
    `images.batch_size` × the process count, after `_scale_batch`)."""
    argv = _schedule_argv(task, tmp_path)
    one = _horizon(monkeypatch, argv, 1)
    two = _horizon(monkeypatch, argv, 2)
    assert one["spe"] == two["spe"] == 6
    total = 5 * one["spe"]
    warm = max(range(total + 1), key=one["sched"])
    assert 0 < warm < total - 1
    for s in (0, warm, total - 1):
        assert two["sched"](s) == one["sched"](s), s
    if task == "pretrain_DIY":
        import xfm_tpu.tasks.common as jcommon

        cfg = yaml.safe_load(open(argv[3]))
        monkeypatch.setattr(jax, "device_count", lambda: 2)
        jcommon._scale_batch(cfg, 8)
        ws = 2
        steps_per_epoch = max(1, cfg.get("train_dataset_size", 10000)
                              // max(1, cfg.get("images", {}).get(
                                  "batch_size", 32) * ws))
        assert two["spe"] == jcommon.opt_steps_per_epoch(cfg,
                                                         steps_per_epoch)


# --- refcoco_bbox and glue under torch.distributed.run ----------------------

def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(x) for x in f.read().splitlines()]


def test_refcoco_bbox_on_two_processes(tmp_path):
    """`--task refcoco_bbox` under torchrun on two processes: stage 1 (the
    region stream, each rank its shard, one step) writes its checkpoint
    once, both ranks load it, stage 2 trains one epoch at `--bs 4` and
    scores the 5 test rows in the ranks' batches of 2; that IoU@0.5
    equals the one-process `--evaluate` of its ckpt/0 (at the rank's
    batch of 2)."""
    from test_torch_pretrain_data import write_corpus

    from xfm_tpu_torch import configs, run

    r = np.random.RandomState(1)
    img = tmp_path / "images"
    img.mkdir()
    rows = []
    for i in range(13):
        w, h = _png(str(img / f"{i}.png"), r)
        rows.append({"image": f"{i}.png", "text": _sentence(r),
                     "ref_id": i, "bbox": [2.0, 3.0, w / 2, h / 2]})
    tiny = dict(layers=2, vision_embed_dim=32, vision_num_heads=2,
                text_hidden_size=32, text_num_attention_heads=2,
                text_intermediate_size=64, compute_dtype="float32",
                drop_path_rate=0.0)
    regions = write_corpus(str(tmp_path / "pt"), n=8, shards=2)["regions"]
    stage1 = configs.grounding_yaml(
        pretrain=True, image_res=32, train_file_regions=regions,
        regions={"image_key": "binary", "is_image_rpath": False,
                 "caption_key": "caption", "batch_size": 4,
                 "max_images": 3, "max_regions": 2,
                 "min_perc_in_image": 0.5}, max_steps=1, print_freq=1,
        **tiny)
    (tmp_path / "stage1.yaml").write_text(yaml.safe_dump(stage1))
    ft = configs.grounding_yaml(
        image_res=48, train_file=[_dump(tmp_path / "tr.json", rows[:8])],
        test_file=_dump(tmp_path / "te.json", rows[8:]),
        image_root=str(img), max_tokens=10,
        domain_pretrain_config=str(tmp_path / "stage1.yaml"), **tiny)
    (tmp_path / "ft.yaml").write_text(yaml.safe_dump(ft))
    out = str(tmp_path / "two")
    _torchrun2(["--task", "refcoco_bbox", "--config",
                str(tmp_path / "ft.yaml"), "--output_dir", out, "--bs", "4",
                "--epoch", "1", "--seed", "3"])
    assert os.listdir(os.path.join(out, "bbox_pretrain", "ckpt")) == ["1"]
    assert os.listdir(os.path.join(out, "ckpt")) == ["0"]
    log = [e for e in _log(out) if "epoch" in e]
    assert [e["epoch"] for e in log] == [0] and np.isfinite(log[0]["loss"])
    ev = run.main(["--task", "refcoco_bbox", "--config",
                   str(tmp_path / "ft.yaml"), "--output_dir",
                   str(tmp_path / "one"), "--device", "cpu", "--bs", "2",
                   "--evaluate", "--checkpoint",
                   os.path.join(out, "ckpt", "0", "state.pt")])
    assert ev == {"iou50_acc": log[0]["iou50_acc"]}


def test_glue_on_two_processes(tmp_path):
    """`--task glue` under torchrun on two processes: each rank its half of
    every global batch of `--bs 4`, one epoch; the validation metrics of
    the predictions gathered from the ranks' batches of 2 (5 examples)
    equal the one-process `--evaluate` of its ckpt/0."""
    from xfm_tpu_torch import configs, run

    r = np.random.RandomState(2)
    for name, n in (("train", 16), ("val", 5)):
        with open(tmp_path / f"{name}.jsonl", "w") as f:
            for _ in range(n):
                f.write(json.dumps({"sentence1": _sentence(r),
                                    "sentence2": _sentence(r),
                                    "label": int(r.randint(2))}) + "\n")
    cfg = configs.glue_yaml(
        layers=2, text_hidden_size=32, text_num_attention_heads=2,
        text_intermediate_size=64, compute_dtype="float32",
        train_file=str(tmp_path / "train.jsonl"),
        validation_file=str(tmp_path / "val.jsonl"), num_train_epochs=1,
        per_device_eval_batch_size=2, max_length=16, learning_rate=1e-3)
    path = tmp_path / "glue.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = str(tmp_path / "two")
    _torchrun2(["--task", "glue", "--config", str(path), "--output_dir",
                out, "--bs", "4", "--seed", "1"])
    log = [e for e in _log(out) if "epoch" in e]
    assert [e["epoch"] for e in log] == [0] and np.isfinite(log[0]["loss"])
    ev = run.main(["--task", "glue", "--config", str(path), "--output_dir",
                   str(tmp_path / "one"), "--device", "cpu", "--evaluate",
                   "--checkpoint", os.path.join(out, "ckpt", "0",
                                                "state.pt")])
    assert set(ev) == {"accuracy", "f1"}
    assert ev == {k: log[0][k] for k in ev}
