"""Data parallelism across processes (`xfm_tpu_torch/core/mesh.py`) on the
CPU: two gloo processes against one process, and against the JAX
package's global-batch step.

The cases of `tests/_torch_mp_worker.py` run in this process on the
global batches (one process, no group) and in two worker processes, each
given its half of every global batch (`mesh.rank_slice`), on a tiny
XFMForPretrain (2 layers a tower, width 64, 64 px, f32) whose weights the
JAX package initializes. Tolerances: losses rtol 1e-5; every gradient
rtol 1e-5 / atol 1e-6 (gradients of order 1e-2 to 1); the parameters
after one HF-AdamW step rtol 1e-5 / atol 5e-5 (lr / 20), the attention
key biases atol lr: Adam's first step moves each element by about ±lr
whatever the size of its gradient, so an element whose gradient is of
the order of eps (1e-8), or analytically zero as a key bias's is, turns
the f32 rounding of its gradient into up to a part of lr. Against the
JAX package the tolerances of `tests/test_torch_pretrain.py`. The rerank
merge is held bit for bit; `python3 -m xfm_tpu_torch.run --task itr_coco`
runs under `torch.distributed.run` on two processes and its eval is held
to the one-process eval of its checkpoint exactly.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_mp_worker as worker
from test_torch_pretrain import slice_setup  # noqa: F401  (a fixture)
from xfm_tpu_torch.core import mesh
from _torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


@pytest.fixture(scope="module")
def runs(slice_setup, tmp_path_factory):  # noqa: F811
    """The cases on one process and on two: (spec, one, [rank 0, rank 1],
    the directory)."""
    from xfm_tpu_torch.train.checkpoint import state_dict_from_jax

    s = slice_setup
    spec = worker.make_spec(state_dict_from_jax(s["params"], s["jcfg"]))
    d = tmp_path_factory.mktemp("dp")
    torch.save(spec, d / "spec.pt")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(d / "spec.pt"), str(d)],
        env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    one = worker.run_cases(spec, str(d / "one"))
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-4000:]
    two = [torch.load(d / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    return spec, one, two, d


def _close_states(want, got, case):
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=f"{case} {k}")
    for n, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{case} grad {n}")
    for n, p in want["params"].items():
        atol = worker.LR if n.endswith("self.key.bias") else worker.LR / 20
        np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(),
                                   rtol=1e-5, atol=atol,
                                   err_msg=f"{case} param {n}")


@pytest.mark.parametrize("case", ["a", "b", "c", "d", "e", "r1", "r0"])
def test_two_rank_step_equals_one_process_step(runs, case):
    """(a) injected negatives, (b) negatives drawn from the shared
    generator, (c) accumulation K = 2, (d) a stream step that leaves
    towers unused, (e) unequal masked-token and masked-patch counts, (r1,
    r0) the retrieval step with idx-aware ITC and negatives from the other
    rank, with the shared cross-k/v negative pass and without: the reduced
    loss, every gradient and the parameters after one step of the two
    ranks equal one process's step on the global batch; both ranks hold
    the same state."""
    _, one, two, _ = runs
    for r in range(2):
        _close_states(one[case], two[r][case], f"{case} rank {r}")
    for n, p in two[0][case]["params"].items():
        assert torch.equal(p, two[1][case]["params"][n]), n
    if case == "e":  # the counts do differ from rank to rank
        ids = worker.make_spec({})["uneven"]["masked_ids"]
        assert (ids[:2] != -100).sum() != (ids[2:] != -100).sum()


def test_two_rank_step_equals_jax_global_step(runs, slice_setup):  # noqa
    """(a) against the JAX package's step on the global batch (the same
    weights, batch and injected negatives; optax HF-AdamW): the losses at
    rtol 1e-4, the gradients and the parameters after the step at rtol
    1e-3 / atol 1e-5 (key biases atol lr), as `test_torch_pretrain`."""
    from xfm_tpu.train.optim import create_optimizer as jcreate
    from xfm_tpu.train.schedules import linear_warmup_decay as jsched
    from xfm_tpu.train.train_state import TrainState as JState
    from xfm_tpu_torch.train.checkpoint import state_dict_from_jax

    s = slice_setup
    jparams = jax.tree.map(jnp.asarray, s["params"])
    jstate = JState.create(jparams, jcreate(jparams, jsched(worker.LR, 10, 0),
                                            weight_decay=0.01, lr_mult=2.0))

    @jax.jit
    def jstep(state):
        (loss, out), g = jax.value_and_grad(
            lambda p: s["loss_fn"](p, s["jb"], jax.random.PRNGKey(0)),
            has_aux=True)(state.params)
        return state.apply_gradients(g), loss, out, g

    jstate, jloss, jout, jgrads = jstep(jstate)
    got = runs[2][0]["a"]
    np.testing.assert_allclose(got["metrics"]["loss"], float(jloss),
                               rtol=1e-4)
    for k in ("loss_itc", "loss_itm", "loss_mlm", "loss_mim"):
        np.testing.assert_allclose(got["metrics"][k], float(jout[k]),
                                   rtol=1e-4, err_msg=k)
    cfg = s["jcfg"]
    grads = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    params = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params),
                                 cfg)
    for n, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), grads[n].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=n)
    for n, p in got["params"].items():
        atol = worker.LR if n.endswith("self.key.bias") else 1e-5
        np.testing.assert_allclose(p.numpy(), params[n].numpy(), rtol=1e-3,
                                   atol=atol, err_msg=n)


def test_unequal_count_losses_are_global(runs):
    """(e) the bbox losses over `is_image` rows (1 + 2 rows kept) and the
    VQ-KD MIM loss over masked patches of unequal counts: the mean over
    the ranks of each rank's loss is the global one."""
    _, one, two, _ = runs
    for r in range(2):
        for k, v in one["e_losses"].items():
            np.testing.assert_allclose(two[r]["e_losses"][k], v, rtol=1e-5,
                                       err_msg=k)


def test_rank_generators(runs):
    """(f) dropout masks differ from rank to rank; the shared generator
    draws the same on every rank and as one process does."""
    _, one, two, _ = runs
    assert not torch.equal(two[0]["f"]["mask"], two[1]["f"]["mask"])
    assert torch.equal(two[0]["f"]["shared"], two[1]["f"]["shared"])
    assert torch.equal(two[0]["f"]["shared"], one["f"]["shared"])


def test_rerank_merge_is_bit_exact(runs):
    """(g) the merged row slices are the one-process scores bit for bit,
    a logit below -100 and one a rounding away from it included."""
    spec, _, two, _ = runs
    for r in range(2):
        for got, want in zip(two[r]["g"], spec["scores"]):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))


def test_collect_results_merges_both_shards(runs):
    """(h) rank 0 merges the shards back into the split's order."""
    _, one, two, d = runs
    assert two[0]["h"] == str(d / "result" / "vqa_result.json")
    with open(two[0]["h"]) as f:
        merged = json.load(f)
    with open(one["h"]) as f:
        assert merged == json.load(f)
    assert [m["question_id"] for m in merged] == list(range(5))
    for r in range(2):
        assert (d / "result" / f"vqa_result_rank{r}.json").exists()


def test_rank_rows_partition_the_global_batches(runs):
    _, _, two, _ = runs
    rows = [t["k"]["rows"] for t in two]
    joined = np.stack([r.reshape(-1, 3) for r in rows], 1).reshape(-1)
    np.testing.assert_array_equal(joined, np.arange(18))
    assert two[0]["k"]["strided"] + two[1]["k"]["strided"] == [
        0, 2, 4, 6, 1, 3, 5]


@pytest.mark.parametrize("axis", ["fsdp", "tensor", "pipe"])
def test_mesh_from_config_refuses_other_axes(axis):
    """(j) `pipe` > 1 raises; `fsdp` and `tensor` run
    (`core/partitioning`) but must divide the world size; `data: -1` takes
    the world size over fsdp × tensor, another `data` must make data ×
    fsdp × tensor the world size."""
    if axis == "pipe":
        with pytest.raises(mesh.MultiProcessUnsupported, match=axis):
            mesh.mesh_from_config({"parallel": {"data": -1, axis: 2}})
    else:  # one process cannot hold 2 shards or 2 cuts
        with pytest.raises(ValueError, match=axis):
            mesh.mesh_from_config({"parallel": {"data": -1, axis: 2}})
    assert mesh.mesh_from_config(
        {"parallel": {"data": -1, "fsdp": 1, "tensor": 1}}) == (1, 1, 1)
    with pytest.raises(ValueError):
        mesh.mesh_from_config({"parallel": {"data": 4}})


def test_single_process_tasks_refuse_and_cards_are_checked(monkeypatch,
                                                            tmp_path):
    """The five tasks that refused more than one process (nlvr,
    refcoco_bbox, imagenet, glue, classify) now start under a group of two,
    called through the launcher or directly: each writes its config.yaml
    and stops at the empty YAML's first missing key, not at a refusal;
    under torchrun's variables `--device cuda` without a card raises
    before any rendezvous."""
    import importlib

    from xfm_tpu_torch import run

    config = tmp_path / "task.yaml"
    config.write_text("{}\n")
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    for task in ("nlvr", "refcoco_bbox", "imagenet", "glue", "classify"):
        module, entry = run.TASKS[task]
        main = getattr(importlib.import_module(
            f"xfm_tpu_torch.tasks.{module}"), entry)
        for how in ("launcher", "entry"):
            out = tmp_path / f"{task}_{how}"
            argv = ["--task", task, "--config", str(config), "--output_dir",
                    str(out), "--device", "cpu"]
            with pytest.raises(KeyError):
                if how == "launcher":
                    run.main(argv)
                else:
                    main(run.build_parser().parse_args(argv))
            assert (out / "config.yaml").exists(), (task, how)
    monkeypatch.undo()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            mesh.maybe_init_distributed("cuda")


def _retrieval_corpus(root, n_img=8):
    from PIL import Image

    rng = np.random.default_rng(0)
    words = ["a", "photo", "of", "the", "red", "blue", "dog", "cat", "on",
             "grass", "with", "sky"]
    train, test = [], []
    for i in range(n_img):
        Image.fromarray(rng.integers(0, 255, (48, 40, 3), dtype=np.uint8)) \
            .save(root / f"img{i}.png")
        caps = [" ".join(rng.choice(words, 3 + (i + j) % 7)) + f" {i}."
                for j in range(2)]
        test.append({"image": f"img{i}.png", "caption": caps})
        train += [{"image": f"img{i}.png", "caption": c, "image_id": i}
                  for c in caps]
    (root / "train.json").write_text(json.dumps(train))
    (root / "test.json").write_text(json.dumps(test))


def test_itr_coco_on_two_processes(tmp_path):
    """(i) `python3 -m xfm_tpu_torch.run --task itr_coco` under
    `torch.distributed.run --nproc_per_node=2` (gloo, `--device cpu`), one
    epoch of 2 global batches of 8: rank 0 alone writes the log (one
    zero-shot line, one epoch line), config.yaml and ckpt/0, and prints
    both ranks' kernel launches; the epoch's eval (encoded on both ranks,
    reranked in two row slices, merged) equals the one-process
    `--evaluate` of ckpt/0."""
    import yaml

    from xfm_tpu_torch import run
    from xfm_tpu_torch.configs import retrieval_eval_yaml

    _retrieval_corpus(tmp_path)
    cfg = retrieval_eval_yaml(
        image_res=64, layers=2, vision_embed_dim=64, vision_num_heads=2,
        text_hidden_size=64, text_num_attention_heads=2,
        text_intermediate_size=128, text_vocab_size=99, embed_dim=32,
        compute_dtype="float32")
    cfg = {k: v for k, v in cfg.items() if k not in ("val_file", "_vision")}
    cfg.update(train_file=[str(tmp_path / "train.json")],
               test_file=str(tmp_path / "test.json"),
               image_root=str(tmp_path), batch_size_test=4, k_test=4)
    path = tmp_path / "ret.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "two"
    common = ["--task", "itr_coco", "--config", str(path), "--device",
              "cpu", "--seed", "0"]
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "xfm_tpu_torch.run", *common,
         "--bs", "8", "--epoch", "1", "--output_dir", str(out)],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    line = [x for x in res.stdout.splitlines()
            if x.startswith("### processes 2 backend gloo launches by rank")]
    assert len(line) == 1  # rank 0's, with both ranks' counts
    assert len(json.loads(line[0].split("by rank ", 1)[1])) == 2
    log = [json.loads(x) for x in (out / "log.txt").read_text().splitlines()]
    assert [e["epoch"] for e in log] == [-1, 0]
    assert np.isfinite(log[1]["loss_itc"]) and np.isfinite(log[1]["loss_itm"])
    assert sorted(os.listdir(out / "ckpt")) == ["0"]
    assert os.listdir(out / "ckpt" / "0") == ["state.pt"]
    assert (out / "config.yaml").exists()
    one = run.main(common + ["--evaluate", "--output_dir",
                             str(tmp_path / "one"), "--checkpoint",
                             str(out / "ckpt" / "0" / "state.pt")])
    assert one == {k: log[1][k] for k in one}


def _torchrun2(args) -> str:
    """`torch.distributed.run --standalone --nproc_per_node=2 -m
    xfm_tpu_torch.run ARGS` on the CPU → its standard output, after
    checking rank 0's `### processes 2 backend gloo` line."""
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "xfm_tpu_torch.run", *args,
         "--device", "cpu"], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert sum(x.startswith("### processes 2 backend gloo launches by rank")
               for x in res.stdout.splitlines()) == 1
    return res.stdout


def test_pretrain_diy_on_two_processes(tmp_path):
    """`--task pretrain_DIY` under torchrun on two processes, each reading
    its shard of every stream: 2 steps at `--bs 4` (2 rows a stream and
    rank), one log line at the checkpoint with each step's finite global
    loss, one checkpoint, written once."""
    import yaml

    from test_torch_pretrain_data import write_corpus
    from test_torch_pretrain_task import _task_config

    files = write_corpus(str(tmp_path / "data"), n=8, shards=2)
    cfg = _task_config(files, max_steps=2, ckpt_frequent_step=2)
    path = tmp_path / "pt.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "out"
    _torchrun2(["--task", "pretrain_DIY", "--config", str(path),
                "--output_dir", str(out), "--bs", "4", "--seed", "0"])
    log = [json.loads(x) for x in (out / "log.txt").read_text().splitlines()]
    assert [e["step"] for e in log] == [2]
    assert len(log[0]["losses"]) == 2
    assert all(np.isfinite(v) and v > 0 for v in log[0]["losses"])
    np.testing.assert_allclose(np.mean(log[0]["losses"]), log[0]["loss"],
                               rtol=1e-6)
    assert sorted(os.listdir(out / "ckpt")) == ["2"]
    saved = torch.load(out / "ckpt" / "2" / "state.pt", weights_only=True)
    assert saved["step"] == 2


def test_vqa_on_two_processes(tmp_path):
    """`--task vqa` under torchrun on two processes (one epoch at `--bs 4`,
    then the test split ranked in two shards and merged on rank 0): the
    merged results and accuracies equal the one-process `--evaluate` of
    its ckpt/0."""
    from test_torch_vqa_task import _corpus, _result, _task_yaml
    from xfm_tpu_torch import run

    root = str(tmp_path / "vqa")
    os.makedirs(root)
    paths = _corpus(root)
    cfg = _task_yaml(root, paths)
    out = str(tmp_path / "two")
    _torchrun2(["--task", "vqa", "--config", cfg, "--output_dir", out,
                "--bs", "4", "--epoch", "1", "--seed", "3"])
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["0"]
    with open(os.path.join(out, "log.txt")) as f:
        log = [json.loads(x) for x in f.read().splitlines()]
    two = _result(out)
    qids = [a["question_id"] for a in json.load(open(paths["test"]))]
    assert [r["question_id"] for r in two] == qids
    ev = str(tmp_path / "one")
    got = run.main(["--task", "vqa", "--config", cfg, "--output_dir", ev,
                    "--device", "cpu", "--evaluate", "--checkpoint",
                    os.path.join(out, "ckpt", "0", "state.pt")])
    assert _result(ev) == two
    assert log[-1] == {k: got[k] for k in ("vqa_acc_exact",
                                           "vqa_acc_official")}


def test_captioning_on_two_processes(tmp_path):
    """`--task coco_captioning` under torchrun on two processes (one
    epoch at `--bs 4`, the val images decoded in two shards, merged and
    scored on rank 0): the captions and scores equal the one-process
    `--evaluate` of its ckpt/0."""
    from test_torch_caption_run import _result, _yaml
    from test_torch_caption_task import write_caption_corpus
    from xfm_tpu_torch import run

    root = str(tmp_path / "cap")
    os.makedirs(root)
    cfg = _yaml(root, write_caption_corpus(root))
    out = str(tmp_path / "two")
    _torchrun2(["--task", "coco_captioning", "--config", cfg,
                "--output_dir", out, "--bs", "4", "--epoch", "1", "--seed",
                "3"])
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["0"]
    with open(os.path.join(out, "log.txt")) as f:
        log = [json.loads(x) for x in f.read().splitlines()]
    ev = str(tmp_path / "one")
    got = run.main(["--task", "coco_captioning", "--config", cfg,
                    "--output_dir", ev, "--device", "cpu", "--evaluate",
                    "--checkpoint", os.path.join(out, "ckpt", "0",
                                                 "state.pt")])
    assert _result(ev) == _result(out)
    assert [r["image_id"] for r in _result(out)] == list(range(1010, 1015))
    assert log[-1] == {"final": got}


def test_stream_masking_differs_per_rank(tmp_path):
    """Ranks 0 and 1 of 2 (`tasks.pretrain.build_streams`) read their own
    shards and draw their block masks from generators seeded seed + rank,
    so the two ranks' image-text and ImageNet masks differ (the block
    masks do not depend on the data)."""
    from test_torch_pretrain_data import WORDS, stream_config, write_corpus
    from xfm_tpu_torch.data.tokenization import SimpleTokenizer
    from xfm_tpu_torch.tasks.pretrain import build_streams

    files = write_corpus(str(tmp_path), n=8, shards=2)
    cfg = stream_config(files, image_res=64)
    cfg.update(num_masking_patches=6, min_num_patches=2)
    tok = SimpleTokenizer.from_texts(WORDS)
    first = []
    for r in range(2):
        streams = build_streams(cfg, tok, 0, r, 2)
        first.append({n: next(iter(streams[n])) for n in ("image",
                                                            "imagenet")})
    for n in ("image", "imagenet"):
        a, b = (np.asarray(f[n]["image_mask"]) for f in first)
        assert a.shape == b.shape and a.sum() > 0
        assert not np.array_equal(a, b), n
