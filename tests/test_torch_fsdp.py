"""FSDP (`xfm_tpu_torch/core/partitioning.py`) on the CPU: two gloo
processes at `parallel: {fsdp: 2}` against one process on the global
batch, and against the JAX package's global-batch step; the checkpoint
across layouts, and the `.th` export against the JAX package's.

The cases of `tests/_torch_fsdp_worker.py` run in this process (one
process, no group, the model whole) and in two worker processes started
here, each holding half of every parameter, gradient and moment and given
its half of every global batch, on a tiny XFMForPretrain (2 layers a
tower, width 64, 64 px, f32) whose weights the JAX package initializes.
Tolerances are those of `tests/test_torch_distributed.py`: losses rtol
1e-5; every gradient rtol 1e-5 / atol 1e-6; the parameters after one
HF-AdamW step rtol 1e-5 / atol 5e-5 (lr / 20), the attention key biases
atol lr (Adam's first step moves an element by about ±lr whatever the
size of its gradient, so a gradient of the order of eps turns its
rounding into a part of lr); against the JAX package those of
`tests/test_torch_pretrain.py`. The clip (0.05) is far below the
gradient's norm (~20), so every rank must clip by the whole gradient's
norm.
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

import _torch_fsdp_worker as fw
import _torch_mp_worker as mp
from test_torch_pretrain import slice_setup  # noqa: F401  (a fixture)
from xfm_tpu_torch.core import mesh
from _torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_fsdp_worker.py")
LR = fw.LR


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


def _task_runs(root) -> list:
    """`itr_coco` (2 global batches of 8, one epoch) and `pretrain_DIY` (2
    steps at `--bs 4`) YAMLs with `parallel: {fsdp: 2}`, and `resume:
    true` on the pretrain one."""
    import yaml

    from test_torch_distributed import _retrieval_corpus
    from test_torch_pretrain_data import write_corpus
    from test_torch_pretrain_task import _task_config
    from xfm_tpu_torch.configs import retrieval_eval_yaml

    ret = root / "ret"
    ret.mkdir()
    _retrieval_corpus(ret)
    cfg = retrieval_eval_yaml(
        image_res=64, layers=2, vision_embed_dim=64, vision_num_heads=2,
        text_hidden_size=64, text_num_attention_heads=2,
        text_intermediate_size=128, text_vocab_size=99, embed_dim=32,
        compute_dtype="float32")
    cfg = {k: v for k, v in cfg.items() if k not in ("val_file", "_vision")}
    cfg.update(train_file=[str(ret / "train.json")],
               test_file=str(ret / "test.json"), image_root=str(ret),
               batch_size_test=4, k_test=4, parallel={"fsdp": 2})
    (root / "ret.yaml").write_text(yaml.safe_dump(cfg))
    files = write_corpus(str(root / "pt"), n=8, shards=2)
    cfg = _task_config(files, max_steps=2, ckpt_frequent_step=2,
                       resume=True, parallel={"fsdp": 2})
    (root / "pt.yaml").write_text(yaml.safe_dump(cfg))
    return [("itr_coco", str(root / "ret.yaml"), ["--bs", "8", "--epoch",
                                                   "1"]),
            ("pretrain_DIY", str(root / "pt.yaml"), ["--bs", "4"])]


@pytest.fixture(scope="module")
def runs(slice_setup, tmp_path_factory):  # noqa: F811
    """The cases on one process and on two: (spec, one, [rank 0, rank 1],
    the directory)."""
    from xfm_tpu_torch.train.checkpoint import (init_weights,
                                                save_checkpoint,
                                                state_dict_from_jax)
    from xfm_tpu_torch.train.train_state import (make_train_step,
                                                 pretrain_loss_fn)

    s = slice_setup
    spec = mp.make_spec(state_dict_from_jax(s["params"], s["jcfg"]))
    spec["task_batches"] = mp.make_task_batches()
    spec["task_state_dicts"] = {}
    for name in mp.TASKS:
        model = mp.task_model(name)
        init_weights(model, 9)
        spec["task_state_dicts"][name] = {
            k: v.detach().clone() for k, v in model.state_dict().items()}
    d = tmp_path_factory.mktemp("fsdp")
    state = fw._state(spec, clip=1.0)
    make_train_step(pretrain_loss_fn)(state, mp._local(spec["batch"],
                                                       spec["neg"]))
    save_checkpoint(str(d / "one_ckpt"), state)
    spec["one_ckpt"] = str(d / "one_ckpt")
    two_spec = dict(spec, runs=_task_runs(d))
    torch.save(two_spec, d / "spec.pt")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(d / "spec.pt"), str(d)],
        env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    one = fw.run_cases(spec, str(d / "one"))
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-4000:]
    two = [torch.load(d / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    return two_spec, one, two, d


def _close_states(want, got, case):
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=f"{case} {k}")
    for n, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{case} grad {n}")
    for n, p in want["params"].items():
        atol = LR if n.endswith("self.key.bias") else LR / 20
        np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(),
                                   rtol=1e-5, atol=atol,
                                   err_msg=f"{case} param {n}")


def _same_on_both_ranks(two, case):
    for n, p in two[0][case]["params"].items():
        assert torch.equal(p, two[1][case]["params"][n]), (case, n)


@pytest.mark.parametrize("case", ["a", "s", "c"])
def test_sharded_step_equals_one_process_step(runs, case):
    """(a) one step with a clip that bites, (s) a stream step that leaves
    towers unused, (c) accumulation K = 2: the reduced loss, the whole
    gradient's norm, every gradient and the parameters after the step of
    two ranks holding half of each equal one process's step on the global
    batch; both ranks hold the same parameters."""
    _, one, two, _ = runs
    for r in range(2):
        _close_states(one[case], two[r][case], f"{case} rank {r}")
    _same_on_both_ranks(two, case)
    if case in ("a", "s"):  # the clip bit: the norm is far above it
        assert two[0][case]["metrics"]["grad_norm"] > 100 * fw.CLIP


def test_sharded_step_equals_jax_global_step(runs, slice_setup):  # noqa
    """(a) against the JAX package's step on the global batch (the same
    weights, batch and injected negatives; optax HF-AdamW with the same
    clip of 0.05): the losses at rtol 1e-4, the gradients and the
    parameters after the step at rtol 1e-3 / atol 1e-5 (key biases atol
    lr), as `test_torch_pretrain`."""
    from xfm_tpu.train.optim import create_optimizer as jcreate
    from xfm_tpu.train.schedules import linear_warmup_decay as jsched
    from xfm_tpu.train.train_state import TrainState as JState
    from xfm_tpu_torch.train.checkpoint import state_dict_from_jax

    s = slice_setup
    jparams = jax.tree.map(jnp.asarray, s["params"])
    jstate = JState.create(jparams, jcreate(
        jparams, jsched(LR, 10, 0), weight_decay=0.01, lr_mult=2.0,
        clip_grad_norm=fw.CLIP))

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
        atol = LR if n.endswith("self.key.bias") else 1e-5
        np.testing.assert_allclose(p.numpy(), params[n].numpy(), rtol=1e-3,
                                   atol=atol, err_msg=n)


def _assert_bit_equal(a, b, what):
    assert a["metrics"] == b["metrics"], what
    for key in ("grads", "params"):
        for n, t in a[key].items():
            assert torch.equal(t, b[key][n]), (what, key, n)


def test_full_checkpointing_under_fsdp_is_bit_equal(runs):
    """(m) `gradient_checkpointing: full` on every block and layer of a
    sharded model (non-reentrant `torch.utils.checkpoint` inside the
    units, the recompute gathering again), dropout and drop-path live:
    the loss, every gradient and the parameters after the step equal the
    plain sharded step bit for bit (the recompute replays the forward's
    masks), as they do on one process."""
    _, one, two, _ = runs
    _assert_bit_equal(one["m"]["plain"], one["m"]["full"], "one process")
    for r in range(2):
        _assert_bit_equal(two[r]["m"]["plain"], two[r]["m"]["full"],
                          f"rank {r}")
    _same_on_both_ranks([two[0]["m"], two[1]["m"]], "full")


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    x = x.float().abs().clamp(min=2.0 ** -126)
    return torch.pow(2.0, torch.floor(torch.log2(x)) - 7)


def test_bf16_params_policy_against_master_weights(runs):
    """(b) `bf16_params` on a sharded model is FSDP2's bf16
    mixed-precision policy over f32 shards; on one process it is
    `MasterWeights`. On both the live (gathered) weights are the rounded
    f32 masters bit for bit, and the step's loss agrees at rtol 1e-5.
    The two layouts' gradients are sums of bf16 products in different
    orders, and Adam's first update lr·g/(|g| + eps) turns their
    difference into up to 2·lr·lr_mult where the signs differ and into a
    part of lr where |g| is near eps (the key biases' case in
    `test_torch_distributed`): so the masters agree within 2·lr·lr_mult
    everywhere, and the live weights within 1 bf16 ulp of the larger of
    the two (`tests/test_torch_master_weights.py`'s bound) on more than
    99.5 % of the elements."""
    _, one, two, _ = runs
    a, b = one["b"], two[0]["b"]
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-5)
    for rec in (a, b, two[1]["b"]):
        for n, m in rec["optimizer"]["master"].items():
            assert m.dtype == torch.float32, n
            assert torch.equal(rec["params"][n], m.to(torch.bfloat16)), n
    beyond = total = 0
    for n, live in a["params"].items():
        assert live.dtype == b["params"][n].dtype == torch.bfloat16, n
        gap = (live.float() - b["params"][n].float()).abs()
        ulp = _bf16_ulp(torch.maximum(live.float().abs(),
                                      b["params"][n].float().abs()))
        beyond += int((gap > ulp).sum())
        total += live.numel()
        mgap = (a["optimizer"]["master"][n]
                - b["optimizer"]["master"][n]).abs()
        assert float(mgap.max()) <= 2 * LR * 2.0 * (1 + 1e-3), n
    assert beyond < 0.005 * total, (beyond, total)
    _same_on_both_ranks([two[0], two[1]], "b")


def test_bf16_checkpoint_restores_on_one_process(runs):
    """(b) the `bf16_params` state saved at `fsdp: 2` has the one-process
    form (bf16 parameters, `{"master", "inner"}`) and restores into a
    one-process `MasterWeights` state bit for bit."""
    from xfm_tpu_torch.train.checkpoint import restore_checkpoint

    spec, _, two, d = runs
    state = restore_checkpoint(str(d / "ckpt_bf16"),
                               fw._state(spec, clip=1.0, bf16=True))
    got = fw.record(state)
    want = two[0]["b"]
    assert got["step"] == want["step"] == 1
    for n, p in want["params"].items():
        assert torch.equal(got["params"][n], p), n
    for n, m in want["optimizer"]["master"].items():
        assert torch.equal(got["optimizer"]["master"][n], m), n
    for key in ("mu", "nu"):
        for n, t in want["optimizer"]["inner"][key].items():
            assert torch.equal(got["optimizer"]["inner"][key][n], t), n


@pytest.mark.parametrize("name", mp.TASKS)
def test_task_step_under_fsdp(runs, name):
    """(t) one step of NLVR, grounding, ImageNet, the LARS probe, GLUE,
    STS-B and the fused classifier, each model placed as its task places
    it (`place_state`): two sharded ranks equal one process; the probe's
    frozen tower does not move, and its trust ratios are those of whole
    parameters."""
    spec, one, two, _ = runs
    for r in range(2):
        _close_states(one["t"][name], two[r]["t"][name], f"{name} {r}")
    _same_on_both_ranks([two[0]["t"], two[1]["t"]], name)
    if name == "probe":
        start = spec["task_state_dicts"]["probe"]
        tower = [n for n in two[0]["t"]["probe"]["params"]
                 if n.startswith("vision_encoder.")]
        assert tower
        for n in tower:
            assert torch.equal(two[0]["t"]["probe"]["params"][n], start[n])
        head = [n for n in two[0]["t"]["probe"]["params"]
                if n.startswith("cls_head.") and n.endswith("weight")]
        assert any(not torch.equal(two[0]["t"]["probe"]["params"][n],
                                   start[n]) for n in head)


def _bit_equal_state(a, b, what):
    assert a["step"] == b["step"], what
    for n, p in a["params"].items():
        assert torch.equal(p, b["params"][n]), (what, n)
    assert a["optimizer"]["count"] == b["optimizer"]["count"], what
    for key in ("mu", "nu"):
        for n, t in a["optimizer"][key].items():
            assert torch.equal(t, b["optimizer"][key][n]), (what, key, n)


def test_checkpoint_moves_between_layouts(runs):
    """(k) A `state.pt` written at `fsdp: 2` (every rank in the gather,
    rank 0 writing) holds whole tensors and restores on one process bit
    for bit: the parameters, both moments, the count and the step; the
    one process's next step from it equals the ranks' next step. The
    reverse: a one-process checkpoint restored into the shards gathers
    back bit-equal to the file, and the ranks' next step from it equals
    the one process's."""
    from xfm_tpu_torch.train.checkpoint import restore_checkpoint
    from xfm_tpu_torch.train.train_state import (make_train_step,
                                                 pretrain_loss_fn)

    spec, one, two, d = runs
    state = restore_checkpoint(str(d / "ckpt"), fw._state(spec, clip=1.0))
    _bit_equal_state(fw.record(state), two[0]["k"]["saved"], "fsdp → 1")
    state, metrics = make_train_step(pretrain_loss_fn)(
        state, mp._local(spec["batch"], spec["neg"]))
    _close_states(fw.record(state, metrics), two[0]["k"]["next"],
                  "fsdp → 1 next")
    written = fw.record(restore_checkpoint(spec["one_ckpt"],
                                           fw._state(spec, clip=1.0)))
    for r in range(2):
        _bit_equal_state(two[r]["k"]["restored"], written, f"1 → rank {r}")
        _close_states(one["k"]["restored_next"], two[r]["k"]["restored_next"],
                      f"1 → fsdp next {r}")


def test_retrieval_eval_under_fsdp(runs):
    """(e) the retrieval eval of a sharded model (the whole model gathered
    once for it, `unsharded`): R@K equal to one process's; the rerank in
    chunks of 2 rows, 2 calls on rank 0 and 1 on rank 1, merged: the
    one-process scores."""
    _, one, two, _ = runs
    for r in range(2):
        assert two[r]["e"]["metrics"] == one["e"]["metrics"]
        for got, want in zip(two[r]["e"]["scores"], one["e"]["scores"]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_task_runs_under_fsdp(runs, tmp_path):
    """(r) `run.main` under `parallel: {fsdp: 2}` on two processes:
    `itr_coco`'s epoch (zero-shot eval, train, eval, ckpt/0) gives the
    eval that one process's `--evaluate` of its ckpt/0 gives; the
    `pretrain_DIY` run's checkpoint at step 2 resumes on one process
    (the `parallel` block taken out) for a third step."""
    import yaml

    from xfm_tpu_torch import run

    spec, _, two, d = runs
    (_, ret_yaml, _), (_, pt_yaml, _) = spec["runs"]
    out = d / "itr_coco"
    log = [json.loads(x) for x in (out / "log.txt").read_text().splitlines()]
    assert [e["epoch"] for e in log] == [-1, 0]
    assert two[0]["r"]["itr_coco"] == two[1]["r"]["itr_coco"]
    cfg = yaml.safe_load(open(ret_yaml))
    del cfg["parallel"]
    one_yaml = tmp_path / "ret.yaml"
    one_yaml.write_text(yaml.safe_dump(cfg))
    one = run.main(["--task", "itr_coco", "--config", str(one_yaml),
                    "--device", "cpu", "--seed", "0", "--evaluate",
                    "--output_dir", str(tmp_path / "ev"), "--checkpoint",
                    str(out / "ckpt" / "0" / "state.pt")])
    assert one == {k: log[1][k] for k in one}
    cfg = yaml.safe_load(open(pt_yaml))
    del cfg["parallel"]
    cfg["max_steps"] = 3
    one_yaml = tmp_path / "pt.yaml"
    one_yaml.write_text(yaml.safe_dump(cfg))
    pt = d / "pretrain_DIY"
    assert sorted(os.listdir(pt / "ckpt")) == ["2"]
    run.main(["--task", "pretrain_DIY", "--config", str(one_yaml),
              "--device", "cpu", "--seed", "0", "--bs", "4",
              "--output_dir", str(pt)])
    log = [json.loads(x) for x in (pt / "log.txt").read_text().splitlines()]
    assert [e["step"] for e in log] == [2, 3]
    assert all(np.isfinite(v) for e in log for v in e["losses"])


def test_mesh_axes():
    """`data` × `fsdp` × `tensor` must be the world size: `data: -1` takes
    the rest, an `fsdp` × `tensor` that does not divide it or a `data`
    that does not make it up raises; `tensor` is the innermost axis (a
    tensor group is T consecutive ranks, the batch split over W / T);
    `pipe` > 1 raises `MultiProcessUnsupported` naming the ROADMAP's next
    item."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(mesh, "world_size", lambda: 4)
        assert mesh.mesh_from_config({"parallel": {"fsdp": 2}}) == (2, 2, 1)
        assert mesh.mesh_from_config(
            {"parallel": {"data": -1, "fsdp": 4}}) == (1, 4, 1)
        assert mesh.mesh_from_config({"parallel": {"data": 2,
                                                   "fsdp": 2}}) == (2, 2, 1)
        assert mesh.mesh_from_config({}) == (4, 1, 1)
        assert mesh.mesh_from_config({"parallel": {"tensor": 2}}) == (2, 1,
                                                                      2)
        assert mesh.mesh_from_config(
            {"parallel": {"fsdp": 2, "tensor": 2}}) == (1, 2, 2)
        with pytest.raises(ValueError, match="fsdp"):
            mesh.mesh_from_config({"parallel": {"fsdp": 3}})
        with pytest.raises(ValueError, match="tensor"):
            mesh.mesh_from_config({"parallel": {"fsdp": 2, "tensor": 4}})
        with pytest.raises(ValueError, match="data"):
            mesh.mesh_from_config({"parallel": {"data": 4, "fsdp": 2}})
        with pytest.raises(mesh.MultiProcessUnsupported,
                           match="core/pipeline"):
            mesh.mesh_from_config({"parallel": {"pipe": 2}})
        m.setattr(mesh, "rank", lambda: 3)
        m.setattr(mesh, "tensor_size", lambda: 2)
        assert (mesh.dp_size(), mesh.dp_rank(), mesh.tensor_rank()) == (
            2, 1, 1)


def test_to_torch_matches_jax_export(slice_setup, tmp_path):  # noqa: F811
    """`python -m xfm_tpu_torch.convert_checkpoint to-torch` of a
    `state.pt` holding the JAX package's weights: every entry that the
    JAX package's `export_xfm_checkpoint` writes of the same weights, by
    name and value; a directory and its state.pt convert alike."""
    import yaml

    from xfm_tpu.train.checkpoint import export_xfm_checkpoint
    from xfm_tpu_torch import convert_checkpoint
    from xfm_tpu_torch.configs import retrieval_eval_yaml
    from xfm_tpu_torch.train.checkpoint import state_dict_from_jax

    s = slice_setup
    params = state_dict_from_jax(s["params"], s["jcfg"])
    step = tmp_path / "ckpt" / "7"
    step.mkdir(parents=True)
    torch.save({"params": params, "optimizer": {}, "step": 7},
               step / "state.pt")
    cfg = retrieval_eval_yaml(image_res=64, layers=2, vision_embed_dim=64,
                              vision_num_heads=2, text_hidden_size=64,
                              text_num_attention_heads=2,
                              text_intermediate_size=128,
                              text_vocab_size=99, embed_dim=32)
    cfg = {k: v for k, v in cfg.items() if k != "_vision"}
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(cfg))
    got = convert_checkpoint.main(["to-torch", str(tmp_path / "ckpt"),
                                   str(tmp_path / "out.th"), "--config",
                                   str(tmp_path / "c.yaml")])
    want = export_xfm_checkpoint(jax.tree.map(np.asarray, s["params"]),
                                 s["jcfg"])
    assert set(want) <= set(got)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    saved = torch.load(tmp_path / "out.th", weights_only=True)
    assert set(saved) == set(got)
    again = convert_checkpoint.to_torch(str(step / "state.pt"),
                                        str(tmp_path / "b.th"),
                                        str(tmp_path / "c.yaml"))
    assert all(torch.equal(again[k], got[k]) for k in got)


def test_to_torch_writes_a_deep_classifier_head(tmp_path):
    """The ImageNet classifier's `DeepMLPHead` goes out as `cls_head.{0,
    1, 3, 4, 6, 7, 9, 10, 12}`, which `load_xfm_checkpoint` reads back
    into a fresh model bit for bit. The JAX package's
    `export_xfm_checkpoint` writes any `cls_head` as an `MLPHead` and
    raises on a deep one (ROADMAP.md Queue 3B)."""
    import yaml

    from xfm_tpu.train.checkpoint import export_xfm_checkpoint
    from xfm_tpu_torch import convert_checkpoint
    from xfm_tpu_torch.train.checkpoint import (init_weights,
                                                load_torch_state_dict,
                                                load_xfm_checkpoint)

    model = mp.task_model("imagenet")
    init_weights(model, 4)
    torch.save({"params": dict(model.named_parameters()), "optimizer": {},
                "step": 0}, tmp_path / "state.pt")
    cfg = {k: v for k, v in mp.task_yaml("imagenet").items()
           if k != "_vision"}
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(cfg))
    sd = convert_checkpoint.to_torch(str(tmp_path / "state.pt"),
                                     str(tmp_path / "out.th"),
                                     str(tmp_path / "c.yaml"))
    heads = sorted({int(k.split(".")[1]) for k in sd
                    if k.startswith("cls_head.")})
    assert heads == [0, 1, 3, 4, 6, 7, 9, 10, 12]
    fresh = mp.task_model("imagenet")
    init_weights(fresh, 5)
    missing, _ = load_xfm_checkpoint(
        fresh, load_torch_state_dict(str(tmp_path / "out.th")))
    for n, p in fresh.named_parameters():
        assert torch.equal(p, dict(model.named_parameters())[n]), n
    deep = {f"{kind}{i}": {"kernel": np.zeros((4, 4), np.float32),
                           "bias": np.zeros(4, np.float32)}
            for i in range(4) for kind in ("fc",)}
    deep.update({f"ln{i}": {"scale": np.ones(4, np.float32),
                            "bias": np.zeros(4, np.float32)}
                 for i in range(4)})
    deep["out"] = {"kernel": np.zeros((4, 5), np.float32),
                   "bias": np.zeros(5, np.float32)}
    with pytest.raises(KeyError):
        export_xfm_checkpoint({"cls_head": deep}, None)
