"""The fine-tune's training modules against the JAX package's: the
config-driven schedule (`train/schedules.py`), the config-driven optimizer
(`train/optim.py`, clip only with `accelerator.CLIP_GRAD_NORM`), gradient
accumulation (`train/train_state.py`), `MetricLogger` (`train/metrics.py`),
the checkpoint's save → restore round trip (`train/checkpoint.py`), and the
reference's six-step training trajectories (`tests/test_trajectory_golden.py`
ported: `tests/fixtures/golden_trajectory.npz`).

Tolerances: the schedules rtol 1e-6 or atol 1e-7·lr (JAX computes them in
f32, so near the cosine's end its rounding is ~1e-7 of lr); the
optimizer's parameters after 3 steps rtol 1e-6 / atol 1e-8 (f32, the same
gradients on both sides; 1e-8 is about 3 f32 ulps at the weights' 0.04,
which the two update orders leave on weights passing near 0); accumulation's metrics and parameters rtol 1e-6
/ atol 1e-7; the averages exact; the round trip bit-equal; the
trajectories at the JAX test's rtol 1e-4 / atol 5e-5 for the losses and
rtol 5e-3 / atol 1e-3 for the pre-clip gradient norms.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from xfm_tpu_torch.configs import xfm_base_pretrain_config
from xfm_tpu_torch.models import XFMForPretrain
from xfm_tpu_torch.train import checkpoint as ck
from xfm_tpu_torch.train.metrics import MetricLogger, SmoothedValue
from xfm_tpu_torch.train.optim import (create_optimizer,
                                       create_optimizer_from_config)
from xfm_tpu_torch.train.schedules import (linear_warmup_decay,
                                           schedule_from_config)
from xfm_tpu_torch.train.train_state import (TrainState,
                                             make_accum_train_step,
                                             make_train_step)
from xfm_tpu_torch.train.checkpoint import state_dict_from_jax

SCHEDULES = [
    dict(sched="linear", lr=3e-5, epochs=10, num_warmup_steps=0.1),
    dict(sched="linear", lr=1e-4, num_training_steps=40,
         num_warmup_steps=7),
    dict(sched="cosine", lr=1e-3, min_lr=1e-5, epochs=5, warmup_epochs=1),
    dict(sched="cosine", lr=2e-4, epochs=3),
]


@pytest.mark.parametrize("sch", SCHEDULES)
def test_schedule_from_config_matches_jax(sch):
    from xfm_tpu.train.schedules import schedule_from_config as jsched

    spe = 6
    ours, theirs = (schedule_from_config({"schedular": sch}, spe),
                    jsched({"schedular": sch}, spe))
    total = sch.get("num_training_steps", sch.get("epochs", 1) * spe)
    for step in range(total + 3):
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   rtol=1e-6, atol=1e-7 * sch["lr"],
                                   err_msg=str(step))


def test_schedule_from_config_rejects():
    with pytest.raises(ValueError, match="steps_per_epoch"):
        schedule_from_config({"schedular": {"epochs": 2}})
    with pytest.raises(NotImplementedError):
        schedule_from_config({"schedular": {"sched": "step"}}, 4)


# --- the config-driven optimizer on a small XFM ---------------------------

KW = dict(hidden=64, layers=2, heads=2, inter=128, image_res=64, vocab=99)


@pytest.fixture(scope="module")
def small():
    from __graft_entry__ import _xfm_config
    from xfm_tpu.models import XFMForPretrain as JPretrain

    jcfg = _xfm_config(dtype=jnp.float32, **KW)
    jm = JPretrain(jcfg)
    ids = jnp.ones((2, 8), jnp.int32)
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 64, 64, 3)), ids,
        ids, method=JPretrain.init_all)["params"])()
    r = np.random.RandomState(0)
    leaves, tree = jax.tree.flatten(params)
    params = jax.tree.unflatten(tree, [
        np.asarray(x) + 0.02 * np.asarray(r.randn(*x.shape), np.float32)
        for x in leaves])
    grads = [jax.tree.unflatten(tree, [
        np.asarray(0.3 * r.randn(*np.shape(x)), np.float32)
        for x in leaves])
        for _ in range(3)]
    return dict(jcfg=jcfg, params=params, grads=grads)


def _port_model(s):
    model = XFMForPretrain(xfm_base_pretrain_config(dtype=torch.float32,
                                                    **KW))
    model.load_state_dict(state_dict_from_jax(s["params"], s["jcfg"]),
                          strict=True)
    return model


@pytest.mark.parametrize("clip", [None, 1.0])
def test_optimizer_from_config_matches_optax(small, clip):
    """3 steps of the same gradients (global norm ≈ 40, so a clip of 1.0
    engages) through each package's `create_optimizer_from_config` on the
    YAML blocks (decay 0.02, lr_mult 2, linear schedule with warmup)."""
    from xfm_tpu.train.optim import create_optimizer_from_config as jcreate
    from xfm_tpu.train.schedules import schedule_from_config as jsched

    config = {"optimizer": {"opt": "adamW", "lr": 1e-3,
                            "weight_decay": 0.02, "lr_mult": 2},
              "schedular": {"sched": "linear", "lr": 1e-3, "epochs": 2,
                            "num_warmup_steps": 0.25},
              "accelerator": ({"RNG_SEED": 42} if clip is None else
                              {"RNG_SEED": 42, "CLIP_GRAD_NORM": clip})}
    jp = jax.tree.map(jnp.asarray, small["params"])
    tx = jcreate(jp, config, jsched(config, 3))
    st = tx.init(jp)
    model = _port_model(small)
    opt = create_optimizer_from_config(model, config,
                                       schedule_from_config(config, 3))
    assert opt.clip_grad_norm == clip
    assert (opt.weight_decay, opt.lr_mult) == (0.02, 2)
    named = dict(model.named_parameters())
    for g in small["grads"]:
        upd, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)
        tg = state_dict_from_jax(g, small["jcfg"])
        for name, p in named.items():
            p.grad = tg[name].clone()
        g_norm = opt.step()
        np.testing.assert_allclose(g_norm.item(), float(
            optax.global_norm(g)), rtol=1e-6)
    assert g_norm.item() > 1.0  # so the clip case clips
    want = state_dict_from_jax(jax.tree.map(np.asarray, jp), small["jcfg"])
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=name)


# --- accumulation ----------------------------------------------------------

def _lin_batches(seed, k):
    r = np.random.RandomState(seed)
    return [dict(x=r.randn(5, 4).astype(np.float32),
                 y=r.randn(5, 3).astype(np.float32)) for _ in range(k)]


def test_accumulation_matches_jax():
    """K = 2 micro-batches a step, 2 steps, on a linear model: the loss and
    aux means, the norm of the averaged gradient and the parameters."""
    from xfm_tpu.train.optim import create_optimizer as jcreate
    from xfm_tpu.train.train_state import TrainState as JState
    from xfm_tpu.train.train_state import make_accum_train_step as jaccum

    r = np.random.RandomState(1)
    w = r.randn(4, 3).astype(np.float32)
    b = r.randn(3).astype(np.float32)

    def jloss(params, batch, rng):
        pred = batch["x"] @ params["dense"]["kernel"] + params["dense"]["bias"]
        err = jnp.mean((pred - batch["y"]) ** 2)
        return err, {"abs": jnp.mean(jnp.abs(pred))}

    jp = {"dense": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}
    jstate = JState.create(jp, jcreate(jp, 1e-2, weight_decay=0.01,
                                       clip_grad_norm=None))
    jstep = jaccum(jloss, 2, donate=False)

    model = torch.nn.Module()
    model.dense = torch.nn.Linear(4, 3)
    with torch.no_grad():
        model.dense.weight.copy_(torch.from_numpy(w.T))
        model.dense.bias.copy_(torch.from_numpy(b))

    def loss_fn(m, batch, generator):
        pred = m.dense(batch["x"])
        return (torch.mean((pred - batch["y"]) ** 2),
                {"abs": torch.mean(torch.abs(pred))})

    state = TrainState.create(model, create_optimizer(
        model, 1e-2, weight_decay=0.01, clip_grad_norm=None))
    step = make_accum_train_step(loss_fn, 2)
    for s in range(2):
        mbs = _lin_batches(s, 2)
        stacked = {k: jnp.stack([jnp.asarray(m[k]) for m in mbs])
                   for k in mbs[0]}
        jstate, jm = jstep(jstate, stacked, jax.random.PRNGKey(0))
        state, m = step(state, [{k: torch.from_numpy(v) for k, v in
                                 mb.items()} for mb in mbs])
        for k in ("loss", "abs", "grad_norm"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    assert state.step == 2 and state.optimizer.count == 2
    np.testing.assert_allclose(model.dense.weight.detach().numpy().T,
                               np.asarray(jstate.params["dense"]["kernel"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(model.dense.bias.detach().numpy(),
                               np.asarray(jstate.params["dense"]["bias"]),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="micro-batches"):
        step(state, [mbs[0]])


# --- MetricLogger ------------------------------------------------------------

def test_metric_logger_matches_jax(capsys):
    from xfm_tpu.train.metrics import MetricLogger as JLogger

    r = np.random.RandomState(2)
    ours, theirs = MetricLogger(), JLogger()
    for _ in range(30):
        vals = dict(loss=float(r.rand()), lr=float(r.rand() * 1e-4))
        ours.update(**{**vals, "loss": torch.tensor(vals["loss"],
                                                  dtype=torch.float64)})
        theirs.update(**vals)
    assert ours.global_avg() == theirs.global_avg()
    assert str(ours) == str(theirs)
    assert ours.loss.median == theirs.loss.median
    seen = list(ours.log_every(range(5), 2, header="h", total=5))
    assert seen == list(range(5))
    out = capsys.readouterr().out
    assert "h [0/5]" in out and "h [4/5]" in out and "Total time" in out
    v = SmoothedValue(window_size=3)
    for x in (1.0, 2.0, 3.0, 4.0):
        v.update(x, n=2)
    assert (v.median, v.avg, v.global_avg, v.value) == (3.0, 3.0, 2.5, 4.0)


# --- checkpoint round trip ------------------------------------------------

def _tiny_state(seed):
    model = torch.nn.Module()
    model.a = torch.nn.Linear(5, 4)
    model.norm = torch.nn.LayerNorm(4)
    ck.init_weights(model, seed)
    return TrainState.create(model, create_optimizer(model, 1e-2))


def _steps(state, n, seed):
    step = make_train_step(lambda m, b, g: (m.norm(m.a(b)).pow(2).mean(),
                                            {}))
    r = np.random.RandomState(seed)
    for _ in range(n):
        state, _ = step(state, torch.from_numpy(
            r.randn(3, 5).astype(np.float32)))
    return state


def _snapshot(state):
    opt = state.optimizer
    return ([p.detach().clone() for p in opt.params],
            [t.clone() for t in opt.mu], [t.clone() for t in opt.nu],
            opt.count, state.step)


def test_checkpoint_round_trip_bit_equal(tmp_path):
    """save → another state trained elsewhere → restore: parameters,
    moments, count and step bit-equal; `keep` deletes the oldest steps;
    `latest_step` and the parameters-only load."""
    state = _steps(_tiny_state(0), 3, 0)
    want = _snapshot(state)
    d = str(tmp_path / "ckpt")
    for epoch in range(4):
        ck.save_checkpoint(d, state, step=epoch, keep=2)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["2",
                                                                     "3"]
    assert ck.latest_step(d) == 3 and ck.latest_step(str(tmp_path)) is None
    other = _steps(_tiny_state(1), 5, 1)
    other = ck.restore_checkpoint(d, other)
    got = _snapshot(other)
    for w, g in zip(want[:3], got[:3]):
        assert all(torch.equal(a, b) for a, b in zip(w, g))
    assert got[3:] == want[3:] == (3, 3)
    params = ck.load_params_from_checkpoint(d, step=2)
    assert all(torch.equal(params[n], p) for n, p in
               zip(state.optimizer.names, want[0]))
    # nothing saved: the state comes back as it is
    fresh = _tiny_state(2)
    assert ck.restore_checkpoint(str(tmp_path / "none"), fresh) is fresh
    with pytest.raises(FileNotFoundError):
        ck.load_params_from_checkpoint(str(tmp_path / "none"))


def test_restore_refuses_another_model(tmp_path):
    state = _tiny_state(0)
    ck.save_checkpoint(str(tmp_path), state, step=0)
    model = torch.nn.Module()
    model.b = torch.nn.Linear(5, 4)
    other = TrainState.create(model, create_optimizer(model, 1e-2))
    with pytest.raises(KeyError, match="differ"):
        ck.restore_checkpoint(str(tmp_path), other)


# --- the golden training trajectories (tests/test_trajectory_golden.py) ---

@pytest.fixture(scope="module")
def traj():
    from test_torch_golden import TEXT, VISION, _load, load_fixture

    from xfm_tpu_torch.models.beit2 import VisionConfig
    from xfm_tpu_torch.models.text_encoder import TextConfig
    from xfm_tpu_torch.models.xfm import XFMBase, XFMConfig

    sd, io = load_fixture("golden_trajectory.npz")
    cfg = XFMConfig(
        vision=VisionConfig(**VISION),
        text=TextConfig(fusion_layer=4, **TEXT),
        fusion=TextConfig(**{**TEXT, "num_hidden_layers": 2,
                             "fusion_layer": 0}),
        embed_dim=32, temp=0.07, use_contrastive_loss=True,
        use_matching_loss=True, use_mlm_loss=True, use_bbox_loss=True)
    return sd, io, cfg, _load


def _trajectory(traj, which, clip):
    from xfm_tpu_torch.models.xfm import XFMBase

    sd, io, cfg, load = traj
    model = XFMBase(cfg)
    load(model, sd)
    t = {k: torch.from_numpy(np.asarray(io[k])) for k in
         ("ids", "atts", "ids_masked", "masked_pos", "masked_ids", "mask")}
    images = torch.from_numpy(io["image"].transpose(0, 2, 3, 1).copy())

    def loss_fn(m, neg, generator):
        image_embeds = m.get_vision_embeds(images)
        image_atts = torch.ones(image_embeds.shape[:2], dtype=torch.int64)
        text_embeds = m.get_text_embeds(t["ids"], t["atts"])
        image_feat, text_feat = m.get_features(image_embeds, text_embeds)
        total = m.get_contrastive_loss(image_feat, text_feat) + \
            m.get_matching_loss(None, image_embeds, image_atts, image_feat,
                                t["atts"], text_feat, text_embeds,
                                is_pretrain=True,
                                fixed_negatives=(neg[0], neg[1]))
        if which == "pt":
            total = total + m.get_fuse_mlm_loss(
                t["ids_masked"], t["atts"], image_embeds, image_atts,
                t["masked_pos"], t["masked_ids"])
            masked = m.get_vision_embeds(images, mask=t["mask"])
            total = total + m.get_mim_loss(masked, image_embeds, t["mask"])
        return total, {}

    sched = linear_warmup_decay(float(io["lr"]),
                                int(io["num_training_steps"]),
                                int(io["num_warmup_steps"]))
    state = TrainState.create(model, create_optimizer(
        model, sched, weight_decay=float(io["weight_decay"]),
        lr_mult=float(io["lr_mult"]), clip_grad_norm=clip))
    step = make_train_step(loss_fn)
    losses, norms = [], []
    for neg in torch.from_numpy(np.asarray(io["negs"], np.int64)):
        state, m = step(state, neg)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return np.asarray(losses), np.asarray(norms)


def test_finetune_trajectory_matches_reference(traj):
    """ITC + ITM, bare AdamW (no clip), linear schedule: the 6-step loss
    sequence of the reference pipeline."""
    losses, _ = _trajectory(traj, "ft", clip=None)
    np.testing.assert_allclose(losses, traj[1]["ft_losses"], rtol=1e-4,
                               atol=5e-5)
    # warmup starts the lr at 0, so the first two match; then it moves
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    assert abs(losses[-1] - losses[0]) > 1e-3


def test_pretrain_trajectory_matches_reference(traj):
    """ITC + ITM + MLM + MIM with a global-norm clip of 1.0: the losses and
    the pre-clip gradient norms (which cross 1.0, so the clip engages)."""
    losses, norms = _trajectory(traj, "pt", clip=1.0)
    io = traj[1]
    np.testing.assert_allclose(losses, io["pt_losses"], rtol=1e-4,
                               atol=5e-5)
    np.testing.assert_allclose(norms, io["pt_grad_norms"], rtol=5e-3,
                               atol=1e-3)
    assert float(np.max(io["pt_grad_norms"])) > 1.0


def _sync_worker(rank, world, port, out):
    import torch.distributed as dist

    from xfm_tpu_torch.train.metrics import is_main_process

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        log = MetricLogger()
        for v in range(rank + 1):
            log.update(loss=float(10 * rank + v))
        log.synchronize_between_processes()
        out.put((rank, is_main_process(), log.global_avg()))
    finally:
        dist.destroy_process_group()


def test_metric_logger_sums_over_a_process_group():
    """Two processes over gloo: each meter's count and total are summed,
    so both see the global average (0 + 10 + 11) / 3; rank 0 alone is
    the main process."""
    import multiprocessing
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_sync_worker, args=(r, 2, port, out))
             for r in range(2)]
    for p in procs:
        p.start()
    got = sorted(out.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
    assert not any(p.is_alive() for p in procs)
    assert all(p.exitcode == 0 for p in procs)
    assert got == [(0, True, {"loss": 7.0}), (1, False, {"loss": 7.0})]
