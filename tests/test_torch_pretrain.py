"""The whole slice: XFMForPretrain losses and gradients, three optimizer
steps, the optimizer's decay/boost sets and the weight bridge, each against
the JAX package at a small size (2 layers, width 64, 64 px images).

Both sides run f32 (JAX matmuls at 'highest' precision) on the same
weights, batch and hard negatives (the JAX draw is replaced by fixed
indices; the port takes them as `hard_negatives`). Tolerances: losses
rtol 1e-4; gradients and parameters after 3 steps rtol 1e-3 / atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.configs import (batch_to_torch, make_batch,
                                   xfm_base_pretrain_config)
from xfm_tpu_torch.models import XFMForPretrain
from xfm_tpu_torch.train.checkpoint import state_dict_from_jax
from xfm_tpu_torch.train.optim import boosted, create_optimizer, decays
from xfm_tpu_torch.train.schedules import linear_warmup_decay
from xfm_tpu_torch.train.train_state import (TrainState, make_train_step,
                                             pretrain_loss_fn)

KW = dict(hidden=64, layers=2, heads=2, inter=128, image_res=64, vocab=99)
B, T, M = 4, 8, 3
NEG = (np.array([1, 2, 3, 0]), np.array([2, 3, 0, 1]))
LOSSES = ("loss_itc", "loss_itm", "loss_mlm", "loss_mim")
LR, STEPS = 1e-3, 3


@pytest.fixture(scope="module")
def slice_setup():
    import xfm_tpu.models.losses as jlosses
    from __graft_entry__ import _batch, _loss_fn, _xfm_config
    from xfm_tpu.models import XFMForPretrain as JPretrain

    jcfg = _xfm_config(dtype=jnp.float32, **KW)
    jb = _batch(B, T, M, 64, 16, 99)
    jm = JPretrain(jcfg)
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jb["images"], jb["text_ids"],
        jb["text_atts"], method=JPretrain.init_all)["params"])()
    r = np.random.RandomState(0)
    leaves, tree = jax.tree.flatten(params)
    params = jax.tree.unflatten(tree, [
        np.asarray(x) + 0.02 * np.asarray(r.randn(*x.shape), np.float32)
        for x in leaves])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlosses, "hard_negative_indices",
                   lambda *a, **k: tuple(jnp.asarray(n) for n in NEG))
        yield dict(jcfg=jcfg, jb=jb, jm=jm, params=params,
                   loss_fn=_loss_fn(jm))


def _port_model(setup):
    tcfg = xfm_base_pretrain_config(dtype=torch.float32, **KW)
    model = XFMForPretrain(tcfg)
    model.load_state_dict(state_dict_from_jax(setup["params"],
                                              setup["jcfg"]), strict=True)
    return model


def _port_batch():
    batch = batch_to_torch(make_batch(B, T, M, 64, 16, 99), "cpu")
    batch["hard_negatives"] = tuple(torch.from_numpy(n) for n in NEG)
    return batch


def test_pretrain_losses_and_grads_match_jax(slice_setup):
    s = slice_setup
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        lambda p: s["loss_fn"](p, s["jb"], jax.random.PRNGKey(0)),
        has_aux=True))(s["params"])
    model = _port_model(s)
    total, out = pretrain_loss_fn(model, _port_batch())
    total.backward()
    for k in LOSSES:
        np.testing.assert_allclose(out[k].item(), float(jout[k]), rtol=1e-4,
                                   err_msg=k)
    assert out["loss_bbox"].item() == 0.0 and out["loss_giou"].item() == 0.0
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), s["jcfg"])
    for name, p in model.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        np.testing.assert_allclose(got, want[name].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)


def test_three_optimizer_steps_match_jax(slice_setup):
    """make_train_step + HF-AdamW (clip 1.0, decay 0.01 on the name-list
    set, lr_mult 2 on the heads, linear schedule) against optax.

    Key biases get an analytically zero gradient (softmax is invariant to a
    per-row shift); Adam normalizes their f32 noise into moves of up to
    ~lr per step, so they are held to atol = lr·steps instead."""
    from xfm_tpu.train.optim import create_optimizer as jcreate
    from xfm_tpu.train.schedules import linear_warmup_decay as jsched
    from xfm_tpu.train.train_state import TrainState as JState

    s = slice_setup
    jparams = jax.tree.map(jnp.asarray, s["params"])
    jstate = JState.create(jparams, jcreate(jparams, jsched(LR, 10, 0),
                                            weight_decay=0.01, lr_mult=2.0))

    @jax.jit
    def jstep(state):
        (loss, _), g = jax.value_and_grad(
            lambda p: s["loss_fn"](p, s["jb"], jax.random.PRNGKey(0)),
            has_aux=True)(state.params)
        return state.apply_gradients(g), loss

    model = _port_model(s)
    state = TrainState.create(model, create_optimizer(
        model, linear_warmup_decay(LR, 10, 0), weight_decay=0.01,
        lr_mult=2.0))
    step = make_train_step(pretrain_loss_fn)
    batch = _port_batch()
    for _ in range(STEPS):
        jstate, jloss = jstep(jstate)
        state, metrics = step(state, batch)
        loss = metrics["loss"]
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    assert state.step == STEPS and state.optimizer.count == STEPS
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params),
                               s["jcfg"])
    for name, p in model.named_parameters():
        atol = LR * STEPS if name.endswith("self.key.bias") else 1e-5
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=atol, err_msg=name)


@pytest.mark.parametrize("total,warmup", [(20, 5), (20, 0.25), (10, 0)])
def test_linear_warmup_decay_matches_jax(total, warmup):
    from xfm_tpu.train.schedules import linear_warmup_decay as jsched

    ours, theirs = linear_warmup_decay(LR, total, warmup), jsched(LR, total,
                                                                  warmup)
    for step in range(total + 3):  # rtol: JAX computes it in f32
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   rtol=1e-6, err_msg=str(step))


def _mask_by_name(setup, mask_tree):
    full = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m)),
                        mask_tree, setup["params"])
    sd = state_dict_from_jax(full, setup["jcfg"])
    return {k: bool(v.reshape(-1)[0]) for k, v in sd.items()}


def test_decay_and_boost_sets_match_jax(slice_setup):
    from xfm_tpu.train.optim import boost_mask, decay_mask

    s = slice_setup
    jdecay = _mask_by_name(s, decay_mask(s["params"]))
    jboost = _mask_by_name(s, boost_mask(s["params"]))
    names = [n for n, _ in _port_model(s).named_parameters()]
    assert sorted(names) == sorted(
        k for k in jdecay if not k.endswith("lm_head.decoder.weight")
        and not k.endswith("lm_head.decoder.bias"))
    assert {n: decays(n) for n in names} == {n: jdecay[n] for n in names}
    assert {n: boosted(n) for n in names} == {n: jboost[n] for n in names}


def test_state_dict_from_jax_equals_export(slice_setup):
    from xfm_tpu.train.checkpoint import export_xfm_checkpoint

    from xfm_tpu_torch.ops.patch_embed import patch_kernel_from_conv

    s = slice_setup
    ours = state_dict_from_jax(s["params"], s["jcfg"])
    ref = export_xfm_checkpoint(s["params"], s["jcfg"])
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        v = torch.from_numpy(np.asarray(v))
        if k.endswith("patch_embed.proj.weight"):  # Conv2d → matmul layout
            v = patch_kernel_from_conv(v)
        assert torch.equal(ours[k], v), k
