"""The pretrain slice with both fused routes on (`XFM_FUSED_LN=1`,
`XFM_MLP_FUSED=1` in the JAX package; `fused_ln=True, fused_mlp=True` in the
port): XFMForPretrain losses, every gradient and three optimizer steps
against the JAX package at a small size (2 layers, width 128 so that
C % 128 = 0, 64 px images, f32).

The JAX package takes those routes only on a TPU. For this module's
duration its predicates are widened to the CPU and its Pallas kernels run
in interpret mode (`fused_ln._on_tpu`, `_HAS_PALLAS`, `_fwd_pallas`,
`_bwd_pallas`; `fused_mlp.fused_mlp_ok`, `act_dense`); nothing in
`xfm_tpu/` changes. The port runs the plain versions of K4 and K5 through
their autograd Functions, counted here by spies. Tolerances are those of
`tests/test_torch_pretrain.py`: losses rtol 1e-4; gradients and parameters
after 3 steps rtol 1e-3 / atol 1e-5 (key biases atol lr·steps).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch import configs
from xfm_tpu_torch.configs import (batch_to_torch, make_batch,
                                   xfm_base_pretrain_config)
from xfm_tpu_torch.models import XFMForPretrain
from xfm_tpu_torch.ops import fused_ln as fl
from xfm_tpu_torch.ops import fused_mlp as fm
from xfm_tpu_torch.train.checkpoint import state_dict_from_jax
from xfm_tpu_torch.train.optim import create_optimizer
from xfm_tpu_torch.train.schedules import linear_warmup_decay
from xfm_tpu_torch.train.train_state import (TrainState, make_train_step,
                                             pretrain_loss_fn)

KW = dict(hidden=128, layers=2, heads=2, inter=256, image_res=64, vocab=99)
B, T, M = 4, 8, 3
NEG = (np.array([1, 2, 3, 0]), np.array([2, 3, 0, 1]))
LOSSES = ("loss_itc", "loss_itm", "loss_mlm", "loss_mim")
LR, STEPS = 1e-3, 3


@pytest.fixture(scope="module")
def slice_setup():
    import xfm_tpu.models.losses as jlosses
    import xfm_tpu.ops.fused_ln as jfl
    import xfm_tpu.ops.fused_mlp as jmlp
    from __graft_entry__ import _batch, _loss_fn, _xfm_config
    from xfm_tpu.models import XFMForPretrain as JPretrain

    jfl_fwd, jfl_bwd = jfl._fwd_pallas, jfl._bwd_pallas
    traced = {}  # the JAX kernels' calls while jit traces, by name

    def interpreted(name, fn):
        def call(*args, interpret=False):
            traced[name] = traced.get(name, 0) + 1
            return fn(*args, interpret=True)
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_FUSED_LN", "1")
        mp.setattr(jfl, "_on_tpu", lambda: True)
        mp.setattr(jfl, "_HAS_PALLAS", True)
        mp.setattr(jfl, "_fwd_pallas",
                   lambda x, y, g, b, eps, interpret: interpreted(
                       "ln_fwd", jfl_fwd)(x, y, g, b, eps))
        mp.setattr(jfl, "_bwd_pallas",
                   lambda xn, dh, dxn, g, eps, interpret: interpreted(
                       "ln_bwd", jfl_bwd)(xn, dh, dxn, g, eps))
        mp.setattr(jmlp, "fused_mlp_ok", lambda: True)
        mp.setattr(jmlp, "act_dense", interpreted("act_dense",
                                                  jmlp.act_dense))
        mp.setattr(jlosses, "hard_negative_indices",
                   lambda *a, **k: tuple(jnp.asarray(n) for n in NEG))
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
        traced.clear()  # count the loss's trace only, not init's
        loss_fn = _loss_fn(jm)
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, jb, jax.random.PRNGKey(0)), has_aux=True))
        yield dict(jcfg=jcfg, params=params, grad_fn=grad_fn,
                   traced=traced)


def _port_model(setup, **flags):
    tcfg = xfm_base_pretrain_config(dtype=torch.float32,
                                    **{"fused_ln": True, "fused_mlp": True,
                                       **flags}, **KW)
    model = XFMForPretrain(tcfg)
    model.load_state_dict(state_dict_from_jax(setup["params"],
                                              setup["jcfg"]), strict=True)
    return model


def _port_batch():
    batch = batch_to_torch(make_batch(B, T, M, 64, 16, 99), "cpu")
    batch["hard_negatives"] = tuple(torch.from_numpy(n) for n in NEG)
    return batch


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the plain K4/K5 calls the port's Functions make."""
    counts = {}

    def spy(module, name):
        real = getattr(module, name)

        def counted(*args):
            counts[name] = counts.get(name, 0) + 1
            return real(*args)
        monkeypatch.setattr(module, name, counted)

    for name in ("fused_ln_reference", "fused_ln_bwd_reference"):
        spy(fl, name)
    for name in ("act_matmul_reference", "act_matmul_bwd_reference"):
        spy(fm, name)
    return counts


def test_fused_pretrain_losses_and_grads_match_jax(slice_setup, plain_calls):
    s = slice_setup
    (_, jout), jgrads = s["grad_fn"](s["params"])
    # the JAX side went through its Pallas kernels at every site
    assert s["traced"] == {"ln_fwd": 16, "ln_bwd": 12, "act_dense": 8}
    model = _port_model(s)
    total, out = pretrain_loss_fn(model, _port_batch())
    total.backward()
    for k in LOSSES:
        np.testing.assert_allclose(out[k].item(), float(jout[k]), rtol=1e-4,
                                   err_msg=k)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), s["jcfg"])
    for name, p in model.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        np.testing.assert_allclose(got, want[name].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    # per step, with L = 2 layers a tower: K4 forward in the vision blocks
    # (L), the clean and the masked text pass (2 · 2L) and the fusion pass
    # (3L); backward the same less the detached masked pass. K5 forward L +
    # 2L + L, backward L + L + L.
    assert plain_calls == {"fused_ln_reference": 16,
                           "fused_ln_bwd_reference": 12,
                           "act_matmul_reference": 8,
                           "act_matmul_bwd_reference": 6}


def test_fused_pretrain_three_optimizer_steps_match_jax(slice_setup):
    """make_train_step + HF-AdamW with both fused routes against optax on
    the JAX package's fused routes (`test_torch_pretrain`'s settings)."""
    from xfm_tpu.train.optim import create_optimizer as jcreate
    from xfm_tpu.train.schedules import linear_warmup_decay as jsched
    from xfm_tpu.train.train_state import TrainState as JState

    s = slice_setup
    jparams = jax.tree.map(jnp.asarray, s["params"])
    jstate = JState.create(jparams, jcreate(jparams, jsched(LR, 10, 0),
                                            weight_decay=0.01, lr_mult=2.0))
    model = _port_model(s)
    state = TrainState.create(model, create_optimizer(
        model, linear_warmup_decay(LR, 10, 0), weight_decay=0.01,
        lr_mult=2.0))
    step = make_train_step(pretrain_loss_fn)
    batch = _port_batch()
    for _ in range(STEPS):
        (jloss, _), g = s["grad_fn"](jstate.params)
        jstate = jstate.apply_gradients(g)
        state, metrics = step(state, batch)
        loss = metrics["loss"]
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params),
                               s["jcfg"])
    for name, p in model.named_parameters():
        atol = LR * STEPS if name.endswith("self.key.bias") else 1e-5
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=atol, err_msg=name)


def test_flags_off_never_reach_the_fused_ops(slice_setup, plain_calls):
    model = _port_model(slice_setup, fused_ln=False, fused_mlp=False)
    total, _ = pretrain_loss_fn(model, _port_batch())
    total.backward()
    assert plain_calls == {}


@pytest.mark.parametrize("env,arg,want", [
    ({}, None, False),
    ({"XFM_FUSED_LN": "1", "XFM_MLP_FUSED": "1"}, None, True),
    ({"XFM_FUSED_LN": "0", "XFM_MLP_FUSED": "0"}, None, False),
    ({"XFM_FUSED_LN": "1", "XFM_MLP_FUSED": "1"}, False, False),
    ({}, True, True),
])
def test_config_flags_default_to_the_jax_environment_switches(
        monkeypatch, env, arg, want):
    for name in ("XFM_FUSED_LN", "XFM_MLP_FUSED"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cfg = configs.xfm_base_pretrain_config(layers=1, fused_ln=arg,
                                           fused_mlp=arg)
    for c in (cfg.vision, cfg.text, cfg.fusion):
        assert c.fused_ln is want and c.fused_mlp is want
