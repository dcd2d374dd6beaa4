"""The CLIP retrieval slice with both fused routes on (`XFM_FUSED_LN=1`,
`XFM_MLP_FUSED=1` in the JAX package; `fused_ln` / `fused_mlp` in the
port, given as arguments or read from the same environment switches):
XFMForRetrieval losses and every gradient against the JAX package at 384 px
and a small size (2 layers, width 128 so that C % 128 = 0, 2 heads, B = 4,
T = 8, f32).

The JAX package reads both switches per call, so under them its text and
fusion encoders take K4 (every post-LN site) and K5 (every output.dense)
while the CLIP tower's LNs and quick-GELU MLPs stay plain. Its routes are
taken only on a TPU: for this module's duration the predicates are widened
to the CPU and the Pallas kernels run in interpret mode (as in
`tests/test_torch_pretrain_fused.py`), K3's dispatch too (as in
`tests/test_torch_clip_retrieval.py`); nothing in `xfm_tpu/` changes. The
port runs the plain versions of K4 and K5 through their autograd
Functions, counted here by spies. Tolerances are
`tests/test_torch_clip_retrieval.py`'s: losses rtol 1e-4; gradients rtol
1e-3 / atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch import configs
from xfm_tpu_torch.configs import (batch_to_torch, make_retrieval_batch,
                                   xfm_clip_retrieval_config)
from xfm_tpu_torch.models import XFMForRetrieval
from xfm_tpu_torch.ops import fused_ln as fl
from xfm_tpu_torch.ops import fused_mlp as fm
from xfm_tpu_torch.train.checkpoint import state_dict_from_jax
from xfm_tpu_torch.train.train_state import retrieval_loss_fn
from _torch_threads import one_intra_op_thread  # noqa: F401

KW = dict(hidden=128, layers=2, heads=2, inter=256, vocab=99)
B, T, RES = 4, 8, 384
NEG = (np.array([1, 2, 3, 0]), np.array([2, 3, 0, 1]))
SWITCHES = ("XFM_FUSED_LN", "XFM_MLP_FUSED")
# per step with L = 2 layers an encoder: K4 forward at the text encoder's 2
# post-LNs a layer (2L) and the fusion encoder's 3 in each of the ITM
# positive and negative passes (2 · 3L), all with a backward (the fine-tune
# trains the text encoder through ITC and ITM); K5 at one output.dense a
# layer of the text pass and of both fusion passes (L + 2L)
LAUNCHES = {"fused_ln_reference": 16, "fused_ln_bwd_reference": 16,
            "act_matmul_reference": 6, "act_matmul_bwd_reference": 6}


def _yaml_config():
    """`tests/test_torch_clip_retrieval.py`'s YAML keys, cut to KW."""
    return {"use_clip_vit": True, "image_res": RES, "patch_size": 16,
            "_vision": {"vision_width": KW["hidden"], "patch_size": 16,
                        "hidden_act": "quick_gelu",
                        "num_attention_heads": KW["heads"],
                        "intermediate_size": KW["inter"],
                        "num_hidden_layers": KW["layers"],
                        "local_attn_depth": 4},
            "text_num_hidden_layers": KW["layers"],
            "fusion_num_hidden_layers": KW["layers"],
            "text_hidden_size": KW["hidden"],
            "text_num_attention_heads": KW["heads"],
            "text_intermediate_size": KW["inter"],
            "text_vocab_size": KW["vocab"], "embed_dim": 256, "temp": 0.07}


@pytest.fixture(scope="module")
def slice_setup():
    import xfm_tpu.models.losses as jlosses
    import xfm_tpu.ops.attention as jattn
    import xfm_tpu.ops.flash_attention as jfa
    import xfm_tpu.ops.fused_ln as jfl
    import xfm_tpu.ops.fused_mlp as jmlp
    from xfm_tpu.models.task_models import XFMForRetrieval as JRetrieval
    from xfm_tpu.models.xfm import config_from_yaml

    real_flash = jfa.flash_attention
    jfl_fwd, jfl_bwd = jfl._fwd_pallas, jfl._bwd_pallas
    traced = {}  # the JAX kernels' calls while jit traces, by name

    def interpreted(name, fn):
        def call(*args, interpret=False):
            traced[name] = traced.get(name, 0) + 1
            return fn(*args, interpret=True)
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_EXACT_ERF", "1")
        mp.setenv("XFM_FUSED_LN", "1")
        mp.setattr(jattn, "_flash_ok", lambda q, k, rate, det:
                   q.shape[1] >= 512 and k.shape[1] >= 512)
        mp.setattr(jfa, "flash_attention",
                   lambda q, k, v, bias=None, scale=None, interpret=True:
                   real_flash(q, k, v, bias, scale, True))
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
        jcfg = config_from_yaml(_yaml_config(), use_contrastive_loss=True,
                                use_matching_loss=True, dtype=jnp.float32)
        jm = JRetrieval(jcfg)
        nb = make_retrieval_batch(B, T, RES, KW["vocab"])
        nb["text_atts"][1, -3:] = 0  # one padded caption
        jb = (jnp.asarray(nb["images"]),
              jnp.asarray(nb["text_ids"], jnp.int32),
              jnp.asarray(nb["text_atts"], jnp.int32))
        params = jax.jit(lambda: jm.init(
            {"params": jax.random.PRNGKey(0)}, *jb,
            method=JRetrieval.init_all)["params"])()
        r = np.random.RandomState(0)
        leaves, tree = jax.tree.flatten(params)
        params = jax.tree.unflatten(tree, [
            np.asarray(x) + 0.02 * np.asarray(r.randn(*x.shape), np.float32)
            for x in leaves])
        traced.clear()  # count the loss's trace only, not init's

        def loss(p):
            itc, itm = jm.apply({"params": p}, *jb, deterministic=True,
                                rngs={"hardneg": jax.random.PRNGKey(0)})
            return itc + itm, (itc, itm)

        (_, (jitc, jitm)), jgrads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params)
        yield dict(jcfg=jcfg, nb=nb, params=params, traced=dict(traced),
                   losses=(float(jitc), float(jitm)),
                   grads=state_dict_from_jax(
                       jax.tree.map(np.asarray, jgrads), jcfg))


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


def _port_model(setup, route, monkeypatch):
    """The port's model with both routes on through `route`: "argument"
    (fused_ln=True, fused_mlp=True) or "environment" (the switches set, the
    arguments left None)."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    if route == "argument":
        flags = dict(fused_ln=True, fused_mlp=True)
    else:
        for name in SWITCHES:
            monkeypatch.setenv(name, "1")
        flags = {}
    cfg = xfm_clip_retrieval_config(image_res=RES, dtype=torch.float32,
                                    **flags, **KW)
    for enc in (cfg.text, cfg.fusion):
        assert enc.fused_ln and enc.fused_mlp
    model = XFMForRetrieval(cfg)
    model.load_state_dict(state_dict_from_jax(setup["params"],
                                              setup["jcfg"]), strict=True)
    return model


def _port_batch(setup):
    batch = batch_to_torch(setup["nb"], "cpu")
    batch["hard_negatives"] = tuple(torch.from_numpy(n) for n in NEG)
    return batch


@pytest.mark.parametrize("route", ["argument", "environment"])
def test_fused_clip_losses_and_grads_match_jax(slice_setup, plain_calls,
                                                monkeypatch, route):
    s = slice_setup
    # the JAX side went through its Pallas kernels at every text and
    # fusion site, and at no site of the tower
    assert s["traced"] == {"ln_fwd": 16, "ln_bwd": 16, "act_dense": 6}
    model = _port_model(s, route, monkeypatch)
    total, out = retrieval_loss_fn(model, _port_batch(s))
    total.backward()
    jitc, jitm = s["losses"]
    np.testing.assert_allclose(out["loss_itc"].item(), jitc, rtol=1e-4)
    np.testing.assert_allclose(out["loss_itm"].item(), jitm, rtol=1e-4)
    for name, p in model.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        np.testing.assert_allclose(got, s["grads"][name].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    assert plain_calls == LAUNCHES


def test_the_clip_tower_takes_neither_fused_kernel(slice_setup, plain_calls,
                                                   monkeypatch):
    """The tower alone, forward and backward, with both routes on: no K4
    or K5 call (its LNs and quick-GELU MLPs are plain, as in JAX)."""
    model = _port_model(slice_setup, "argument", monkeypatch)
    images = _port_batch(slice_setup)["images"]
    embeds = model.get_vision_embeds(images)
    embeds.float().sum().backward()
    assert plain_calls == {}
    assert model.vision_encoder.encoder.layers[0].self_attn.q_proj \
        .weight.grad is not None


@pytest.mark.parametrize("env,arg,want", [
    ({}, None, False),
    ({"XFM_FUSED_LN": "1", "XFM_MLP_FUSED": "1"}, None, True),
    ({"XFM_FUSED_LN": "0", "XFM_MLP_FUSED": "0"}, None, False),
    ({"XFM_FUSED_LN": "1", "XFM_MLP_FUSED": "1"}, False, False),
    ({}, True, True),
])
def test_clip_config_flags_default_to_the_jax_environment_switches(
        monkeypatch, env, arg, want):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cfg = configs.xfm_clip_retrieval_config(layers=1, fused_ln=arg,
                                            fused_mlp=arg)
    for c in (cfg.text, cfg.fusion):
        assert c.fused_ln is want and c.fused_mlp is want
    assert not hasattr(cfg.vision, "fused_ln")


def test_make_clip_retrieval_run_takes_the_fused_routes(plain_calls):
    """The entry point passes the flags on: one step at a tiny width."""
    state, batch, step = configs.make_clip_retrieval_run(
        B=2, T=8, device="cpu", hidden=128, layers=1, heads=2, inter=256,
        vocab=99, fused_ln=True, fused_mlp=True)
    state, metrics = step(state, batch, torch.Generator().manual_seed(0))
    loss = metrics["loss"]
    assert torch.isfinite(loss)
    # one layer an encoder: K4 2 (text) + 2 · 3 (fusion), K5 1 + 2
    assert plain_calls == {"fused_ln_reference": 8,
                           "fused_ln_bwd_reference": 8,
                           "act_matmul_reference": 3,
                           "act_matmul_bwd_reference": 3}
