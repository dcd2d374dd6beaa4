"""`XFM_SHARED_CROSS_KV`: the switch that forces the ITM negative pass's
cross k/v to be projected once per unique image and gathered per row ("1")
or projected from the gathered image rows ("0"); unset, the shared form is
taken from 577 image tokens (`xfm_tpu/models/xfm.py` `get_matching_loss`).

For each setting and at N = 577 (384 px) and N = 197 (224 px), the port's
ITM and ITC losses and every gradient against the JAX package under the same
switch, on the CLIP retrieval slice at a tiny size (1 layer an encoder,
width 64, 1 head, B = 4, T = 8, f32; at 384 px the tower's attention takes
K3's dispatch, the JAX Pallas kernel in interpret mode as in
`tests/test_torch_clip_retrieval.py`). The unset switch gives bit for bit
what the length rule's form gives. Tolerances are that module's: losses
rtol 1e-4; gradients rtol 1e-3 / atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.configs import (batch_to_torch, make_retrieval_batch,
                                   xfm_clip_retrieval_config)
from xfm_tpu_torch.models import XFMForRetrieval
from xfm_tpu_torch.models.xfm import shared_cross_kv
from xfm_tpu_torch.train.checkpoint import state_dict_from_jax
from xfm_tpu_torch.train.train_state import retrieval_loss_fn

KW = dict(hidden=64, layers=1, heads=1, inter=128, vocab=99)
B, T = 4, 8
NEG = (np.array([1, 2, 3, 0]), np.array([2, 3, 0, 1]))
SWITCH = "XFM_SHARED_CROSS_KV"


def _yaml_config(res):
    return {"use_clip_vit": True, "image_res": res, "patch_size": 16,
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


@pytest.fixture(scope="module", params=[384, 224])
def setup(request):
    """JAX params and, for each forced setting, the JAX losses and
    gradients at one resolution."""
    import xfm_tpu.models.losses as jlosses
    import xfm_tpu.ops.attention as jattn
    import xfm_tpu.ops.flash_attention as jfa
    from xfm_tpu.models.task_models import XFMForRetrieval as JRetrieval
    from xfm_tpu.models.xfm import config_from_yaml

    res = request.param
    real_flash = jfa.flash_attention
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_EXACT_ERF", "1")
        mp.setattr(jattn, "_flash_ok", lambda q, k, rate, det:
                   q.shape[1] >= 512 and k.shape[1] >= 512)
        mp.setattr(jfa, "flash_attention",
                   lambda q, k, v, bias=None, scale=None, interpret=True:
                   real_flash(q, k, v, bias, scale, True))
        mp.setattr(jlosses, "hard_negative_indices",
                   lambda *a, **k: tuple(jnp.asarray(n) for n in NEG))
        jcfg = config_from_yaml(_yaml_config(res), use_contrastive_loss=True,
                                use_matching_loss=True, dtype=jnp.float32)
        jm = JRetrieval(jcfg)
        nb = make_retrieval_batch(B, T, res, KW["vocab"])
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

        def loss(p):
            itc, itm = jm.apply({"params": p}, *jb, deterministic=True,
                                rngs={"hardneg": jax.random.PRNGKey(0)})
            return itc + itm, (itc, itm)

        want = {}
        for setting in ("0", "1"):  # read while jit traces: one jit each
            mp.setenv(SWITCH, setting)
            (_, (itc, itm)), g = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(params)
            want[setting] = (float(itc), float(itm), state_dict_from_jax(
                jax.tree.map(np.asarray, g), jcfg))
        yield dict(res=res, jcfg=jcfg, nb=nb, params=params, want=want)


def _port_run(s, monkeypatch, setting):
    """Losses and gradients of the port under `setting` ("0", "1" or None
    for unset), and the image_row_idx each fusion pass was given."""
    if setting is None:
        monkeypatch.delenv(SWITCH, raising=False)
    else:
        monkeypatch.setenv(SWITCH, setting)
    cfg = xfm_clip_retrieval_config(image_res=s["res"], dtype=torch.float32,
                                    fused_ln=False, fused_mlp=False, **KW)
    model = XFMForRetrieval(cfg)
    model.load_state_dict(state_dict_from_jax(s["params"], s["jcfg"]),
                          strict=True)
    row_idx = []
    real = model.get_cross_embeds

    def spy(*args, image_row_idx=None, **kw):
        row_idx.append(image_row_idx)
        return real(*args, image_row_idx=image_row_idx, **kw)

    monkeypatch.setattr(model, "get_cross_embeds", spy)
    batch = batch_to_torch(s["nb"], "cpu")
    batch["hard_negatives"] = tuple(torch.from_numpy(n) for n in NEG)
    total, out = retrieval_loss_fn(model, batch)
    total.backward()
    grads = {n: p.grad.clone() if p.grad is not None else None
             for n, p in model.named_parameters()}
    return out, grads, row_idx


@pytest.mark.parametrize("setting", ["0", "1"])
def test_forced_form_matches_jax_under_the_same_switch(setup, monkeypatch,
                                                       setting):
    out, grads, row_idx = _port_run(setup, monkeypatch, setting)
    # the positive pass never gathers; the negative pass as forced
    assert row_idx[0] is None
    assert (row_idx[1] is not None) == (setting == "1")
    itc, itm, want = setup["want"][setting]
    np.testing.assert_allclose(out["loss_itm"].item(), itm, rtol=1e-4)
    np.testing.assert_allclose(out["loss_itc"].item(), itc, rtol=1e-4)
    for name, g in grads.items():
        got = g.numpy() if g is not None else np.zeros(want[name].shape)
        np.testing.assert_allclose(got, want[name].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)


def test_unset_switch_keeps_the_length_rule(setup, monkeypatch):
    n_tokens = (setup["res"] // 16) ** 2 + 1
    rule = "1" if n_tokens >= 577 else "0"
    out, grads, row_idx = _port_run(setup, monkeypatch, None)
    assert (row_idx[1] is not None) == (rule == "1")
    ref_out, ref_grads, _ = _port_run(setup, monkeypatch, rule)
    for k in ("loss_itc", "loss_itm"):
        assert out[k].item() == ref_out[k].item(), k
    for name, g in grads.items():
        if g is None:
            assert ref_grads[name] is None, name
        else:
            assert torch.equal(g, ref_grads[name]), name


@pytest.mark.parametrize("env,n,want", [
    (None, 577, True), (None, 901, True), (None, 197, False),
    ("1", 197, True), ("0", 577, False), ("0", 197, False),
    ("1", 577, True),
])
def test_shared_cross_kv_reads_the_switch(monkeypatch, env, n, want):
    if env is None:
        monkeypatch.delenv(SWITCH, raising=False)
    else:
        monkeypatch.setenv(SWITCH, env)
    assert shared_cross_kv(n) is want
