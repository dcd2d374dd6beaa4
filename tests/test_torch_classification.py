"""The classifiers in the port against the JAX package:
`XFMForClassification`'s image, linear-probe, text (and STS-B) and fused
branches and `TextClassifier` (losses, logits, every gradient, the
parameter tree), LARS, and the reference load of a `cls_head`
(`xfm_tpu/models/task_models.py`, `xfm_tpu/train/optim.py`,
`xfm_tpu/train/checkpoint.py`).

Both sides run f32 (JAX at 'highest' precision, exact erf-GELU) on the same
weights, carried across by `state_dict_from_jax`, at text width 64, vision
width 128 (two heads of 64, as the Pallas K1 takes them), 2 layers a tower
and 32 px images; the JAX image tower takes K1 (`flash_attention_packed`)
in interpret mode. Tolerances: losses and logits rtol 1e-5; gradients
within 1e-4 of each tensor's largest value + 1e-7 (the floor is for the
gradients that are zero in exact arithmetic, the key biases', which read
~1e-8 in f32); LARS's updates rtol 1e-6; loaded weights bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.configs import glue_yaml, imagenet_yaml
from xfm_tpu_torch.models import (TextClassifier, XFMForClassification,
                                  config_from_yaml)
from xfm_tpu_torch.train.checkpoint import state_dict_from_jax
from _torch_threads import one_intra_op_thread  # noqa: F401

C, V, RES, NL = 64, 60, 32, 5
SMALL = dict(image_res=RES, vision_embed_dim=2 * C, vision_num_heads=2,
             text_hidden_size=C, text_num_attention_heads=2,
             text_intermediate_size=128, text_vocab_size=V,
             compute_dtype="float32", drop_path_rate=0.0, num_labels=NL)
# the branches: (task_name, is_lp, num_labels, inputs)
BRANCHES = {
    "image": ("imagenet", False, NL, "images"),
    "image_lp": ("imagenet", True, NL, "images"),
    "text": ("glue", False, NL, "text"),
    "text_stsb": ("glue", False, 1, "text"),
    "fused": ("fused", False, NL, "both"),
    "text_classifier": (None, False, NL, "text"),
}


def small_yaml(name: str) -> dict:
    """The branch's YAML: 2 layers a tower (the fused one with its 2-layer
    fusion encoder), width 64, 32 px."""
    if name.startswith("image"):
        return imagenet_yaml(lp=name == "image_lp", layers=2, **SMALL)
    cfg = glue_yaml(layers=2, **SMALL)
    if name == "fused":
        cfg.update(vision_depth=2, fusion_num_hidden_layers=2)
    return cfg


def _inputs(kind: str, B=3, T=7, seed=0):
    r = np.random.RandomState(seed)
    out = {}
    if kind in ("images", "both"):
        out["images"] = r.randn(B, RES, RES, 3).astype(np.float32)
    if kind in ("text", "both"):
        ids = r.randint(5, V - 1, (B, T)).astype(np.int32)
        ids[:, 0] = 1
        atts = np.ones((B, T), np.int32)
        for b in range(B):
            n = T - 2 * b
            ids[b, n - 1], ids[b, n:], atts[b, n:] = 2, 0, 0
        out.update(text_ids=ids, text_atts=atts)
    return out


def _targets(num_labels: int, B=3, seed=1):
    r = np.random.RandomState(seed)
    if num_labels == 1:
        return r.uniform(0, 5, B).astype(np.float32)
    return r.randint(0, num_labels, B).astype(np.int32)


def _torch(inputs: dict) -> dict:
    return {k: (torch.from_numpy(v).long() if k.startswith("text")
                else torch.from_numpy(v)) for k, v in inputs.items()}


def _jax_model(name: str):
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.models.task_models import TextClassifier as JText
    from xfm_tpu.models.task_models import XFMForClassification as JCls

    task, is_lp, nl, kind = BRANCHES[name]
    jcfg = jconfig_from_yaml(small_yaml(name))
    if task is None:
        return JText(jcfg.text, num_labels=nl), jcfg.text, JText.init_all
    return (JCls(jcfg, num_labels=nl, task_name=task, is_lp=is_lp), jcfg,
            JCls.init_all)


def _port_model(name: str):
    task, is_lp, nl, _ = BRANCHES[name]
    cfg = config_from_yaml(small_yaml(name))
    if task is None:
        return TextClassifier(cfg.text, num_labels=nl)
    return XFMForClassification(cfg, num_labels=nl, task_name=task,
                                is_lp=is_lp)


@pytest.fixture(scope="module")
def jax_k1_interpret():
    """The JAX BEiT tower through K1, the Pallas kernel in interpret mode,
    and exact erf-GELU, for the module's duration."""
    import xfm_tpu.ops.flash_attention as jfa

    real = jfa.flash_attention_packed

    def packed(qkv, bias, scale, num_heads, interpret=True):
        # the custom_vjp's forward rule calls the module's name with
        # `interpret` by place
        return real(qkv, bias, scale, num_heads, True)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_EXACT_ERF", "1")
        mp.setattr(jfa, "packed_ok", lambda *a: True)
        mp.setattr(jfa, "flash_attention_packed", packed)
        yield


@pytest.fixture(scope="module")
def pairs(jax_k1_interpret):
    """name → (JAX model, its config, its perturbed params, the port's
    model with them), built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            jm, jcfg, init = _jax_model(name)
            ex = {k: jnp.asarray(v) for k, v in
                  _inputs(BRANCHES[name][3], B=2).items()}
            params = jax.jit(lambda: jm.init(
                {"params": jax.random.PRNGKey(0)}, **ex,
                method=init)["params"])()
            r = np.random.RandomState(0)
            params = jax.tree.map(lambda x: np.asarray(
                np.asarray(x) + 0.1 * r.randn(*np.shape(x)), np.float32),
                params)
            model = _port_model(name)
            model.load_state_dict(state_dict_from_jax(params, jcfg),
                                  strict=True)
            cache[name] = (jm, jcfg, params, model)
        return cache[name]

    return get


@pytest.mark.parametrize("name", ["image", "image_lp", "text", "fused",
                                  "text_classifier"])
def test_parameter_tree_matches_jax(pairs, name):
    """The port builds the towers the branch runs and no other: its
    parameters are the JAX tree's leaves, name for name (through the
    bridge), shape for shape and in count (no fusion tower in the image
    and text branches, where the YAML asks for none; no MLM head)."""
    jm, jcfg, params, model = pairs(name)
    sd = state_dict_from_jax(params, jcfg)
    named = dict(model.named_parameters())
    assert set(sd) == set(model.state_dict()) >= set(named)  # tied once
    for k, p in named.items():
        assert tuple(sd[k].shape) == tuple(p.shape), k
    assert sum(p.numel() for p in named.values()) == sum(
        np.size(x) for x in jax.tree.leaves(params))
    tops = {n.split(".")[0] for n in named}
    want = {"image": {"vision_encoder", "cls_head"},
            "image_lp": {"vision_encoder", "cls_head"},
            "text": {"text_encoder", "cls_head"},
            "text_classifier": {"text_encoder", "cls_head"},
            "fused": {"vision_encoder", "text_encoder", "fusion_encoder",
                      "fusion_proj", "cls_head"}}[name]  # widths differ
    assert tops == want
    deep = name.startswith("image")
    heads = sorted({int(n.split(".")[1]) for n in named
                    if n.startswith("cls_head.")})
    assert heads == ([0, 1, 3, 4, 6, 7, 9, 10, 12] if deep else [0, 1, 3])
    if name == "image_lp":  # the frozen tower takes no gradient
        assert {n for n, p in named.items() if p.requires_grad} == {
            n for n in named if n.startswith("cls_head.")}


@pytest.mark.parametrize("name", list(BRANCHES))
def test_loss_logits_and_grads_match_jax(pairs, name, monkeypatch):
    """The loss (cross-entropy; STS-B's MSE) and every gradient, and the
    logits with `train=False`; under `is_lp` the tower's gradients are
    absent in the port and zero in JAX (its `stop_gradient`)."""
    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    jm, jcfg, params, model = pairs(name)
    kind, nl = BRANCHES[name][3], BRANCHES[name][2]
    inputs, targets = _inputs(kind), _targets(nl)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}

    def loss(p):
        return jm.apply({"params": p}, **jin, targets=jnp.asarray(targets),
                        train=True)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    jlogits = np.asarray(jax.jit(lambda p: jm.apply(
        {"params": p}, **jin, train=False))(params))
    model.zero_grad(set_to_none=True)
    t = torch.from_numpy(targets)
    got = model.loss(**_torch(inputs), targets=t if nl == 1 else t.long())
    got.backward()
    np.testing.assert_allclose(got.item(), float(jloss), rtol=1e-5)
    with torch.no_grad():
        logits = model.loss(**_torch(inputs), train=False).numpy()
    assert logits.shape == (3, nl)
    np.testing.assert_allclose(logits, jlogits, rtol=1e-5, atol=1e-6)
    want = state_dict_from_jax(jgrads, jcfg)
    for n, p in model.named_parameters():
        w = want[n].numpy().reshape(p.shape)
        if name == "image_lp" and n.startswith("vision_encoder."):
            assert p.grad is None and not np.any(w), n
            continue
        g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-7, n
    model.zero_grad(set_to_none=True)


def test_lp_tower_runs_with_dropout_live_and_no_graph():
    """Under `is_lp` the tower's dropout and drop-path stay live (two
    generators give two sets of embeds) while it records no graph: the
    features' graph starts at the head."""
    cfg = imagenet_yaml(lp=True, layers=2, **dict(SMALL,
                                                  drop_path_rate=0.5))
    model = XFMForClassification(config_from_yaml(cfg), num_labels=NL,
                                 task_name="imagenet", is_lp=True)
    from xfm_tpu_torch.ops.dropout import dropout_generator

    images = _torch(_inputs("images"))["images"]

    outs = []
    for seed in (0, 1):
        with dropout_generator(torch.Generator().manual_seed(seed)):
            outs.append(model.features(images, deterministic=False))
    assert not torch.equal(outs[0], outs[1])
    assert all(not f.requires_grad for f in outs)
    assert model.loss(images, targets=torch.zeros(3, dtype=torch.long),
                      generator=torch.Generator().manual_seed(0),
                      deterministic=False).requires_grad


def _lars_pair(weight_decay: float):
    """(JAX params, their LARS updates over 3 steps of gradients that are
    zero on the tower, the port's LP model after the same 3 steps), the
    schedule the LP YAML's half-cosine."""
    import optax

    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.models.task_models import XFMForClassification as JCls
    from xfm_tpu.train.optim import lars as jlars
    from xfm_tpu.train.schedules import half_cosine as jhalf_cosine

    from xfm_tpu_torch.train.optim import LARS, trained_parameters
    from xfm_tpu_torch.train.schedules import half_cosine

    cfg = small_yaml("image_lp")
    jcfg = jconfig_from_yaml(cfg)
    jm = JCls(jcfg, num_labels=NL, task_name="imagenet", is_lp=True)
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(1)},
        images=jnp.zeros((2, RES, RES, 3)), method=JCls.init_all)[
        "params"])()
    params = jax.tree.map(np.asarray, params)
    model = _port_model("image_lp")
    model.load_state_dict(state_dict_from_jax(params, jcfg), strict=True)
    args = (0.4, 1e-6, 50, 2, 4)
    tx = jlars(jhalf_cosine(*args), weight_decay=weight_decay)
    opt = LARS(trained_parameters(model), half_cosine(*args),
               weight_decay=weight_decay)
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    r = np.random.RandomState(3)
    leaves, tree = jax.tree.flatten(params["cls_head"])
    named = dict(model.named_parameters())
    for _ in range(3):
        head = jax.tree.unflatten(tree, [np.asarray(0.3 * r.randn(
            *np.shape(x)), np.float32) for x in leaves])
        g = dict(jax.tree.map(np.zeros_like, params), cls_head=head)
        upd, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)
        tg = state_dict_from_jax({"cls_head": head}, jcfg)
        for n, t in tg.items():
            named[n].grad = t.clone()
        opt.step()
    return params, jax.tree.map(np.asarray, jp), jcfg, model, opt


def test_lars_matches_jax():
    """Three LARS steps (trust ratio on rank > 1, momentum 0.9, lr of the
    half-cosine at count + 1) on the head, at the shipped LP YAMLs'
    `weight_decay: 0.0`, equal to `xfm_tpu.train.optim.lars` within 1e-6;
    the tower moves on neither side; LARS holds momenta for the head
    alone, and its state round-trips."""
    from xfm_tpu_torch.train.optim import LARS, trained_parameters
    from xfm_tpu_torch.train.schedules import half_cosine

    params, jp, jcfg, model, opt = _lars_pair(0.0)
    want = state_dict_from_jax(jp, jcfg)
    start = state_dict_from_jax(params, jcfg)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
        if n.startswith("vision_encoder."):
            assert torch.equal(p.detach(), start[n])
    assert set(opt.names) == {n for n, _ in model.named_parameters()
                              if n.startswith("cls_head.")}
    assert opt.count == 3
    again = LARS(trained_parameters(model), half_cosine(0.4, 1e-6, 50, 2, 4))
    again.load_state_dict(opt.state_dict())
    assert again.count == 3 and all(
        torch.equal(a, b) for a, b in zip(again.mu, opt.mu))


def test_lars_frozen_tower_stays_at_weight_decay():
    """At `weight_decay > 0` the JAX package's LARS adds wd·p to the frozen
    tower's zero gradients and so moves it; the port's holds no state for
    the tower, which stays put (ROADMAP Queue 3B), while the head's
    updates still equal JAX's."""
    params, jp, jcfg, model, _ = _lars_pair(0.05)
    want, start = state_dict_from_jax(jp, jcfg), state_dict_from_jax(
        params, jcfg)
    moved = 0
    for n, p in model.named_parameters():
        if n.startswith("vision_encoder."):
            assert torch.equal(p.detach(), start[n]), n
            moved += not torch.equal(want[n], start[n])
        else:
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=n)
    assert moved > 0  # JAX moved the tower


@pytest.mark.parametrize("name", ["image", "text"])
def test_cls_head_loads_from_a_reference_state_dict(name):
    """`load_xfm_checkpoint` reads a reference-named `cls_head`
    (`DeepMLPHead` at indices 0…12, `MLPHead` at 0, 1, 3) with the towers,
    bit for bit: nothing missing. The JAX importer reads it only with
    `head="cls_deep"` / `"cls_mlp"`, which the JAX tasks never pass
    (ROADMAP Queue 3B); its reading equals the port's."""
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.train.checkpoint import import_xfm_checkpoint

    from xfm_tpu_torch.train.checkpoint import (init_weights,
                                                load_xfm_checkpoint,
                                                reference_state_dict)

    src, dst = _port_model(name), _port_model(name)
    init_weights(src, 1)
    init_weights(dst, 2)
    ref = reference_state_dict(src)
    missing, unexpected = load_xfm_checkpoint(dst, ref)
    assert missing == [] and unexpected == []
    for k, v in dst.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k
    jcfg = jconfig_from_yaml(small_yaml(name))
    sd = {k: v.numpy() for k, v in ref.items()}
    assert "cls_head" not in import_xfm_checkpoint(sd, jcfg)
    head = "cls_deep" if name == "image" else "cls_mlp"
    jhead = import_xfm_checkpoint(sd, jcfg, head=head)["cls_head"]
    back = state_dict_from_jax({"cls_head": jhead}, jcfg)
    for k, v in back.items():
        assert torch.equal(v, src.state_dict()[k]), k
