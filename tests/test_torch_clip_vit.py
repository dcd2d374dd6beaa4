"""The port's CLIP-ViT tower against the reference torch module's golden
fixture and against the JAX package's tower, and its weight bridge.

At 384 px the tower has N = 577 tokens, so each self-attention takes the
K3 dispatch on both sides: the port's plain version here, the JAX package's
Pallas kernel in interpret mode (its dispatch predicate, which asks for a
TPU, is widened to the CPU). Tolerances: the golden fixture at
tests/test_golden_parity.py's bounds (atol 2e-4 / rtol 1e-3); the JAX tower
in f32 on both sides (JAX matmuls at 'highest') at atol 1e-5 / rtol 1e-4 for
the output, and rtol 1e-3 / atol 1e-5 + 2e-6·max|grad| of each tensor for the
parameter gradients: each sums 2 × 577 token rows in other orders on the two
sides, which lands within about 1e-6 of the tensor's largest entry (the
largest reach ~200 under a random cotangent; the key biases' gradient is
zero, f32 noise of 1e-6 on both sides).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.models.clip_vit import (ClipVisionConfig,
                                           ClipVisionTransformer)
from xfm_tpu_torch.train.checkpoint import (clip_vit_from_jax,
                                            load_reference_state_dict,
                                            to_torch)
from _torch_threads import one_intra_op_thread  # noqa: F401

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
KW = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
          intermediate_size=256, hidden_act="quick_gelu")
B, RES = 2, 384


def test_tower_matches_the_golden_fixture():
    """The reference torch module's output (models/clip_vit.py) on its own
    weights, loaded through `load_reference_state_dict` (Conv2d patch
    weight converted, `position_ids` dropped)."""
    z = np.load(os.path.join(FIX, "golden_clip_vit.npz"))
    sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")}
    model = ClipVisionTransformer(ClipVisionConfig(
        image_res=32, patch_size=8, hidden_size=24, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=48))
    res = load_reference_state_dict(model, sd)
    assert not res.missing_keys and not res.unexpected_keys
    with torch.no_grad():
        out = model(torch.from_numpy(z["images"].transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(out.numpy(), z["out"], atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def jax_tower():
    import xfm_tpu.ops.attention as jattn
    import xfm_tpu.ops.flash_attention as jfa
    from xfm_tpu.models.clip_vit import ClipVisionConfig as JConfig
    from xfm_tpu.models.clip_vit import ClipVisionTransformer as JTower

    real_flash = jfa.flash_attention
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattn, "_flash_ok", lambda q, k, rate, det:
                   q.shape[1] >= 512 and k.shape[1] >= 512)
        # (the custom_vjp's forward rule calls the module's name too)
        mp.setattr(jfa, "flash_attention",
                   lambda q, k, v, bias=None, scale=None, interpret=True:
                   real_flash(q, k, v, bias, scale, True))
        cfg = JConfig(image_res=RES, patch_size=16, dtype=jnp.float32, **KW)
        tower = JTower(cfg)
        r = np.random.RandomState(0)
        images = r.randn(B, RES, RES, 3).astype(np.float32)
        params = tower.init(jax.random.PRNGKey(0), jnp.asarray(images))[
            "params"]
        leaves, tree = jax.tree.flatten(params)
        params = jax.tree.unflatten(tree, [
            np.asarray(x) + 0.02 * r.randn(*x.shape).astype(np.float32)
            for x in leaves])
        g = r.randn(B, cfg.num_patches + 1, KW["hidden_size"]).astype(
            np.float32)

        def loss(p, atts):
            out = tower.apply({"params": p}, jnp.asarray(images),
                              image_atts=atts)
            return jnp.sum(out * g), out

        yield dict(cfg=cfg, params=params, images=images, g=g,
                   value_and_grad=jax.jit(jax.value_and_grad(
                       loss, has_aux=True)))


def _port_tower(params):
    model = ClipVisionTransformer(ClipVisionConfig(image_res=RES,
                                                   patch_size=16, **KW))
    model.load_state_dict(to_torch(clip_vit_from_jax(
        params, KW["num_hidden_layers"])), strict=True)
    return model


@pytest.mark.parametrize("masked", [False, True])
def test_tower_matches_jax_at_384px(jax_tower, masked):
    """Output and every parameter gradient; with `masked`, `image_atts`
    masks the last 40 keys of row 1 in every layer (a [B, 1, 1, N] bias)."""
    s = jax_tower
    atts = None
    if masked:
        atts = np.ones((B, 577), np.int64)
        atts[1, -40:] = 0
    (_, jout), jgrads = s["value_and_grad"](
        s["params"], None if atts is None else jnp.asarray(atts))
    model = _port_tower(s["params"])
    out = model(torch.from_numpy(s["images"]),
                image_atts=None if atts is None else torch.from_numpy(atts))
    out.backward(torch.from_numpy(s["g"]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-4)
    want = clip_vit_from_jax(jax.tree.map(np.asarray, jgrads),
                             KW["num_hidden_layers"])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want[name], rtol=1e-3,
            atol=1e-5 + 2e-6 * np.abs(want[name]).max(), err_msg=name)


def test_clip_vit_from_jax_round_trips_through_import_clip_vit(jax_tower):
    """The port's export, with its matmul patch kernel put back into the
    reference's Conv2d layout, imports through the JAX package's
    `import_clip_vit` into the same tree, key for key and bit for bit."""
    from xfm_tpu.train.checkpoint import import_clip_vit

    s = jax_tower
    sd = clip_vit_from_jax(s["params"], KW["num_hidden_layers"])
    P, C = 16, KW["hidden_size"]
    sd["patch_embed.weight"] = sd["patch_embed.weight"].reshape(
        P, P, 3, C).transpose(3, 2, 0, 1)
    back = import_clip_vit(sd, s["cfg"])
    flat = dict(jax.tree_util.tree_flatten_with_path(s["params"])[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert sorted(map(str, flat)) == sorted(map(str, flat_back))
    for path, x in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]),
                                      np.asarray(x), err_msg=str(path))


def test_mim_mask_and_region_mode_raise():
    """A MIM mask still raises (CLIP has no mask token, as in JAX); region
    mode, ported since, returns (region rows, image rows) in both forms
    (tests/test_torch_region_attention.py holds them to JAX)."""
    images = torch.zeros(1, 32, 32, 3)
    for local in (0, 1):
        model = ClipVisionTransformer(ClipVisionConfig(
            image_res=32, patch_size=8, hidden_size=24, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=48,
            local_attn_depth=local))
        with pytest.raises(NotImplementedError, match="MIM"):
            model(images, mask=torch.zeros(1, 16, dtype=torch.bool))
        region, full = model(images,
                             idx_to_group_img=torch.zeros(2,
                                                          dtype=torch.int64),
                             image_atts=torch.ones(2, 17))
        assert region.shape == (2, 17, 24) and full.shape == (1, 17, 24)


def test_init_weights_follows_the_jax_initializers():
    """normal(0.02) for the class embedding, patch kernel and position
    embedding, lecun-normal Dense kernels, zero biases, unit LayerNorms."""
    from xfm_tpu_torch.train.checkpoint import init_weights

    model = ClipVisionTransformer(ClipVisionConfig(image_res=RES, **KW))
    init_weights(model, seed=0)
    for p in (model.class_embedding, model.patch_embed.weight,
              model.pos_embed.weight):
        assert abs(p.std().item() - 0.02) < 0.002
    q = model.encoder.layers[0].self_attn.q_proj
    assert abs(q.weight.std().item() - 128 ** -0.5) < 0.01
    assert not q.bias.any()
    assert torch.equal(model.post_layernorm.weight, torch.ones(128))
