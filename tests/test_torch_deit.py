"""The port's DeiT tower against the JAX package's, its XFMBase route, and
the load of a reference checkpoint in timm names.

Tolerances: f32 on both sides (JAX matmuls at 'highest', exact erf on the
JAX side): outputs at atol 1e-5 / rtol 1e-4, parameter and gate gradients
at rtol 1e-3 / atol 1e-5 + 2e-6·max|grad| of each tensor (each sums the
tokens in another order on the two sides); the checkpoint load is exact
(copies, and the port's own interpolation of `pos_embed`).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.models.deit import DeitConfig, DeitVisionTransformer
from xfm_tpu_torch.train.checkpoint import (deit_from_jax,
                                            interpolate_abs_pos_embed,
                                            load_xfm_checkpoint,
                                            reference_state_dict, to_torch)
from _torch_threads import one_intra_op_thread  # noqa: F401

KW = dict(patch_size=16, embed_dim=128, depth=2, num_heads=2)


def _jax_tower(image_res, seed=0):
    from xfm_tpu.models.deit import DeitConfig as JConfig
    from xfm_tpu.models.deit import DeitVisionTransformer as JTower

    tower = JTower(JConfig(image_res=image_res, **KW))
    r = np.random.RandomState(seed)
    images = r.randn(2, image_res, image_res, 3).astype(np.float32)
    params = tower.init(jax.random.PRNGKey(seed), jnp.asarray(images))[
        "params"]
    leaves, tree = jax.tree.flatten(params)
    params = jax.tree.unflatten(tree, [
        np.asarray(x) + 0.05 * r.randn(*x.shape).astype(np.float32)
        for x in leaves])
    return tower, params, images, r


def _port_tower(params, image_res):
    model = DeitVisionTransformer(DeitConfig(image_res=image_res, **KW))
    model.load_state_dict(to_torch(deit_from_jax(params, KW["depth"])),
                          strict=True)
    return model


def _check_grads(model, jgrads):
    want = deit_from_jax(jax.tree.map(np.asarray, jgrads), KW["depth"])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want[name], rtol=1e-3,
            atol=1e-5 + 2e-6 * np.abs(want[name]).max(), err_msg=name)


@pytest.mark.parametrize("image_res", [64, 384])
def test_tower_matches_jax(image_res, monkeypatch):
    """Output and every parameter gradient; at 384 px (N = 577) each block
    takes `dot_product_attention`'s K3 route, which on CPU tensors is its
    plain version: a counter on `flash_attention` shows the 2 blocks' calls
    (none at 64 px, N = 17)."""
    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    import xfm_tpu_torch.ops.flash_attention as fa

    tower, params, images, r = _jax_tower(image_res)
    N = (image_res // 16) ** 2 + 1
    g = r.randn(2, N, KW["embed_dim"]).astype(np.float32)

    def loss(p):
        out = tower.apply({"params": p}, jnp.asarray(images))
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    model = _port_tower(params, image_res)
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or real(
                            *a, **k))
    out = model(torch.from_numpy(images))
    (out * torch.from_numpy(g)).sum().backward()
    assert calls == ([(2, 577, 2, 64)] * 2 if image_res == 384 else [])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-4)
    _check_grads(model, jgrads)


def test_prob_gate_gradient_matches_jax(monkeypatch):
    """`register_blk` = 1 with a gate of ones [B, H, N, N]: the gate's
    gradient (GradCAM's attn ⊙ ∂L/∂attn) and the parameters' against JAX;
    the gated block takes the plain route."""
    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    tower, params, images, r = _jax_tower(64, seed=1)
    N = 17
    g = r.randn(2, N, KW["embed_dim"]).astype(np.float32)
    gate = np.ones((2, 2, N, N), np.float32)

    def loss(p, gt):
        out = tower.apply({"params": p}, jnp.asarray(images),
                          register_blk=1, prob_gate=gt)
        return jnp.sum(out * g)

    jgp, jgg = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(gate))
    model = _port_tower(params, 64)
    tg = torch.from_numpy(gate).requires_grad_(True)
    out = model(torch.from_numpy(images), register_blk=1, prob_gate=tg)
    (out * torch.from_numpy(g)).sum().backward()
    jgg = np.asarray(jgg)
    np.testing.assert_allclose(tg.grad.numpy(), jgg, rtol=1e-3,
                               atol=1e-5 + 2e-6 * np.abs(jgg).max())
    _check_grads(model, jgp)


def _deit_yaml(image_res=32):
    return dict(use_deit=True, image_res=image_res, patch_size=16,
                _vision={"vision_width": 32, "num_hidden_layers": 1,
                         "num_attention_heads": 2},
                text_encoder="roberta-base", text_num_hidden_layers=1,
                text_fusion_start_at=1, fusion_num_hidden_layers=1,
                fusion_fusion_start_at=0, text_hidden_size=32,
                text_num_attention_heads=2, text_intermediate_size=64,
                embed_dim=16)


def test_deit_backbone_through_xfm_base():
    """`config_from_yaml`'s `use_deit` branch (that of
    tests/test_components_r1b.py) into XFMBase: [cls ‖ 4 patches] of width
    32 through `get_vision_embeds`, the config equal to the JAX package's
    field for field; a MIM mask, region mode and the masked pair raise."""
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu_torch.models import XFMBase, config_from_yaml

    cfg = config_from_yaml(_deit_yaml(), dtype=torch.float32)
    jcfg = jconfig_from_yaml(_deit_yaml(), dtype=jnp.float32)
    assert cfg.vision_backbone == jcfg.vision_backbone == "deit"
    for f in ("image_res", "patch_size", "embed_dim", "depth", "num_heads",
              "mlp_ratio", "layer_norm_eps", "num_patches"):
        assert getattr(cfg.vision, f) == getattr(jcfg.vision, f), f
    assert cfg.vision_width == jcfg.vision_width == 32
    model = XFMBase(cfg)
    images = torch.zeros(2, 32, 32, 3)
    assert model.get_vision_embeds(images).shape == (2, 5, 32)
    with pytest.raises(NotImplementedError, match="no MIM mask"):
        model.get_vision_embeds(images, mask=torch.ones(2, 4))
    with pytest.raises(NotImplementedError, match="no MIM mask"):
        model.get_vision_embeds(images, idx_to_group_img=torch.tensor([0]),
                                image_atts=torch.ones(1, 5))
    with pytest.raises(NotImplementedError, match="no MIM mask path"):
        model.get_vision_embeds_pair(images, torch.ones(2, 4))


def test_timm_checkpoint_loads_with_pos_embed_interpolated():
    """A DeiT retrieval checkpoint in the reference's timm names at 224 px
    (pos_embed [1, 197, C], the Conv2d patch weight) onto the model at
    384 px: every tower weight loads, `pos_embed` interpolated to 577 rows
    by `interpolate_abs_pos_embed`, the patch weight made a matmul kernel.
    The JAX package cannot import it: `import_xfm_checkpoint` sends a DeiT
    tower to `import_beit2`, which reads BEiT's config fields
    (`use_abs_pos_emb`, `grid_size`) and q_bias / v_bias, which DeiT
    lacks."""
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.train.checkpoint import import_xfm_checkpoint
    from xfm_tpu_torch.models import XFMForRetrieval, config_from_yaml
    from xfm_tpu_torch.train.checkpoint import init_weights

    def model_at(res, seed):
        m = XFMForRetrieval(config_from_yaml(
            _deit_yaml(image_res=res), use_contrastive_loss=True,
            use_matching_loss=True, dtype=torch.float32))
        init_weights(m, seed)
        return m

    src = reference_state_dict(model_at(224, 0))
    assert src["vision_encoder.pos_embed"].shape == (1, 197, 32)
    assert src["vision_encoder.patch_embed.proj.weight"].shape == (32, 3, 16,
                                                                   16)
    dst = model_at(384, 1)
    missing, unexpected = load_xfm_checkpoint(dst, src)
    assert not missing and not unexpected
    got = dst.state_dict()
    want_pos = interpolate_abs_pos_embed(
        src["vision_encoder.pos_embed"].numpy(), 576)
    assert got["vision_encoder.pos_embed"].shape == (1, 577, 32)
    np.testing.assert_array_equal(got["vision_encoder.pos_embed"].numpy(),
                                  want_pos)
    back = reference_state_dict(dst)
    for k, v in src.items():
        if k != "vision_encoder.pos_embed":
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(),
                                          err_msg=k)
    jcfg = jconfig_from_yaml(_deit_yaml(image_res=384), dtype=jnp.float32,
                             use_contrastive_loss=True,
                             use_matching_loss=True)
    with pytest.raises(AttributeError, match="use_abs_pos_emb"):
        import_xfm_checkpoint({k: v.numpy() for k, v in src.items()}, jcfg)
