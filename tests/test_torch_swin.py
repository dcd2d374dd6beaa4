"""The port's Swin tower against the JAX package's and against the reference
torch module's golden fixture, and its checkpoint paths.

Tolerances: the golden fixture at tests/test_golden_parity.py's bounds
(atol 2e-4 / rtol 1e-3); the JAX tower in f32 on both sides (JAX matmuls at
'highest', exact erf on the JAX side) at atol 1e-5 / rtol 1e-4 for the
outputs, and rtol 1e-3 / atol 1e-5 + 2e-6·max|grad| of each tensor for the
parameter gradients (each sums the tokens in another order on the two
sides); the window helpers, the rel-pos index and the shift mask are exact;
the table interpolation within 1e-5 of the largest entry of the JAX
function's (which computes its weights and its 16-tap sums in f32, about
2⁻²⁴ · 16 · Σ|w·x| ≤ 2e-6 of that entry; the port in float64), while
torch's bicubic is further than 1e-3 from it.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.models.swin import (SwinConfig, SwinTransformer,
                                       shift_attn_mask, swin_rel_pos_index,
                                       window_partition, window_reverse)
from xfm_tpu_torch.train.checkpoint import (_interp_swin_table,
                                            load_reference_state_dict,
                                            swin_from_jax, to_torch)
from _torch_threads import one_intra_op_thread  # noqa: F401

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
TINY = dict(image_res=32, patch_size=4, embed_dim=16, depths=(2, 2),
            num_heads=(2, 4), window_size=4, drop_path_rate=0.0)


@pytest.mark.parametrize("H,W,ws", [(8, 8, 4), (12, 6, 3), (24, 24, 12)])
def test_windows_match_jax(H, W, ws):
    from xfm_tpu.models import swin as jswin

    x = np.random.RandomState(0).randn(2, H, W, 5).astype(np.float32)
    wins = window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(
        wins.numpy(), np.asarray(jswin.window_partition(jnp.asarray(x), ws)))
    np.testing.assert_array_equal(window_reverse(wins, ws, H, W).numpy(), x)
    np.testing.assert_array_equal(swin_rel_pos_index(ws),
                                  jswin.swin_rel_pos_index(ws))


@pytest.mark.parametrize("H,W,ws,shift", [(8, 8, 4, 2), (24, 24, 12, 6),
                                          (12, 12, 6, 3)])
def test_shift_mask_matches_jax(H, W, ws, shift):
    from xfm_tpu.models import swin as jswin

    np.testing.assert_array_equal(shift_attn_mask(H, W, ws, shift),
                                  jswin.shift_attn_mask(H, W, ws, shift))


def test_window_partition_refuses_an_indivisible_stage():
    with pytest.raises(ValueError, match="not divisible by window_size"):
        window_partition(torch.zeros(1, 10, 10, 4), 4)
    with pytest.raises(ValueError, match="not divisible by window_size"):
        SwinTransformer(SwinConfig(image_res=40, patch_size=4, embed_dim=8,
                                   depths=(2,), num_heads=(2,),
                                   window_size=4))(torch.zeros(1, 40, 40, 3))


def test_mim_mask_raises():
    model = SwinTransformer(SwinConfig(**TINY))
    with pytest.raises(NotImplementedError, match="no MIM mask path"):
        model(torch.zeros(1, 32, 32, 3), mask=torch.ones(1, 64))


def test_tower_matches_the_golden_fixture():
    """The reference torch module's output on its own weights, through
    `load_reference_state_dict` (the Conv2d patch weight converted, the
    `relative_position_index` and `attn_mask` buffers dropped): stage 0's
    second block is shifted, stage 1's window covers its 4 × 4 stage."""
    z = np.load(os.path.join(FIX, "golden_swin.npz"))
    sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")}
    model = SwinTransformer(SwinConfig(**TINY))
    res = load_reference_state_dict(model, sd)
    assert not res.missing_keys and not res.unexpected_keys
    assert model.layers[0].blocks[1].shift == 2
    assert model.layers[1].blocks[1].shift == 0
    with torch.no_grad():
        out = model(torch.from_numpy(z["images"].transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(out.numpy(), z["out"], atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def jax_tower():
    mp = pytest.MonkeyPatch()
    mp.setenv("XFM_EXACT_ERF", "1")  # read when the JAX tower runs
    from xfm_tpu.models.swin import SwinConfig as JConfig
    from xfm_tpu.models.swin import SwinTransformer as JTower

    tower = JTower(JConfig(**TINY))
    r = np.random.RandomState(0)
    images = r.randn(3, 32, 32, 3).astype(np.float32)
    params = tower.init(jax.random.PRNGKey(0), jnp.asarray(images))["params"]
    leaves, tree = jax.tree.flatten(params)
    params = jax.tree.unflatten(tree, [
        np.asarray(x) + 0.05 * r.randn(*x.shape).astype(np.float32)
        for x in leaves])
    g = r.randn(3, 17, 32).astype(np.float32)
    idx = np.array([0, 2, 2, 1])
    atts = (r.rand(4, 17) < 0.6).astype(np.int64)
    gr = r.randn(4, 17, 32).astype(np.float32)

    def loss(p, region):
        if region:
            grouped, full = tower.apply({"params": p}, jnp.asarray(images),
                                        idx_to_group_img=jnp.asarray(idx),
                                        image_atts=jnp.asarray(atts))
            return jnp.sum(grouped * gr) + jnp.sum(full * g), grouped
        out = tower.apply({"params": p}, jnp.asarray(images))
        return jnp.sum(out * g), out

    yield dict(params=params, images=images, g=g, idx=idx, atts=atts, gr=gr,
               vg=jax.value_and_grad(loss, has_aux=True))
    mp.undo()


def _port_tower(params):
    cfg = SwinConfig(**TINY)
    model = SwinTransformer(cfg)
    model.load_state_dict(to_torch(swin_from_jax(params, cfg)), strict=True)
    return model


@pytest.mark.parametrize("region", [False, True])
def test_tower_matches_jax(jax_tower, region):
    """Output and every parameter gradient against the JAX tower, the
    shifted block's table gradient among them; with `region`, region mode
    (4 regions over 3 images, the pooled first slot from each region's
    token mask) and the full rows in one loss."""
    s = jax_tower
    (_, jout), jgrads = s["vg"](s["params"], region)
    model = _port_tower(s["params"])
    images = torch.from_numpy(s["images"])
    if region:
        grouped, full = model(images,
                              idx_to_group_img=torch.from_numpy(s["idx"]),
                              image_atts=torch.from_numpy(s["atts"]))
        loss = (grouped * torch.from_numpy(s["gr"])).sum() + (
            full * torch.from_numpy(s["g"])).sum()
        out = grouped
    else:
        out = model(images)
        loss = (out * torch.from_numpy(s["g"])).sum()
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-4)
    want = swin_from_jax(jax.tree.map(np.asarray, jgrads), SwinConfig(**TINY))
    table = "layers.0.blocks.1.attn.relative_position_bias_table"
    assert np.abs(want[table]).max() > 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want[name], rtol=1e-3,
            atol=1e-5 + 2e-6 * np.abs(want[name]).max(), err_msg=name)


def test_swin_from_jax_round_trips_through_import_swin(jax_tower):
    """The port's export, its matmul patch kernel put back in Conv2d
    layout, imports through the JAX package's `import_swin` into the same
    tree, key for key and bit for bit."""
    from xfm_tpu.models.swin import SwinConfig as JConfig
    from xfm_tpu.train.checkpoint import import_swin

    s = jax_tower
    sd = swin_from_jax(s["params"], SwinConfig(**TINY))
    sd["patch_embed.proj.weight"] = sd["patch_embed.proj.weight"].reshape(
        4, 4, 3, 16).transpose(3, 2, 0, 1)
    back = import_swin(sd, JConfig(**TINY))
    flat = dict(jax.tree_util.tree_flatten_with_path(s["params"])[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert sorted(map(str, flat)) == sorted(map(str, flat_back))
    for path, x in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]),
                                      np.asarray(x), err_msg=str(path))


@pytest.mark.parametrize("dst_ws", [12, 15])
def test_interp_swin_table_matches_jax(dst_ws):
    """Window 7 → 12 (13² → 23² rows) and 7 → 15 (13² → 29²), 4 heads:
    the Keys cubic (a = −0.5) of `jax.image.resize`, not torch's bicubic."""
    from xfm_tpu.train.checkpoint import _interp_swin_table as jinterp

    table = np.random.RandomState(dst_ws).randn(13 * 13, 4).astype(
        np.float32)
    dst = (2 * dst_ws - 1) ** 2
    got = _interp_swin_table(table, dst)
    want = np.asarray(jinterp(table, dst))
    assert got.shape == want.shape == (dst, 4)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # torch's bicubic (a = −0.75) is another function
    t = torch.from_numpy(table.reshape(1, 13, 13, 4)).permute(0, 3, 1, 2)
    torch_bicubic = torch.nn.functional.interpolate(
        t, size=(2 * dst_ws - 1,) * 2, mode="bicubic", align_corners=False)
    assert np.abs(torch_bicubic.permute(0, 2, 3, 1).reshape(dst, 4).numpy()
                  - want).max() > 1e-3
