"""BEiT-2 tower of the port against the JAX package, on weights carried
across by `beit2_from_jax`.

Tolerances (f32 both sides, JAX matmuls at 'highest' precision): forward
values atol 1e-4 (two blocks of f32 reassociation); gradients rtol 1e-3 /
atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.models.beit2 import BeitVisionTransformer, VisionConfig
from xfm_tpu_torch.train.checkpoint import beit2_from_jax, to_torch

KW = dict(image_res=64, patch_size=16, embed_dim=128, depth=2, num_heads=2,
          drop_path_rate=0.0, hidden_act="gelu")


@pytest.fixture(scope="module")
def towers():
    from xfm_tpu.models.beit2 import (BeitVisionTransformer as JBeit,
                                      VisionConfig as JCfg)

    jm = JBeit(JCfg(**KW))
    r = np.random.RandomState(0)
    images = r.randn(2, 64, 64, 3).astype(np.float32)
    mask = np.zeros((2, 16), bool)
    mask[:, :5] = True
    params = jax.jit(lambda: jm.init(jax.random.PRNGKey(0),
                                     jnp.asarray(images))["params"])()
    # perturb every leaf so zero-initialized tables and biases are exercised
    leaves, tree = jax.tree.flatten(params)
    params = jax.tree.unflatten(tree, [
        np.asarray(x) + 0.05 * np.asarray(r.randn(*x.shape), np.float32)
        for x in leaves])
    tm = BeitVisionTransformer(VisionConfig(**KW))
    tm.load_state_dict(to_torch(beit2_from_jax(params, KW["depth"])),
                       strict=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_EXACT_ERF", "1")  # erf-GELU on the JAX side
        yield jm, params, tm, images, mask


def test_tower_forward_matches_jax(towers):
    jm, params, tm, images, mask = towers
    want = jm.apply({"params": params}, jnp.asarray(images),
                    mask=jnp.asarray(mask))
    got = tm(torch.from_numpy(images), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4)


def test_pair_values_and_grads_match_jax(towers):
    jm, params, tm, images, mask = towers
    r = np.random.RandomState(1)
    g = r.randn(2, 2, 17, KW["embed_dim"]).astype(np.float32)

    def jloss(p):
        full, masked = jm.apply({"params": p}, jnp.asarray(images),
                                jnp.asarray(mask), method=_jax_pair)
        return jnp.sum(full * g[0]) + jnp.sum(masked * g[1]), (full, masked)

    (_, (jfull, jmasked)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)

    tm.zero_grad()
    full, masked = tm.pair(torch.from_numpy(images), torch.from_numpy(mask))
    (torch.sum(full * torch.from_numpy(g[0]))
     + torch.sum(masked * torch.from_numpy(g[1]))).backward()
    np.testing.assert_allclose(full.detach().numpy(), np.asarray(jfull),
                               atol=1e-4)
    np.testing.assert_allclose(masked.detach().numpy(), np.asarray(jmasked),
                               atol=1e-4)
    want = to_torch(beit2_from_jax(jax.tree.map(np.asarray, jgrads),
                                   KW["depth"]))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def _jax_pair(module, images, mask):
    return module.pair(images, mask)
