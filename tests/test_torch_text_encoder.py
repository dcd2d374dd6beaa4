"""Text / fusion encoder of the port against the JAX package, on weights
carried across by `text_encoder_from_jax`.

Tolerances (f32 both sides, JAX matmuls at 'highest' precision): values
atol 1e-4, MLM logits atol 2e-4 (a 99-way vocab projection on top);
gradients rtol 1e-3 / atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.models.text_encoder import TextConfig, TextTransformer
from xfm_tpu_torch.train.checkpoint import text_encoder_from_jax, to_torch
from _torch_threads import one_intra_op_thread  # noqa: F401

KW = dict(vocab_size=99, hidden_size=64, num_hidden_layers=4,
          num_attention_heads=2, intermediate_size=128,
          max_position_embeddings=40, fusion_layer=2, encoder_width=96,
          hidden_act="gelu")


@pytest.fixture(scope="module")
def encoders():
    from xfm_tpu.models.text_encoder import (TextConfig as JCfg,
                                             TextTransformer as JText)

    r = np.random.RandomState(0)
    ids = r.randint(3, 99, (4, 9)).astype(np.int64)
    atts = np.ones((4, 9), np.int64)
    atts[1, 6:] = 0
    ids[1, 6:] = 1  # pads
    enc = r.randn(2, 5, 96).astype(np.float32)
    jm = JText(JCfg.roberta_base(**KW), with_mlm=True)
    params = jax.jit(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(ids),
        attention_mask=jnp.asarray(atts),
        encoder_hidden_states=jnp.asarray(enc[[0, 1, 1, 0]]),
        method=JText.init_all)["params"])()
    leaves, tree = jax.tree.flatten(params)
    params = jax.tree.unflatten(tree, [
        np.asarray(x) + 0.05 * np.asarray(r.randn(*x.shape), np.float32)
        for x in leaves])
    tm = TextTransformer(TextConfig.roberta_base(**KW), with_mlm=True)
    tm.load_state_dict(to_torch(text_encoder_from_jax(
        params, KW["num_hidden_layers"])), strict=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_EXACT_ERF", "1")  # erf-GELU on the JAX side
        yield jm, params, tm, ids, atts, enc


def test_text_mode_matches_jax(encoders):
    jm, params, tm, ids, atts, _ = encoders
    want = jm.apply({"params": params}, jnp.asarray(ids),
                    attention_mask=jnp.asarray(atts), mode="text")
    got = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(atts),
             mode="text")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4)


def test_fusion_mode_with_row_idx_matches_jax(encoders):
    """inputs_embeds → fusion layers with cross-attention k/v projected once
    per unique encoder row and gathered by `encoder_row_idx`; MLM logits at
    masked positions; gradients of params and encoder states."""
    jm, params, tm, ids, atts, enc = encoders
    r = np.random.RandomState(1)
    emb = r.randn(4, 9, 64).astype(np.float32)
    row_idx = np.array([0, 1, 1, 0])
    pos = np.array([[0, 3], [1, 2], [4, 5], [2, 8]])
    g = r.randn(4, 2, 99).astype(np.float32)

    def jloss(p, e):
        h = jm.apply({"params": p}, inputs_embeds=jnp.asarray(emb),
                     attention_mask=jnp.asarray(atts),
                     encoder_hidden_states=e,
                     encoder_row_idx=jnp.asarray(row_idx), mode="fusion")
        logits = jm.apply({"params": p}, h, jnp.asarray(pos),
                          method="mlm_logits")
        return jnp.sum(logits * g), (h, logits)

    (_, (jh, jlogits)), (jgp, jge) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(enc))

    tm.zero_grad()
    te = torch.from_numpy(enc).requires_grad_(True)
    h = tm(inputs_embeds=torch.from_numpy(emb),
           attention_mask=torch.from_numpy(atts), encoder_hidden_states=te,
           encoder_row_idx=torch.from_numpy(row_idx), mode="fusion")
    logits = tm.mlm_logits(h, torch.from_numpy(pos))
    torch.sum(logits * torch.from_numpy(g)).backward()

    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=2e-4)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jge), rtol=1e-3,
                               atol=1e-5)
    want = to_torch(text_encoder_from_jax(jax.tree.map(np.asarray, jgp),
                                          KW["num_hidden_layers"]))
    for name, p in tm.named_parameters():
        if p.grad is None:  # text-mode layers and embeddings: unused here
            assert not np.any(want[name].numpy()), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)
