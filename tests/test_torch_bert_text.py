"""The BERT text encoder of the port (`TextConfig.bert_base`) against the
JAX package's, and its reference names (`bert.*`, `cls.predictions.*`)
through `reference_state_dict` and `load_xfm_checkpoint`.

Tolerances (f32 both sides, JAX matmuls at 'highest', exact erf on the JAX
side), those of tests/test_torch_text_encoder.py: hidden states atol 1e-4,
MLM logits atol 2e-4, gradients rtol 1e-3 / atol 1e-5; the name round
trips are exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.models.text_encoder import TextConfig, TextTransformer
from xfm_tpu_torch.train.checkpoint import (load_xfm_checkpoint,
                                            reference_state_dict,
                                            state_dict_from_jax,
                                            text_encoder_from_jax, to_torch)
from _torch_threads import one_intra_op_thread  # noqa: F401

KW = dict(vocab_size=99, hidden_size=64, num_hidden_layers=2,
          num_attention_heads=2, intermediate_size=128, fusion_layer=2,
          encoder_width=64, hidden_act="gelu")


def test_bert_base_config_matches_jax():
    from xfm_tpu.models.text_encoder import TextConfig as JCfg

    got, want = TextConfig.bert_base(), JCfg.bert_base()
    for f in ("vocab_size", "max_position_embeddings", "pad_token_id",
              "layer_norm_eps", "position_style", "type_vocab_size",
              "hidden_size", "num_hidden_layers", "hidden_act"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.vocab_size, got.max_position_embeddings, got.pad_token_id,
            got.layer_norm_eps, got.type_vocab_size) == (30522, 512, 0,
                                                         1e-12, 2)


@pytest.fixture(scope="module")
def bert():
    from xfm_tpu.models.text_encoder import (TextConfig as JCfg,
                                             TextTransformer as JText)

    r = np.random.RandomState(0)
    ids = r.randint(1, 99, (3, 9)).astype(np.int64)
    atts = np.ones((3, 9), np.int64)
    atts[1, 6:] = 0
    ids[1, 6:] = 0  # BERT's pad id
    types = (np.arange(9)[None] >= np.array([[4], [9], [2]])).astype(
        np.int64)
    jm = JText(JCfg.bert_base(**KW), with_mlm=True)
    params = jax.jit(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(ids),
        attention_mask=jnp.asarray(atts), method=JText.init_all)["params"])()
    leaves, tree = jax.tree.flatten(params)
    params = jax.tree.unflatten(tree, [
        np.asarray(x) + 0.05 * np.asarray(r.randn(*x.shape), np.float32)
        for x in leaves])
    tm = TextTransformer(TextConfig.bert_base(**KW), with_mlm=True)
    tm.load_state_dict(to_torch(text_encoder_from_jax(
        params, KW["num_hidden_layers"])), strict=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_EXACT_ERF", "1")
        yield jm, params, tm, ids, atts, types


@pytest.mark.parametrize("past_length,with_types", [(0, False), (5, False),
                                                    (0, True), (7, True)])
def test_bert_encoder_matches_jax(bert, past_length, with_types):
    """Absolute positions from `past_length` (BERT's, where RoBERTa's count
    non-pad tokens from the pad offset), token type ids given or zeros: the
    hidden states, the MLM logits at masked positions and every
    gradient."""
    jm, params, tm, ids, atts, types = bert
    pos = np.array([[0, 3], [1, 5], [2, 8]])
    g = np.random.RandomState(past_length + 3).randn(3, 2, 99).astype(
        np.float32)
    tt = types if with_types else None

    def jloss(p):
        h = jm.apply({"params": p}, jnp.asarray(ids),
                     attention_mask=jnp.asarray(atts),
                     token_type_ids=None if tt is None else jnp.asarray(tt),
                     past_length=past_length)
        logits = jm.apply({"params": p}, h, jnp.asarray(pos),
                          method="mlm_logits")
        return jnp.sum(logits * g), (h, logits)

    (_, (jh, jl)), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tm.zero_grad()
    h = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(atts),
           past_length=past_length,
           token_type_ids=None if tt is None else torch.from_numpy(tt))
    logits = tm.mlm_logits(h, torch.from_numpy(pos))
    (logits * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                               atol=2e-4)
    want = text_encoder_from_jax(jax.tree.map(np.asarray, jg),
                                 KW["num_hidden_layers"])
    for name, p in tm.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        np.testing.assert_allclose(got, want[name], rtol=1e-3, atol=1e-5,
                                   err_msg=name)
    # the rows past the cache offset read the position table there
    pe = "roberta.embeddings.position_embeddings.weight"
    used = np.abs(want[pe]).sum(1) > 0
    assert used[past_length:past_length + 9].all()
    assert not used[:past_length].any() and not used[past_length + 9:].any()


def _swin_bert_yaml():
    return dict(use_swin=True, image_res=32,
                _vision=dict(image_res=32, embed_dim=16, depths=[2, 2],
                             num_heads=[2, 4], window_size=4),
                text_encoder="data/bert-base-uncased",
                text_num_hidden_layers=2, text_fusion_start_at=2,
                fusion_num_hidden_layers=2, text_hidden_size=48,
                text_num_attention_heads=2, text_intermediate_size=96,
                text_vocab_size=99, embed_dim=16)


def test_bert_names_round_trip_and_match_the_jax_import():
    """A Swin + BERT retrieval model's `reference_state_dict` holds its text
    and fusion encoders under `bert.*` and the fusion MLM head under
    `cls.predictions.{transform.dense, transform.LayerNorm, bias,
    decoder}`; `load_xfm_checkpoint` takes it back into a fresh model,
    nothing missing or left over, bit for bit; the JAX package's
    `import_xfm_checkpoint` + `merge_params` read the same dict into the
    same weights."""
    from xfm_tpu.models.task_models import XFMForRetrieval as JRetrieval
    from xfm_tpu.models.xfm import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.train.checkpoint import (import_xfm_checkpoint,
                                          merge_params, to_jax)
    from xfm_tpu_torch.models import XFMForRetrieval, config_from_yaml
    from xfm_tpu_torch.train.checkpoint import init_weights

    kw = dict(use_contrastive_loss=True, use_matching_loss=True)
    cfg = config_from_yaml(_swin_bert_yaml(), dtype=torch.float32, **kw)
    assert cfg.text.position_style == cfg.fusion.position_style == "bert"
    src = XFMForRetrieval(cfg)
    init_weights(src, 3)
    sd = reference_state_dict(src)
    assert not any(".roberta." in k or ".lm_head." in k for k in sd)
    for k in ("text_encoder.bert.embeddings.token_type_embeddings.weight",
              "fusion_encoder.bert.encoder.layer.1.crossattention.self."
              "key.weight",
              "fusion_encoder.cls.predictions.transform.dense.weight",
              "fusion_encoder.cls.predictions.transform.LayerNorm.bias",
              "fusion_encoder.cls.predictions.bias",
              "fusion_encoder.cls.predictions.decoder.weight"):
        assert k in sd, k
    dst = XFMForRetrieval(cfg)
    init_weights(dst, 4)
    missing, unexpected = load_xfm_checkpoint(dst, sd)
    assert not missing and not unexpected
    for (k, a), b in zip(src.state_dict().items(),
                         dst.state_dict().values()):
        assert torch.equal(a, b), k

    jcfg = jconfig_from_yaml(_swin_bert_yaml(), dtype=jnp.float32, **kw)
    jm = JRetrieval(jcfg)
    # (not under jit: the JAX Swin block builds its shift mask in numpy)
    init = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)),
                   jnp.ones((2, 5), jnp.int32), jnp.ones((2, 5), jnp.int32),
                   method=JRetrieval.init_all)["params"]
    params, jmissing, _ = merge_params(init, to_jax(import_xfm_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, jcfg)))
    assert not jmissing, jmissing
    back = state_dict_from_jax(jax.tree.map(np.asarray, params), cfg)
    for k, v in src.state_dict().items():
        np.testing.assert_allclose(back[k].numpy(), v.numpy(), rtol=0,
                                   atol=0, err_msg=k)
