"""VQA's model in the port against the JAX package: the causal answer
decoder, its LM losses, `XFMForVQA`'s train loss and gradients, and
`rank_answer` (`xfm_tpu/models/text_encoder.py`,
`xfm_tpu/models/generation.py`).

Both sides run f32 (JAX matmuls at 'highest' precision, exact erf-GELU) on
the same weights, carried across by `state_dict_from_jax`, at a small
width (32-64, 2 layers) and small images (32 px: the BEiT attention takes
its plain route on both sides), and once at 384 px, where the BEiT
attention takes K2's dispatch on both sides (the port's plain version,
the JAX package's Pallas kernel in interpret mode, its dispatch predicate
widened to the CPU). Tolerances: hidden states and logits atol 1e-5 /
rtol 1e-4; losses rtol 1e-5 (1e-4 at 384 px); gradients atol 1e-5 +
rtol 1e-3 of each tensor's largest value; rank probabilities atol 1e-6;
top-k ids exact. The decoder's teacher-forced logits are held to the
reference decoder's per-step logits of `golden_decode.npz` at its own
test's atol 5e-4 / rtol 1e-3.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.configs import vqa_yaml
from xfm_tpu_torch.models import XFMForVQA
from xfm_tpu_torch.models.generation import shift_lm_loss, stable_topk
from xfm_tpu_torch.models.text_encoder import (TextConfig, TextTransformer,
                                               per_sample_lm_loss)
from xfm_tpu_torch.train.checkpoint import (state_dict_from_jax,
                                            text_encoder_from_jax, to_torch)
from _torch_threads import one_intra_op_thread  # noqa: F401

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
C, V = 32, 100


def small_yaml(res=32, **keys):
    return vqa_yaml(image_res=res, layers=2, vision_embed_dim=C,
                    vision_num_heads=2, text_hidden_size=C,
                    text_num_attention_heads=2, text_intermediate_size=64,
                    text_vocab_size=V, compute_dtype="float32",
                    drop_path_rate=0.0, **keys)


def _perturbed(params, seed):
    r = np.random.RandomState(seed)
    leaves, tree = jax.tree.flatten(params)
    return jax.tree.unflatten(tree, [
        np.asarray(x) + 0.02 * np.asarray(r.randn(*x.shape), np.float32)
        for x in leaves])


def _models(ycfg, pad_token_id=1, seed=0):
    """The JAX XFMForVQA, its perturbed params, and the port's model with
    them."""
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.models.generation import XFMForVQA as JVQA

    jcfg = jconfig_from_yaml(ycfg)
    jm = JVQA(jcfg, num_dec_layers=2, decoder_fusion_start_at=0,
              pad_token_id=pad_token_id)
    res = ycfg["image_res"]
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros((2, res, res, 3)), jnp.ones((2, 6), jnp.int32),
        jnp.ones((2, 6), jnp.int32), method=JVQA.init_all)["params"])()
    params = _perturbed(params, seed)
    model = XFMForVQA.from_yaml(ycfg, pad_token_id=pad_token_id)
    model.load_state_dict(state_dict_from_jax(params, jcfg), strict=True)
    return jm, jcfg, params, model


@pytest.fixture(scope="module")
def small():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_EXACT_ERF", "1")
        yield _models(small_yaml())


def _batch(res, seed=0, B=3, T=7, K=2, L=5):
    """Images, questions with padded tails, B·K answers (cls first, pads 1
    after their sep; the last of each question a weight-0 pad row)."""
    r = np.random.RandomState(seed)
    q_ids = r.randint(5, V - 1, (B, T)).astype(np.int32)
    q_atts = np.ones((B, T), np.int32)
    q_atts[1, -3:] = 0
    q_ids[q_atts == 0] = 1
    a_ids = r.randint(5, V - 1, (B * K, L)).astype(np.int32)
    a_ids[:, 0] = 0
    a_atts = np.ones((B * K, L), np.int32)
    for i in range(B * K):
        n = 2 + i % (L - 1)
        a_ids[i, n - 1], a_ids[i, n:], a_atts[i, n:] = 2, 1, 0
    weights = np.tile(np.array([1.0, 0.0], np.float32), B)
    weights[2:4] = [0.6, 0.4]
    return dict(images=r.randn(B, res, res, 3).astype(np.float32),
                q_ids=q_ids, q_atts=q_atts, answer_ids=a_ids,
                answer_atts=a_atts, weights=weights,
                ques_idx=np.repeat(np.arange(B, dtype=np.int32), K))


def _torch(nb):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in nb.items()}


def _decoder_pair(seed=0):
    from xfm_tpu.models.text_encoder import TextConfig as JTextConfig
    from xfm_tpu.models.text_encoder import TextTransformer as JText

    kw = dict(vocab_size=V, hidden_size=C, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=64,
              max_position_embeddings=40, fusion_layer=0, encoder_width=48,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    jm = JText(JTextConfig.roberta_base(is_decoder=True, **kw),
               with_mlm=True)
    ids = jnp.ones((2, 6), jnp.int32)
    enc = jnp.zeros((2, 5, 48))
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(seed)}, ids, attention_mask=ids,
        encoder_hidden_states=enc, method=JText.init_all)["params"])()
    params = _perturbed(params, seed)
    model = TextTransformer(TextConfig.roberta_base(is_decoder=True, **kw),
                            with_mlm=True)
    model.load_state_dict(to_torch(text_encoder_from_jax(params, 2)),
                          strict=True)
    return jm, params, model


@pytest.mark.parametrize("padded", [False, True])
def test_causal_decoder_matches_jax(padded, monkeypatch):
    """The decoder's hidden states and LM logits, without and with a
    padding mask (the causal −1e9 added to the mask's), cross-attending to
    encoder states of another width with their own mask."""
    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    from xfm_tpu.models.text_encoder import TextTransformer as JText

    jm, params, model = _decoder_pair()
    r = np.random.RandomState(1)
    ids = r.randint(5, V - 1, (3, 8)).astype(np.int32)
    atts = np.ones((3, 8), np.int32)
    if padded:
        atts[0, 5:], atts[2, 3:] = 0, 0
    enc = r.randn(3, 5, 48).astype(np.float32)
    enc_atts = np.ones((3, 5), np.int32)
    enc_atts[1, 3:] = 0
    mask = atts if padded else None
    jh = jm.apply({"params": params}, jnp.asarray(ids),
                  attention_mask=None if mask is None else jnp.asarray(mask),
                  encoder_hidden_states=jnp.asarray(enc),
                  encoder_attention_mask=jnp.asarray(enc_atts))
    jl = jm.apply({"params": params}, jh, None, method=JText.mlm_logits)
    with torch.no_grad():
        h = model(torch.from_numpy(ids).long(),
                  attention_mask=(None if mask is None
                                  else torch.from_numpy(mask)),
                  encoder_hidden_states=torch.from_numpy(enc),
                  encoder_attention_mask=torch.from_numpy(enc_atts))
        logits = model.mlm_logits(h)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-4)
    # causal: a later token changes nothing before it
    ids2 = ids.copy()
    ids2[:, -1] = 7
    with torch.no_grad():
        h2 = model(torch.from_numpy(ids2).long(),
                   attention_mask=(None if mask is None
                                   else torch.from_numpy(mask)),
                   encoder_hidden_states=torch.from_numpy(enc),
                   encoder_attention_mask=torch.from_numpy(enc_atts))
    torch.testing.assert_close(h2[:, :-1], h[:, :-1], rtol=0, atol=0)
    if padded:
        return
    # the decode cache: token by token, the teacher-forced logits
    from xfm_tpu_torch.models import DecodeCache

    cache, steps = DecodeCache(), []
    with torch.no_grad():
        for t in range(ids.shape[1]):
            steps.append(model.mlm_logits(model(
                torch.from_numpy(ids[:, t:t + 1]).long(),
                encoder_hidden_states=torch.from_numpy(enc),
                encoder_attention_mask=torch.from_numpy(enc_atts),
                decode=cache, past_length=t, cross_from_cache=t > 0)))
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), np.asarray(jl),
                               atol=1e-5, rtol=1e-4)


def test_decoder_matches_golden_decode_logits():
    """The reference causal decoder's greedy per-step logits
    (`golden_decode.npz`, its cached steps) equal the port decoder's
    teacher-forced logits over the same sequence, its weights loaded by the
    reference-name loader."""
    from xfm_tpu_torch.train.checkpoint import load_reference_state_dict

    z = np.load(os.path.join(FIX, "golden_decode.npz"))
    sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")}
    cfg = TextConfig(vocab_size=99, hidden_size=48, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=96,
                     max_position_embeddings=40, fusion_layer=0,
                     encoder_width=96, pad_token_id=1,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0, layer_norm_eps=1e-5,
                     is_decoder=True)
    model = TextTransformer(cfg, with_mlm=True)
    missing, unexpected = load_reference_state_dict(model, sd, strict=False)
    assert set(missing) <= {"lm_head.decoder.weight",
                            "lm_head.decoder.bias"} and not unexpected
    seq = torch.from_numpy(z["seq"]).long()
    with torch.no_grad():
        h = model(seq[:, :-1], encoder_hidden_states=torch.from_numpy(
            z["enc"]), encoder_attention_mask=torch.from_numpy(
                z["enc_atts"]).long())
        logits = model.mlm_logits(h)
    np.testing.assert_allclose(logits.numpy(), z["step_logits"], atol=5e-4,
                               rtol=1e-3)
    assert torch.equal(logits.argmax(-1), seq[:, 1:])


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_lm_losses_match_jax(smoothing):
    from xfm_tpu.models.generation import shift_lm_loss as jshift
    from xfm_tpu.models.text_encoder import per_sample_lm_loss as jper

    r = np.random.RandomState(2)
    logits = (3 * r.randn(4, 6, 50)).astype(np.float32)
    labels = r.randint(0, 50, (4, 6)).astype(np.int32)
    labels[0, 4:], labels[2, 1:] = -100, -100
    for fn, jfn in ((per_sample_lm_loss, jper), (shift_lm_loss, jshift)):
        got = fn(torch.from_numpy(logits), torch.from_numpy(labels),
                 label_smoothing=smoothing)
        want = jfn(jnp.asarray(logits), jnp.asarray(labels),
                   label_smoothing=smoothing)
        assert got.shape == (4,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def _jax_loss_and_grads(jm, params, nb):
    def loss(p):
        return jm.apply({"params": p}, jnp.asarray(nb["images"]),
                        jnp.asarray(nb["q_ids"]), jnp.asarray(nb["q_atts"]),
                        answer_ids=jnp.asarray(nb["answer_ids"]),
                        answer_atts=jnp.asarray(nb["answer_atts"]),
                        ques_idx=jnp.asarray(nb["ques_idx"]),
                        weights=jnp.asarray(nb["weights"]), train=True)

    return jax.value_and_grad(loss)(params)


def _check_loss_and_grads(jm, jcfg, params, model, nb, rtol):
    jloss, jgrads = _jax_loss_and_grads(jm, params, nb)
    model.zero_grad(set_to_none=True)
    loss = model.loss(**_torch(nb))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=rtol)
    want = state_dict_from_jax(jgrads, jcfg)
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for name, p in named.items():
        g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        w = want[name].numpy().reshape(g.shape)
        tol = 1e-5 + 1e-3 * np.abs(w).max()
        assert np.abs(g - w).max() <= tol, name


def test_vqa_loss_and_grads_match_jax(small):
    """The weighted causal answer loss over the flat layout (a weight-0 pad
    row, padded questions and answers) and every parameter's gradient,
    the decoder's tied word embeddings and the text encoder trained
    through the fusion pass among them."""
    jm, jcfg, params, model = small
    _check_loss_and_grads(jm, jcfg, params, model, _batch(32), 1e-5)


def _answer_list(n, L, first=None, seed=5):
    """n answers (cls, tokens, sep, pads); `first` draws their first
    tokens from that few ids, so many share one (tied first-token
    probabilities)."""
    r = np.random.RandomState(seed)
    ids = r.randint(5, V - 1, (n, L)).astype(np.int32)
    ids[:, 0] = 0
    if first:
        ids[:, 1] = r.choice(np.arange(5, 5 + first), n)
    atts = np.ones((n, L), np.int32)
    for i in range(n):
        m = 3 + i % (L - 2)
        ids[i, m - 1], ids[i, m:], atts[i, m:] = 2, 1, 0
    return ids, atts


@pytest.mark.parametrize("first,k", [(None, 4), (3, 5)],
                         ids=["distinct", "ties"])
@pytest.mark.parametrize("mode", ["2", "0"])
def test_rank_answer_matches_jax(small, first, k, mode, monkeypatch):
    """`XFMForVQA.rank` (the grouped candidates) against the JAX eval in
    its grouped mode "2" and its repeat mode "0": the same top-k ids in the
    same order, their probabilities within 1e-6. With 12 answers over 3
    first tokens the k-th place falls inside a tie of equal first-token
    probabilities: the lower index goes first on both sides."""
    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    monkeypatch.setenv("XFM_EVAL_SHARED_KV", mode)
    jm, _, params, model = small
    nb = _batch(32, seed=3)
    ans_ids, ans_atts = _answer_list(12, 5, first)
    jids, jprobs = jm.apply(
        {"params": params}, jnp.asarray(nb["images"]),
        jnp.asarray(nb["q_ids"]), jnp.asarray(nb["q_atts"]), train=False,
        answer_list_ids=jnp.asarray(ans_ids),
        answer_list_atts=jnp.asarray(ans_atts), k=k)
    ids, probs = model.rank(*(_torch(nb)[n] for n in ("images", "q_ids",
                                                      "q_atts")),
                            torch.from_numpy(ans_ids).long(),
                            torch.from_numpy(ans_atts).long(), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6)
    if first:
        # the first-token probabilities really tie across the cut
        with torch.no_grad():
            q = model.encode_question(*(_torch(nb)[n] for n in (
                "images", "q_ids", "q_atts")))
            start = torch.zeros(q.shape[0], 1, dtype=torch.long)
            p0 = torch.softmax(model.decode_answers(
                start, None, q, torch.ones(q.shape[:2],
                                           dtype=torch.long))[:, 0], -1)
        pf = p0[:, torch.from_numpy(ans_ids[:, 1]).long()]
        kth = pf.sort(-1, descending=True).values[:, k - 1]
        assert all((pf[i] == kth[i]).sum() > 1 for i in range(len(kth)))


def test_stable_topk_breaks_ties_by_lower_index():
    x = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3, 0.3]])
    vals, idx = stable_topk(x, 3)
    assert idx.tolist() == [[1, 2, 4]] and torch.equal(vals, x[:, [1] * 3])
    want = jax.lax.top_k(jnp.asarray(x.numpy()), 3)[1]
    assert idx.tolist() == np.asarray(want).tolist()


def test_vqa_loss_and_grads_match_jax_at_384px(monkeypatch):
    """At 384 px the BEiT attention (N = 577) takes K2's dispatch on both
    sides: the port's plain version against the JAX package's Pallas
    kernel in interpret mode."""
    import xfm_tpu.ops.flash_attention as jfa

    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    monkeypatch.setattr(jfa, "relpos_inkernel_ok",
                        lambda n, w: n == w[0] * w[1] + 1 and n >= 512)
    monkeypatch.setattr(jfa, "beit_attention_relpos", functools.partial(
        jfa.beit_attention_relpos, interpret=True))
    jm, jcfg, params, model = _models(small_yaml(384, vision_depth=1),
                                      seed=1)
    _check_loss_and_grads(jm, jcfg, params, model, _batch(384, seed=4, B=2),
                          1e-4)
