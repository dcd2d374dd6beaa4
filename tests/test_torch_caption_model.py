"""COCO captioning's model in the port against the JAX package: the
decoder's KV cache, `XFMForCaptioning`'s loss and gradients, its parameter
tree and optimizer groups, `generate`, `top_k_top_p_filtering` and
`beam_generate` (`xfm_tpu/models/text_encoder.py`,
`xfm_tpu/models/generation.py`).

Both sides run f32 (JAX matmuls at 'highest' precision, exact erf-GELU) on
the same weights, carried across by `state_dict_from_jax`, at width 32, 2
decoder layers, 1-2 BEiT blocks and 32 px images (the BEiT attention takes
its plain route on both sides). Tolerances: cached logits against JAX's
cached steps and against the port's teacher-forced pass atol 1e-5 / rtol
1e-4, against `golden_decode.npz`'s steps its own test's atol 5e-4 / rtol
1e-3; losses rtol 1e-5; gradients atol 1e-5 + 1e-3 of each tensor's
largest value; greedy log-probabilities atol 1e-5; every sequence (greedy,
prompted, `min_len`, grouped samples, beams) token for token;
`top_k_top_p_filtering` bit for bit. Sampling cannot follow JAX's random
stream, so it is held by its properties (see
`test_sampling_properties`).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.configs import caption_yaml
from xfm_tpu_torch.models import (DecodeCache, TextConfig, TextTransformer,
                                  XFMForCaptioning, beam_generate, generate,
                                  top_k_top_p_filtering)
from xfm_tpu_torch.train.checkpoint import (state_dict_from_jax,
                                            text_encoder_from_jax, to_torch)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
C, V = 32, 100
PROMPT = (10, 11, 12, 13)


def small_yaml(**keys):
    return caption_yaml(image_res=32, layers=2, vision_embed_dim=C,
                        vision_num_heads=2, text_hidden_size=C,
                        text_num_attention_heads=2,
                        text_intermediate_size=64, text_vocab_size=V,
                        compute_dtype="float32", drop_path_rate=0.0, **keys)


def _perturbed(params, seed, scale):
    r = np.random.RandomState(seed)
    leaves, tree = jax.tree.flatten(params)
    return jax.tree.unflatten(tree, [
        np.asarray(x) + scale * np.asarray(r.randn(*x.shape), np.float32)
        for x in leaves])


def _models(ycfg, seed=0, scale=0.3, **kw):
    """The JAX XFMForCaptioning, its perturbed params (0.3: logits spread
    enough that decoding picks many tokens), and the port's model with
    them."""
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.models.generation import XFMForCaptioning as JCap

    jcfg = jconfig_from_yaml(ycfg)
    jm = JCap(jcfg, num_dec_layers=ycfg["num_dec_layers"], pad_token_id=1,
              prompt_length=ycfg.get("prompt_length", 0),
              max_decode_len=ycfg["max_length"] + ycfg["prompt_length"] + 2,
              **kw)
    res = ycfg["image_res"]
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((2, res, res, 3)),
        jnp.ones((2, 6), jnp.int32), jnp.ones((2, 6), jnp.int32),
        method=JCap.init_all)["params"])()
    params = _perturbed(params, seed, scale)
    model = XFMForCaptioning.from_yaml(dict(ycfg, **kw))
    model.load_state_dict(state_dict_from_jax(params, jcfg), strict=True)
    return jm, jcfg, params, model


@pytest.fixture(scope="module")
def small():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_EXACT_ERF", "1")
        yield _models(small_yaml())


def _images(B, seed=0, res=32):
    return np.random.RandomState(seed).randn(B, res, res, 3).astype(
        np.float32)


# --- the decode cache -------------------------------------------------------

def _decoder_pair(seed=0, cache_len=12):
    from xfm_tpu.models.text_encoder import TextConfig as JTextConfig
    from xfm_tpu.models.text_encoder import TextTransformer as JText

    kw = dict(vocab_size=V, hidden_size=C, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=64,
              max_position_embeddings=40, fusion_layer=0, encoder_width=48,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
              is_decoder=True, decode_cache_len=cache_len)
    jm = JText(JTextConfig.roberta_base(**kw), with_mlm=True)
    ids = jnp.ones((2, 6), jnp.int32)
    enc = jnp.zeros((2, 5, 48))
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(seed)}, ids, attention_mask=ids,
        encoder_hidden_states=enc, method=JText.init_all)["params"])()
    params = _perturbed(params, seed, 0.05)
    model = TextTransformer(TextConfig.roberta_base(**kw), with_mlm=True)
    model.load_state_dict(to_torch(text_encoder_from_jax(params, 2)),
                          strict=True)
    return jm, params, model


@pytest.mark.parametrize("chunks", [(1, 1, 1, 1, 1, 1), (3, 1, 2, 1)],
                         ids=["steps", "multi_token_chunk"])
def test_decode_cache_matches_jax(chunks, monkeypatch):
    """The cached decode, chunk by chunk, against JAX's `mutable=['cache']`
    steps (a chunk of several tokens causal inside itself) and against the
    port's own teacher-forced pass over the whole sequence; a pad token
    inside a sequence takes position 1 and enters the cache unmasked, as
    in JAX."""
    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    from xfm_tpu.models.text_encoder import TextTransformer as JText

    jm, params, model = _decoder_pair()
    r = np.random.RandomState(1)
    n = sum(chunks)
    ids = r.randint(5, V - 1, (3, n)).astype(np.int32)
    ids[:, 0] = 0
    ids[1, 4] = 1  # a pad mid-sequence, as a finished row feeds them
    enc = r.randn(3, 5, 48).astype(np.float32)
    enc_atts = np.ones((3, 5), np.int32)
    enc_atts[1, 3:] = 0
    jvars = jm.init({"params": jax.random.PRNGKey(0)},
                    jnp.asarray(ids[:, :1]), attention_mask=None,
                    encoder_hidden_states=jnp.asarray(enc),
                    encoder_attention_mask=jnp.asarray(enc_atts),
                    decode=True)
    # init ran a step: start from empty slots at index 0
    jcache = jax.tree.map(jnp.zeros_like, jvars["cache"])
    cache = DecodeCache()
    got, want = [], []
    at = 0
    for ch in chunks:
        tok = ids[:, at:at + ch]
        h, mut = jm.apply(
            {"params": params, "cache": jcache}, jnp.asarray(tok),
            attention_mask=None, encoder_hidden_states=jnp.asarray(enc),
            encoder_attention_mask=jnp.asarray(enc_atts), decode=True,
            past_length=at, cross_from_cache=at > 0, mutable=["cache"])
        jcache = mut["cache"]
        want.append(np.asarray(jm.apply({"params": params}, h, None,
                                        method=JText.mlm_logits)))
        with torch.no_grad():
            th = model(torch.from_numpy(tok).long(),
                       encoder_hidden_states=torch.from_numpy(enc),
                       encoder_attention_mask=torch.from_numpy(enc_atts),
                       decode=cache, past_length=at,
                       cross_from_cache=at > 0)
            got.append(model.mlm_logits(th).numpy())
        at += ch
        assert cache.index == at
    got, want = np.concatenate(got, 1), np.concatenate(want, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    with torch.no_grad():
        full = model.mlm_logits(model(
            torch.from_numpy(ids).long(),
            encoder_hidden_states=torch.from_numpy(enc),
            encoder_attention_mask=torch.from_numpy(enc_atts)))
    # rows 0 and 2 equal the teacher-forced pass; row 1's tokens after its
    # pad take positions that count the pad's slot (as JAX's cache does)
    # where the full pass skips it
    np.testing.assert_allclose(got[[0, 2]], full.numpy()[[0, 2]],
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got[1, :5], full.numpy()[1, :5], atol=1e-5,
                               rtol=1e-4)
    # the cross k/v are read back, not projected again, after the first
    assert all(lc.cross_k.shape == (3, 5, 2, 16) for lc in cache.layers)
    assert all(lc.k.shape == (3, 12, 2, 16) for lc in cache.layers)
    with pytest.raises(ValueError, match="decode cache full"):
        model(torch.ones(3, 13 - at, dtype=torch.long),
              encoder_hidden_states=torch.from_numpy(enc), decode=cache,
              past_length=at, cross_from_cache=True)


def test_decode_cache_matches_golden_decode():
    """The reference causal decoder's greedy decode with past_key_values
    (`golden_decode.npz`): the port's cached steps give its sequence and
    its per-step logits."""
    from xfm_tpu_torch.train.checkpoint import load_reference_state_dict

    z = np.load(os.path.join(FIX, "golden_decode.npz"))
    sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")}
    cfg = TextConfig(vocab_size=99, hidden_size=48, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=96,
                     max_position_embeddings=40, fusion_layer=0,
                     encoder_width=96, pad_token_id=1,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0, layer_norm_eps=1e-5,
                     is_decoder=True, decode_cache_len=12)
    model = TextTransformer(cfg, with_mlm=True)
    load_reference_state_dict(model, sd, strict=False)
    enc = torch.from_numpy(z["enc"])
    enc_atts = torch.from_numpy(z["enc_atts"]).long()
    B, L = z["seq"].shape[0], z["seq"].shape[1] - 1
    cache = DecodeCache()
    cur = torch.zeros(B, 1, dtype=torch.long)
    toks, steps = [cur], []
    with torch.no_grad():
        for t in range(L):
            h = model(cur, encoder_hidden_states=enc,
                      encoder_attention_mask=enc_atts, decode=cache,
                      past_length=t, cross_from_cache=t > 0)
            logits = model.mlm_logits(h)[:, -1]
            steps.append(logits.numpy())
            cur = logits.argmax(-1)[:, None]
            toks.append(cur)
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(), z["seq"])
    np.testing.assert_allclose(np.stack(steps, 1), z["step_logits"],
                               atol=5e-4, rtol=1e-3)


# --- the model ---------------------------------------------------------------

def _caption_batch(B=3, T=9, seed=0, prompt=()):
    r = np.random.RandomState(seed)
    ids = r.randint(5, V - 1, (B, T)).astype(np.int32)
    ids[:, 0] = 0
    ids[:, 1:1 + len(prompt)] = prompt
    atts = np.ones((B, T), np.int32)
    for b in range(B):
        n = T - 2 * b
        ids[b, n - 1], ids[b, n:], atts[b, n:] = 2, 1, 0
    return _images(B, seed), ids, atts


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("prompt_length", [0, 4])
def test_caption_loss_and_grads_match_jax(prompt_length, smoothing,
                                          monkeypatch):
    """The mean of the captions' summed causal LM loss (pads and the first
    `prompt_length` positions ignored, label smoothing mixed in) and every
    parameter's gradient, the BEiT tower's and the decoder's tied word
    embeddings among them."""
    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    ycfg = small_yaml(prompt_length=prompt_length)
    jm, jcfg, params, model = _models(ycfg, seed=2, scale=0.02,
                                      label_smoothing=smoothing)
    images, ids, atts = _caption_batch(prompt=PROMPT[:prompt_length])

    def loss(p):
        return jm.apply({"params": p}, jnp.asarray(images), jnp.asarray(ids),
                        jnp.asarray(atts), train=True)

    jloss, jgrads = jax.value_and_grad(loss)(params)
    got = model.loss(torch.from_numpy(images), torch.from_numpy(ids).long(),
                     torch.from_numpy(atts).long())
    got.backward()
    np.testing.assert_allclose(got.item(), float(jloss), rtol=1e-5)
    want = state_dict_from_jax(jgrads, jcfg)
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for name, p in named.items():
        g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        w = want[name].numpy().reshape(g.shape)
        assert np.abs(g - w).max() <= 1e-5 + 1e-3 * np.abs(w).max(), name


def test_parameter_tree_and_optimizer_groups_match_jax(small):
    """The port's parameters are the JAX module's, name for name and in
    count (the vision tower and the decoder; no text or fusion encoder, no
    projections); HF-AdamW decays the set JAX's `decay_mask` decays and
    boosts none (no `DEFAULT_BOOST_PATTERNS` name is in the tree), and
    two updates of the same gradients through both packages'
    `create_optimizer_from_config` (lr_mult 2) agree."""
    import optax

    from xfm_tpu.train.optim import create_optimizer_from_config as jcreate
    from xfm_tpu.train.optim import decay_mask
    from xfm_tpu.train.schedules import schedule_from_config as jsched

    from xfm_tpu_torch.train.optim import create_optimizer_from_config
    from xfm_tpu_torch.train.schedules import schedule_from_config

    jm, jcfg, params, _ = small
    model = XFMForCaptioning.from_yaml(small_yaml())
    model.load_state_dict(state_dict_from_jax(params, jcfg), strict=True)
    assert set(params) == {"backbone", "text_decoder"}
    assert set(params["backbone"]) == {"vision_encoder"}
    tops = {n.split(".")[0] for n, _ in model.named_parameters()}
    assert tops == {"vision_encoder", "text_decoder"}
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.size(x) for x in jax.tree.leaves(params))
    config = {"optimizer": {"opt": "adamW", "lr": 1e-3,
                            "weight_decay": 0.02, "lr_mult": 2},
              "schedular": {"sched": "linear", "lr": 1e-3, "epochs": 2,
                            "num_warmup_steps": 0.25}}
    opt = create_optimizer_from_config(model, config,
                                       schedule_from_config(config, 2))
    assert opt.boost_idx == []
    mask = state_dict_from_jax(jax.tree.map(
        lambda m: np.float32(m), decay_mask(params)), jcfg)
    assert {opt.names[i] for i in opt.decay_idx} == {
        n for n in opt.names if mask[n].reshape(-1)[0] == 1.0}
    jp = jax.tree.map(jnp.asarray, params)
    tx = jcreate(jp, config, jsched(config, 2))
    st = tx.init(jp)
    named = dict(model.named_parameters())
    r = np.random.RandomState(3)
    leaves, tree = jax.tree.flatten(params)
    for _ in range(2):
        g = jax.tree.unflatten(tree, [np.asarray(0.3 * r.randn(
            *np.shape(x)), np.float32) for x in leaves])
        upd, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)
        tg = state_dict_from_jax(g, jcfg)
        for name, p in named.items():
            p.grad = tg[name].clone()
        opt.step()
    want = state_dict_from_jax(jax.tree.map(np.asarray, jp), jcfg)
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=name)


# --- decoding ----------------------------------------------------------------

EOS = 31  # a token the perturbed model often picks: rows finish early


@pytest.mark.parametrize("kw", [
    dict(), dict(prompt_ids=PROMPT), dict(min_len=5),
    dict(prompt_ids=PROMPT, min_len=6, num_return_sequences=3)],
    ids=["plain", "prompt", "min_len", "prompt_min_len_n3"])
def test_greedy_generate_matches_jax(small, kw, monkeypatch):
    """Greedy sequences token for token and their per-token
    log-probabilities within 1e-5: the forced prompt slots (log p 0),
    EOS blocked while `min_len` is not reached, finished rows padded at
    0, each image's n rows contiguous."""
    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    from xfm_tpu.models.generation import generate as jgenerate

    jm, _, params, model = small
    images = _images(3, seed=4)
    js, jl = jgenerate(jm, {"params": params}, jnp.asarray(images),
                       bos_id=0, eos_id=EOS, pad_id=1, max_len=10, **kw)
    ts, tl = generate(model, torch.from_numpy(images), bos_id=0,
                      eos_id=EOS, pad_id=1, max_len=10, **kw)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    seqs = ts.numpy()
    assert (seqs == EOS).any() and (seqs == 1).any()  # rows did finish
    if "prompt_ids" in kw:
        assert (seqs[:, :4] == PROMPT).all() and (tl[:, :4] == 0).all()


def test_top_k_top_p_filtering_bit_equal():
    """The filter against JAX's on logits with ties at the k-th value and
    at the nucleus threshold: the same kept set and values, bit for
    bit."""
    from xfm_tpu.models.generation import top_k_top_p_filtering as jfilter

    r = np.random.RandomState(5)
    logits = np.round(3 * r.randn(6, 40), 1).astype(np.float32)
    logits[0, :5] = logits[0, 5]  # a tie across the k-th place
    logits[1] = 0.0
    logits[1, :3] = [2.0, 1.0, 1.0]
    for top_k, top_p in ((0, 1.0), (5, 1.0), (1, 1.0), (0, 0.9), (0, 0.5),
                         (8, 0.7), (100, 0.3)):
        got = top_k_top_p_filtering(torch.from_numpy(logits), top_k, top_p)
        want = np.asarray(jfilter(jnp.asarray(logits), top_k, top_p))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_properties(small):
    """Sampling cannot follow JAX's random stream; it is held by its
    properties: top-k 1 is greedy (the same tokens, each at log p 0, the
    one token the filter keeps);
    one generator seed repeats a draw bit for bit and another seed draws
    other tokens; prompt forcing and done handling as in greedy. The draw
    frequencies of 20,000 draws over a 6-token vocabulary match the
    filtered softmax within 0.02 of each probability (5 standard
    deviations of a frequency at p = 0.5)."""
    from xfm_tpu_torch.models.generation import _gumbel_argmax

    _, _, _, model = small
    images = torch.from_numpy(_images(2, seed=6))
    kw = dict(bos_id=0, eos_id=EOS, pad_id=1, max_len=9, prompt_ids=PROMPT)
    gs, gl = generate(model, images, **kw)
    ks, kl = generate(model, images, greedy=False, top_k=1,
                      generator=torch.Generator().manual_seed(1), **kw)
    assert torch.equal(gs, ks) and (kl == 0).all()  # one token kept
    draws = [generate(model, images, greedy=False, top_p=0.9,
                      num_return_sequences=3,
                      generator=torch.Generator().manual_seed(s), **kw)
             for s in (7, 7, 8)]
    assert torch.equal(draws[0][0], draws[1][0])
    assert torch.equal(draws[0][1], draws[1][1])
    assert not torch.equal(draws[0][0], draws[2][0])
    seqs, lps = draws[0]
    assert (seqs[:, :4] == torch.tensor(PROMPT)).all()
    assert (lps[:, :4] == 0).all() and (lps <= 0).all()
    done = torch.cumsum((seqs == EOS).long(), 1) - (seqs == EOS).long() > 0
    assert done.any() and (seqs[done] == 1).all() and (lps[done] == 0).all()
    logits = torch.tensor([[2.0, 1.5, 1.0, 0.2, -1.0, -3.0]])
    filt = top_k_top_p_filtering(logits, 4, 0.95)
    p = torch.softmax(filt, -1)[0]
    g = torch.Generator().manual_seed(0)
    picks = _gumbel_argmax(torch.log_softmax(filt, -1).expand(20000, 6), g)
    freq = torch.bincount(picks, minlength=6).float() / 20000
    assert (freq - p).abs().max() <= 0.02 and freq[4:].sum() == 0


@pytest.mark.parametrize("kw", [
    dict(), dict(prompt_ids=PROMPT), dict(min_len=6),
    dict(prompt_ids=PROMPT, min_len=7, length_penalty=0.0)],
    ids=["plain", "prompt", "min_len", "prompt_min_len_lp0"])
def test_beam_generate_matches_jax(small, kw, monkeypatch):
    """Beam search (K = 3) token for token against JAX's, and the grouped
    form (each image's beams against its once-projected k/v) equal to the
    repeat form (the image embeds repeated K times)."""
    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    from xfm_tpu.models.generation import beam_generate as jbeam

    jm, _, params, model = small
    images = _images(3, seed=8)
    want = jbeam(jm, {"params": params}, jnp.asarray(images), bos_id=0,
                 eos_id=EOS, pad_id=1, max_len=9, num_beams=3, **kw)
    got = beam_generate(model, torch.from_numpy(images), bos_id=0,
                        eos_id=EOS, pad_id=1, max_len=9, num_beams=3, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rep = beam_generate(model, torch.from_numpy(images), bos_id=0,
                        eos_id=EOS, pad_id=1, max_len=9, num_beams=3,
                        image_group=False, **kw)
    assert torch.equal(got, rep)


def test_beam_generate_ties_match_jax(monkeypatch):
    """A decoder whose LM head gives every token the same logit (all
    weights of the head's dense and LayerNorm 0, the bias 0): every
    candidate ties, and both sides expand the lower indices first."""
    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    from xfm_tpu.models.generation import beam_generate as jbeam

    jm, jcfg, params, _ = _models(small_yaml(), seed=1)
    head = params["text_decoder"]["mlm_head"]
    head = dict(head, layer_norm=dict(
        scale=np.zeros_like(head["layer_norm"]["scale"]),
        bias=np.zeros_like(head["layer_norm"]["bias"])),
        bias=np.zeros_like(head["bias"]))
    params = dict(params, text_decoder=dict(params["text_decoder"],
                                            mlm_head=head))
    model = XFMForCaptioning.from_yaml(small_yaml())
    model.load_state_dict(state_dict_from_jax(params, jcfg), strict=True)
    images = _images(2, seed=9)
    for kw in (dict(), dict(prompt_ids=PROMPT, min_len=6)):
        want = jbeam(jm, {"params": params}, jnp.asarray(images), bos_id=0,
                     eos_id=2, pad_id=1, max_len=8, num_beams=3, **kw)
        got = beam_generate(model, torch.from_numpy(images), bos_id=0,
                            eos_id=2, pad_id=1, max_len=8, num_beams=3, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
