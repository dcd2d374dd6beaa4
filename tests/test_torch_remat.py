"""Activation checkpointing in the port (`ops/checkpoint.py`, its sites in
`models/beit2.py` and `models/text_encoder.py`, `attn_remat` in
`ops/attention.py`, the keys `gradient_checkpointing` / `remat_policy` in
`models/xfm.config_from_yaml`), on the CPU.

- For each policy (`full`, `dots`, `except_attn`, `attn_out`), the loss and
  every gradient with checkpointing on are bit-equal to those with it off,
  with live dropout and drop-path drawn from one seeded generator, and the
  generator ends in the same state: the BEiT pair pass, region attention
  (`local_attn_depth` 1), the text and fusion encoders (attention dropout
  live and at 0), the caption decoder and the pretrain task's stream step.
  The recompute is real: under `full`, `dots` and `attn_out` every block
  and K1's entry (its plain version here) run twice a step; under
  `except_attn` the blocks run once and the plain attention twice.
- Dropout is replayed from the generator's saved state; GradCAM's gate
  still gets its gradient; greedy captions decode alike with the decoder's
  layers checkpointed, and its training step differentiates.
- Against the JAX package: `config_from_yaml` with `gradient_checkpointing`
  and a "large" `vision_config` (shrunk by `vision_embed_dim` /
  `vision_depth`, heads of 64), weights carried by `state_dict_from_jax`,
  deterministic f32: losses rtol 1e-4, each gradient within 1e-3 of its
  largest |value| (+ 1e-7, as `test_torch_pretrain_task.py`); the bridge at
  the large tower's layout (24 blocks, 16 heads) at width 128 (f32
  forward within 1e-4 of the output's largest |value|); K1's plain version
  against the Pallas K1 in interpret mode at H = 16.
- The pins of Queue 3C: an unknown policy raises (JAX reads it as
  `full`); the CLIP-ViT, Swin and DeiT towers are not checkpointed.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.models import XFMForPretrain
from xfm_tpu_torch.models import beit2 as tbeit
from xfm_tpu_torch.models.beit2 import BeitVisionTransformer, VisionConfig
from xfm_tpu_torch.models.generation import (XFMForCaptioning, XFMForVQA,
                                             generate, make_decoder_config)
from xfm_tpu_torch.models.task_models import LOSS_KEYS
from xfm_tpu_torch.models.text_encoder import (DecodeCache, TextConfig,
                                               TextTransformer)
from xfm_tpu_torch.models.xfm import config_from_yaml
from xfm_tpu_torch.ops import attention as tattn
from xfm_tpu_torch.ops import checkpoint as remat
from xfm_tpu_torch.ops.dropout import (active_generator, dropout,
                                       dropout_generator)
from xfm_tpu_torch.train.checkpoint import (beit2_from_jax, init_weights,
                                            state_dict_from_jax, to_torch)
from _torch_threads import one_intra_op_thread  # noqa: F401

POLICIES = ("full", "dots", "except_attn", "attn_out")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LARGE_JSON = os.path.join(REPO, "configs", "model",
                          "config_beit2_large.json")


def tiny_yaml(**keys) -> dict:
    """A pretrain-style YAML at width 64 (vision 128), depth 2, 32 px."""
    return dict(image_res=32, patch_size=16, vision_embed_dim=128,
                vision_depth=2, vision_num_heads=2, text_hidden_size=64,
                text_num_attention_heads=2, text_intermediate_size=128,
                text_vocab_size=40, text_num_hidden_layers=2,
                text_fusion_start_at=2, fusion_num_hidden_layers=2,
                hidden_act="gelu", drop_path_rate=0.2, **keys)


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _grads(model) -> dict:
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _assert_same(ref, got):
    """(loss, grads, generator state) bit for bit."""
    assert torch.equal(ref[0], got[0])
    assert set(ref[1]) == set(got[1])
    for name in ref[1]:
        assert torch.equal(ref[1][name], got[1][name]), name
    assert torch.equal(ref[2], got[2])


class _Calls:
    """Counts the calls of a module attribute it wraps."""

    def __init__(self, monkeypatch, owner, name):
        self.n = 0
        real = getattr(owner, name)

        def spy(*a, **k):
            self.n += 1
            return real(*a, **k)

        monkeypatch.setattr(owner, name, spy)


def _count_block_calls(blocks) -> list:
    counts = [0]

    def hook(*_):
        counts[0] += 1

    for blk in blocks:
        blk.register_forward_pre_hook(hook)
    return counts


# ------------------------------------------------------------ the BEiT tower

BEIT = VisionConfig(image_res=32, patch_size=16, embed_dim=64, depth=2,
                    num_heads=2, drop_path_rate=0.2, drop_rate=0.1,
                    local_attn_depth=1)


def _beit_run(cfg, sd, region: bool):
    model = BeitVisionTransformer(cfg)
    model.load_state_dict(sd)
    calls = _count_block_calls(model.blocks)
    r = torch.Generator().manual_seed(3)
    images = torch.randn(3, 32, 32, 3, generator=r)
    g = torch.Generator().manual_seed(5)
    with dropout_generator(g):
        if region:
            atts = torch.ones(4, 5, dtype=torch.int64)
            atts[0, 3] = atts[2, 1] = 0
            a, b = model(images, idx_to_group_img=torch.tensor([0, 2, 1, 0]),
                         image_atts=atts, deterministic=False)
        else:
            mask = torch.zeros(3, 4, dtype=torch.bool)
            mask[:, :2] = True
            a, b = model.pair(images, mask, deterministic=False)
    loss = (a * 1.3).sum() + (b ** 2).sum()
    loss.backward()
    return (loss.detach(), _grads(model), g.get_state()), calls[0]


@pytest.fixture(scope="module")
def beit_state():
    torch.manual_seed(0)
    model = BeitVisionTransformer(BEIT)
    init_weights(model, 0)
    return _state(model)


@pytest.mark.parametrize("region", [False, True], ids=["pair", "region"])
@pytest.mark.parametrize("policy", POLICIES)
def test_beit_checkpointed_bit_equal(beit_state, monkeypatch, policy,
                                     region):
    ref, calls_off = _beit_run(BEIT, beit_state, region)
    k1 = _Calls(monkeypatch, tbeit, "flash_attention_packed")
    plain = _Calls(monkeypatch, tattn, "attention_reference")
    got, calls_on = _beit_run(
        dataclasses.replace(BEIT, remat=True, remat_policy=policy),
        beit_state, region)
    _assert_same(ref, got)
    # the pair pass runs both blocks through K1's entry; region mode runs
    # block 0 through it and block 1, with the regions' batch-axis bias,
    # through the plain attention
    n_k1, n_plain = (1, 1) if region else (2, 0)
    if policy == "except_attn":
        assert (calls_on, k1.n, plain.n) == (calls_off, n_k1, 2 * n_plain)
    else:  # every block and kernel once more in the recompute
        assert (calls_on, k1.n, plain.n) == (2 * calls_off, 2 * n_k1,
                                             2 * n_plain)


def test_intermediate_layers_checkpointed_bit_equal(beit_state):
    def run(cfg):
        model = BeitVisionTransformer(cfg)
        model.load_state_dict(beit_state)
        g = torch.Generator().manual_seed(1)
        with dropout_generator(g):
            outs = model.intermediate_layers(
                torch.ones(2, 32, 32, 3), [1, 0, 1], deterministic=False)
        loss = sum((o * (i + 1)).sum() for i, o in enumerate(outs))
        loss.backward()
        return loss.detach(), _grads(model), g.get_state()

    _assert_same(run(BEIT), run(dataclasses.replace(BEIT, remat=True)))


# ------------------------------------------------- the text and fusion stack

def _text_cfg(rate):
    return TextConfig.roberta_base(
        vocab_size=50, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=2, intermediate_size=128,
        max_position_embeddings=40, fusion_layer=1, encoder_width=96,
        hidden_dropout_prob=0.1, attention_probs_dropout_prob=rate)


def _text_run(cfg, sd):
    model = TextTransformer(cfg, with_mlm=True)
    model.load_state_dict(sd)
    calls = _count_block_calls(model.roberta.encoder.layer)
    r = torch.Generator().manual_seed(2)
    ids = torch.randint(3, 50, (3, 7), generator=r)
    atts = torch.ones(3, 7, dtype=torch.int64)
    atts[1, 5:] = 0
    enc = torch.randn(3, 5, 96, generator=r).requires_grad_(True)
    g = torch.Generator().manual_seed(9)
    with dropout_generator(g):
        h = model(ids, attention_mask=atts, encoder_hidden_states=enc,
                  deterministic=False)
        logits = model.mlm_logits(h)
    loss = logits.logsumexp(-1).sum()
    loss.backward()
    grads = dict(_grads(model), encoder_states=enc.grad.clone())
    return (loss.detach(), grads, g.get_state()), calls[0]


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["attn_drop0", "attn_drop"])
@pytest.mark.parametrize("policy", POLICIES)
def test_text_and_fusion_checkpointed_bit_equal(monkeypatch, policy, rate):
    cfg = _text_cfg(rate)
    torch.manual_seed(0)
    init = TextTransformer(cfg, with_mlm=True)
    init_weights(init, 1)
    sd = _state(init)
    ref, calls_off = _text_run(cfg, sd)
    plain = _Calls(monkeypatch, tattn, "attention_reference")
    got, calls_on = _text_run(
        dataclasses.replace(cfg, remat=True, remat_policy=policy), sd)
    _assert_same(ref, got)
    n_attn = 5  # 3 self-attentions, 2 cross-attentions
    if policy == "except_attn":
        # the plain attention recomputes only where no dropout is live
        assert (calls_on, plain.n) == (calls_off,
                                       n_attn * (2 if rate == 0 else 1))
    else:
        assert (calls_on, plain.n) == (2 * calls_off, 2 * n_attn)


def test_gradcam_gate_gets_its_gradient_under_checkpointing():
    from xfm_tpu_torch.models.gradcam import itm_gradcam
    from xfm_tpu_torch.models.task_models import XFMForRetrieval

    cams = []
    for on in (False, True):
        cfg = config_from_yaml(tiny_yaml(gradient_checkpointing=on),
                               use_contrastive_loss=True,
                               use_matching_loss=True, dtype=torch.float32)
        assert cfg.fusion.remat == on
        model = XFMForRetrieval(cfg)
        init_weights(model, 4)
        r = torch.Generator().manual_seed(0)
        cams.append(itm_gradcam(model, torch.randn(2, 32, 32, 3, generator=r),
                                torch.randint(3, 40, (2, 6), generator=r),
                                torch.ones(2, 6, dtype=torch.int64),
                                block_num=1))
    assert cams[0].abs().max() > 0
    assert torch.equal(cams[0], cams[1])


# ------------------------------------------------------------ the decoders

def _caption_model(on: bool, policy: str = "full") -> XFMForCaptioning:
    cfg = tiny_yaml(gradient_checkpointing=on, remat_policy=policy,
                    num_dec_layers=2, max_length=6)
    model = XFMForCaptioning.from_yaml(
        cfg, config_from_yaml(cfg, dtype=torch.float32), pad_token_id=0)
    init_weights(model, 7)
    return model


def test_decoders_inherit_the_text_config():
    for on, policy in ((False, "full"), (True, "dots")):
        cfg = tiny_yaml(gradient_checkpointing=on, remat_policy=policy)
        xcfg = config_from_yaml(cfg, dtype=torch.float32)
        dec = make_decoder_config(xcfg, 2)
        assert (dec.remat, dec.remat_policy, dec.is_decoder) == (on, policy,
                                                                 True)
        vqa = XFMForVQA.from_yaml(dict(cfg, num_dec_layers=2), xcfg)
        cap = XFMForCaptioning.from_yaml(dict(cfg, num_dec_layers=2), xcfg)
        for m in (vqa, cap):
            assert (m.text_decoder.c.remat,
                    m.text_decoder.c.remat_policy) == (on, policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_caption_decoder_checkpointed_bit_equal(policy):
    r = torch.Generator().manual_seed(0)
    images = torch.randn(2, 32, 32, 3, generator=r)
    ids = torch.randint(3, 40, (2, 6), generator=r)
    ids[1, 4:] = 0
    res = []
    for on in (False, True):
        model = _caption_model(on, policy)
        g = torch.Generator().manual_seed(11)
        loss = model.loss(images, ids, (ids != 0).long(), generator=g,
                          deterministic=False)
        loss.backward()
        res.append((loss.detach(), _grads(model), g.get_state()))
    _assert_same(*res)


def test_caption_greedy_decode_and_step_under_checkpointing(monkeypatch):
    """The counterpart of tests/test_tasks.py's decode under remat: the
    cached decode never checkpoints (nothing writes a slot twice) and
    gives the captions of the model without checkpointing; the training
    step differentiates."""
    images = torch.randn(2, 32, 32, 3,
                         generator=torch.Generator().manual_seed(1))
    seqs = []
    for on in (False, True):
        model = _caption_model(on)
        seqs.append(generate(model, images, bos_id=1, eos_id=2, pad_id=0,
                             max_len=6, greedy=True))
    with torch.no_grad():
        embeds = model.encode_images(images)
    calls = _Calls(monkeypatch, remat, "run_checkpointed")
    with torch.enable_grad():  # a cached step with grad on: no checkpoint
        model.decode_step(torch.ones(2, 1, dtype=torch.int64), embeds,
                          DecodeCache())
    assert calls.n == 0
    assert seqs[0][0].shape == (2, 6)
    assert torch.equal(seqs[0][0], seqs[1][0])
    assert torch.equal(seqs[0][1], seqs[1][1])
    ids = torch.ones(2, 6, dtype=torch.int64)
    model.loss(images, ids, ids).backward()
    assert all(torch.isfinite(p.grad).all()
               for p in model.parameters() if p.grad is not None)


# ---------------------------------------------------- the pretrain stream step

@pytest.mark.parametrize("policy", ["full", "dots"])
def test_pretrain_stream_step_checkpointed_bit_equal(policy):
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.tasks.pretrain import stream_loss_fn
    from xfm_tpu_torch.train.train_state import TrainState, make_stream_step

    class _NoUpdate:
        def step(self):
            return torch.zeros(())

    sizes = dict(image=3, imagenet=2, regions=3, max_images=2,
                 max_regions=2, text=3, T=8, M=3, text_T=10, text_M=3,
                 masked_patches=2)
    nb = configs.make_stream_batches(sizes, 32, 40, seed=0)
    flags = {"image": dict(ret_itc=True, ret_match=True, ret_mlm=True,
                           ret_mim=True, data_source="image"),
             "region": dict(ret_itc=True, ret_match=True, ret_mlm=True,
                            ret_bbox=True, ret_bbox_giou=True,
                            data_source="region"),
             "imagenet": dict(ret_mim=True, data_source="imagenet"),
             "text": {}}
    res = []
    for on in (False, True):
        cfg = config_from_yaml(
            tiny_yaml(gradient_checkpointing=on, remat_policy=policy,
                      hidden_dropout_prob=0.1,
                      attention_probs_dropout_prob=0.1),
            use_contrastive_loss=True, use_matching_loss=True,
            use_mlm_loss=True, use_bbox_loss=True, dtype=torch.float32)
        model = XFMForPretrain(cfg)
        init_weights(model, 2)
        step = make_stream_step(stream_loss_fn(flags, {n: 1.0 for n in nb}))
        gens = {n: torch.Generator().manual_seed(i)
                for i, n in enumerate(sorted(nb))}
        batches = {n: configs.batch_to_torch(b, "cpu") for n, b in nb.items()}
        _, m = step(TrainState(model, _NoUpdate()), batches, gens)
        res.append((m["loss"], _grads(model),
                    torch.cat([gens[n].get_state() for n in sorted(gens)])))
    _assert_same(*res)


# ------------------------------------------------------- dropout and policies

def test_recompute_replays_dropout_from_the_saved_state():
    """A checkpointed function drawing dropout: the recompute draws the
    forward's masks from a copy of the generator's state at the call, and
    the step's generator moves once; with no generator at the forward the
    recompute gets none either."""
    masks = []

    def fn(x):
        y = dropout(x, 0.5, False)
        masks.append(y != 0)
        return y * x

    x = torch.randn(64, requires_grad=True)
    g = torch.Generator().manual_seed(0)
    with dropout_generator(g):
        y = remat.run_checkpointed(fn, x)
        after_forward = g.get_state()
    with dropout_generator(torch.Generator().manual_seed(1)):
        y.sum().backward()  # a live generator at the backward is not used
    assert len(masks) == 2 and torch.equal(masks[0], masks[1])
    assert torch.equal(g.get_state(), after_forward)
    seen = []

    def probe(t):
        seen.append(active_generator())
        return t * t

    y = remat.run_checkpointed(probe, x)
    with dropout_generator(torch.Generator().manual_seed(2)):
        y.sum().backward()
    assert seen == [None, None]


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        remat.remat_policy("attn")
    with pytest.raises(ValueError, match="remat_policy"):
        VisionConfig(remat_policy="bogus")
    with pytest.raises(ValueError, match="remat_policy"):
        TextConfig(remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        config_from_yaml(tiny_yaml(gradient_checkpointing=True,
                                   remat_policy="Full"))
    assert remat.remat_policy("except_attn") is None


def test_attn_remat_gradients_equal_the_plain_ones(monkeypatch):
    """XFM_ATTN_REMAT (the port's counterpart of tests/test_components_r1b.py
    `test_attn_remat_grad_equivalence`): read into the configs, and the
    checkpointed plain attention's gradients equal the plain ones."""
    r = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 9, 2, 8, generator=r) for _ in range(3))
    bias = torch.randn(1, 2, 9, 9, generator=r)
    grads = []
    for on in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
        out = tattn.dot_product_attention(*leaves[:3], bias=leaves[3],
                                          remat=on)
        (out ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    monkeypatch.setenv("XFM_ATTN_REMAT", "1")
    cfg = config_from_yaml(tiny_yaml(), dtype=torch.float32)
    assert (cfg.vision.attn_remat, cfg.text.attn_remat,
            cfg.fusion.attn_remat, cfg.vision.remat) == (True, True, True,
                                                         False)
    from xfm_tpu_torch.configs import xfm_base_pretrain_config

    small = xfm_base_pretrain_config(hidden=64, layers=1, heads=2, inter=128)
    assert small.vision.attn_remat and small.text.attn_remat


@pytest.mark.parametrize("tower", ["use_clip_vit", "use_swin", "use_deit"])
def test_other_towers_are_not_checkpointed(tower):
    cfg = config_from_yaml(tiny_yaml(gradient_checkpointing=True,
                                     **{tower: True}), dtype=torch.float32)
    fields = {f.name for f in dataclasses.fields(cfg.vision)}
    assert not fields & {"remat", "remat_policy", "attn_remat"}
    assert cfg.text.remat and cfg.fusion.remat


def test_clip_tower_runs_no_checkpoint(monkeypatch):
    from xfm_tpu_torch.models.task_models import XFMForRetrieval

    calls = _Calls(monkeypatch, remat, "run_checkpointed")
    cfg = config_from_yaml(tiny_yaml(gradient_checkpointing=True,
                                     use_clip_vit=True,
                                     _vision=dict(vision_width=64,
                                                  num_hidden_layers=2,
                                                  num_attention_heads=2,
                                                  intermediate_size=128)),
                           use_contrastive_loss=True, dtype=torch.float32)
    model = XFMForRetrieval(cfg)
    init_weights(model, 0)
    model.get_vision_embeds(torch.randn(2, 32, 32, 3)).sum().backward()
    assert calls.n == 0
    model.get_text_embeds(torch.randint(3, 40, (2, 5)),
                          torch.ones(2, 5, dtype=torch.int64)).sum().backward()
    assert calls.n == 2  # the text encoder's two layers


# --------------------------------------------------------- against the JAX package

@pytest.fixture(scope="module")
def large_setup():
    import xfm_tpu.models.losses as jlosses
    from xfm_tpu.models import XFMForPretrain as JPretrain
    from xfm_tpu.models.xfm import config_from_yaml as jconfig_from_yaml

    from test_torch_pretrain_task import NEG, _batches

    yaml = tiny_yaml(gradient_checkpointing=True, vision_config=LARGE_JSON)
    jcfg = jconfig_from_yaml(yaml, use_contrastive_loss=True,
                             use_matching_loss=True, use_mlm_loss=True,
                             use_bbox_loss=True, dtype=jnp.float32)
    assert (jcfg.vision.remat, jcfg.vision.num_heads,
            jcfg.vision.embed_dim) == (True, 2, 128)
    jm = JPretrain(jcfg)
    b = _batches()["image"]
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(b["images"]),
        jnp.asarray(b["text_ids"]), jnp.asarray(b["text_atts"]),
        method=JPretrain.init_all)["params"])()
    r = np.random.RandomState(0)
    leaves, tree = jax.tree.flatten(params)
    params = jax.tree.unflatten(tree, [
        np.asarray(x) + 0.02 * np.asarray(r.randn(*x.shape), np.float32)
        for x in leaves])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlosses, "hard_negative_indices",
                   lambda *a, **k: tuple(jnp.asarray(n) for n in NEG))
        yield dict(jcfg=jcfg, jm=jm, params=params, yaml=yaml)


@pytest.mark.parametrize("kind", ["image", "region"])
def test_large_checkpointed_matches_jax(large_setup, kind):
    from test_torch_pretrain_task import FLAGS, NEG, _batches

    s = large_setup
    batch, flags = _batches()[kind], FLAGS[kind]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        out = s["jm"].apply({"params": p}, **jbatch, **flags,
                            deterministic=True,
                            rngs={"hardneg": jax.random.PRNGKey(0)})
        return sum(out[k] for k in LOSS_KEYS), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        s["params"])
    cfg = config_from_yaml(s["yaml"], use_contrastive_loss=True,
                           use_matching_loss=True, use_mlm_loss=True,
                           use_bbox_loss=True, dtype=torch.float32)
    assert (cfg.vision.remat, cfg.vision.depth, cfg.text.remat) == (True, 2,
                                                                    True)
    model = XFMForPretrain(cfg)
    model.load_state_dict(state_dict_from_jax(s["params"], s["jcfg"]),
                          strict=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = model.loss(**tb, **flags,
                     hard_negatives=tuple(torch.from_numpy(n) for n in NEG))
    sum(out[k] for k in LOSS_KEYS).backward()
    for k in LOSS_KEYS:
        np.testing.assert_allclose(out[k].item(), float(jout[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), s["jcfg"])
    for name, p in model.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        ref = want[name].numpy()
        tol = 1e-3 * np.abs(ref).max() + 1e-7
        assert np.abs(got - ref).max() <= tol, (kind, name)


def test_bridge_carries_the_large_tower_layout():
    """`beit2_from_jax` and `state_dict_from_jax` at BEiT-2-large's layout
    (24 blocks, 16 heads, from `config_from_yaml` of a "large"
    vision_config) at width 128: every name, and the tower's output."""
    from xfm_tpu.models.beit2 import BeitVisionTransformer as JBeit
    from xfm_tpu.models.xfm import config_from_yaml as jconfig_from_yaml

    yaml = dict(tiny_yaml(vision_config=LARGE_JSON), vision_depth=None,
                vision_num_heads=None)
    jcfg = jconfig_from_yaml(yaml, dtype=jnp.float32)
    cfg = config_from_yaml(yaml, dtype=torch.float32)
    assert (jcfg.vision.depth, jcfg.vision.num_heads) == (24, 16)
    assert (cfg.vision.depth, cfg.vision.num_heads,
            cfg.vision.embed_dim) == (24, 16, 128)
    images = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    jt = JBeit(jcfg.vision)
    params = jax.jit(lambda: jt.init(jax.random.PRNGKey(0),
                                     jnp.asarray(images))["params"])()
    r = np.random.RandomState(1)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.02 * r.randn(
        *np.shape(x)).astype(np.float32), params)
    want = np.asarray(jax.jit(lambda p: jt.apply({"params": p}, jnp.asarray(
        images)))(params))
    tower = BeitVisionTransformer(cfg.vision)
    tower.load_state_dict(to_torch(beit2_from_jax(params, 24)), strict=True)
    with torch.no_grad():
        got = tower(torch.from_numpy(images)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    whole = state_dict_from_jax({"vision_encoder": params}, jcfg)
    assert {k[len("vision_encoder."):] for k in whole} == set(
        tower.state_dict())


def test_k1_plain_matches_pallas_at_16_heads():
    from test_torch_flash_attention import ATOL, RTOL, _inputs, _port
    from xfm_tpu.ops.flash_attention import _packed_bwd_impl, _packed_fwd_impl

    B, N, H, D = 2, 17, 16, 64
    qkv, bias, g = _inputs(B, N, H, D, seed=16)
    scale = D ** -0.5
    out, dqkv, db = _port(qkv, bias, g, scale, H)
    jout = _packed_fwd_impl(jnp.asarray(qkv), jnp.asarray(bias), scale, H,
                            interpret=True)
    jdqkv, jdb = _packed_bwd_impl(jnp.asarray(qkv), jnp.asarray(bias), scale,
                                  H, jnp.asarray(g), interpret=True)
    np.testing.assert_allclose(out, np.asarray(jout), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dqkv, np.asarray(jdqkv), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(db, np.asarray(jdb), atol=ATOL, rtol=RTOL)
