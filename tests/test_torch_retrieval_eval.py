"""The two-stage retrieval eval of the port against the JAX package's
(`xfm_tpu/tasks/retrieval.py`): grouped cross-attention, `itm_scores`,
`rerank_scores`, `itm_eval`, `evaluation` on a PNG corpus and the
`--evaluate` launcher with a checkpoint, at width 64, depth 2, f32, 384 px
with the BEiT-2 tower (N = 577 image tokens).

Both sides run f32 (JAX matmuls at 'highest' precision, exact erf-GELU) on
the same weights (carried across by `state_dict_from_jax`). On the CPU the
JAX package's dispatch takes its plain attention everywhere; the port's
takes K3's plain version where gs·T and 577 are both ≥ 512 (the grouped
rerank), its plain attention elsewhere. Tolerances: cross-attention
outputs and ITM logits atol 1e-5 / rtol 1e-4; score matrices atol 1e-5;
R@K and `itm_eval` exact.
"""
import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.configs import retrieval_eval_yaml
from xfm_tpu_torch.models import XFMForRetrieval, config_from_yaml
from xfm_tpu_torch.tasks import retrieval
from xfm_tpu_torch.train.checkpoint import state_dict_from_jax
from _torch_threads import one_intra_op_thread  # noqa: F401

RES, NK, C = 384, 577, 64
YCFG = retrieval_eval_yaml(
    image_res=RES, layers=2, vision_embed_dim=C, vision_num_heads=2,
    text_hidden_size=C, text_num_attention_heads=2,
    text_intermediate_size=128, text_vocab_size=99, embed_dim=32,
    compute_dtype="float32")


def _perturbed(params, seed):
    r = np.random.RandomState(seed)
    leaves, tree = jax.tree.flatten(params)
    return jax.tree.unflatten(tree, [
        np.asarray(x) + 0.02 * np.asarray(r.randn(*x.shape), np.float32)
        for x in leaves])


def _jax_params(jm, res, seed):
    from xfm_tpu.models.task_models import XFMForRetrieval as JRetrieval

    images = jnp.zeros((2, res, res, 3), jnp.float32)
    ids = jnp.ones((2, 8), jnp.int32)
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(seed)}, images, ids, ids,
        method=JRetrieval.init_all)["params"])()
    return _perturbed(params, seed)


@pytest.fixture(scope="module")
def models():
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.models.task_models import XFMForRetrieval as JRetrieval

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_EXACT_ERF", "1")  # erf-GELU on the JAX side
        mp.delenv("XFM_EVAL_GROUPED", raising=False)
        jcfg = jconfig_from_yaml(YCFG, use_contrastive_loss=True,
                                 use_matching_loss=True)
        jm = JRetrieval(jcfg)
        params = _jax_params(jm, RES, 0)
        cfg = config_from_yaml(YCFG, use_contrastive_loss=True,
                               use_matching_loss=True)
        model = XFMForRetrieval(cfg)
        model.load_state_dict(state_dict_from_jax(params, jcfg), strict=True)
        yield types.SimpleNamespace(jm=jm, jcfg=jcfg, params=params,
                                    model=model)


def _itm_inputs(U, gs, T, seed):
    """U image embeds [U, 577, C] and U·gs text rows, the runs of each
    image's candidates contiguous, their pads at the tails."""
    r = np.random.RandomState(seed)
    img = r.randn(U, NK, C).astype(np.float32)
    txt = r.randn(U * gs, T, C).astype(np.float32)
    atts = np.ones((U * gs, T), np.int64)
    for i in range(U * gs):
        atts[i, T - i % 5:] = 0
    return img, txt, atts


# (U, gs, T): gs·T = 640 and 577 keys route the port's grouped
# cross-attention to K3's dispatch; 48 stays on the plain attention
GROUPS = [(2, 16, 40), (3, 4, 12)]


@pytest.mark.parametrize("U,gs,T", GROUPS)
@pytest.mark.parametrize("bias_rows", ["per_row", "per_image"])
def test_grouped_cross_attention_matches_jax_and_repeat(models, U, gs, T,
                                                        bias_rows,
                                                        monkeypatch):
    """The fusion encoder's first cross-attention with kv_group_size, against
    JAX `SelfAttention(is_cross=True)(kv_group_size=gs)` and against the
    port's repeat form (k/v repeated per row). The bias comes per text row
    (the group's first row stands for it) or per image. Where gs·T ≥ 512,
    K3's entry gets q as a view of the projection ([U, gs·T, H, D],
    contiguous, so the kernel reads it in place) and a bias of U rows."""
    from xfm_tpu.models.text_encoder import SelfAttention as JSelfAttention
    from xfm_tpu.ops.attention import mask_to_bias as jmask_to_bias
    from xfm_tpu_torch.ops import flash_attention as fa
    from xfm_tpu_torch.ops.attention import mask_to_bias

    calls = []

    def spy(q, k, v, bias=None, scale=None):
        calls.append((tuple(q.shape), q.is_contiguous(), q._base is not None,
                      tuple(bias.shape)))
        return fa.flash_attention_reference(q, k, v, bias, scale)

    monkeypatch.setattr(fa, "flash_attention", spy)

    s = models
    img, txt, _ = _itm_inputs(U, gs, T, 1)
    img_atts = np.ones((U, NK), np.int64)
    img_atts[:, NK - 9:] = 0
    rows = img_atts if bias_rows == "per_image" else np.repeat(img_atts, gs,
                                                               axis=0)
    jp = s.params["backbone"]["fusion_encoder"]["layer_0"]["crossattention"]
    want = JSelfAttention(s.jcfg.fusion, is_cross=True).apply(
        {"params": jp}, jnp.asarray(txt), jnp.asarray(img),
        jmask_to_bias(jnp.asarray(rows)), kv_group_size=gs)
    att = s.model.fusion_encoder.roberta.encoder.layer[0].crossattention
    with torch.no_grad():
        got = att(torch.from_numpy(txt), torch.from_numpy(img),
                  mask_to_bias(torch.from_numpy(rows)), kv_group_size=gs)
        rep = att(torch.from_numpy(txt),
                  torch.from_numpy(np.repeat(img, gs, axis=0)),
                  mask_to_bias(torch.from_numpy(np.repeat(img_atts, gs,
                                                          axis=0))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), rep.numpy(), atol=1e-5,
                               rtol=1e-4)
    if gs * T >= 512:
        assert calls == [((U, gs * T, 2, 32), True, True, (U, 1, 1, NK))]
    else:
        assert calls == []


def test_grouped_cross_attention_refuses_prob_gate(models):
    att = models.model.fusion_encoder.roberta.encoder.layer[0].crossattention
    img, txt, _ = _itm_inputs(2, 4, 6, 2)
    with pytest.raises(NotImplementedError, match="prob_gate"):
        att(torch.from_numpy(txt), torch.from_numpy(img), None,
            kv_group_size=4, prob_gate=torch.ones(1))


@pytest.mark.parametrize("U,gs,T", GROUPS)
@pytest.mark.parametrize("form", ["grouped", "repeat", "row_idx"])
def test_itm_scores_match_jax(models, U, gs, T, form):
    from xfm_tpu.models.task_models import XFMForRetrieval as JRetrieval

    s = models
    img, txt, atts = _itm_inputs(U, gs, T, 3)
    kw, jkw = {}, {}
    if form == "grouped":
        image = img
        kw = jkw = {"image_group_size": gs}
    elif form == "repeat":
        image = np.repeat(img, gs, axis=0)
    else:
        image = img
        row_idx = np.repeat(np.arange(U), gs)
        kw = {"image_row_idx": torch.from_numpy(row_idx)}
        jkw = {"image_row_idx": jnp.asarray(row_idx)}
    want = s.jm.apply({"params": s.params}, jnp.asarray(image),
                      jnp.asarray(txt), jnp.asarray(atts),
                      method=JRetrieval.itm_scores, **jkw)
    with torch.no_grad():
        got = s.model.itm_scores(torch.from_numpy(image),
                                 torch.from_numpy(txt),
                                 torch.from_numpy(atts), **kw)
    assert got.shape == (U * gs,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)


def _corpus_embeds(n_img, n_txt, T, seed):
    r = np.random.RandomState(seed)
    img = r.randn(n_img, NK, C).astype(np.float32)
    txt = r.randn(n_txt, T, C).astype(np.float32)
    atts = np.ones((n_txt, T), np.int64)
    for i in range(n_txt):
        atts[i, T - i % 7:] = 0
    sims = r.randn(n_img, n_txt).astype(np.float32)
    return img, txt, atts, sims


@pytest.mark.parametrize("grouped", ["1", "0"])
def test_rerank_scores_match_jax(models, monkeypatch, grouped):
    """Same sims → the same candidate sets and ITM scores (k_test = 16,
    T = 40: the grouped chunks reach K3's dispatch), each direction; the
    union of a 2-process row split equals the one-process rerank."""
    from xfm_tpu.tasks.retrieval import rerank_scores as jrerank

    s = models
    monkeypatch.setenv("XFM_EVAL_GROUPED", grouped)
    img, txt, atts, sims = _corpus_embeds(18, 21, 40, 4)
    k = 16
    want = jrerank(s.jm, s.params, img, txt, atts.astype(np.int32), sims, k,
                   process_index=0, process_count=1)
    args = (torch.from_numpy(img), torch.from_numpy(txt),
            torch.from_numpy(atts), sims, k)
    got = retrieval.rerank_scores(s.model, *args, process_index=0,
                                  process_count=1)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g == -100.0, np.asarray(w) == -100.0)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)
    parts = [retrieval.rerank_scores(s.model, *args, process_index=p,
                                     process_count=2) for p in range(2)]
    for d in range(2):
        merged = parts[0][d] + parts[1][d] + 100.0
        np.testing.assert_allclose(merged, got[d], atol=1e-5)
    assert (parts[0][0][1] == -100).all() and (parts[1][0][0] == -100).all()
    assert retrieval.merge_rerank_scores(*got) == got


def test_itm_eval_matches_jax():
    from xfm_tpu.tasks.retrieval import itm_eval as jitm_eval

    r = np.random.RandomState(5)
    n_img, per = 23, 3
    s_i2t = r.randn(n_img, n_img * per).astype(np.float32)
    s_t2i = r.randn(n_img * per, n_img).astype(np.float32)
    s_i2t[r.rand(*s_i2t.shape) < 0.5] = -100.0
    img2txt = {i: list(range(per * i, per * (i + 1))) for i in range(n_img)}
    txt2img = {t: t // per for t in range(n_img * per)}
    got = retrieval.itm_eval(s_i2t, s_t2i, img2txt, txt2img)
    want = jitm_eval(s_i2t, s_t2i, img2txt, txt2img)
    assert got == want


def _png_corpus(root, n_img, per_image):
    from PIL import Image

    rng = np.random.default_rng(0)
    ann = []
    for i in range(n_img):
        arr = rng.integers(0, 255, (48, 40, 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / f"img{i}.png")
        words = ["a", "photo", "of", "the", "red", "blue", "dog", "cat",
                 "on", "grass", "with", "sky"]
        caps = [" ".join(rng.choice(words, 3 + (i + j) % 9))
                + f" number {i}." for j in range(per_image)]
        ann.append({"image": f"img{i}.png", "caption": caps})
    (root / "test.json").write_text(json.dumps(ann))
    return str(root / "test.json")


def test_evaluation_matches_jax_on_png_corpus(models, tmp_path):
    """16 PNGs with 2 captions each, read by each package's own
    RetrievalEvalData (TestTransform at 384 px, the SimpleTokenizer over
    the captions, T = 40): stage 1's features, the rerank's scores on each
    side's own sims (k_test = 16, so gs·T = 640), and R@K."""
    from xfm_tpu.data.finetune_data import RetrievalEvalData as JData
    from xfm_tpu.data.tokenization import SimpleTokenizer as JTok
    from xfm_tpu.data.transforms import TestTransform as JTest
    from xfm_tpu.tasks import retrieval as jret
    from xfm_tpu_torch.data.finetune_data import RetrievalEvalData
    from xfm_tpu_torch.data.tokenization import SimpleTokenizer
    from xfm_tpu_torch.data.transforms import TestTransform

    s = models
    ann = _png_corpus(tmp_path, 16, 2)
    texts = retrieval._ann_texts(ann)
    jdata = JData(ann, JTest(RES), str(tmp_path), JTok.from_texts(texts),
                  max_tokens=40)
    data = RetrievalEvalData(ann, TestTransform(RES), str(tmp_path),
                             SimpleTokenizer.from_texts(texts),
                             max_tokens=40)
    cfg = dict(YCFG, batch_size_test=6, k_test=16)
    jenc = jret.encode_corpus(s.jm, s.params, jdata, 6)
    enc = retrieval.encode_corpus(s.model, data, 6)
    for g, w in zip(enc, jenc):
        g = g.numpy() if torch.is_tensor(g) else g
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-4)
    jsims = np.asarray(jenc[1]) @ np.asarray(jenc[3]).T
    sims = enc[1] @ enc[3].T
    np.testing.assert_array_equal(np.argsort(-sims, 1)[:, :16],
                                  np.argsort(-jsims, 1)[:, :16])
    jscores = jret.rerank_scores(s.jm, s.params, *[np.asarray(x) for x in
                                 (jenc[0], jenc[2], jenc[4])], jsims, 16,
                                 process_index=0, process_count=1)
    scores = retrieval.rerank_scores(s.model, enc[0], enc[2], enc[4], sims,
                                     16)
    for g, w in zip(scores, jscores):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)
    want = jret.evaluation(s.jm, s.params, jdata, cfg)
    got = retrieval.evaluation(s.model, data, cfg)
    assert got == want
    assert all(0.0 <= v <= 100.0 for v in got.values())


def test_run_evaluate_matches_jax_with_checkpoint(models, tmp_path):
    """The port's launcher (`python3 -m xfm_tpu_torch.run --task itr_coco
    --evaluate --checkpoint ...`, here on the CPU) against JAX
    `retrieval.main`, on a checkpoint the JAX package writes
    (`export_xfm_checkpoint` + `save_torch_checkpoint`) from a 224 px
    model, so both sides interpolate its rel-pos tables to 384 px: the same
    R@K. Without --evaluate the port fine-tunes from the checkpoint (one
    epoch at batch 4 on the corpus' pairs): a zero-shot eval, an epoch,
    an eval and ckpt/0. The launcher's tasks are the repository's
    `run.py`'s."""
    import yaml

    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.models.task_models import XFMForRetrieval as JRetrieval
    from xfm_tpu.tasks import retrieval as jret
    from xfm_tpu.train.checkpoint import (export_xfm_checkpoint,
                                          save_torch_checkpoint)
    from xfm_tpu_torch import run

    ann = _png_corpus(tmp_path, 10, 2)
    ycfg = {k: v for k, v in YCFG.items() if k not in ("train_file",
                                                       "val_file", "_vision")}
    ycfg.update(test_file=ann, image_root=str(tmp_path), batch_size_test=4,
                k_test=6)
    cfg_path = tmp_path / "ret.yaml"
    cfg_path.write_text(yaml.safe_dump(ycfg))
    tok = jret.build_tokenizer_or_fallback(ycfg,
                                           lambda: jret._ann_texts(ann))
    jcfg224 = jret._maybe_shrink_vocab(jconfig_from_yaml(
        dict(ycfg, image_res=224), use_contrastive_loss=True,
        use_matching_loss=True), tok)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_EXACT_ERF", "1")
        params = _jax_params(JRetrieval(jcfg224), 224, 7)
        ckpt = tmp_path / "ckpt.th"
        save_torch_checkpoint(str(ckpt), export_xfm_checkpoint(params,
                                                               jcfg224))
        argv = ["--task", "itr_coco", "--config", str(cfg_path),
                "--checkpoint", str(ckpt), "--evaluate", "--seed", "0"]
        want = jret.main(types.SimpleNamespace(
            config=str(cfg_path), output_dir=str(tmp_path / "jax"),
            checkpoint=str(ckpt), evaluate=True, bs=None, epoch=None,
            seed=0))
        got = run.main(argv + ["--output_dir", str(tmp_path / "port"),
                               "--device", "cpu"])
    assert got == want
    assert (tmp_path / "port" / "config.yaml").exists()
    log = (tmp_path / "port" / "log.txt").read_text().splitlines()
    assert json.loads(log[-1])["eval"]["r_mean"] == got["r_mean"]
    train = [{"image": a["image"], "caption": c, "image_id": i}
             for i, a in enumerate(json.loads(open(ann).read()))
             for c in a["caption"]]
    (tmp_path / "train.json").write_text(json.dumps(train))
    ft_path = tmp_path / "ft.yaml"
    ft_path.write_text(yaml.safe_dump(dict(
        ycfg, train_file=str(tmp_path / "train.json"))))
    ft = run.main(["--task", "itr_coco", "--config", str(ft_path),
                   "--checkpoint", str(ckpt), "--bs", "4", "--epoch", "1",
                   "--device", "cpu", "--output_dir", str(tmp_path / "ft")])
    log = [json.loads(line) for line in
           (tmp_path / "ft" / "log.txt").read_text().splitlines()]
    assert [e["epoch"] for e in log] == [-1, 0]
    assert log[0]["r_mean"] == got["r_mean"]  # zero-shot: the same weights
    assert np.isfinite(log[1]["loss_itc"]) and np.isfinite(log[1]["loss_itm"])
    assert ft["best_r_mean"] >= log[0]["r_mean"]
    assert (tmp_path / "ft" / "ckpt" / "0" / "state.pt").exists()
    # every task of the repository's run.py is ported; any other is an
    # argparse error
    import run as repo_run

    assert set(run.TASKS) == set(repo_run.TASKS)
    with pytest.raises(SystemExit):
        run.main(["--task", "imagenet22k", "--config", str(cfg_path)])
