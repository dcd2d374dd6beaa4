"""VQA's data, accuracy, checkpoint routes and task in the port
(`xfm_tpu_torch/data/finetune_data.py` `VQAData`,
`xfm_tpu_torch/eval/vqa_eval.py`, `train/checkpoint.vqa_checkpoint`,
`tasks/vqa.py`, `run.py --task vqa`), the first three against the JAX
package's.

- `VQAData`: train and test batches bit-equal to the JAX class's, from one
  tokenizer instance, seeded transforms on both sides (the port reseeds
  its own from [epoch_seed, 1] each epoch; the JAX package's is built
  with that seed), on PNGs under two roots: the careful flip with its
  left/right swap, Visual Genome rows at 0.5, count / n weights, the
  weight-0 pads, the question ids, the encoded answer list.
- `vqa_eval`: the port's copy equal to the JAX module on raw answers.
- The checkpoint routes: the port's loaded model equal, bit for bit, to
  the JAX package's import of the same state dict (`xfm_tpu/tasks/vqa.py`'s
  branch: `import_xfm_checkpoint`, `import_text_encoder`, `merge_params`)
  carried across by `state_dict_from_jax`, case by case.
- `python3 -m xfm_tpu_torch.run --task vqa --device cpu` on a tiny YAML
  (width 32, 2 + 2 + 2 + 2 layers, 32 px, f32): the fine-tune's
  checkpoints, per-epoch and final result files with one answer a
  question, the accuracies; the resume bit-equal to the uninterrupted run
  on one CPU thread; `--evaluate --checkpoint` from the run's own
  checkpoint giving the run's final answers; the default YAML.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

import jax

from xfm_tpu_torch.configs import vqa_yaml
from xfm_tpu_torch.models import XFMForVQA
from xfm_tpu_torch.train.checkpoint import (init_weights,
                                            load_xfm_checkpoint,
                                            reference_state_dict,
                                            state_dict_from_jax,
                                            vqa_checkpoint)
from _torch_threads import one_intra_op_thread  # noqa: F401

C, V = 32, 100
WORDS = ["what", "is", "on", "the", "of", "man", "dog", "color", "how",
         "many", "red", "blue", "two", "yes", "no", "cat"]


def _png(path, r, h, w):
    from PIL import Image

    Image.fromarray(r.randint(0, 255, (h, w, 3)).astype(np.uint8)).save(path)


def _corpus(root, n_train=14, n_test=6, seed=0):
    """PNGs under root/coco and root/vg; train rows of both datasets (VQA
    rows with 10 human answers, some repeated; VG rows with one answer),
    questions and answers that mention left and right; test rows with
    question ids, a list of human answers or one answer; an answer list
    that holds every answer."""
    r = np.random.RandomState(seed)
    for d in ("coco", "vg"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    answers = ["yes", "no", "two", "red", "left", "right", "blue dog",
               "on the left", "cat"]
    train, test = [], []
    for i in range(n_train + n_test):
        ds = "vg" if i % 3 == 2 and i < n_train else "vqa"
        name = f"img{i}.png"
        _png(os.path.join(root, "vg" if ds == "vg" else "coco", name), r,
             20 + 3 * i, 44 - i)
        q = " ".join(r.choice(WORDS, 3 + i % 5)) + (
            " on the left?" if i % 2 else " Right?")
        if i < n_train:
            ans = (str(r.choice(answers)) if ds == "vg"
                   else [str(a) for a in r.choice(answers[:4 + i % 5], 10)])
            train.append({"image": name, "question": q, "answer": ans,
                          "dataset": ds})
        else:
            ans = ([str(a) for a in r.choice(answers, 10)] if i % 2
                   else str(r.choice(answers)))
            test.append({"image": name, "question": q, "answer": ans,
                         "question_id": 1000 + i, "dataset": "vqa"})
    paths = {}
    for name, obj in (("train", train), ("test", test),
                      ("answers", answers)):
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    return paths


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vqa"))
    return root, _corpus(root)


def _tokenizer(paths):
    from xfm_tpu_torch.data.tokenization import SimpleTokenizer
    from xfm_tpu_torch.tasks.vqa import vqa_texts

    return SimpleTokenizer.from_texts(vqa_texts(
        {"train_file": [paths["train"]], "test_file": [paths["test"]],
         "answer_list": paths["answers"]}))


@pytest.mark.parametrize("epoch_seed", [0, 43])
def test_vqa_data_bit_equal_to_jax(corpus, epoch_seed):
    from xfm_tpu.data.finetune_data import VQAData as JData
    from xfm_tpu.data.transforms import TestTransform as JTest
    from xfm_tpu.data.transforms import TrainTransform as JTrain

    from xfm_tpu_torch.data.finetune_data import VQAData
    from xfm_tpu_torch.data.transforms import TestTransform, TrainTransform

    root, paths = corpus
    roots = {"vqa": os.path.join(root, "coco"),
             "vg": os.path.join(root, "vg")}
    tok = _tokenizer(paths)
    ours = VQAData([paths["train"]], TrainTransform(48, hflip=False,
                                                    seed=7),
                   roots, tok, batch_size=4, split="train")
    theirs = JData([paths["train"]], JTrain(48, hflip=False,
                                            seed=[epoch_seed, 1]),
                   roots, tok, batch_size=4, split="train")
    got, want = list(ours.epoch(epoch_seed)), list(theirs.epoch(epoch_seed))
    assert len(got) == len(want) == 3  # 14 rows, the last 2 dropped
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == sorted(
            ["images", "q_ids", "q_atts", "answer_ids", "answer_atts",
             "weights", "ques_idx"])
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
        assert g["answer_ids"].shape == (16, 10)
    weights = np.concatenate([b["weights"] for b in got])
    assert {0.0, 0.5} <= set(weights.tolist())  # pads and VG rows
    ours_t = VQAData([paths["test"]], TestTransform(48), roots, tok,
                     batch_size=4, split="test",
                     answer_list=paths["answers"])
    theirs_t = JData([paths["test"]], JTest(48), roots, tok, batch_size=4,
                     split="test", answer_list=paths["answers"])
    got, want = list(ours_t.epoch()), list(theirs_t.epoch())
    assert len(got) == len(want) == 2  # the last batch kept
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    for a, b in zip(ours_t.encode_answer_list(),
                    theirs_t.encode_answer_list()):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_vqa_data_flip_swaps_left_and_right(corpus):
    from xfm_tpu_torch.data.finetune_data import VQAData

    assert VQAData._swap_left_right("the left dog right of it") == \
        "the right dog left of it"
    root, paths = corpus
    tok = _tokenizer(paths)

    class Fixed:
        def reseed(self, seed):
            pass

        def __call__(self, img):
            return np.arange(2 * 3 * 3, dtype=np.float32).reshape(2, 3, 3)

    data = VQAData([paths["train"]], Fixed(),
                   {"vqa": os.path.join(root, "coco"),
                    "vg": os.path.join(root, "vg")}, tok, batch_size=14,
                   split="train")
    (batch,) = list(data.epoch(3))
    flipped = batch["images"][:, 0, 0, 0] != 0
    assert flipped.any() and not flipped.all()
    order = np.arange(14)
    np.random.default_rng(3).shuffle(order)
    right, left = tok.convert_tokens_to_ids(["right", "left"])
    for b in range(14):
        # each question holds one of the two words: swapped iff flipped
        was_left = "left" in data.ann[order[b]]["question"]
        q = batch["q_ids"][b].tolist()
        assert (left in q, right in q) == (
            (was_left, not was_left) if not flipped[b]
            else (not was_left, was_left))


def test_vqa_eval_copy_matches_jax():
    from xfm_tpu.eval import vqa_eval as jv

    from xfm_tpu_torch.eval import vqa_eval as tv

    raw = ["Two", "2", "two.", "the dog", "A Dog!", "dont", "isnt it",
           "3,000", "10 / 20", "yes\n", "none", "it's (red)", "e.g. 5.5",
           "ten", "Cat's", "hasnt"]
    assert [tv.process_answer(a) for a in raw] == \
        [jv.process_answer(a) for a in raw]
    r = np.random.RandomState(0)
    ann = {i: [str(a) for a in r.choice(raw, 10)] for i in range(20)}
    preds = [{"question_id": i, "answer": str(r.choice(raw))}
             for i in range(25)]
    assert tv.vqa_accuracy(preds, ann) == jv.vqa_accuracy(preds, ann)
    assert tv.vqa_accuracy([], ann) == jv.vqa_accuracy([], ann) == 0


def _small_yaml(**keys):
    return vqa_yaml(image_res=32, layers=2, **{**dict(
        vision_embed_dim=C, vision_num_heads=2, text_hidden_size=C,
        text_num_attention_heads=2, text_intermediate_size=64,
        text_vocab_size=V, compute_dtype="float32"), **keys})


@pytest.fixture(scope="module")
def jax_vqa():
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.models.generation import XFMForVQA as JVQA

    import jax.numpy as jnp

    jcfg = jconfig_from_yaml(_small_yaml())
    jm = JVQA(jcfg, num_dec_layers=2)
    init = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)),
        jnp.ones((1, 5), jnp.int32), jnp.ones((1, 5), jnp.int32),
        method=JVQA.init_all)["params"])()
    return jcfg, init


def _jax_route(sd, jcfg, init, own):
    """`xfm_tpu/tasks/vqa.py`'s import of `--checkpoint`, its lines as they
    are."""
    from xfm_tpu.models.generation import make_decoder_config
    from xfm_tpu.train.checkpoint import (import_text_encoder,
                                          import_xfm_checkpoint,
                                          merge_params, strip_prefix,
                                          to_jax)

    imported = import_xfm_checkpoint(sd, jcfg)
    has_decoder = any(k.startswith("text_decoder.") for k in sd)
    if own and has_decoder:
        sub = strip_prefix(sd, "text_decoder.roberta.")
        sub.update({k[len("text_decoder."):]: v for k, v in sd.items()
                    if k.startswith("text_decoder.lm_head.")})
        if not sub:
            sub = strip_prefix(sd, "text_decoder.bert.")
            sub.update({k[len("text_decoder."):]: v for k, v in sd.items()
                        if k.startswith("text_decoder.cls.")})
        imported["text_decoder"] = import_text_encoder(
            sub, make_decoder_config(jcfg, 2, 0), with_mlm=True)
    elif "fusion_encoder" in imported["backbone"]:
        imported["text_decoder"] = imported["backbone"]["fusion_encoder"]
    params, missing, _ = merge_params(init, to_jax(imported))
    return params, missing


def _bert_names(sd):
    out = {}
    for k, v in sd.items():
        k = k.replace("text_decoder.roberta.", "text_decoder.bert.")
        for a, b in (("lm_head.dense.", "cls.predictions.transform.dense."),
                     ("lm_head.layer_norm.",
                      "cls.predictions.transform.LayerNorm."),
                     ("lm_head.bias", "cls.predictions.bias"),
                     ("lm_head.decoder.", "cls.predictions.decoder.")):
            k = k.replace("text_decoder." + a, "text_decoder." + b)
        out[k] = v
    return out


@pytest.mark.parametrize("case", ["vqa_eval", "vqa_finetune",
                                  "pretrain_eval", "bert_names"])
def test_checkpoint_routes_match_jax(jax_vqa, case):
    """A VQA checkpoint evaluated (its own decoder) or fine-tuned without
    `load_vqa_pretrain` (the decoder from its fusion encoder); a pretrain
    checkpoint, which has no decoder (the decoder from its fusion
    encoder); a VQA checkpoint under the BERT names (`text_decoder.bert.`,
    `cls.predictions.`)."""
    jcfg, init = jax_vqa
    src = XFMForVQA.from_yaml(_small_yaml())
    init_weights(src, 5)
    sd = {k: v.numpy() for k, v in reference_state_dict(src).items()}
    own = case != "vqa_finetune"
    if case == "pretrain_eval":
        sd = {k: v for k, v in sd.items()
              if not k.startswith("text_decoder.")}
    elif case == "bert_names":
        sd = _bert_names(sd)
    params, missing = _jax_route(sd, jcfg, init, own)
    assert not missing
    model = XFMForVQA.from_yaml(_small_yaml())
    init_weights(model, 9)
    load_xfm_checkpoint(model, vqa_checkpoint(sd, model, own))
    want = state_dict_from_jax(params, jcfg)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k].reshape(got[k].shape)), k
    dec, fus = "text_decoder.roberta.", "fusion_encoder.roberta."
    from_fusion = case in ("vqa_finetune", "pretrain_eval")
    same = torch.equal(got[dec + "encoder.layer.1.crossattention.self."
                           "key.weight"],
                       got[fus + "encoder.layer.1.crossattention.self."
                           "key.weight"])
    assert same == from_fusion


def test_decoder_from_fusion_refuses_other_widths():
    model = XFMForVQA.from_yaml(_small_yaml(vision_embed_dim=48))
    sd = {k: v.numpy() for k, v in reference_state_dict(model).items()
          if k.startswith("fusion_encoder.")}
    with pytest.raises(ValueError, match="fusion encoder"):
        vqa_checkpoint(sd, model, own_decoder=True)


def _task_yaml(root, paths, **keys):
    cfg = _small_yaml(
        train_file=[paths["train"]], test_file=[paths["test"]],
        answer_list=paths["answers"], vqa_root=os.path.join(root, "coco"),
        vg_root=os.path.join(root, "vg"), k_test=4, batch_size_test=4,
        start_eval=0, resume=True,
        optimizer={"opt": "adamW", "lr": 1e-3, "weight_decay": 0.01,
                   "lr_mult": 2},
        schedular={"sched": "linear", "lr": 1e-3, "epochs": 2,
                   "num_warmup_steps": 0.1}, **keys)
    path = os.path.join(root, f"vqa{len(os.listdir(root))}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _result(out, tag=""):
    with open(os.path.join(out, "result", f"vqa_result{tag}.json")) as f:
        return json.load(f)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_vqa_on_the_cpu(corpus, tmp_path, one_thread):
    """The fine-tune (2 epochs of 3 steps, an eval after epoch 0 and at the
    end), its resume, and `--evaluate` from its own checkpoint."""
    from xfm_tpu_torch import run

    root, paths = corpus
    cfg = _task_yaml(root, paths)
    out = str(tmp_path / "out")
    argv = ["--task", "vqa", "--config", cfg, "--output_dir", out,
            "--device", "cpu", "--bs", "4", "--seed", "3"]
    res = run.main(argv)
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["0", "1"]
    qids = sorted(a["question_id"] for a in json.load(open(paths["test"])))
    answers = set(json.load(open(paths["answers"])))
    for tag in ("_epoch0", ""):
        rows = _result(out, tag)
        assert sorted(r["question_id"] for r in rows) == qids
        assert all(r["answer"] in answers for r in rows)
    assert not os.path.exists(os.path.join(out, "result",
                                           "vqa_result_epoch1.json"))
    assert res["result_file"] == os.path.join(out, "result",
                                              "vqa_result.json")
    assert 0 <= res["vqa_acc_exact"] <= 1
    assert 0 <= res["vqa_acc_official"] <= 1
    with open(os.path.join(out, "log.txt")) as f:
        log = [json.loads(x) for x in f.read().splitlines()]
    assert [e.get("epoch") for e in log if "loss" in e] == [0, 1]
    assert all(np.isfinite(e["loss"]) for e in log if "loss" in e)
    assert log[-1] == {k: res[k] for k in ("vqa_acc_exact",
                                           "vqa_acc_official")}
    final = torch.load(os.path.join(out, "ckpt", "1", "state.pt"),
                       weights_only=True)

    # the resume: ckpt/1 deleted, the run goes on at epoch 1
    shutil.rmtree(os.path.join(out, "ckpt", "1"))
    first = _result(out)
    again = run.main(argv)
    resumed = torch.load(os.path.join(out, "ckpt", "1", "state.pt"),
                         weights_only=True)
    assert resumed["step"] == final["step"] == 6
    for n, p in final["params"].items():
        assert torch.equal(p, resumed["params"][n]), n
    assert _result(out) == first and again == res

    # --evaluate from the run's own checkpoint ranks as the run did
    ev = run.main(["--task", "vqa", "--config", cfg, "--output_dir",
                   str(tmp_path / "ev"), "--device", "cpu", "--evaluate",
                   "--checkpoint", os.path.join(out, "ckpt", "1",
                                                "state.pt")])
    assert _result(str(tmp_path / "ev")) == first
    assert ev["vqa_acc_exact"] == res["vqa_acc_exact"]


def test_run_vqa_evaluate_from_a_pretrain_checkpoint(corpus, tmp_path):
    """`--evaluate` with a state dict that has no decoder: the decoder is
    the checkpoint's fusion encoder."""
    from xfm_tpu_torch import run
    from xfm_tpu_torch.tasks import vqa

    root, paths = corpus
    cfg = _task_yaml(root, paths)
    vocab = max(16, _tokenizer(paths).vocab_size)  # the task's fallback
    src = XFMForVQA.from_yaml(_small_yaml(text_vocab_size=vocab),
                              pad_token_id=0)
    init_weights(src, 11)
    ckpt = str(tmp_path / "pretrain.pth")
    torch.save({"model": {k: v for k, v in
                          reference_state_dict(src).items()
                          if not k.startswith("text_decoder.")}}, ckpt)
    seen = {}
    real = vqa.evaluate

    def evaluate(model, *a, **kw):
        seen["model"] = model
        return real(model, *a, **kw)

    vqa.evaluate = evaluate
    try:
        res = run.main(["--task", "vqa", "--config", cfg, "--output_dir",
                        str(tmp_path / "out"), "--device", "cpu",
                        "--evaluate", "--checkpoint", ckpt])
    finally:
        vqa.evaluate = real
    sd = seen["model"].state_dict()
    for k, v in sd.items():
        if k.startswith("text_decoder."):
            f = "fusion_encoder." + k[len("text_decoder."):]
            assert torch.equal(v, sd[f]), k
    assert len(_result(str(tmp_path / "out"))) == 6
    assert set(res) == {"result_file", "vqa_acc_exact", "vqa_acc_official"}


def test_run_vqa_falls_back_to_the_default_config(monkeypatch, tmp_path):
    from xfm_tpu_torch import run
    from xfm_tpu_torch.tasks import vqa

    seen = []
    monkeypatch.setattr(vqa, "main", lambda args: seen.append(args.config))
    for extra in ([], ["--config", str(tmp_path / "missing.yaml")]):
        run.main(["--task", "vqa", "--output_dir", str(tmp_path)] + extra)
    want = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "configs", "xfm-ft", "VQA.yaml")
    assert seen == [want, want] and os.path.exists(want)
    with open(want) as f:
        from xfm_tpu_torch import configs

        assert configs.VQA == yaml.safe_load(f)


def test_fallback_tokenizer_holds_the_corpus_words(corpus, tmp_path,
                                                   monkeypatch):
    """Without the RoBERTa files the JAX task builds its fallback tokenizer
    over no text (`xfm_tpu/tasks/vqa.py:116`), so every word reads as
    unknown; the port's holds every word of the questions, the answers and
    the answer list."""
    from xfm_tpu.tasks.retrieval import build_tokenizer_or_fallback as jbuild

    from xfm_tpu_torch import run
    from xfm_tpu_torch.tasks import vqa

    root, paths = corpus
    cfg_path = _task_yaml(root, paths)
    with open(cfg_path) as f:
        assert jbuild(yaml.safe_load(f)).vocab_size == 5  # the specials
    seen = []
    real = vqa.build_tokenizer_or_fallback
    monkeypatch.setattr(vqa, "build_tokenizer_or_fallback",
                        lambda cfg, texts_fn: seen.append(real(
                            cfg, texts_fn)) or seen[-1])
    run.main(["--task", "vqa", "--config", cfg_path, "--output_dir",
              str(tmp_path), "--device", "cpu", "--evaluate"])
    (tok,) = seen
    texts = [a["question"] for a in json.load(open(paths["test"]))]
    texts += json.load(open(paths["answers"]))
    assert all(tok.unk_token not in tok.tokenize(t) for t in texts)
