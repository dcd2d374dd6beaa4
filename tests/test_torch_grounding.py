"""RefCOCO grounding in the port against the JAX package: `XFMForGrounding`,
its parameter tree and optimizer groups, `GroundingData`, the box-aware
train transform (Queue 3B fault (b)), `eval/refer.py`, stage 1's losses on
a regions-only config, the two-stage hand-off across resolutions (fault
(c)), the fallback tokenizer, `python3 -m xfm_tpu_torch.run --task
refcoco_bbox --device cpu` and `main_weakly_supervised`
(`xfm_tpu/models/task_models.py`, `xfm_tpu/data/finetune_data.py`,
`xfm_tpu/eval/refer.py`, `xfm_tpu/tasks/grounding.py`).

Both models run f32 (JAX at 'highest' precision, exact erf-GELU) on the
same weights, carried across by `state_dict_from_jax`, at width 32, 2
vision, text and fusion layers and 32 px images. Tolerances: coords atol
1e-6; losses rtol 1e-5 (stage 1's rtol 1e-4, atol 1e-7, as the pretrain
task's test holds them); gradients atol 1e-5 + 1e-3 of each tensor's
largest value; two optimizer updates rtol 1e-6; batches, REFER's rows and
accuracies, and the interpolated tables bit for bit.
"""
import json
import os
import pickle
import shutil
import types

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from test_torch_nlvr import check_tree_and_groups
from test_torch_pretrain_data import write_corpus
from xfm_tpu_torch.configs import grounding_yaml
from xfm_tpu_torch.models import XFMForGrounding, config_from_yaml
from xfm_tpu_torch.train.checkpoint import state_dict_from_jax

C, V = 32, 60
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["the", "man", "on", "left", "red", "car", "right", "woman",
         "in", "blue", "shirt", "dog", "near", "table", "white", "cup"]
SMALL = dict(layers=2, vision_embed_dim=C, vision_num_heads=2,
             text_hidden_size=C, text_num_attention_heads=2,
             text_intermediate_size=64, compute_dtype="float32",
             drop_path_rate=0.0)


def small_yaml(image_res=32, **keys):
    return grounding_yaml(image_res=image_res, text_vocab_size=V,
                          **dict(SMALL, **keys))


@pytest.fixture(scope="module")
def pair():
    from xfm_tpu.models import XFMForGrounding as JGround
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_EXACT_ERF", "1")
        ycfg = small_yaml()
        jcfg = jconfig_from_yaml(ycfg, use_bbox_loss=True)
        jm = JGround(jcfg)
        params = jax.jit(lambda: jm.init(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 32, 32, 3)),
            jnp.ones((2, 6), jnp.int32), jnp.ones((2, 6), jnp.int32),
            method=JGround.init_all)["params"])()
        r = np.random.RandomState(0)
        params = jax.tree.map(lambda x: np.asarray(
            np.asarray(x) + 0.1 * r.randn(*np.shape(x)), np.float32), params)
        model = XFMForGrounding(config_from_yaml(ycfg, use_bbox_loss=True))
        model.load_state_dict(state_dict_from_jax(params, jcfg), strict=True)
        yield jm, jcfg, params, model


def test_grounding_coords_loss_and_grads_match_jax(pair, monkeypatch):
    """The sigmoid cxcywh boxes (`train=False`), L1 and GIoU against the
    targets, and every parameter's gradient of their sum."""
    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    jm, jcfg, params, model = pair
    r = np.random.RandomState(1)
    B, T = 3, 8
    images = r.randn(B, 32, 32, 3).astype(np.float32)
    ids = r.randint(5, V - 1, (B, T)).astype(np.int32)
    ids[:, 0] = 1
    atts = np.ones((B, T), np.int32)
    ids[1, 5], ids[1, 6:], atts[1, 6:] = 2, 0, 0
    tgt = np.asarray([[0.5, 0.5, 0.4, 0.3], [0.3, 0.6, 0.2, 0.5],
                      [0.7, 0.2, 0.3, 0.2]], np.float32)
    args = tuple(jnp.asarray(x) for x in (images, ids, atts))
    jcoords = np.asarray(jax.jit(lambda p: jm.apply(
        {"params": p}, *args, train=False))(params))

    def loss(p):
        lb, lg = jm.apply({"params": p}, *args, target_bbox=jnp.asarray(tgt),
                          train=True)
        return lb + lg, (lb, lg)

    (_, (jlb, jlg)), jgrads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    tin = (torch.from_numpy(images), torch.from_numpy(ids).long(),
           torch.from_numpy(atts).long())
    with torch.no_grad():
        coords = model.loss(*tin, train=False)
    assert coords.shape == (B, 4) and coords.dtype == torch.float32
    np.testing.assert_allclose(coords.numpy(), jcoords, atol=1e-6)
    model.zero_grad(set_to_none=True)
    lb, lg = model.loss(*tin, torch.from_numpy(tgt))
    (lb + lg).backward()
    np.testing.assert_allclose(lb.item(), float(jlb), rtol=1e-5)
    np.testing.assert_allclose(lg.item(), float(jlg), rtol=1e-5)
    want = state_dict_from_jax(jgrads, jcfg)
    for name, p in model.named_parameters():
        g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        w = want[name].numpy().reshape(g.shape)
        assert np.abs(g - w).max() <= 1e-5 + 1e-3 * np.abs(w).max(), name
    model.zero_grad(set_to_none=True)


def test_parameter_tree_and_optimizer_groups_match_jax(pair):
    """Grounding's tree: the three encoders and `bbox_head` alone (no ITM
    head, projections or temperature); only `bbox_head` is boosted."""
    _, jcfg, params, _ = pair
    assert set(params) == {"backbone"}
    assert set(params["backbone"]) == {"vision_encoder", "text_encoder",
                                       "fusion_encoder", "bbox_head"}
    model = XFMForGrounding(config_from_yaml(small_yaml(),
                                             use_bbox_loss=True))
    model.load_state_dict(state_dict_from_jax(params, jcfg), strict=True)
    check_tree_and_groups(params, jcfg, model, (
        "vision_encoder", "text_encoder", "fusion_encoder", "bbox_head"),
        ("bbox_head",))


def _png(path, r, lo=40, hi=64):
    from PIL import Image

    h, w = r.randint(lo, hi, 2)
    Image.fromarray(r.randint(0, 255, (h, w, 3)).astype(np.uint8)).save(path)
    return int(w), int(h)


def _phrase(r):
    return " ".join(r.choice(WORDS, r.randint(3, 9)))


def _corpus(root, seed=0):
    """PNGs; train (10) and test (5) rows with a pixel box and a ref_id;
    weakly supervised rows (5) with 3 candidate boxes on the 32 px frame
    and a `gt` index; a regions JSONL for stage 1."""
    r = np.random.RandomState(seed)
    img = os.path.join(root, "images")
    os.makedirs(img, exist_ok=True)
    paths, n = {"image_root": img}, 0
    for split, rows in (("train", 10), ("test", 5), ("weak", 5)):
        ann = []
        for i in range(rows):
            name = f"img{n:03d}.png"
            W, H = _png(os.path.join(img, name), r)
            n += 1
            x, y = float(r.uniform(0, W / 2)), float(r.uniform(0, H / 2))
            row = {"image": name, "text": _phrase(r), "ref_id": 100 + n}
            if split == "weak":
                row["boxes"] = [[0, 0, 16, 16], [16, 0, 32, 32],
                                [0, 16, 32, 32]]
                row["gt"] = int(r.randint(0, 3))
            else:
                row["bbox"] = [x, y, float(r.uniform(4, W - x)),
                               float(r.uniform(4, H - y))]
            ann.append(row)
        paths[split] = os.path.join(root, f"{split}.json")
        with open(paths[split], "w") as f:
            json.dump(ann, f)
    paths["regions"] = write_corpus(os.path.join(root, "pt"), n=6)["regions"]
    return paths


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("grounding"))
    return root, _corpus(root)


def _tokenizer(paths):
    from xfm_tpu_torch.data.tokenization import SimpleTokenizer
    from xfm_tpu_torch.tasks.grounding import grounding_texts

    return SimpleTokenizer.from_texts(grounding_texts(
        {"train_file": [paths["train"]], "test_file": paths["test"]}))


@pytest.mark.parametrize("split", ["test", "weak", "train_plain"])
def test_grounding_data_bit_equal_to_jax(corpus, split):
    """The eval batches (the short last one kept; the weakly supervised
    rows with the dummy (0, 0, 1, 1) box) and, through a plain
    `TrainTransform` (not box-aware), the train batches, bit for bit."""
    from xfm_tpu.data.finetune_data import GroundingData as JData
    from xfm_tpu.data.transforms import TestTransform as JTest
    from xfm_tpu.data.transforms import TrainTransform as JTrain

    from xfm_tpu_torch.data.finetune_data import GroundingData
    from xfm_tpu_torch.data.transforms import TestTransform, TrainTransform

    root, paths = corpus
    tok = _tokenizer(paths)
    train = split == "train_plain"
    ann = paths["train" if train else split]
    t, jt = ((TrainTransform(32, hflip=False, seed=9),
              JTrain(32, hflip=False, seed=[5, 1])) if train
             else (TestTransform(32), JTest(32)))
    got = list(GroundingData(ann, t, paths["image_root"], tok, max_tokens=10,
                             batch_size=4, train=train).epoch(5))
    want = list(JData(ann, jt, paths["image_root"], tok, max_tokens=10,
                      batch_size=4, train=train).epoch(5))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["images", "ref_id", "target_bbox",
                                          "text_atts", "text_ids"]
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    if split == "weak":
        from PIL import Image

        a = json.load(open(ann))[0]
        W, H = Image.open(os.path.join(paths["image_root"], a["image"])).size
        np.testing.assert_array_equal(
            got[0]["target_bbox"][0],
            np.float32([0.5 / W, 0.5 / H, 1 / W, 1 / H]))


def _painted(tmp_path, W=200, H=150, box=(120, 30, 60, 50)):
    """A black PNG with a white rectangle at `box` (x, y, w, h)."""
    from PIL import Image

    arr = np.zeros((H, W, 3), np.uint8)
    x, y, w, h = box
    arr[y:y + h, x:x + w] = 255
    path = str(tmp_path / "painted.png")
    Image.fromarray(arr).save(path)
    return path


def _covered(image, target, res):
    """The painted pixels' bounding box against the target's, in pixels of
    the res² frame → the largest distance of an edge."""
    lum = image.mean(-1)
    ys, xs = np.nonzero(lum > (lum.max() + lum.min()) / 2)
    found = np.asarray([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
    cx, cy, w, h = target * res
    want = np.asarray([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
    return np.abs(found - want).max()


def test_box_train_transform_keeps_the_box_on_its_pixels(tmp_path):
    """Queue 3B fault (b): with the JAX package's train path
    (`TrainTransform(384, hflip=False)`, the box normalized by the
    uncropped image) the target misses the painted pixels by many pixels
    for some seeds; through the port's `BoxTrainTransform` it covers them
    (within 2 px of the bicubic edge at 64 px) for every seed, and the
    crop holds the whole box."""
    from xfm_tpu.data.finetune_data import GroundingData as JData
    from xfm_tpu.data.transforms import TrainTransform as JTrain

    from xfm_tpu_torch.data.finetune_data import GroundingData
    from xfm_tpu_torch.data.tokenization import SimpleTokenizer
    from xfm_tpu_torch.data.transforms import BoxTrainTransform

    path = _painted(tmp_path)
    ann = str(tmp_path / "ann.json")
    with open(ann, "w") as f:
        json.dump([{"image": os.path.basename(path), "text": "the box",
                    "bbox": [120, 30, 60, 50], "ref_id": 1}], f)
    tok = SimpleTokenizer.from_texts(["the box"])
    jax_miss, port_miss = [], []
    for seed in range(8):
        ours = GroundingData(ann, BoxTrainTransform(64), str(tmp_path), tok,
                             batch_size=1, train=True)
        (b,) = list(ours.epoch(seed))
        port_miss.append(_covered(b["images"][0], b["target_bbox"][0], 64))
        theirs = JData(ann, JTrain(64, hflip=False, seed=[seed, 1]),
                       str(tmp_path), tok, batch_size=1, train=True)
        (jb,) = list(theirs.epoch(seed))
        jax_miss.append(_covered(jb["images"][0], jb["target_bbox"][0], 64))
    assert max(port_miss) <= 2.0, port_miss
    assert max(jax_miss) > 8.0, jax_miss


def test_refer_matches_jax(tmp_path):
    """`REFER` on a synthetic refs(unc).p and instances.json: the splits,
    boxes and images, `to_grounding_json` and
    `grounding_eval_from_results`, equal to the JAX module's."""
    from xfm_tpu.eval import refer as jrefer

    from xfm_tpu_torch.eval import refer

    r = np.random.RandomState(0)
    d = tmp_path / "refcoco+"
    d.mkdir()
    images = [{"id": i, "file_name": f"COCO_{i:06d}.jpg"} for i in range(4)]
    anns = [{"id": 10 + i, "image_id": i % 4,
             "bbox": [float(v) for v in r.uniform(1, 50, 4)]}
            for i in range(6)]
    refs = [{"ref_id": 100 + i, "ann_id": 10 + i, "image_id": i % 4,
             "split": ("train", "val", "testA")[i % 3],
             "sentences": [{"sent": f"the {w} one"} for w in
                           ("left", "red")[: 1 + i % 2]]
             + ([{"raw": "raw only"}] if i == 2 else [])}
            for i in range(6)]
    with open(d / "refs(unc).p", "wb") as f:
        pickle.dump(refs, f)
    with open(d / "instances.json", "w") as f:
        json.dump({"images": images, "annotations": anns}, f)
    ours = refer.REFER(str(tmp_path), "refcoco+", "unc")
    theirs = jrefer.REFER(str(tmp_path), "refcoco+", "unc")
    for split in ("train", "val", "testA", "testB"):
        assert ours.get_refs(split) == theirs.get_refs(split)
        assert ours.to_grounding_json(split) == theirs.to_grounding_json(
            split)
    for ref in refs:
        assert ours.ref_box(ref["ref_id"]) == theirs.ref_box(ref["ref_id"])
        assert ours.ref_image(ref["ref_id"]) == theirs.ref_image(
            ref["ref_id"])
    results = []
    for ref in refs:
        x, y, w, h = ours.ref_box(ref["ref_id"])
        jit = r.uniform(-0.3, 0.3, 4) * w
        results.append({"ref_id": ref["ref_id"], "pred_xyxy_pixels": [
            x + jit[0], y + jit[1], x + w + jit[2], y + h + jit[3]]})
    got = refer.grounding_eval_from_results(results, ours)
    assert got == jrefer.grounding_eval_from_results(results, theirs)
    assert 0 < got < 1


def _pretrain_yaml(paths, **keys):
    keys.setdefault("text_vocab_size", V)
    return grounding_yaml(
        pretrain=True, image_res=32,
        train_file_regions=paths["regions"],
        regions={"image_key": "binary", "is_image_rpath": False,
                 "caption_key": "caption", "batch_size": 4,
                 "max_images": 3, "max_regions": 2,
                 "min_perc_in_image": 0.5},
        **dict(SMALL, **keys))


def test_stage1_losses_match_jax(corpus, monkeypatch):
    """Stage 1 on Grounding_bbox_pretrain.yaml's keys: the region stream
    alone, its flags equal to JAX's `stream_flags`, and its losses (ITC,
    ITM, fusion-MLM, bbox and GIoU; the hard negatives fixed on both
    sides) on a batch of that stream equal to the JAX module's."""
    import xfm_tpu.models.losses as jlosses
    from xfm_tpu.models import XFMForPretrain as JPretrain
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.tasks.pretrain import stream_flags as jflags

    from xfm_tpu_torch.models import XFMForPretrain
    from xfm_tpu_torch.models.task_models import LOSS_KEYS
    from xfm_tpu_torch.tasks import pretrain

    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    root, paths = corpus
    cfg = _pretrain_yaml(paths)
    tok = _tokenizer(paths)
    streams = pretrain.build_streams(cfg, tok, seed=0)
    assert sorted(streams) == ["region"]
    flags = pretrain.stream_flags("region", 0, cfg)
    assert flags == jflags("region", 0, cfg)
    assert flags["ret_bbox"] and flags["ret_bbox_giou"]
    batch = next(iter(streams["region"]))
    kw = dict(use_contrastive_loss=True, use_matching_loss=True,
              use_mlm_loss=True, use_bbox_loss=True)
    jcfg = jconfig_from_yaml(cfg, **kw)
    jm = JPretrain(jcfg)
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((2, 32, 32, 3)),
        jnp.ones((2, 6), jnp.int32), jnp.ones((2, 6), jnp.int32),
        method=JPretrain.init_all)["params"])()
    B = batch["text_ids"].shape[0]
    neg = (np.roll(np.arange(B), 1), np.roll(np.arange(B), -1))
    monkeypatch.setattr(jlosses, "hard_negative_indices",
                        lambda *a, **k: tuple(jnp.asarray(n) for n in neg))
    jout = jax.jit(lambda p, b: jm.apply(
        {"params": p}, **b, **flags,
        rngs={"hardneg": jax.random.PRNGKey(0)}))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = XFMForPretrain(config_from_yaml(cfg, **kw))
    model.load_state_dict(state_dict_from_jax(params, jcfg), strict=True)
    with torch.no_grad():
        out = model.loss(**{k: torch.from_numpy(
            v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}, **flags,
                         hard_negatives=tuple(map(torch.from_numpy, neg)))
    for k in LOSS_KEYS:
        np.testing.assert_allclose(out[k].item(), float(jout[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert {k for k in LOSS_KEYS if out[k].item() != 0.0} == {
        "loss_itc", "loss_itm", "loss_mlm", "loss_bbox", "loss_giou"}


def _ft_yaml(root, paths, stage1=None, **keys):
    keys = dict(dict(
        image_res=48, train_file=[paths["train"]], test_file=paths["test"],
        image_root=paths["image_root"], max_tokens=10, resume=True,
        optimizer={"opt": "adamW", "lr": 1e-3, "weight_decay": 0.01,
                   "lr_mult": 2},
        schedular={"sched": "linear", "lr": 1e-3, "epochs": 2,
                   "num_warmup_steps": 0.1}), **keys)
    cfg = small_yaml(**keys)
    if stage1:
        cfg["domain_pretrain_config"] = stage1
    path = os.path.join(root, f"ft{len(os.listdir(root))}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _stage1_yaml(root, paths):
    path = os.path.join(root, "stage1.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(_pretrain_yaml(paths, max_steps=2, print_freq=1), f)
    return path


def test_jax_pipeline_raises_at_the_hand_off(corpus, tmp_path,
                                             monkeypatch):
    """Queue 3B fault (c): the JAX package's `main_bbox_pipeline` with
    stage 1 at 32 px (rel-pos tables [(2·2 − 1)² + 3, 2] = [12, 2]) and
    stage 2 at 48 px ([28, 2]) raises ValueError in `merge_params` at the
    hand-off, before stage 2 trains. Stage 1's training and its Orbax
    files are stood in for (its `pretrain.main` records its config, and
    the checkpoint read returns the stage-1 model's parameters, initialized
    from its YAML): the hand-off is what fails."""
    import xfm_tpu.tasks.pretrain as jpretrain
    import xfm_tpu.train.checkpoint as jckpt
    from xfm_tpu.models import XFMForPretrain as JPretrain
    from xfm_tpu.models import config_from_yaml as jconfig_from_yaml
    from xfm_tpu.tasks import grounding as jgrounding

    root, paths = corpus
    s1 = _stage1_yaml(str(tmp_path), paths)
    ft = _ft_yaml(str(tmp_path), paths, stage1=s1)
    jm = JPretrain(jconfig_from_yaml(_pretrain_yaml(paths, text_vocab_size=16),
                                     use_contrastive_loss=True,
                                     use_matching_loss=True,
                                     use_mlm_loss=True, use_bbox_loss=True))
    stage1 = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 32, 32, 3)),
        jnp.ones((2, 6), jnp.int32), jnp.ones((2, 6), jnp.int32),
        method=JPretrain.init_all)["params"])()
    from flax.traverse_util import flatten_dict

    tables = [v.shape for k, v in flatten_dict(stage1, sep="/").items()
              if k.endswith("relative_position_bias_table")]
    assert tables == [(12, 2), (12, 2)]
    seen = []
    monkeypatch.setattr(jpretrain, "main",
                        lambda a: seen.append((a.config, a.output_dir)))
    monkeypatch.setattr(jckpt, "load_params_from_checkpoint",
                        lambda d, step=None: seen.append(d) or stage1)
    args = types.SimpleNamespace(
        config=ft, output_dir=str(tmp_path / "jax"), evaluate=False,
        checkpoint=None, load_ckpt_from=None, bs=None, epoch=None, seed=0)
    with pytest.raises(ValueError, match="relative_position_bias_table"):
        jgrounding.main_bbox_pipeline(args)
    out = str(tmp_path / "jax" / "bbox_pretrain")
    assert seen == [(s1, out), os.path.join(out, "ckpt")]
    assert not os.path.exists(tmp_path / "jax" / "ckpt")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(x) for x in f.read().splitlines()]


def test_run_refcoco_bbox_on_the_cpu(corpus, tmp_path, one_thread,
                                     monkeypatch):
    """Both stages through `run.main`: stage 1 (2 steps at 32 px) into
    <out>/bbox_pretrain/ckpt/2; stage 2 at 48 px from its weights, each
    BEiT rel-pos table the interpolation of stage 1's to the 3 × 3 grid,
    the bbox head stage 1's; 2 epochs at `--bs 4` with the IoU@0.5
    accuracy each epoch; the resume (ckpt/1 deleted, `--load_ckpt_from`
    stage 1's directory) bit-equal; `--evaluate --checkpoint` from its own
    checkpoint giving the last epoch's accuracy."""
    from xfm_tpu_torch import run
    from xfm_tpu_torch.tasks import grounding
    from xfm_tpu_torch.train.checkpoint import (
        interpolate_rel_pos_bias_table, load_params_from_checkpoint)

    root, paths = corpus
    ft = _ft_yaml(str(tmp_path), paths, stage1=_stage1_yaml(str(tmp_path),
                                                            paths))
    out = str(tmp_path / "out")
    seen = {}
    real = grounding._load_stage1

    def load_stage1(model, path):
        real(model, path)
        seen["path"] = path
        seen["sd"] = {k: v.clone() for k, v in model.state_dict().items()}

    monkeypatch.setattr(grounding, "_load_stage1", load_stage1)
    argv = ["--task", "refcoco_bbox", "--config", ft, "--output_dir", out,
            "--device", "cpu", "--bs", "4", "--seed", "3"]
    res = run.main(argv)
    stage1 = os.path.join(out, "bbox_pretrain", "ckpt")
    assert os.listdir(stage1) == ["2"] and seen["path"] == stage1
    s1 = load_params_from_checkpoint(stage1)
    tables = [k for k in s1 if k.endswith("relative_position_bias_table")]
    assert len(tables) == 2
    for k in tables:
        assert tuple(s1[k].shape) == (12, 2)
        want = interpolate_rel_pos_bias_table(s1[k].detach().numpy(),
                                              (3, 3))
        assert np.array_equal(seen["sd"][k].numpy(), want), k
        assert seen["sd"][k].shape == (28, 2)
    for k in ("bbox_head.0.weight", "fusion_encoder.roberta.encoder."
              "layer.1.crossattention.self.key.weight"):
        assert torch.equal(seen["sd"][k], s1[k]), k
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["0", "1"]
    log = [e for e in _log(out) if "epoch" in e]
    assert [e["epoch"] for e in log] == [0, 1]
    for e in log:
        assert np.isfinite(e["loss"]) and 0 <= e["iou50_acc"] <= 1
        assert abs(e["loss"] - e["loss_bbox"] - e["loss_giou"]) < 1e-5
    assert res == {"best_iou50": max(e["iou50_acc"] for e in log)}
    final = torch.load(os.path.join(out, "ckpt", "1", "state.pt"),
                       weights_only=True)
    assert final["step"] == 4
    shutil.rmtree(os.path.join(out, "ckpt", "1"))
    run.main(argv + ["--load_ckpt_from", stage1])
    resumed = torch.load(os.path.join(out, "ckpt", "1", "state.pt"),
                         weights_only=True)
    assert resumed["step"] == final["step"]
    for name, p in final["params"].items():
        assert torch.equal(p, resumed["params"][name]), name
    assert os.listdir(stage1) == ["2"]  # stage 1 did not run again
    ev = run.main(["--task", "refcoco_bbox", "--config", ft,
                   "--output_dir", str(tmp_path / "ev"), "--device", "cpu",
                   "--evaluate", "--checkpoint",
                   os.path.join(out, "ckpt", "1", "state.pt")])
    assert ev == {"iou50_acc": log[-1]["iou50_acc"]}
    assert not os.path.exists(tmp_path / "ev" / "bbox_pretrain")


def test_main_weakly_supervised(corpus, tmp_path, monkeypatch):
    """GradCAM grounding over the weakly supervised rows: the accuracy of
    each sample's best-ranked box (`rank_boxes_by_cam` over
    `itm_gradcam` at `block_num` 1) against `gt`, logged."""
    from xfm_tpu_torch.models import itm_gradcam, rank_boxes_by_cam
    from xfm_tpu_torch.tasks import grounding

    root, paths = corpus
    cfg = _ft_yaml(str(tmp_path), paths, test_file=paths["weak"],
                   image_res=32, block_num=1, batch_size=2)
    cams = []

    def spy(*a, **kw):
        cams.append((kw["block_num"], itm_gradcam(*a, **kw)))
        return cams[-1][1]

    monkeypatch.setattr(grounding, "itm_gradcam", spy)
    args = types.SimpleNamespace(config=cfg, output_dir=str(tmp_path / "o"),
                                 checkpoint=None, seed=0, device="cpu")
    res = grounding.main_weakly_supervised(args)
    assert [c.shape[0] for _, c in cams] == [2, 2, 1]
    assert {b for b, _ in cams} == {1}
    ann = json.load(open(paths["weak"]))
    cam = torch.cat([c for _, c in cams]).numpy()
    hits = [int(np.argmax(rank_boxes_by_cam(cam[i], a["boxes"], 32, 16)))
            == a["gt"] for i, a in enumerate(ann)]
    assert res == {"gradcam_acc": sum(hits) / len(hits)}
    assert _log(str(tmp_path / "o"))[-1] == res


def test_run_refcoco_bbox_falls_back_to_the_default_config(monkeypatch,
                                                           tmp_path):
    from xfm_tpu_torch import configs, run
    from xfm_tpu_torch.tasks import grounding

    seen = []
    monkeypatch.setattr(grounding, "main_bbox_pipeline",
                        lambda args: seen.append(args.config))
    for extra in ([], ["--config", str(tmp_path / "missing.yaml")]):
        run.main(["--task", "refcoco_bbox", "--output_dir",
                  str(tmp_path)] + extra)
    want = os.path.join(REPO, "configs", "xfm-ft", "Grounding_bbox.yaml")
    assert seen == [want, want]
    with open(want) as f:
        assert configs.GROUNDING == yaml.safe_load(f)
    with open(os.path.join(os.path.dirname(want),
                           "Grounding_bbox_pretrain.yaml")) as f:
        assert configs.GROUNDING_PRETRAIN == yaml.safe_load(f)
    assert grounding.stage1_config(want) == os.path.join(
        os.path.dirname(want), "Grounding_bbox_pretrain.yaml")


def test_fallback_tokenizer_holds_both_stages_words(corpus, tmp_path):
    """Without the RoBERTa files JAX builds its fallback over no text
    (`xfm_tpu/tasks/grounding.py:69`); the port's holds every word of the
    train and test phrases and, in the pipeline, of stage 1's region
    captions, so that both stages share one vocabulary."""
    from xfm_tpu.tasks.retrieval import build_tokenizer_or_fallback as jbuild

    from xfm_tpu_torch.core.config import load_config
    from xfm_tpu_torch.tasks.grounding import grounding_texts
    from xfm_tpu_torch.tasks.pretrain import corpus_texts
    from xfm_tpu_torch.data.tokenization import SimpleTokenizer

    root, paths = corpus
    ft = _ft_yaml(str(tmp_path), paths, stage1=_stage1_yaml(str(tmp_path),
                                                            paths))
    cfg = load_config(ft)
    assert jbuild(cfg).vocab_size == 5  # the specials alone
    stage1 = load_config(cfg["domain_pretrain_config"])
    tok = SimpleTokenizer.from_texts(grounding_texts(cfg, stage1))
    words = {w for s in ("train", "test") for a in json.load(open(paths[s]))
             for w in a["text"].split()}
    words |= {w for t in corpus_texts(stage1) for w in t.split()}
    unk = tok.convert_tokens_to_ids(["<unk>"])[0]
    assert unk not in tok.convert_tokens_to_ids(sorted(words))
