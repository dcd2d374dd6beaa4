"""The pretrain task (`python3 -m xfm_tpu_torch.run --task pretrain_DIY`)
and what it adds to the model, against the JAX package where it has a
counterpart.

- `XFMForPretrain.loss` for each stream kind (image-text with MIM, region
  with bbox/GIoU, ImageNet, text-only, and one `stop_calc` stage with ITM
  off, so the separate fusion-MLM pass) against the JAX module: the same
  weights (the bridge), batch and hard negatives (the JAX draw replaced by
  fixed indices), f32 on both sides at depth 2, width 64, 32 px. Losses
  rtol 1e-4; each gradient within 1e-3 of its largest |value| (+ 1e-7 for
  the key biases, whose gradient is zero up to f32 noise). The region
  stream also without `is_image`, as `calc_image_bbox_loss` runs it.
- `bbox_loss` against JAX on random boxes, degenerate ones and exact hits
  among them (atol 1e-6 in f32; the gradient away from the hits, where
  the two take different subgradients of |x|).
- `--bs` against `_scale_batch`, `stream_flags` against JAX around every
  `stop_calc_*` threshold, the keys of unported branches raising.
- The multi-stream step: its summed gradients equal one backward of the
  summed loss (rtol 1e-5), and a CPU spy counts the packed attention (K1's
  entry) at depth + depth a step for each image-bearing stream, none for
  the text stream.
- The task on the CPU on a 4-stream corpus: finite losses, non-zero where
  the flags say so, `ckpt/` and `log.txt`; the resume restoring the state
  bit for bit; `text_step_separate` with `dispatch_steps: 2` on the
  trajectory of `dispatch_steps: 1` (bit for bit on one CPU thread).
"""
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_pretrain_data import stream_config, write_corpus
from xfm_tpu_torch.configs import xfm_base_pretrain_config
from xfm_tpu_torch.models import XFMForPretrain
from xfm_tpu_torch.models import losses as tlosses
from xfm_tpu_torch.models.task_models import LOSS_KEYS
from xfm_tpu_torch.tasks import pretrain
from xfm_tpu_torch.train.checkpoint import state_dict_from_jax
from _torch_threads import one_intra_op_thread  # noqa: F401

KW = dict(hidden=64, layers=2, heads=2, inter=128, image_res=32, vocab=40)
NEG = (np.array([1, 2, 3, 0]), np.array([2, 3, 0, 1]))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PT_YAML = os.path.join(REPO, "configs", "xfm-pt", "Pretrain_base_4m.yaml")


def _batches():
    """One batch of each stream kind at B = 4 rows (the region stream: 3
    images, 4 regions)."""
    r = np.random.RandomState(0)
    B, T, M, V, P = 4, 8, 3, KW["vocab"], 4

    def text():
        atts = np.ones((B, T), np.int64)
        atts[1, 6:] = 0
        ids = r.randint(3, V - 1, (B, T)).astype(np.int64)
        return dict(text_ids=ids, text_atts=atts,
                    text_ids_masked=np.where(r.rand(B, T) < 0.3, 3, ids),
                    masked_pos=r.randint(1, 6, (B, M)).astype(np.int64),
                    masked_ids=np.where(np.arange(M) < 2,
                                        r.randint(3, V - 1, (B, M)), -100))

    def images(n):
        return r.randn(n, 32, 32, 3).astype(np.float32)

    mask = np.zeros((B, P), bool)
    mask[:, :2] = True
    image_atts = np.zeros((B, 1 + P), np.int64)
    image_atts[:, 0] = 1
    image_atts[np.arange(B), 1 + np.array([0, 3, 1, 2])] = 1
    image_atts[0, 2] = 1
    return {
        "image": dict(images=images(B), image_mask=mask, **text()),
        "region": dict(images=images(3),
                       idx_to_group_img=np.array([0, 2, 0, 1]),
                       image_atts=image_atts,
                       target_bbox=np.array(
                           [[0.5, 0.5, 0.4, 0.3], [0.2, 0.7, 0.1, 0.2],
                            [0.6, 0.4, 0.5, 0.5], [0.3, 0.3, 0.2, 0.1]],
                           np.float32),
                       is_image=np.array([0, 0, 1, 0], np.float32),
                       **text()),
        "imagenet": dict(images=images(B), image_mask=mask),
        "text": text(),
    }


FLAGS = {
    "image": dict(ret_itc=True, ret_match=True, ret_mlm=True, ret_mim=True,
                  data_source="image"),
    "region": dict(ret_itc=True, ret_match=True, ret_mlm=True, ret_mim=False,
                   ret_bbox=True, ret_bbox_giou=True, data_source="region"),
    "imagenet": dict(ret_itc=False, ret_match=False, ret_mlm=False,
                     ret_mim=True, data_source="imagenet"),
    "text": {},
    "image_itm_off": dict(ret_itc=True, ret_match=False, ret_mlm=True,
                          ret_mim=True, data_source="image"),
    # calc_image_bbox_loss: the region batch without `is_image`
    "region_image_bbox": dict(ret_itc=True, ret_match=True, ret_mlm=True,
                              ret_mim=False, ret_bbox=True,
                              ret_bbox_giou=True, data_source="region"),
}


@pytest.fixture(scope="module")
def model_setup():
    import xfm_tpu.models.losses as jlosses
    from __graft_entry__ import _xfm_config
    from xfm_tpu.models import XFMForPretrain as JPretrain

    jcfg = _xfm_config(dtype=jnp.float32, **KW)
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
        yield dict(jcfg=jcfg, jm=jm, params=params)


def _port_model(s):
    model = XFMForPretrain(xfm_base_pretrain_config(dtype=torch.float32,
                                                    **KW))
    model.load_state_dict(state_dict_from_jax(s["params"], s["jcfg"]),
                          strict=True)
    return model


@pytest.mark.parametrize("kind", sorted(FLAGS))
def test_stream_losses_and_grads_match_jax(model_setup, kind):
    s = model_setup
    batch = _batches()[kind.split("_")[0]]
    if kind == "region_image_bbox":
        batch.pop("is_image")
    flags = FLAGS[kind]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if kind == "text":
        jbatch["images"] = None
    if kind == "imagenet":  # the JAX module takes the text inputs by place
        jbatch.update(text_ids=None, text_atts=None)

    def jloss(p):
        out = s["jm"].apply({"params": p}, **jbatch, **flags,
                            deterministic=True,
                            rngs={"hardneg": jax.random.PRNGKey(0)})
        return sum(out[k] for k in LOSS_KEYS), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        s["params"])
    model = _port_model(s)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = model.loss(**tb, **flags,
                     hard_negatives=tuple(torch.from_numpy(n) for n in NEG))
    sum(out[k] for k in LOSS_KEYS).backward()
    for k in LOSS_KEYS:
        np.testing.assert_allclose(out[k].item(), float(jout[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    on = {"image": {"loss_itc", "loss_itm", "loss_mlm", "loss_mim"},
          "image_itm_off": {"loss_itc", "loss_mlm", "loss_mim"},
          "region": {"loss_itc", "loss_itm", "loss_mlm", "loss_bbox",
                     "loss_giou"},
          "region_image_bbox": {"loss_itc", "loss_itm", "loss_mlm",
                                "loss_bbox", "loss_giou"},
          "imagenet": {"loss_mim"}, "text": {"loss_mlm"}}[kind]
    assert {k for k in LOSS_KEYS if out[k].item() != 0.0} == on
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), s["jcfg"])
    for name, p in model.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        ref = want[name].numpy()
        # + 1e-7: the key biases' gradient is analytically zero (softmax
        # ignores a per-row shift), both sides hold f32 noise of ~1e-8
        tol = 1e-3 * np.abs(ref).max() + 1e-7
        assert np.abs(got - ref).max() <= tol, (kind, name)


@pytest.mark.parametrize("with_is_image", [False, True])
def test_bbox_loss_matches_jax(with_is_image):
    from xfm_tpu.models.losses import bbox_loss as jbbox

    r = np.random.RandomState(1)
    pred = r.rand(64, 4).astype(np.float32)
    tgt = r.rand(64, 4).astype(np.float32)
    pred[:8, 2:] *= -1.0   # degenerate predictions
    tgt[8:12, 3] = -0.1    # degenerate targets
    tgt[12:14] = pred[12:14]  # exact hits
    is_image = (r.rand(64) < 0.3).astype(np.float32) if with_is_image \
        else None
    tp = torch.from_numpy(pred).requires_grad_(True)
    got = tlosses.bbox_loss(tp, torch.from_numpy(tgt),
                            None if is_image is None
                            else torch.from_numpy(is_image))
    (got[0] + got[1]).backward()
    want, jgrad = jax.value_and_grad(
        lambda p: sum(jbbox(p, jnp.asarray(tgt), None if is_image is None
                            else jnp.asarray(is_image))))(jnp.asarray(pred))
    want = jbbox(jnp.asarray(pred), jnp.asarray(tgt),
                 None if is_image is None else jnp.asarray(is_image))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.item(), float(b), atol=1e-6)
    # the L1 term's subgradient where pred == target: torch's |x|' is 0 at
    # 0, jax's 1; the two agree everywhere else
    off = pred != tgt
    np.testing.assert_allclose(tp.grad.numpy()[off], np.asarray(jgrad)[off],
                               atol=1e-6)


def test_bs_scales_the_stream_batches_as_jax(tmp_path, monkeypatch):
    """`--bs` on the pretrain YAML: the global batch over the processes
    into the four stream blocks (and batch_size_train where the YAML has
    it), as `_scale_batch` does."""
    import xfm_tpu.tasks.common as jcommon
    from xfm_tpu.core.config import load_config

    from xfm_tpu_torch.tasks.common import TaskContext, scale_batch

    args = types.SimpleNamespace(config=PT_YAML, bs=24, epoch=None,
                                 output_dir=str(tmp_path), seed=0,
                                 device="cpu")
    got = TaskContext.from_args(args).config
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    want = load_config(PT_YAML)
    jcommon._scale_batch(want, 24)
    for key in ("images", "texts", "regions", "images_imagenet"):
        assert got[key] == want[key], key
        assert got[key]["batch_size"] == 24
    for n in (1, 3, 8):  # several processes, batch_size_train too
        cfg = dict(load_config(PT_YAML), batch_size_train=7)
        ref = dict(load_config(PT_YAML), batch_size_train=7)
        scale_batch(cfg, 50, n)
        monkeypatch.setattr(jax, "device_count", lambda n=n: n)
        jcommon._scale_batch(ref, 50)
        assert cfg == ref, n


def test_stream_flags_match_jax():
    from xfm_tpu.tasks.pretrain import stream_flags as jflags

    cfg = {"stop_calc_itm": 5, "stop_calc_mlm": 9, "stop_calc_itc": 3,
           "stop_calc_mim": 7, "use_mm_mim_loss": True,
           "ret_bbox_loss": True, "ret_bbox_giou": False}
    names = ("image", "web", "aux", "region", "imagenet", "text")
    for step in sorted({t + d for t in (3, 5, 7, 9) for d in (-1, 0, 1)}
                       | {0, 100}):
        for name in names:
            assert pretrain.stream_flags(name, step, cfg) == \
                jflags(name, step, cfg), (name, step)
    plain = {"use_mm_mim_loss": False}
    for name in names:
        assert pretrain.stream_flags(name, 0, plain) == \
            jflags(name, 0, plain), name


@pytest.mark.parametrize("calc", [False, True])
def test_calc_image_bbox_loss_drops_is_image(calc):
    """`calc_image_bbox_loss` drops the region stream's `is_image`, as the
    JAX task does, so its whole-image rows count in the bbox losses; the
    other streams' batches pass as they are."""
    seen = {}

    class Spy:
        def loss(self, **kw):
            seen[kw["data_source"]] = kw.get("is_image", "absent")
            return dict.fromkeys(LOSS_KEYS, torch.zeros(()))

    flags = {n: FLAGS[n] for n in ("image", "region")}
    fn = pretrain.stream_loss_fn(flags, dict.fromkeys(flags, 1.0), calc)
    batches = _batches()
    for name in flags:
        fn(Spy(), name, batches[name], None)
    assert seen["image"] == "absent"
    if calc:
        assert seen["region"] is None
    else:
        np.testing.assert_array_equal(seen["region"],
                                      batches["region"]["is_image"])


# the tokenizer's small-model keys (the tiny run's 32 px, 16 px patches)
TINY_TOKENIZER = dict(tokenizer_embed_dim=32, tokenizer_depth=1,
                      tokenizer_num_heads=2, codebook_size=16,
                      codebook_dim=8)


@pytest.mark.parametrize("key,value", [
    ("use_vision_tokenizer", True), ("local_attn_depth", 2),
    ("bf16_params", True), ("device_randaug", True),
    ("bench_redispatch", 4)])
def test_unported_keys_raise(tmp_path, key, value):
    """The keys of the branches the port once refused (the tokenizer,
    region attention, bf16 parameters, device RandAugment on the image
    block, the redispatch probe) each run a step to finite losses."""
    files = write_corpus(str(tmp_path / "data"), n=4)
    cfg = _task_config(files)
    if key == "device_randaug":
        cfg["images"][key] = value
        key, value = "max_steps", 1
    cfg.update({key: value, "max_steps": 1, "ckpt_frequent_step": 1})
    if key == "use_vision_tokenizer":
        cfg.update(TINY_TOKENIZER)
    stats = _run(tmp_path, cfg, "out")
    assert np.isfinite(stats["loss"])


@pytest.mark.parametrize("device_randaug", [False, True])
def test_task_feeds_the_loader_batches(tmp_path, monkeypatch,
                                       device_randaug):
    """At the YAML's `num_workers` the image-text and ImageNet streams
    hand uint8 images to the model; with `device_randaug` on both blocks
    the task runs RandAugment on them before the loss, stream i drawing
    from the rank generator of (seed, step, RANDAUG_KEY + i), so that
    another step or seed draws
    anew; without it the C++ RandAugment ran on the host and the task
    runs none."""
    from xfm_tpu_torch import native

    if not native.available():
        pytest.skip(f"native loader unavailable "
                    f"({native.unavailable_reason()})")
    files = write_corpus(str(tmp_path / "data"), n=6)
    cfg = _task_config(files, max_steps=2, ckpt_frequent_step=2)
    cfg["images_imagenet"]["num_workers"] = 4
    for block in ("images", "images_imagenet"):
        cfg[block]["device_randaug"] = device_randaug
    seen, fed = [], {}
    real_aug, real_loss = pretrain.randaugment_batch, XFMForPretrain.loss

    def spy_aug(images, gen):
        out = real_aug(images, gen)
        seen.append((images.dtype, tuple(images.shape), gen.initial_seed(),
                     bool(torch.equal(out, images))))
        return out

    def spy_loss(self, images=None, **kw):
        if images is not None:
            fed.setdefault(kw.get("data_source"), images.dtype)
        return real_loss(self, images=images, **kw)

    monkeypatch.setattr(pretrain, "randaugment_batch", spy_aug)
    monkeypatch.setattr(XFMForPretrain, "loss", spy_loss)
    stats = _run(tmp_path, cfg, "out", seed=3)
    assert np.isfinite(stats["loss"])
    assert fed == {"image": torch.uint8, "imagenet": torch.uint8,
                   "region": torch.float32}
    if not device_randaug:
        assert seen == []
        return
    order = sorted(["image", "imagenet", "region", "text"])
    from xfm_tpu_torch.tasks.common import TaskContext, step_generator

    ctx = TaskContext(config=cfg, out_dir="", device="cpu", seed=3)
    want = [step_generator(ctx, step, pretrain.RANDAUG_KEY
                           + order.index(n)).rank.initial_seed()
            for step in range(2) for n in ("image", "imagenet")]
    assert [s[2] for s in seen] == want and len(set(want)) == 4
    assert all(s[0] == torch.uint8 and s[1] == (4, 32, 32, 3) for s in seen)
    assert not all(s[3] for s in seen)  # some image changed


def test_stream_step_equals_one_summed_backward():
    """Forward and backward a stream at a time, then one update: the
    summed gradient is that of the summed loss."""
    from xfm_tpu_torch.train.optim import create_optimizer
    from xfm_tpu_torch.train.train_state import TrainState, make_stream_step

    torch.manual_seed(0)
    cfg = xfm_base_pretrain_config(dtype=torch.float32, **KW)
    batches = {k: {n: torch.from_numpy(v) for n, v in b.items()}
               for k, b in _batches().items()}
    neg = tuple(torch.from_numpy(n) for n in NEG)
    weights = {"image": 1.0, "region": 0.5, "imagenet": 2.0, "text": 1.0}

    def stream_loss(model, name, batch):
        out = model.loss(**batch, **FLAGS[name], hard_negatives=neg)
        return weights[name] * sum(out[k] for k in LOSS_KEYS)

    m1 = XFMForPretrain(cfg)
    from xfm_tpu_torch.train.checkpoint import init_weights

    init_weights(m1, 0)
    m2 = XFMForPretrain(cfg)
    m2.load_state_dict(m1.state_dict())
    sum(stream_loss(m1, n, b) for n, b in batches.items()).backward()
    state = TrainState.create(m2, create_optimizer(m2, 0.0,
                                                   weight_decay=0.0))
    state, metrics = make_stream_step(
        lambda m, n, b, g: (stream_loss(m, n, b), {}))(
        state, batches, dict.fromkeys(batches))
    assert state.step == 1
    for (name, p1), p2 in zip(m1.named_parameters(), m2.parameters()):
        if p1.grad is None:
            assert p2.grad is None or not p2.grad.any(), name
            continue
        np.testing.assert_allclose(p2.grad.numpy(), p1.grad.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_packed_attention_calls_per_stream(monkeypatch):
    """The BEiT self-attention of every image-bearing stream goes through
    the packed-attention entry (K1 on the card): depth forward and depth
    backward calls a stream, at 2B rows for the image-text and ImageNet
    pair passes and `max_images` rows for the region stream, with dropout
    and drop-path live; the text stream makes none."""
    from xfm_tpu_torch.models import beit2
    from xfm_tpu_torch.ops.dropout import dropout_generator  # noqa: F401

    calls = []
    real = beit2.flash_attention_packed

    def spy(qkv, bias, scale, H):
        out = real(qkv, bias, scale, H)
        rec = {"rows": qkv.shape[0], "bwd": 0}
        calls.append(rec)
        out.register_hook(lambda g: rec.__setitem__("bwd", rec["bwd"] + 1))
        return out

    monkeypatch.setattr(beit2, "flash_attention_packed", spy)
    cfg = xfm_base_pretrain_config(dtype=torch.float32, **KW)
    cfg = cfg.__class__(**{**cfg.__dict__, "vision": cfg.vision.__class__(
        **{**cfg.vision.__dict__, "drop_path_rate": 0.1})})
    model = XFMForPretrain(cfg)
    from xfm_tpu_torch.train.checkpoint import init_weights

    init_weights(model, 0)
    rows = {"image": 8, "region": 3, "imagenet": 8, "text": None}
    for name, b in _batches().items():
        calls.clear()
        out = model.loss(**{k: torch.from_numpy(v) for k, v in b.items()},
                         **FLAGS[name], deterministic=False,
                         generator=torch.Generator().manual_seed(1))
        sum(out[k] for k in LOSS_KEYS).backward()
        if rows[name] is None:
            assert calls == [], name
            continue
        assert len(calls) == KW["layers"], name
        assert all(c["rows"] == rows[name] and c["bwd"] == 1
                   for c in calls), (name, calls)


# --- the task ----------------------------------------------------------------

def _task_config(files, **extra):
    cfg = stream_config(files)
    cfg.update(
        text_encoder="data/roberta-base", text_num_hidden_layers=1,
        text_fusion_start_at=1, fusion_num_hidden_layers=1,
        text_hidden_size=32, text_num_attention_heads=2,
        text_intermediate_size=64, vision_embed_dim=32, vision_depth=1,
        vision_num_heads=2, embed_dim=16, hidden_act="gelu_tanh",
        wregion=1.0, wimagenet=0.5, wimage=1.0, wtext=1.0,
        use_mm_mim_loss=True, train_dataset_size=16, max_steps=3,
        ckpt_frequent_step=2, print_freq=1,
        schedular={"sched": "linear", "lr": 1e-3, "epochs": 1,
                   "num_warmup_steps": 1},
        optimizer={"opt": "adamW", "lr": 1e-3, "weight_decay": 0.01,
                   "lr_mult": 2},
        accelerator={"CLIP_GRAD_NORM": 1.0})
    cfg.update(extra)
    return cfg


def _run(tmp_path, cfg, out, seed=0):
    import yaml

    from xfm_tpu_torch import run

    path = tmp_path / f"{out}.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return run.main(["--task", "pretrain_DIY", "--config", str(path),
                     "--output_dir", str(tmp_path / out), "--device", "cpu",
                     "--seed", str(seed)])


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _saved(out_dir, step):
    from xfm_tpu_torch.train.checkpoint import _load

    return _load(os.path.join(out_dir, "ckpt"), step, "cpu")


def test_pretrain_task_runs_and_resumes(tmp_path, monkeypatch, one_thread):
    files = write_corpus(str(tmp_path / "data"))
    cfg = _task_config(files)
    stats = _run(tmp_path, cfg, "out")
    for name, on in {"image": ("itc", "itm", "mlm", "mim"),
                     "region": ("itc", "itm", "mlm", "bbox", "giou"),
                     "imagenet": ("mim",), "text": ("mlm",)}.items():
        for k in LOSS_KEYS:
            v = stats[f"{name}_{k}"]
            assert np.isfinite(v)
            assert (v != 0.0) == (k[5:] in on), (name, k, v)
    assert np.isfinite(stats["loss"]) and "samples_per_sec" in stats
    out = tmp_path / "out"
    assert sorted(os.listdir(out / "ckpt")) == ["2", "3"]
    log = (out / "log.txt").read_text().splitlines()
    assert len(log) == 2 and '"step": 3' in log[1]
    assert _saved(str(out), 3)["step"] == 3

    # resume from step 2: the state restored bit for bit, the run goes on
    import shutil

    from xfm_tpu_torch.tasks import common

    shutil.rmtree(out / "ckpt" / "3")
    restored = {}
    real = common.restore_latest

    def record(ctx, state):
        state, step = real(ctx, state)
        restored.update(step=step, count=state.optimizer.count,
                        params={n: p.detach().clone() for n, p in
                                zip(state.optimizer.names,
                                    state.optimizer.params)},
                        mu=[m.clone() for m in state.optimizer.mu])
        return state, step

    monkeypatch.setattr(pretrain, "restore_latest", record)
    _run(tmp_path, dict(cfg, resume=True), "out")
    want = _saved(str(out), 2)
    assert restored["step"] == 2 and restored["count"] == 2
    for n, p in restored["params"].items():
        assert torch.equal(p, want["params"][n]), n
    for n, m in zip(want["optimizer"]["mu"], restored["mu"]):
        assert torch.equal(m, want["optimizer"]["mu"][n]), n
    assert sorted(os.listdir(out / "ckpt")) == ["2", "3"]


def test_text_step_separate_and_dispatch_steps(tmp_path, one_thread):
    """`text_step_separate` (the text stream's own update first: two a
    step) under `dispatch_steps: 2` ends bit for bit where
    `dispatch_steps: 1` does."""
    files = write_corpus(str(tmp_path / "data"))
    base = _task_config(files, max_steps=4, ckpt_frequent_step=4,
                        text_step_separate=True)
    s1 = _run(tmp_path, base, "k1")
    s2 = _run(tmp_path, dict(base, dispatch_steps=2), "k2")
    a, b = _saved(str(tmp_path / "k1"), 4), _saved(str(tmp_path / "k2"), 4)
    assert a["step"] == b["step"] == 8  # two updates a step
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    for k in ("image_loss_itc", "text_loss_mlm", "region_loss_giou"):
        np.testing.assert_allclose(s1[k], s2[k], rtol=1e-6, err_msg=k)


def test_run_falls_back_to_the_default_config(monkeypatch, tmp_path):
    from xfm_tpu_torch import run

    seen = {}
    monkeypatch.setattr(pretrain, "main",
                        lambda args: seen.setdefault("config", args.config))
    run.main(["--task", "pretrain_DIY", "--output_dir", str(tmp_path)])
    assert seen["config"].endswith(
        os.path.join("configs", "xfm-pt", "Pretrain_XBrain_base_4m.yaml"))
    assert os.path.exists(seen["config"])
    from xfm_tpu_torch.tasks import retrieval

    got = []
    monkeypatch.setattr(retrieval, "main", lambda args: got.append(
        args.config))
    for task in ("itr_coco", "itr_flickr"):
        run.main(["--task", task, "--output_dir", str(tmp_path)])
    ft = os.path.join(os.path.dirname(seen["config"]), os.pardir, "xfm-ft")
    assert got == [os.path.join(os.path.normpath(ft), name) for name in (
        "Retrieval_coco.yaml", "Retrieval_flickr.yaml")]
    assert all(os.path.exists(c) for c in got)
