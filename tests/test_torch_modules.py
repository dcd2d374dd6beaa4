"""Small ops of the port against their JAX counterparts, and the port's
import hygiene.

Tolerances: f32 on both sides (JAX matmuls at 'highest' precision); the
gathers and reshapes are exact, the rest differ by the order of f32 ops:
atol 1e-6 for activations and biases, 1e-5 for the table gradient.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("window", [(4, 4), (3, 5)])
def test_relative_position_index_matches_jax(window):
    from xfm_tpu.models.beit2 import relative_position_index as jidx
    from xfm_tpu_torch.ops.relpos import relative_position_index

    np.testing.assert_array_equal(relative_position_index(window),
                                  jidx(window))


@pytest.mark.parametrize("window,H", [((4, 4), 2), ((3, 5), 3)])
def test_rel_pos_bias_and_table_gradient_match_jax(window, H):
    from xfm_tpu.ops.relpos import beit_rel_pos_bias as jbias
    from xfm_tpu_torch.ops.relpos import (beit_rel_pos_bias,
                                          num_relative_distance,
                                          relative_position_index)

    r = np.random.RandomState(0)
    table = r.randn(num_relative_distance(window), H).astype(np.float32)
    n = window[0] * window[1] + 1
    g = r.randn(1, H, n, n).astype(np.float32)

    tt = torch.from_numpy(table).requires_grad_(True)
    idx = torch.from_numpy(relative_position_index(window))
    out = beit_rel_pos_bias(tt, idx)
    out.backward(torch.from_numpy(g))

    jout, vjp = jax.vjp(lambda t: jbias(t, window), jnp.asarray(table))
    (jgrad,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgrad), atol=1e-5)


def test_patch_tokens_match_jax():
    from xfm_tpu.ops.patch_embed import (extract_patches as jext,
                                         patchify_kernel_from_conv as jconv)
    from xfm_tpu_torch.ops.patch_embed import (extract_patches,
                                               patch_kernel_from_conv)

    r = np.random.RandomState(1)
    images = r.randn(2, 32, 48, 3).astype(np.float32)
    conv = r.randn(8, 3, 16, 16).astype(np.float32)
    np.testing.assert_array_equal(
        extract_patches(torch.from_numpy(images), 16).numpy(),
        np.asarray(jext(jnp.asarray(images), 16)))
    np.testing.assert_array_equal(
        patch_kernel_from_conv(torch.from_numpy(conv)).numpy(),
        np.asarray(jconv(jnp.asarray(conv))))


@pytest.mark.parametrize("name", ["gelu", "gelu_tanh", "gelu_new",
                                  "quick_gelu", "relu"])
def test_activations_match_jax(name, monkeypatch):
    monkeypatch.setenv("XFM_EXACT_ERF", "1")
    from xfm_tpu.models.text_encoder import ACT as JACT
    from xfm_tpu_torch.ops.activations import ACT

    x = np.linspace(-6, 6, 1001).astype(np.float32)
    np.testing.assert_allclose(ACT[name](torch.from_numpy(x)).numpy(),
                               np.asarray(JACT[name](jnp.asarray(x))),
                               atol=1e-6)


def test_mask_to_bias_matches_jax():
    from xfm_tpu.ops.attention import mask_to_bias as jm
    from xfm_tpu_torch.ops.attention import mask_to_bias

    m2 = np.array([[1, 1, 0], [1, 0, 0]], np.int64)
    m3 = np.random.RandomState(2).randint(0, 2, (2, 3, 3))
    for m in (m2, m3):
        np.testing.assert_array_equal(
            mask_to_bias(torch.from_numpy(m)).numpy(),
            np.asarray(jm(jnp.asarray(m))))


def test_maybe_normalize_matches_jax():
    from xfm_tpu.data.device_aug import maybe_normalize as jn
    from xfm_tpu_torch.data.device_aug import maybe_normalize

    img = np.random.RandomState(3).randint(0, 256, (2, 4, 4, 3)).astype(
        np.uint8)
    np.testing.assert_allclose(maybe_normalize(torch.from_numpy(img)).numpy(),
                               np.asarray(jn(jnp.asarray(img))), atol=1e-6)
    f = torch.ones(1, 2, 2, 3)
    assert maybe_normalize(f) is f


def test_hard_negative_draws_follow_the_jax_weights():
    """The port draws from a torch.Generator, JAX from its own keys, so the
    draws differ; both sample softmax(sim/temp) + 1e-5 with the positives
    zeroed. Over 4000 draws each, the port's and the JAX function's
    frequencies must match those weights (computed here with numpy) within
    0.03, about 4 standard errors; the port's never hit a positive and
    repeat with the generator's seed."""
    from xfm_tpu.models.losses import hard_negative_indices as jhard
    from xfm_tpu_torch.models.losses import hard_negative_indices

    r = np.random.RandomState(4)
    B = 4
    img = r.randn(B, 8).astype(np.float32)
    txt = r.randn(B, 8).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    temp = 0.5
    sim = img @ txt.T / temp

    def weights(s):
        e = np.exp(s - s.max(1, keepdims=True))
        w = e / e.sum(1, keepdims=True) + 1e-5
        np.fill_diagonal(w, 0.0)
        return w / w.sum(1, keepdims=True)

    ti, tt = torch.from_numpy(img), torch.from_numpy(txt)
    g = torch.Generator().manual_seed(0)
    draws = [hard_negative_indices(g, ti, tt, torch.tensor(temp))
             for _ in range(4000)]
    image_neg = torch.stack([d[0] for d in draws]).numpy()
    text_neg = torch.stack([d[1] for d in draws]).numpy()
    jimage_neg, jtext_neg = jax.jit(jax.vmap(
        lambda k: jhard(k, jnp.asarray(img), jnp.asarray(txt), temp)))(
        jax.random.split(jax.random.PRNGKey(0), 4000))
    rows = np.arange(B)
    assert not np.any(image_neg == rows) and not np.any(text_neg == rows)
    for neg, w in ((text_neg, weights(sim)), (image_neg, weights(sim.T)),
                   (np.asarray(jtext_neg), weights(sim)),
                   (np.asarray(jimage_neg), weights(sim.T))):
        freq = np.stack([np.bincount(neg[:, i], minlength=B) for i in rows])
        np.testing.assert_allclose(freq / len(neg), w, atol=0.03)
    again = hard_negative_indices(torch.Generator().manual_seed(0), ti, tt,
                                  torch.tensor(temp))
    assert all(torch.equal(a, b) for a, b in zip(again, draws[0]))


def test_port_imports_neither_jax_nor_xfm_tpu():
    """Every module of xfm_tpu_torch (the fine-tune's, the eval's, the
    pretrain task's, VQA's, captioning's, NLVR2's, grounding's, ImageNet's,
    GLUE's and classify's tasks/, data/, eval/, models/ (the VQ-KD
    tokenizer and its teachers, the Swin and DeiT towers too), native/ (the C++ loader's binding,
    which builds nothing when imported), train/ and run.py among them) and
    chip_smoke's helpers
    import in a fresh interpreter
    without pulling in jax, flax, optax or any xfm_tpu module; PIL, yaml,
    transformers, h5py and datasets, which the card's machine may lack, are
    imported only inside the functions that need them."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import xfm_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "xfm_tpu_torch.__path__, 'xfm_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "want = {'xfm_tpu_torch.run', 'xfm_tpu_torch.tasks.retrieval',"
        " 'xfm_tpu_torch.tasks.common', 'xfm_tpu_torch.core.config',"
        " 'xfm_tpu_torch.data.tokenization',"
        " 'xfm_tpu_torch.data.transforms',"
        " 'xfm_tpu_torch.data.finetune_data',"
        " 'xfm_tpu_torch.data.randaugment', 'xfm_tpu_torch.data.prefetch',"
        " 'xfm_tpu_torch.ops.dropout', 'xfm_tpu_torch.train.metrics',"
        " 'xfm_tpu_torch.tasks.pretrain', 'xfm_tpu_torch.data.io',"
        " 'xfm_tpu_torch.data.jsonl', 'xfm_tpu_torch.data.block_masking',"
        " 'xfm_tpu_torch.data.text_masking',"
        " 'xfm_tpu_torch.data.pretrain_data',"
        " 'xfm_tpu_torch.models.generation', 'xfm_tpu_torch.tasks.vqa',"
        " 'xfm_tpu_torch.eval', 'xfm_tpu_torch.eval.vqa_eval',"
        " 'xfm_tpu_torch.tasks.captioning',"
        " 'xfm_tpu_torch.eval.caption_metrics', 'xfm_tpu_torch.eval.cider',"
        " 'xfm_tpu_torch.eval.meteor', 'xfm_tpu_torch.eval.meteor_synonyms',"
        " 'xfm_tpu_torch.eval.ptb_tokenizer', 'xfm_tpu_torch.tasks.nlvr',"
        " 'xfm_tpu_torch.tasks.grounding', 'xfm_tpu_torch.eval.refer',"
        " 'xfm_tpu_torch.models.gradcam', 'xfm_tpu_torch.tasks.imagenet',"
        " 'xfm_tpu_torch.tasks.glue', 'xfm_tpu_torch.tasks.classify',"
        " 'xfm_tpu_torch.data.timm_aug', 'xfm_tpu_torch.data.probe_datasets',"
        " 'xfm_tpu_torch.eval.glue_metrics', 'xfm_tpu_torch.models.vqkd',"
        " 'xfm_tpu_torch.models.teachers', 'xfm_tpu_torch.native',"
        " 'xfm_tpu_torch.models.swin', 'xfm_tpu_torch.models.deit'}\n"
        "lazy = ('PIL', 'yaml', 'transformers', 'h5py', 'datasets')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'flax', 'optax', 'xfm_tpu') + lazy]\n"
        "bad += sorted(want - set(names))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
