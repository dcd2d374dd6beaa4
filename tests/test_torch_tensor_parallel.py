"""Tensor parallelism (`xfm_tpu_torch/ops/tensor_parallel.py`,
`core/partitioning.cut_model`) on the CPU.

In this process: the cuts and their inverses (a), a block and a fusion
layer summed from their shards by hand (b), the towers and `seq_shard`
built under `tensor: 2`, the checks before a cut (g). The cases of
`tests/_torch_tp_worker.py` run in this process (one process, the model
whole) and in two gloo groups started here, at the same time: two
processes at `parallel: {tensor: 2}` (the towers' retrieval model too)
and at `{tensor: 2, seq_shard: true}`, and four at `{tensor: 4}`, `{data:
2, tensor: 2}` (with dropout live under `full` checkpointing, and
`bf16_params`) and `{fsdp: 2, tensor: 2}`, each also with `seq_shard`,
each holding its cut of every attention and MLP weight (c-f, s, t); the
BEiT-2 blocks and text and fusion layers under `seq_shard` and the
CLIP-ViT, DeiT and Swin blocks, each cut and run under the T = 2 and
T = 4 groups against the whole block here (k).
Width 128, 4 heads, 2 layers a tower, 32 px, f32, both fused routes on
(K4's and K5's plain versions).
Tolerances: losses rtol 1e-5; every gradient rtol 1e-5 / atol 1e-6; the
parameters after one step rtol 1e-5 / atol 5e-5 (lr / 20; the attention
key biases atol lr: Adam's first step moves an element by about ±lr
whatever the size of its gradient, whose rounding is then a part of lr),
as `tests/test_torch_fsdp.py` holds the fsdp axis; against the JAX
package 3e-4, the tolerance of `test_tp_loss_matches_replicated`.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_tp_worker as tw
import chip_smoke
from xfm_tpu_torch.core import mesh, partitioning
from xfm_tpu_torch.ops import tensor_parallel as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_tp_worker.py")
LR = tw.LR
T2, T4 = {"tensor": 2}, {"tensor": 4}
D2T2, F2T2 = {"data": 2, "tensor": 2}, {"fsdp": 2, "tensor": 2}
SEQ = {"seq_shard": True}
T2S, T4S, D2T2S, F2T2S = ({**lay, **SEQ} for lay in (T2, T4, D2T2, F2T2))
# each group takes the cases that wait for JAX's inputs (c, t) last
LAYOUTS = {2: [(T2S, ["s", "k", "d", "m", "e"]),
               (T2, ["d", "l", "e", "f", "r", "c", "t"]), (T2S, ["c"])],
           4: [(T4S, ["s", "k"]), (D2T2, ["d_det", "l", "d", "m", "b"]),
               (D2T2S, ["d_det"]), (F2T2, ["d_det", "l"]),
               (F2T2S, ["d_det"]), (T4, ["c"]), (T4S, ["c"])]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(spec_path, d, w):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return [subprocess.Popen(
        [sys.executable, WORKER, str(spec_path), str(d)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(w),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(w)]


def _task_runs(root) -> list:
    """An `itr_coco` YAML with the CLIP-ViT tower (2 global batches of 8,
    one epoch) with `parallel: {tensor: 2, seq_shard: true}`: the tower
    cut, the text and fusion stacks cut and sharded over the sequence."""
    import yaml

    from test_torch_distributed import _retrieval_corpus
    from xfm_tpu_torch.configs import retrieval_eval_yaml

    ret = root / "ret"
    ret.mkdir()
    _retrieval_corpus(ret)
    cfg = retrieval_eval_yaml(
        image_res=64, layers=2, clip=True, text_hidden_size=64,
        text_num_attention_heads=2, text_intermediate_size=128,
        text_vocab_size=99, embed_dim=32, compute_dtype="float32")
    cfg = {k: v for k, v in cfg.items() if k != "val_file"}
    cfg["_vision"].update(vision_width=64, num_attention_heads=2,
                          intermediate_size=128, local_attn_depth=0)
    cfg.update(train_file=[str(ret / "train.json")],
               test_file=str(ret / "test.json"), image_root=str(ret),
               batch_size_test=4, k_test=4, parallel=T2S)
    (root / "ret.yaml").write_text(yaml.safe_dump(cfg))
    return [("itr_coco", str(root / "ret.yaml"), ["--bs", "8", "--epoch",
                                                   "1"])]


class _Jax:
    """The JAX `XFMForPretrain` of `tests/test_sharding.py`'s `tiny_cfg`,
    its weights (PRNGKey 0) and batch, as `test_tp_loss_matches_
    replicated` makes them."""

    def __init__(self):
        import jax

        from test_sharding import make_batch, tiny_cfg
        from xfm_tpu.models import XFMForPretrain

        self.model = XFMForPretrain(tiny_cfg())
        self.batch = make_batch()
        self.params = self.init_params()

    def init_params(self):
        import jax

        from xfm_tpu.models import XFMForPretrain

        b = self.batch
        return self.model.init({"params": jax.random.PRNGKey(0)},
                               b["images"], b["text_ids"], b["text_atts"],
                               method=XFMForPretrain.init_all)["params"]

    def save(self, path) -> None:
        """The weights through `state_dict_from_jax` and the batch, written
        to `path` at once (`_torch_tp_worker.jax_inputs` waits for it)."""
        import jax

        from test_sharding import tiny_cfg
        from xfm_tpu_torch.train.checkpoint import state_dict_from_jax

        torch.save(dict(state_dict=state_dict_from_jax(
            jax.tree.map(np.asarray, self.params), tiny_cfg()),
            batch={k: np.asarray(v) for k, v in self.batch.items()}),
            f"{path}.part")
        os.replace(f"{path}.part", path)

    def losses(self):
        """The deterministic ITC + MLM + MIM loss replicated and on the
        (1, 1, 2) mesh, and the model with `seq_shard` on that mesh under
        `jax.set_mesh` (under the legacy `with mesh:` its
        `constrain_seq_sharding` sees no mesh and does nothing) →
        (replicated, sharded, sequence-sharded)."""
        import dataclasses

        import jax

        from test_sharding import tiny_cfg
        from xfm_tpu.core.mesh import make_mesh, shard_batch
        from xfm_tpu.core.partitioning import param_shardings
        from xfm_tpu.models import XFMForPretrain

        def losses_det(model):
            def fn(params, batch):
                out = model.apply({"params": params}, **batch, ret_mim=True,
                                  ret_match=False, rngs={})
                return out["loss_itc"] + out["loss_mlm"] + out["loss_mim"]
            return jax.jit(fn)

        base = float(losses_det(self.model)(self.params, self.batch))
        jmesh = make_mesh(jax.devices()[:2], data=1, fsdp=1, tensor=2)
        sparams = jax.tree.map(jax.device_put, self.params, param_shardings(
            jax.eval_shape(self.init_params), jmesh))
        with jmesh:
            sharded = float(losses_det(self.model)(
                sparams, shard_batch(jmesh, self.batch)))
        c = tiny_cfg()
        seq_model = XFMForPretrain(dataclasses.replace(c, **{
            k: dataclasses.replace(getattr(c, k), seq_shard=True)
            for k in ("vision", "text", "fusion")}))
        with jax.set_mesh(jmesh):
            seq = float(losses_det(seq_model)(
                sparams, shard_batch(jmesh, self.batch)))
        return base, sharded, seq


def _jax_towers(path) -> dict:
    """Case (t)'s JAX inputs: for each tower of `_torch_tp_worker.TOWERS`
    the JAX `XFMForRetrieval` of `tower_yaml` (exact erf, fixed hard
    negatives), its weights (PRNGKey 0, moved off their inits by 0.02 of
    a seeded normal) through `state_dict_from_jax` and its batch, written
    to `path` at once → kind → (ITC, ITM) of the deterministic loss."""
    import jax
    import jax.numpy as jnp

    import xfm_tpu.models.losses as jlosses
    from xfm_tpu.models.task_models import XFMForRetrieval as JRetrieval
    from xfm_tpu.models.xfm import config_from_yaml as jconfig_from_yaml
    from xfm_tpu_torch.configs import make_retrieval_batch
    from xfm_tpu_torch.train.checkpoint import state_dict_from_jax

    inputs, losses = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XFM_EXACT_ERF", "1")
        mp.setattr(jlosses, "hard_negative_indices",
                   lambda *a, **k: tuple(jnp.asarray(n) for n in tw.NEG))
        for kind in tw.TOWERS:
            jm = JRetrieval(jconfig_from_yaml(
                tw.tower_yaml(kind), use_contrastive_loss=True,
                use_matching_loss=True, dtype=jnp.float32))
            nb = make_retrieval_batch(tw.TOWER_B, 8, 32, 99)
            nb["text_atts"][1, -3:] = 0
            jb = (jnp.asarray(nb["images"]),
                  jnp.asarray(nb["text_ids"], jnp.int32),
                  jnp.asarray(nb["text_atts"], jnp.int32))
            # eagerly: the JAX Swin block builds its shift mask in numpy
            params = jm.init({"params": jax.random.PRNGKey(0)}, *jb,
                             method=JRetrieval.init_all)["params"]
            r = np.random.RandomState(0)
            leaves, tree = jax.tree.flatten(params)
            params = jax.tree.unflatten(tree, [
                np.asarray(x)
                + 0.02 * np.asarray(r.randn(*x.shape), np.float32)
                for x in leaves])
            itc, itm = jm.apply({"params": params}, *jb, deterministic=True,
                                rngs={"hardneg": jax.random.PRNGKey(0)})
            losses[kind] = (float(itc), float(itm))
            inputs[kind] = dict(batch=nb, state_dict=state_dict_from_jax(
                params, tw.tower_config(kind)))
    torch.save(inputs, f"{path}.part")
    os.replace(f"{path}.part", path)
    return losses


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every test here on one intra-op thread, as the groups' processes
    run: the models are tiny, and the suite's workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def groups(tmp_path_factory, one_thread):
    """The cases on one process and in the two groups: (spec, one,
    {world: [rank 0, ...]}, the directory, the JAX losses)."""
    from xfm_tpu_torch.train.checkpoint import save_checkpoint
    from xfm_tpu_torch.train.train_state import (make_train_step,
                                                 pretrain_loss_fn)

    d = tmp_path_factory.mktemp("tp")
    spec = tw.make_spec()
    st = tw.state(spec, {})
    make_train_step(pretrain_loss_fn)(st, tw.local_batch(spec),
                                      mesh.step_generators(0, (1,), "cpu"))
    save_checkpoint(str(d / "one_ckpt"), st)
    spec["one_ckpt"] = str(d / "one_ckpt")
    spec["jax"] = str(d / "jax.pt")
    spec["jax_towers"] = str(d / "jax_towers.pt")
    spec["layouts"] = LAYOUTS
    spec["runs"] = _task_runs(d)
    torch.save(spec, d / "spec.pt")
    procs = {w: _start(d / "spec.pt", d, w) for w in LAYOUTS}
    jx = _Jax()  # while the groups run, which take cases (c), (t) last
    jx.save(spec["jax"])
    towers = _jax_towers(spec["jax_towers"])
    jax_losses = jx.losses()
    one = tw.run_cases(spec, {}, ["c", "d", "d_det", "b", "l", "e", "t"],
                       d / "one")
    one["jax_towers"] = towers
    one["f"] = dict(step=tw.record(st))
    got = {}
    for w, ps in procs.items():
        for p in ps:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, out[-4000:]
        got[w] = [torch.load(d / f"w{w}_rank{r}.pt", weights_only=False)
                  for r in range(w)]
    return spec, one, got, d, jax_losses


# --- (a) the cuts -----------------------------------------------------------

@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("kind", [tp.COLUMN, tp.ROW, tp.QKV])
def test_cuts_round_trip(kind, size):
    """(a) each rank's cut of a weight, joined in rank order, is the weight
    bit for bit; the packed qkv cut takes the q, k and v rows of the
    rank's heads (interleaved, not a contiguous chunk)."""
    g = torch.Generator().manual_seed(size)
    w = torch.randn(3 * 8 * 4, 24, generator=g)
    parts = [tp.cut_tensor(w, kind, size, r) for r in range(size)]
    assert torch.equal(tp.join(parts, kind), w)
    if kind == tp.QKV:
        C, n = 8 * 4, 8 * 4 // size  # 8 heads of width 4
        for r, part in enumerate(parts):
            for i in range(3):
                assert torch.equal(part[i * n:(i + 1) * n],
                                   w[i * C + r * n:i * C + (r + 1) * n])
    b = torch.randn(32, generator=g)
    assert torch.equal(tp.join([tp.cut_tensor(b, tp.COLUMN, size, r)
                                for r in range(size)], tp.COLUMN), b)


def test_cut_plan_makes_megatron_pairs():
    """(a) the cut's plan: every block's four pairs, the text MLP's
    `intermediate.dense` / `output.dense` and BEiT's `proj` included
    (which `DEFAULT_RULES`' regexes miss), the row biases, tables,
    embeddings, projections and heads whole; two cuts of the model joined
    back are the whole model, bit for bit."""
    from xfm_tpu_torch.models import XFMForPretrain

    model = XFMForPretrain(tw.tiny_config())
    plan, _ = partitioning.cut_plan(model)
    v = "vision_encoder.blocks.0."
    t = "fusion_encoder.roberta.encoder.layer.1."
    want = {v + "attn.qkv.weight": tp.QKV, v + "attn.q_bias": tp.COLUMN,
            v + "attn.v_bias": tp.COLUMN, v + "attn.proj.weight": tp.ROW,
            v + "mlp.fc1.weight": tp.COLUMN, v + "mlp.fc1.bias": tp.COLUMN,
            v + "mlp.fc2.weight": tp.ROW,
            t + "attention.self.query.weight": tp.COLUMN,
            t + "crossattention.self.key.bias": tp.COLUMN,
            t + "crossattention.output.dense.weight": tp.ROW,
            t + "intermediate.dense.weight": tp.COLUMN,
            t + "intermediate.dense.bias": tp.COLUMN,
            t + "output.dense.weight": tp.ROW}
    assert {k: plan.get(k) for k in want} == want
    for whole in ("attn.proj.bias", "mlp.fc2.bias", "norm1.weight",
                  "gamma_1", "attn.relative_position_bias_table"):
        assert v + whole not in plan
    assert not [n for n in plan if "embeddings" in n or "proj." in n
                and "attn.proj" not in n or "head" in n or n == "temp"]
    # 7 a BEiT block, 10 a text layer, 17 a fusion layer
    assert len(plan) == 7 * 2 + 10 * 2 + 17 * 2
    shards = [dict(s.named_parameters())
              for s in partitioning.tensor_shards(model, 2)]
    for n, p in model.named_parameters():
        whole = (tp.join([s[n].detach() for s in shards], plan[n])
                 if n in plan else shards[0][n].detach())
        assert torch.equal(whole, p.detach()), n


# --- (b) the shards summed by hand ------------------------------------------

def _close_grads(full, got):
    """Every gradient of the whole module `full` against `got` (name →
    the cut's whole gradient)."""
    for n, p in full.named_parameters():
        # f32 sums over ~10³ rows in another order: 1e-5 of the largest,
        # at least 1e-6; a key bias's gradient is zero but for rounding
        # (softmax is shift-invariant over the keys): 1e-5
        atol = (1e-5 if n.endswith(("key.bias", "k_proj.bias"))
                else max(1e-6, 1e-5 * float(p.grad.abs().max())))
        np.testing.assert_allclose(got[n].numpy(), p.grad.numpy(),
                                   rtol=1e-5, atol=atol, err_msg=n)


@pytest.mark.parametrize("res,size", [(32, 2), (32, 4), (368, 2)],
                         ids=["N5-T2", "N5-T4", "N530-T2"])
def test_beit_block_from_shards(res, size):
    """(b) a BEiT-2 block (width 128, 4 heads, both fused routes) from its
    T shards, the row partials summed by hand: at N = 5 through K1's plain
    version ([1, H/T, N, N] bias), at N = 530 ≥ 512 through K2's (the
    table's H/T columns): the output (rtol 1e-5, atol 1e-6) and every
    gradient (the shards' joined, the tables' columns summed; within 1e-5
    of its largest element, at least 1e-6) equal the whole block's."""
    from xfm_tpu_torch.models.beit2 import BeitBlock, VisionConfig
    from xfm_tpu_torch.train.checkpoint import init_weights

    c = VisionConfig(image_res=res, patch_size=16, embed_dim=128, depth=1,
                     num_heads=4, drop_path_rate=0.0, fused_ln=True,
                     fused_mlp=True, hidden_act="gelu_tanh")
    blk = BeitBlock(c)
    init_weights(blk, 1)
    g = torch.Generator().manual_seed(res)
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    shards = partitioning.tensor_shards(blk, size)
    x = torch.randn(2, c.num_patches + 1, 128, generator=g)
    y = blk(x)
    dy = torch.randn(y.shape, generator=g)
    y.backward(dy)
    ys = chip_smoke.shard_beit_block(shards, x)
    ys.backward(dy)
    np.testing.assert_allclose(ys.detach().numpy(), y.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    _close_grads(blk, chip_smoke.shard_whole_grads(shards))


@pytest.mark.parametrize("size", [2, 4])
def test_fusion_layer_from_shards(size):
    """(b) a fusion layer (self-attention with a padded mask, the
    cross-attention from 96-wide features, the MLP) from its T shards:
    the output and every gradient equal the whole layer's, at the
    tolerances of `test_beit_block_from_shards`."""
    from xfm_tpu_torch.models.text_encoder import (TextConfig,
                                                   TransformerLayer)
    from xfm_tpu_torch.ops.attention import mask_to_bias
    from xfm_tpu_torch.train.checkpoint import init_weights

    c = TextConfig.roberta_base(
        hidden_size=128, num_attention_heads=4, intermediate_size=256,
        encoder_width=96, fusion_layer=0, vocab_size=99,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        fused_ln=True, fused_mlp=True)
    layer = TransformerLayer(c, has_cross_attention=True)
    init_weights(layer, 2)
    g = torch.Generator().manual_seed(size)
    h = torch.randn(3, 7, 128, generator=g)
    enc = torch.randn(3, 9, 96, generator=g)
    m = torch.ones(3, 7)
    m[1, -2:] = 0
    bias = mask_to_bias(m)
    shards = partitioning.tensor_shards(layer, size)
    y = layer(h, bias, enc, None)
    dy = torch.randn(y.shape, generator=g)
    y.backward(dy)
    ys = chip_smoke.shard_text_layer(shards, h, bias, enc, None)
    ys.backward(dy)
    np.testing.assert_allclose(ys.detach().numpy(), y.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    _close_grads(layer, chip_smoke.shard_whole_grads(shards))


def _against_group(groups, kind, res, size):
    """Case (k)'s block (`_torch_tp_worker.block_case`) cut for each rank
    of the group of `size` and run under it (the real collectives; under
    `seq_shard` the rows scattered and gathered as a stack runs its loop):
    rank 0's gathered output (rtol 1e-5; atol 1e-6 of its largest
    element, at least 1e-6: a residual stream without layer scale, where
    f32 sums in another order differ by an ulp of its scale) and every
    whole gradient (`_close_grads`; the `seq_shard` partials summed over
    the group, the cut ones gathered) against the whole block's for the
    same output gradient."""
    _, _, got, _, _ = groups
    lay = tw.layout_name(T2S if size == 2 else T4S)
    ys, grads = got[size][0][lay]["k"][(kind, res)]
    full, run, x, seed = tw.block_case(kind, res, size)
    y = run(full, x)
    y.backward(torch.randn(y.shape,
                           generator=torch.Generator().manual_seed(seed)))
    np.testing.assert_allclose(
        ys.numpy(), y.detach().numpy(), rtol=1e-5,
        atol=max(1e-6, 1e-6 * float(y.detach().abs().max())))
    _close_grads(full, grads)


@pytest.mark.parametrize("res,size", [(32, 2), (32, 4), (368, 2), (368, 4)],
                         ids=["N5-T2", "N5-T4", "N530-T2", "N530-T4"])
def test_beit_block_seq_from_shards(groups, res, size):
    """(k) a BEiT-2 block under `seq_shard` cut into T shards, each rank's
    run under the group on its ⌈N/T⌉ rows: its LayerNorms (K4's plain
    version), layer scales and residuals on its own rows, the rows
    gathered for the attention (K1's plain version at N = 5, K2's at
    530) and the MLP (K5's), the row partials reduce-scattered; N padded
    to T·⌈N/T⌉ (5 → 6, 8; 530 → 530, 532). The output and every gradient
    equal the whole block's (`_against_group`)."""
    _against_group(groups, "beit", res, size)


@pytest.mark.parametrize("cross,size", [(False, 2), (False, 4), (True, 2),
                                        (True, 4)],
                         ids=["text-T2", "text-T4", "fusion-T2",
                              "fusion-T4"])
def test_text_layer_seq_from_shards(groups, cross, size):
    """(k) a text layer (self-attention over 7 rows, one padded) and a
    fusion layer (the cross-attention to 9 rows of 96-wide features, read
    whole) under `seq_shard`, each rank's run under the group on its rows
    (7 padded to 8): the output and every gradient equal the whole
    layer's (`_against_group`)."""
    _against_group(groups, "fusion" if cross else "text", 0, size)


@pytest.mark.parametrize("kind,res,size", [
    ("clip", 32, 2), ("clip", 32, 4), ("clip", 368, 2), ("deit", 32, 2),
    ("deit", 32, 4), ("deit", 368, 2), ("swin", 32, 2), ("swin", 32, 4)],
    ids=["clip-N5-T2", "clip-N5-T4", "clip-N530-T2", "deit-N5-T2",
         "deit-N5-T4", "deit-N530-T2", "swin-T2", "swin-T4"])
def test_tower_block_from_shards(groups, kind, res, size):
    """(k) a CLIP-ViT layer, a DeiT block and a shifted Swin block cut
    into T shards, each rank's run under the group: q/k/v and fc1 by
    columns at H/T heads (K3's plain version forward and backward at
    N = 530), out_proj / proj and fc2 by rows, all-reduced, Swin's table
    read by its heads' columns: the output and every gradient equal the
    whole block's (`_against_group`)."""
    _against_group(groups, kind, res, size)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "k5"])
def test_row_partials_round_once(fused):
    """(b) a bf16 row layer's partial sums come back in f32, unrounded
    (`dense_partial`; on the fused route K5's plain version without a
    bias), so that the T = 2 cut summed with the bias (`row_sum`, as
    `row_output` sums after the all-reduce) rounds once, as the whole
    layer does: equal to the f32 product of the bf16 operands plus the
    bias, rounded to bf16, but where the two partials' order of summation
    moves an f32 sum across a rounding boundary (at most one bf16 ulp, on
    under 1 % of the elements). The input's and the weight's gradients
    are the whole layer's, cut (rtol 1e-2: bf16 products)."""
    from xfm_tpu_torch.core.precision import (ACT, act_dense, dense,
                                              dense_partial)

    bf, K = torch.bfloat16, 256
    g = torch.Generator().manual_seed(7)
    layer = torch.nn.Linear(K, 64)
    with torch.no_grad():
        layer.weight.copy_(torch.randn(64, K, generator=g) / 16)
        layer.bias.copy_(torch.randn(64, generator=g))
    x = torch.randn(3, 40, K, generator=g).to(bf)

    def run(inp, lin, bias=True):
        if fused:
            return act_dense(inp, lin, "gelu_tanh", bf, fused=True,
                             bias=bias)
        return dense(inp, lin, bf) if bias else dense_partial(inp, lin, bf)

    act = ACT["gelu_tanh"] if fused else (lambda t: t)
    want = (act(x.float()).to(bf).float() @ layer.weight.to(bf).float().t()
            + layer.bias.to(bf).float()).to(bf)
    parts, cuts = [], []
    for r in range(2):
        cut = torch.nn.Linear(K // 2, 64, bias=False)
        with torch.no_grad():
            cut.weight.copy_(tp.cut_tensor(layer.weight, tp.ROW, 2, r))
        xr = x[..., r * K // 2:(r + 1) * K // 2].clone().requires_grad_()
        parts.append(run(xr, cut, bias=False))
        assert parts[-1].dtype == torch.float32
        cuts.append((xr, cut))
    got = tp.row_sum(parts, layer.bias, bf)
    assert got.dtype == bf
    gap = (got.float() - want.float()).abs()
    assert bool((gap <= _bf16_ulp(want)).all())
    assert int((gap > 0).sum()) < 0.01 * gap.numel()
    dy = torch.randn(got.shape, generator=g).to(bf)
    got.backward(dy)
    whole = x.clone().requires_grad_()
    run(whole, layer).backward(dy)
    for r, (xr, cut) in enumerate(cuts):
        np.testing.assert_allclose(
            xr.grad.float().numpy(),
            whole.grad[..., r * K // 2:(r + 1) * K // 2].float().numpy(),
            rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(
            cut.weight.grad.numpy(),
            tp.cut_tensor(layer.weight.grad, tp.ROW, 2, r).numpy(),
            rtol=1e-2, atol=1e-2)


# --- (c)-(f) the groups -----------------------------------------------------

@pytest.mark.parametrize("w,seq", [(2, False), (4, False), (2, True),
                                   (4, True)],
                         ids=["tensor2", "tensor4", "tensor2-seq",
                              "tensor4-seq"])
def test_loss_matches_jax(groups, w, seq):
    """(c) the JAX `XFMForPretrain` of `tests/test_sharding.py`'s
    `tiny_cfg` (its weights through `state_dict_from_jax`): the port's
    deterministic ITC + MLM + MIM at `{tensor: T}` (with `seq_shard`: the
    JAX model with `seq_shard` under `jax.set_mesh`) equals the JAX loss
    replicated and on the (1, 1, 2) mesh within 3e-4, and the port's one
    process within 1e-5, on every rank."""
    _, one, got, _, (base, sharded, seq_loss) = groups
    if seq:
        sharded = seq_loss
    np.testing.assert_allclose(sharded, base, rtol=3e-4, atol=3e-4)
    want = sum(one["c"].values())
    name = tw.layout_name({**(T2 if w == 2 else T4),
                           **(SEQ if seq else {})})
    for r in range(w):
        loss = sum(got[w][r][name]["c"].values())
        np.testing.assert_allclose(loss, base, rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(loss, sharded, rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(loss, want, rtol=1e-5)


def _close_states(want, got, what, scaled=False):
    """`scaled`: each gradient's atol 1e-5 of its largest element (at
    least 1e-6), as (b) holds them: the towers without layer scale, whose
    gradients run larger."""
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=f"{what} {k}")
    for n, g in want["grads"].items():
        atol = (max(1e-6, 1e-5 * float(g.abs().max())) if scaled
                else 1e-6)
        np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy(),
                                   rtol=1e-5, atol=atol,
                                   err_msg=f"{what} grad {n}")
    for n, p in want["params"].items():
        atol = LR if n.endswith("self.key.bias") else LR / 20
        np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(),
                                   rtol=1e-5, atol=atol,
                                   err_msg=f"{what} param {n}")


@pytest.mark.parametrize("w,layout,case", [
    (2, T2, "d"), (2, T2, "l"), (4, D2T2, "d_det"), (4, D2T2, "l"),
    (4, F2T2, "d_det"), (4, F2T2, "l"), (2, T2S, "d"), (4, D2T2S, "d_det"),
    (4, F2T2S, "d_det")],
    ids=["tensor2-live", "tensor2-lars", "data2-tensor2",
         "data2-tensor2-lars", "fsdp2-tensor2", "fsdp2-tensor2-lars",
         "tensor2-seq-live", "data2-tensor2-seq", "fsdp2-tensor2-seq"])
def test_step_equals_one_process_step(groups, w, layout, case):
    """(d) one step at the layout equals one process's step on the global
    batch: the reduced loss, the whole gradient's norm, every gradient
    (gathered over the cuts and shards) and the updated parameters. At
    `{tensor: 2}` with dropout, attention dropout and drop-path live (the
    masks drawn over all heads, a rank's heads taken) and HF-AdamW with a
    clip that bites; the other layouts split the batch over their data or
    fsdp ranks (their rank generators are not one process's, so the step
    is deterministic); LARS's trust ratios take whole weights. Under
    `seq_shard` the LayerNorms, layer scales and row biases, whose
    gradients each rank sums over its rows alone, come out whole too.
    Every rank holds the same whole parameters."""
    _, one, got, _, _ = groups
    name = tw.layout_name(layout)
    for r in range(w):
        _close_states(one[case], got[w][r][name][case], f"{name} {r}")
        for n, p in got[w][0][name][case]["params"].items():
            assert torch.equal(p, got[w][r][name][case]["params"][n]), n
    if case != "l":
        norm = got[w][0][name][case]["metrics"]["grad_norm"]
        assert norm > 100 * tw.CLIP


def test_full_checkpointing_under_tensor_is_bit_equal(groups):
    """(d) `gradient_checkpointing: full` on every block and layer of the
    cut model at `{data: 2, tensor: 2}`, dropout live: the loss, every
    gradient and the parameters after the step equal the plain step's at
    that layout bit for bit on every rank (the recompute replays the
    masks and its all-reduces give the same sums)."""
    _, _, got, _, _ = groups
    name = tw.layout_name(D2T2)
    for r in range(4):
        a, b = got[4][r][name]["d"], got[4][r][name]["m"]
        assert a["metrics"] == b["metrics"], r
        for key in ("grads", "params"):
            for n, t in a[key].items():
                assert torch.equal(t, b[key][n]), (r, key, n)


def test_full_checkpointing_under_seq_shard_is_bit_equal(groups):
    """(d) `gradient_checkpointing: full` at `{tensor: 2, seq_shard:
    true}`, dropout live: the loss, every gradient and the parameters
    after the step equal the plain step's at that layout bit for bit on
    both ranks (the recompute replays the gathers, the reduce-scatters and
    the masks on the rank's rows)."""
    _, _, got, _, _ = groups
    name = tw.layout_name(T2S)
    for r in range(2):
        a, b = got[2][r][name]["d"], got[2][r][name]["m"]
        assert a["metrics"] == b["metrics"], r
        for key in ("grads", "params"):
            for n, t in a[key].items():
                assert torch.equal(t, b[key][n]), (r, key, n)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    x = x.float().abs().clamp(min=2.0 ** -126)
    return torch.pow(2.0, torch.floor(torch.log2(x)) - 7)


def test_bf16_params_under_tensor(groups):
    """(d) `bf16_params` on the cut model at `{data: 2, tensor: 2}` (bf16
    live cuts, f32 masters that carry the cut, the batch split over two
    replicas) against one process's `MasterWeights` step, at
    the tolerances of `tests/test_torch_fsdp.py`'s bf16 test: the loss
    at rtol 1e-5, the masters within 2·lr·lr_mult, the live weights the
    rounded masters bit for bit and within 1 bf16 ulp of one process's on
    more than 99.5 % of the elements."""
    _, one, got, _, _ = groups
    a = one["b"]
    b = got[4][0][tw.layout_name(D2T2)]["b"]
    np.testing.assert_allclose(b["metrics"]["loss"], a["metrics"]["loss"],
                               rtol=1e-5)
    beyond = total = 0
    for n, live in a["params"].items():
        m = b["optimizer"]["master"][n]
        assert m.dtype == torch.float32, n
        assert torch.equal(b["params"][n], m.to(torch.bfloat16)), n
        gap = (live.float() - b["params"][n].float()).abs()
        ulp = _bf16_ulp(torch.maximum(live.float().abs(),
                                      b["params"][n].float().abs()))
        beyond += int((gap > ulp).sum())
        total += live.numel()
        mgap = (a["optimizer"]["master"][n] - m).abs()
        assert float(mgap.max()) <= 2 * LR * 2.0 * (1 + 1e-3), n
    assert beyond < 0.005 * total, (beyond, total)


def test_evals_equal_one_process(groups):
    """(e) at `{tensor: 2}` the retrieval eval's R@K, `XFMForVQA.rank`'s
    top-k (ids equal, probabilities within 1e-5) and the greedy and beam-3
    captions (token for token, log p within 1e-5) equal one process's on
    both ranks: no row counted twice. (The probabilities sum the heads in
    another order: 1e-5.)"""
    _, one, got, _, _ = groups
    name = tw.layout_name(T2)
    for r in range(2):
        e = got[2][r][name]["e"]
        assert e["retrieval"] == one["e"]["retrieval"]
        assert torch.equal(e["rank"][0], one["e"]["rank"][0])
        np.testing.assert_allclose(e["rank"][1].numpy(),
                                   one["e"]["rank"][1].numpy(), atol=1e-5)
        assert torch.equal(e["greedy"][0], one["e"]["greedy"][0])
        np.testing.assert_allclose(e["greedy"][1].numpy(),
                                   one["e"]["greedy"][1].numpy(), atol=1e-5)
        assert torch.equal(e["beam"], one["e"]["beam"])


def test_evals_under_seq_shard_equal_one_process(groups):
    """(e) at `{tensor: 2, seq_shard: true}` the same as at `{tensor: 2}`:
    the retrieval eval's R@K, `rank`'s top-k (the question's encoders
    sharded over the sequence, the decoder's cached steps unsplit) and
    the greedy and beam-3 captions equal one process's on both ranks."""
    _, one, got, _, _ = groups
    name = tw.layout_name(T2S)
    for r in range(2):
        e = got[2][r][name]["e"]
        assert e["retrieval"] == one["e"]["retrieval"]
        assert torch.equal(e["rank"][0], one["e"]["rank"][0])
        np.testing.assert_allclose(e["rank"][1].numpy(),
                                   one["e"]["rank"][1].numpy(), atol=1e-5)
        assert torch.equal(e["greedy"][0], one["e"]["greedy"][0])
        np.testing.assert_allclose(e["greedy"][1].numpy(),
                                   one["e"]["greedy"][1].numpy(), atol=1e-5)
        assert torch.equal(e["beam"], one["e"]["beam"])


@pytest.mark.parametrize("w", [2, 4], ids=["tensor2", "tensor4"])
def test_sequence_functions_round_trip(groups, w):
    """(s) over a group of T ranks at N = 5 and 530 (uneven: padded to
    T·⌈N/T⌉): a rank's scattered rows are its rows of x and zeros past
    N; gathered back they are x bit for bit and x's gradient is the
    output's; the row partials reduce-scattered and gathered are their
    sum over the ranks (f32: 1e-5), each partial's gradient the output's;
    a column gather's gradient is the ranks' summed (1e-5). The padding
    reaches no output and no gradient."""
    _, _, got, _, _ = groups
    name = tw.layout_name(T2S if w == 2 else T4S)
    for r in range(w):
        for n, res in got[w][r][name]["s"].items():
            assert res["rows"] == (2, -(-n // w), 8), (r, n)
            for key in ("pad_zero", "own", "back", "grad", "part_grad"):
                assert res[key], (r, n, key)
            assert res["sum"] <= 1e-5 and res["col_grad"] <= 1e-5, (r, n)


def test_checkpoints_move_between_layouts(groups, tmp_path):
    """(f) the one-process checkpoint restores into the `{tensor: 2}`
    state bit for bit (parameters and moments, gathered back); the
    `{tensor: 2}` checkpoint (whole tensors under the reference names, one
    file) restores on one process bit for bit and holds one process's
    step; the `.th` export of each (`train/checkpoint.reference_names`,
    what `convert_checkpoint to-torch` writes) has the same entries."""
    from xfm_tpu_torch.convert_checkpoint import load_state_params
    from xfm_tpu_torch.train.checkpoint import (reference_names,
                                                restore_checkpoint)

    spec, one, got, d, _ = groups
    name = tw.layout_name(T2)
    saved = torch.load(os.path.join(spec["one_ckpt"], "1", "state.pt"),
                       weights_only=True)
    for r in range(2):
        rec = got[2][r][name]["f"]["restored"]
        for n, p in saved["params"].items():
            assert torch.equal(rec["params"][n], p), n
        for n, m in saved["optimizer"]["mu"].items():
            assert torch.equal(rec["optimizer"]["mu"][n], m), n
    path = d / name / "ckpt"
    st = restore_checkpoint(str(path), tw.state(spec, {}))
    mine = tw.record(st)
    tp_file = torch.load(path / "1" / "state.pt", weights_only=True)
    for n, p in tp_file["params"].items():
        assert torch.equal(mine["params"][n], p), n
    _close_states(dict(one["f"]["step"], metrics={}, grads={}), mine,
                  "restored")
    cfg = tw.pretrain_config()
    a = reference_names(load_state_params(str(path)), cfg)
    b = reference_names(load_state_params(spec["one_ckpt"]), cfg)
    assert set(a) == set(b)
    for n, v in b.items():
        atol = LR if n.endswith("key.bias") else LR / 20
        np.testing.assert_allclose(a[n].numpy(), v.numpy(), rtol=1e-5,
                                   atol=atol, err_msg=n)


@pytest.mark.parametrize("kind", tw.TOWERS)
def test_tower_loss_matches_jax(groups, kind):
    """(t) the retrieval model with the `kind` tower on the JAX package's
    weights (exact erf, fixed hard negatives): the deterministic ITC and
    ITM at `{tensor: 2}` equal the JAX losses within 3e-4 and one
    process's within 1e-5, on both ranks."""
    _, one, got, _, _ = groups
    jitc, jitm = one["jax_towers"][kind]
    want = one["t"][kind]["loss"]
    np.testing.assert_allclose(want["loss_itc"], jitc, rtol=3e-4)
    np.testing.assert_allclose(want["loss_itm"], jitm, rtol=3e-4)
    for r in range(2):
        loss = got[2][r][tw.layout_name(T2)]["t"][kind]["loss"]
        np.testing.assert_allclose(loss["loss_itc"], jitc, rtol=3e-4)
        np.testing.assert_allclose(loss["loss_itm"], jitm, rtol=3e-4)
        for k, v in want.items():
            np.testing.assert_allclose(loss[k], v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", tw.TOWERS)
def test_tower_step_equals_one_process_step(groups, kind):
    """(t) one deterministic retrieval step with the `kind` tower at
    `{tensor: 2}` (HF-AdamW, its clip) equals one process's: the metrics,
    every gradient (within 1e-5 of its largest element, as (b)) and the
    updated parameters, at `test_step_equals_one_process_step`'s
    tolerances; both ranks hold the same whole parameters."""
    _, one, got, _, _ = groups
    name = tw.layout_name(T2)
    a = got[2][0][name]["t"][kind]["step"]
    for r in range(2):
        b = got[2][r][name]["t"][kind]["step"]
        _close_states(one["t"][kind]["step"], b, f"{kind} {r}",
                      scaled=True)
        for n, p in a["params"].items():
            assert torch.equal(p, b["params"][n]), n


@pytest.mark.parametrize("kind", tw.TOWERS)
def test_tower_checkpoint_loads_whole(groups, kind):
    """(t) the `{tensor: 2}` checkpoint of the `kind` tower's step holds
    whole tensors: it restores into one process's state and holds one
    process's step; its `.th` export (`reference_names`, what
    `convert_checkpoint to-torch` writes) has one process's entries."""
    from xfm_tpu_torch.convert_checkpoint import load_state_params
    from xfm_tpu_torch.train.checkpoint import (reference_names,
                                                restore_checkpoint)

    spec, one, _, d, _ = groups
    path = d / tw.layout_name(T2) / f"ckpt_{kind}"
    jx = tw.jax_inputs(spec, "jax_towers")
    mine = tw.record(restore_checkpoint(str(path),
                                        tw.tower_state({}, kind, jx)))
    _close_states(dict(one["t"][kind]["step"], metrics={}, grads={}), mine,
                  f"{kind} restored")
    cfg = tw.tower_config(kind)
    a = reference_names(load_state_params(str(path)), cfg)
    b = reference_names(load_state_params(str(d / "one" / f"ckpt_{kind}")),
                        cfg)
    assert set(a) == set(b)
    for n, v in b.items():
        atol = LR if n.endswith(("key.bias", "k_proj.bias")) else LR / 20
        np.testing.assert_allclose(a[n].numpy(), v.numpy(), rtol=1e-5,
                                   atol=atol, err_msg=n)


def test_task_runs_under_tensor(groups, tmp_path):
    """`run.main` under `parallel: {tensor: 2, seq_shard: true}` on two
    processes with the CLIP-ViT tower: `itr_coco`'s epoch (zero-shot eval,
    train, eval, ckpt/0) gives the eval that one process's `--evaluate`
    of its ckpt/0 gives, on both ranks."""
    import yaml

    from xfm_tpu_torch import run

    spec, _, got, d, _ = groups
    ((_, ret_yaml, _),) = spec["runs"]
    out = d / "tensor2" / "itr_coco"
    log = [json.loads(x) for x in (out / "log.txt").read_text().splitlines()]
    assert [e["epoch"] for e in log] == [-1, 0]
    name = tw.layout_name(T2)
    assert got[2][0][name]["r"]["itr_coco"] == got[2][1][name]["r"][
        "itr_coco"]
    cfg = yaml.safe_load(open(ret_yaml))
    del cfg["parallel"]
    one_yaml = tmp_path / "ret.yaml"
    one_yaml.write_text(yaml.safe_dump(cfg))
    one = run.main(["--task", "itr_coco", "--config", str(one_yaml),
                    "--device", "cpu", "--seed", "0", "--evaluate",
                    "--output_dir", str(tmp_path / "ev"), "--checkpoint",
                    str(out / "ckpt" / "0" / "state.pt")])
    assert one == {k: log[1][k] for k in one}


# --- (g) the towers and seq_shard under tensor: 2; the checks ---------------

@pytest.mark.parametrize("key", ["use_clip_vit", "use_swin", "use_deit",
                                 "seq_shard"])
def test_towers_and_seq_shard_refuse_tensor(groups, key):
    """(g) the CLIP-ViT, Swin and DeiT towers and `seq_shard` no longer
    refuse `parallel.tensor` > 1: `config_from_yaml` builds them at
    `tensor: 2` (`seq_shard` on the BEiT-2 tower and the text and fusion
    stacks, not on another tower, as the JAX package sets it; a no-op at
    `tensor: 1`), and the groups ran them (case (t)'s step with each
    tower, the `seq_shard` step at `{tensor: 2, seq_shard: true}`: finite
    losses on both ranks). A Swin stage whose heads T does not divide
    raises ValueError before anything is cut."""
    from xfm_tpu_torch.models import XFMForRetrieval, config_from_yaml

    _, _, got, _, _ = groups
    kind = {"use_clip_vit": "clip", "use_swin": "swin",
            "use_deit": "deit"}.get(key)
    yaml_cfg = dict(tw.tower_yaml(kind) if kind else {},
                    parallel={"tensor": 2, "seq_shard": True})
    cfg = config_from_yaml(yaml_cfg)
    assert cfg.text.seq_shard and cfg.fusion.seq_shard
    assert getattr(cfg.vision, "seq_shard", False) == (kind is None)
    for r in range(2):
        if kind is None:
            m = got[2][r][tw.layout_name(T2S)]["d"]["metrics"]
        else:
            m = got[2][r][tw.layout_name(T2)]["t"][kind]["step"]["metrics"]
        assert m and all(np.isfinite(v) for v in m.values()), (key, r)
    if key == "use_swin":
        bad = dict(yaml_cfg, _vision=dict(yaml_cfg["_vision"],
                                          num_heads=[2, 3]))
        model = XFMForRetrieval(config_from_yaml(bad, dtype=torch.float32))
        before = {n: p.shape for n, p in model.named_parameters()}
        with pytest.raises(ValueError, match="does not divide the 3 heads"):
            partitioning.cut_model(model, tp.TensorCut(2, 0))
        assert {n: p.shape for n, p in model.named_parameters()} == before


def test_tensor_must_divide_heads_and_width():
    """(g) a T that does not divide the heads (4) or an MLP width raises
    ValueError naming them, before anything is cut."""
    from xfm_tpu_torch.models import XFMForPretrain

    model = XFMForPretrain(tw.tiny_config())
    before = {n: p.shape for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match="does not divide the 4 heads"):
        partitioning.cut_model(model, tp.TensorCut(3, 0))
    assert {n: p.shape for n, p in model.named_parameters()} == before
