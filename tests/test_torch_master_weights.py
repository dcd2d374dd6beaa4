"""bf16 live parameters with f32 master weights (`train/optim.
with_master_weights`, `tasks/common.maybe_bf16_params`) and the precision
helpers under them, against the JAX package (`tests/test_optim.py`'s and
`tests/test_precision.py`'s master-weight cases).

- Updates below bf16's resolution accumulate in the masters.
- HF-AdamW under master weights against JAX's `with_master_weights` over
  five steps of the same bf16 gradients: masters within 1e-6 of each
  tensor's largest |value|; live parameters within 1 bf16 ulp of JAX's,
  the ulp taken at the larger of the parameter's magnitudes before and
  after the step (the port sets each to its rounded master; JAX adds the
  bf16 delta (rounded master − live), which rounds at the old value's
  scale, so where a value shrinks across binades JAX's lands several of
  the new value's ulps away, never more than one of the old one's).
- The port's live parameters equal their rounded masters bit for bit (the
  pinned difference); LARS under master weights equals LARS on the
  masters; a save and restore continue bit for bit.
- LayerNorm (plain, add, post, and K4's route, its plain version here)
  takes bf16 γ and β with f32 statistics: equal to the f32 parameters'
  result bit for bit; BEiT's K1 entry gets an f32 bias from a bf16 table,
  whose gradient is the f32 table's rounded once.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfm_tpu_torch.train.optim import (LARS, HFAdamW, MasterWeights,
                                       create_optimizer_from_config,
                                       trained_parameters,
                                       with_master_weights)
from _torch_threads import one_intra_op_thread  # noqa: F401


class _SGD:
    """p -= lr·g: the JAX test's `optax.sgd` as an inner optimizer."""

    def __init__(self, named, lr):
        self.names, self.params = zip(*named)
        self.lr = lambda _c: lr
        self.count = 0

    @torch.no_grad()
    def step(self):
        for p in self.params:
            p.sub_(self.lr(self.count) * p.grad.float())
        self.count += 1
        return torch.zeros(())

    def state_dict(self):
        return {"count": self.count}

    def load_state_dict(self, s):
        self.count = s["count"]


def test_master_weights_accumulate_small_updates():
    w = torch.nn.Parameter(torch.full((4,), 256.0, dtype=torch.bfloat16))
    opt = with_master_weights([("w", w)], lambda n: _SGD(n, 0.05))
    for _ in range(100):
        w.grad = torch.ones(4, dtype=torch.bfloat16)
        opt.step()
    # 100 × 0.05 = 5; a single bf16 step would freeze at 256 (ulp 2)
    np.testing.assert_allclose(w.detach().float().numpy(), 251.0, atol=1.5)
    np.testing.assert_allclose(opt.masters[0].numpy(), 251.0, atol=1e-2)
    assert w.dtype == torch.bfloat16 and opt.masters[0].dtype == torch.float32


CFG = {"bf16_params": True, "optimizer": {"weight_decay": 0.05},
       "accelerator": {"CLIP_GRAD_NORM": 1.0}}


def _model(seed=0):
    torch.manual_seed(seed)
    m = torch.nn.Module()
    m.dense = torch.nn.Linear(16, 8)
    m.norm = torch.nn.LayerNorm(8)
    with torch.no_grad():
        m.norm.weight.add_(0.1 * torch.randn(8))
    return m


def _bf16_state(seed=0):
    from xfm_tpu_torch.tasks.common import TaskContext, maybe_bf16_params
    from xfm_tpu_torch.train.train_state import TrainState

    model = _model(seed)
    f32 = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState.create(model, create_optimizer_from_config(
        model, CFG, lambda c: 1e-2))
    ctx = TaskContext(config=CFG, out_dir="unused", device="cpu")
    return maybe_bf16_params(ctx, state, lambda c: 1e-2), f32


def _grads(step, names_shapes):
    r = np.random.RandomState(100 + step)
    return {n: (r.randn(*s) * 0.3).astype(np.float32)
            for n, s in names_shapes}


def _ulp(x):
    """bf16's unit in the last place at each |x|."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_hf_adamw_under_master_weights_tracks_jax():
    from xfm_tpu.train.optim import create_optimizer_from_config as jcreate
    from xfm_tpu.train.optim import with_master_weights as jwith

    state, f32 = _bf16_state()
    model, opt = state.model, state.optimizer
    assert isinstance(opt, MasterWeights)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    for n, m in zip(opt.names, opt.masters):
        assert m.dtype == torch.float32 and torch.equal(m, f32[n])
    jparams = {"dense": {"kernel": f32["dense.weight"].numpy().T,
                         "bias": f32["dense.bias"].numpy()},
               "norm": {"scale": f32["norm.weight"].numpy(),
                        "bias": f32["norm.bias"].numpy()}}
    jparams = jax.tree.map(jnp.asarray, jparams)
    tx = jwith(jcreate(jparams, CFG, lambda c: 1e-2))
    jstate = tx.init(jparams)
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    names_shapes = [(n, tuple(p.shape)) for n, p in
                    model.named_parameters()]
    to_j = {"dense.weight": ("dense", "kernel", True),
            "dense.bias": ("dense", "bias", False),
            "norm.weight": ("norm", "scale", False),
            "norm.bias": ("norm", "bias", False)}
    for step in range(5):
        g = _grads(step, names_shapes)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n]).to(torch.bfloat16)
        jg = {}
        for n, (mod, leaf, tr) in to_j.items():
            v = jnp.asarray(g[n].T if tr else g[n]).astype(jnp.bfloat16)
            jg.setdefault(mod, {})[leaf] = v
        state.apply_gradients()
        upd, jstate = tx.update(jg, jstate, jp)
        jprev = jp
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for n, p in model.named_parameters():
            mod, leaf, tr = to_j[n]
            jlive = np.asarray(jp[mod][leaf].astype(jnp.float32))
            jold = np.asarray(jprev[mod][leaf].astype(jnp.float32))
            jmaster = np.asarray(jstate["master"][mod][leaf])
            if tr:
                jlive, jold, jmaster = jlive.T, jold.T, jmaster.T
            live = p.float().detach().numpy()
            master = opt.masters[opt.names.index(n)].numpy()
            assert np.abs(master - jmaster).max() <= 1e-6 * np.abs(
                jmaster).max(), (step, n)
            scale = np.maximum(np.abs(jlive), np.abs(jold))
            assert (np.abs(live - jlive) <= _ulp(scale)).all(), (step, n)
            # the port's pin: live == its master rounded, bit for bit
            assert torch.equal(p.detach(), torch.from_numpy(master).to(
                torch.bfloat16)), (step, n)


def test_lars_under_master_weights_equals_lars_on_the_masters():
    w32 = torch.nn.Parameter(torch.randn(6, 5))
    b32 = torch.nn.Parameter(torch.randn(5))
    ref = LARS([("w", w32), ("b", b32)], 0.1, weight_decay=1e-3)
    w = torch.nn.Parameter(w32.detach().clone())
    b = torch.nn.Parameter(b32.detach().clone())
    opt = with_master_weights([("w", w), ("b", b)],
                              lambda n: LARS(n, 0.1, weight_decay=1e-3))
    with torch.no_grad():
        w.data, b.data = w.data.bfloat16(), b.data.bfloat16()
    for step in range(3):
        gw, gb = torch.randn(6, 5), torch.randn(5)
        w.grad, b.grad = gw.bfloat16(), gb.bfloat16()
        w32.grad, b32.grad = gw.bfloat16().float(), gb.bfloat16().float()
        ref.step()
        opt.step()
        torch.testing.assert_close(opt.masters[0], w32.detach(), rtol=0,
                                   atol=0)
        torch.testing.assert_close(w.detach(), w32.detach().bfloat16(),
                                   rtol=0, atol=0)
    assert opt.count == ref.count == 3


def test_resume_is_bit_equal(tmp_path):
    """A state saved after two steps and restored into a fresh bf16 state
    continues bit for bit: live parameters, masters, moments, count."""
    from xfm_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                save_checkpoint)

    names_shapes = None

    def run(state, steps):
        nonlocal names_shapes
        names_shapes = [(n, tuple(p.shape)) for n, p in
                        state.model.named_parameters()]
        for s in steps:
            g = _grads(s, names_shapes)
            for n, p in state.model.named_parameters():
                p.grad = torch.from_numpy(g[n]).bfloat16()
            state.apply_gradients()

    a, _ = _bf16_state()
    run(a, range(2))
    save_checkpoint(str(tmp_path / "ckpt"), a)
    run(a, range(2, 4))
    b, _ = _bf16_state(seed=1)  # other weights, overwritten by the restore
    restore_checkpoint(str(tmp_path / "ckpt"), b)
    assert b.step == 2 and b.optimizer.count == 2
    run(b, range(2, 4))
    for (n, p), (_, q) in zip(a.model.named_parameters(),
                              b.model.named_parameters()):
        assert p.dtype == torch.bfloat16 and torch.equal(p, q), n
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for n in sa["master"]:
        assert torch.equal(sa["master"][n], sb["master"][n])
        assert torch.equal(sa["inner"]["mu"][n], sb["inner"]["mu"][n])
        assert torch.equal(sa["inner"]["nu"][n], sb["inner"]["nu"][n])
    assert sa["inner"]["count"] == sb["inner"]["count"] == 4


def test_layer_norm_helpers_take_bf16_affine():
    """bf16 γ, β give the result of their f32 values exactly: the
    statistics and the affine run in f32 whatever the parameters' storage,
    on the plain and the fused (K4, its plain version on the CPU)
    routes."""
    from xfm_tpu_torch.core.precision import (add_layer_norm, dense,
                                              layer_norm, post_layer_norm)

    torch.manual_seed(0)
    ln32 = torch.nn.LayerNorm(256)
    with torch.no_grad():
        ln32.weight.add_(torch.randn(256))
        ln32.bias.add_(torch.randn(256))
        ln32.weight.copy_(ln32.weight.bfloat16().float())
        ln32.bias.copy_(ln32.bias.bfloat16().float())
    ln16 = torch.nn.LayerNorm(256)
    ln16.load_state_dict(ln32.state_dict())
    ln16.to(torch.bfloat16)
    x, y = torch.randn(2, 5, 256), torch.randn(2, 5, 256)
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(layer_norm(x, ln16, dt), layer_norm(x, ln32, dt))
        for fused in (False, True):
            a = add_layer_norm(x, y, ln16, dt, fused)
            b = add_layer_norm(x, y, ln32, dt, fused)
            assert all(torch.equal(u, v) for u, v in zip(a, b))
            assert torch.equal(post_layer_norm(x, y, ln16, dt, fused),
                               post_layer_norm(x, y, ln32, dt, fused))
        lin = torch.nn.Linear(256, 4)
        lin16 = torch.nn.Linear(256, 4)
        lin16.load_state_dict(lin.state_dict())
        with torch.no_grad():
            lin.weight.copy_(lin.weight.bfloat16().float())
            lin.bias.copy_(lin.bias.bfloat16().float())
        lin16.to(torch.bfloat16)
        assert torch.equal(dense(x, lin16, dt), dense(x, lin, dt))


def test_beit_bf16_table_reaches_k1_as_f32(monkeypatch):
    """BEiT under bf16 parameters: the packed kernel's entry gets an f32
    bias; the table's gradient is the f32 table's gradient rounded once
    (the gather's backward sums in f32)."""
    from xfm_tpu_torch.models import beit2
    from xfm_tpu_torch.models.beit2 import (BeitVisionTransformer,
                                            VisionConfig)

    seen = []
    real = beit2.flash_attention_packed

    def spy(qkv, bias, scale, heads):
        seen.append(bias.dtype)
        return real(qkv, bias, scale, heads)

    monkeypatch.setattr(beit2, "flash_attention_packed", spy)
    cfg = VisionConfig(image_res=32, patch_size=16, embed_dim=64, depth=1,
                       num_heads=1, drop_path_rate=0.0)
    m32 = BeitVisionTransformer(cfg)
    with torch.no_grad():
        for p in m32.parameters():
            p.copy_((torch.randn_like(p) * 0.1).bfloat16().float())
    m16 = BeitVisionTransformer(cfg)
    m16.load_state_dict(m32.state_dict())
    m16.to(torch.bfloat16)
    x = torch.randn(2, 32, 32, 3)
    g = torch.randn(2, 5, 64)
    for m in (m32, m16):
        (m(x) * g).sum().backward()
    assert seen == [torch.float32, torch.float32]
    t32 = m32.blocks[0].attn.relative_position_bias_table
    t16 = m16.blocks[0].attn.relative_position_bias_table
    assert t16.grad.dtype == torch.bfloat16
    assert torch.equal(t16.grad, t32.grad.bfloat16())


@pytest.mark.parametrize("inner", ["adamw", "lars"])
def test_state_dict_holds_the_masters(inner):
    model = _model()
    named = trained_parameters(model)
    make = ((lambda n: HFAdamW(n, 1e-3)) if inner == "adamw"
            else (lambda n: LARS(n, 1e-3)))
    opt = with_master_weights(named, make)
    sd = opt.state_dict()
    assert set(sd["master"]) == {n for n, _ in named}
    assert set(sd["inner"]) >= {"mu", "count"}
    with pytest.raises(KeyError):
        opt.load_state_dict({"master": {"x": torch.zeros(1)},
                             "inner": sd["inner"]})
