"""The port's CUDA kernels (K1–K5) against their plain versions, on a
card.

Run on a machine with an H100 (JAX is not needed):
    python -m pytest tests/test_torch_cuda.py -q
Elsewhere every test here skips: a CUDA kernel has no CPU mode.
"""
import numpy as np
import pytest
import torch


def _inputs(B, N, H, D, seed):
    r = np.random.RandomState(seed)
    qkv = r.randn(B, N, 3 * H * D).astype(np.float32)
    bias = (0.5 * r.randn(1, H, N, N)).astype(np.float32)
    g = r.randn(B, N, H * D).astype(np.float32)
    return qkv, bias, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H", [(3, 50, 4), (2, 197, 12), (4, 197, 12),
                                   (96, 197, 12)])   # the pretrain pair pass
def test_packed_attention_kernel_matches_plain(dtype, B, N, H):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, bias, g = _inputs(B, N, H, 64, seed=9)
    tq = torch.from_numpy(qkv).cuda().to(dtype)
    tb = torch.from_numpy(bias).cuda()
    tg = torch.from_numpy(g).cuda().to(dtype)
    out, stats = fa.packed_attention_fwd(tq, tb, 0.125, H)
    dqkv, db = fa.packed_attention_bwd(tq, tb, out, stats, tg, 0.125, H)
    rq, rb = tq.clone().requires_grad_(True), tb.clone().requires_grad_(True)
    ref = fa.packed_attention_reference(rq, rb, 0.125, H)
    ref.backward(tg)
    # bf16: 4 ulps at the largest value (P and ds are rounded to bf16 on
    # both sides, sums run in other orders); f32: the order of sums
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    for got, want in ((out, ref), (dqkv, rq.grad), (db, rb.grad)):
        want = want.float()
        assert (got.float() - want).abs().max() <= tol * want.abs().max()


@pytest.mark.cuda
def test_packed_attention_bf16_backward_is_deterministic():
    """K1's bf16 backward owns every output (db summed over b in order in
    one block per tile): two runs at the pretrain shape give the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, bias, g = _inputs(96, 197, 12, 64, seed=10)
    tq = torch.from_numpy(qkv).cuda().to(torch.bfloat16)
    tb = torch.from_numpy(bias).cuda()
    tg = torch.from_numpy(g).cuda().to(torch.bfloat16)
    runs = []
    for _ in range(2):
        out, stats = fa.packed_attention_fwd(tq, tb, 0.125, 12)
        runs.append((out,) + fa.packed_attention_bwd(tq, tb, out, stats, tg,
                                                     0.125, 12))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_packed_autograd_matches_plain(dtype):
    """Through `flash_attention_packed` and autograd (the forward's output
    and statistics saved for the backward), against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, bias, g = _inputs(4, 197, 12, 64, seed=11)
    tg = torch.from_numpy(g).cuda().to(dtype)
    runs = []
    for fn in (fa.flash_attention_packed, fa.packed_attention_reference):
        x = torch.from_numpy(qkv).cuda().to(dtype).requires_grad_(True)
        t = torch.from_numpy(bias).cuda().requires_grad_(True)
        out = fn(x, t, 0.125, 12)
        out.backward(tg)
        runs.append((out.detach(), x.grad, t.grad))
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    for got, want in zip(*runs):
        assert got.dtype == want.dtype and got.shape == want.shape
        want = want.float()
        assert (got.float() - want).abs().max() <= tol * want.abs().max()


def _relpos_inputs(B, window, H, dtype, seed):
    from xfm_tpu_torch.ops.relpos import compact_rel_pos

    wh, ww = window
    N = wh * ww + 1
    r = np.random.RandomState(seed)
    qkv = torch.from_numpy(r.randn(B, N, 3 * H * 64).astype(np.float32))
    table = torch.from_numpy(
        (0.5 * r.randn((2 * wh - 1) * (2 * ww - 1) + 3, H)).astype(np.float32))
    g = torch.from_numpy(r.randn(B, N, H * 64).astype(np.float32))
    cr, cls3 = compact_rel_pos(table, wh, ww)
    cr = cr.to(dtype).reshape(H, ww, (2 * wh - 1) * ww)
    return (qkv.cuda().to(dtype), cr.cuda(), cls3.to(dtype).float().cuda(),
            g.cuda().to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,window,H", [
    (3, (3, 5), 4), (2, (7, 11), 2), (2, (24, 24), 12), (1, (30, 30), 4),
    (2, (30, 30), 12),   # 480 px: N = 901, the model's heads
    (4, (3, 5), 12),     # N = 16, shorter than one tile
    (2, (20, 30), 2),    # N = 601: ww > wh, tails on both sides
])
def test_relpos_attention_kernel_matches_plain(dtype, B, window, H):
    """K2 forward and backward against the plain version, on windows square
    and not, at 384 and 480 px among them: out, dq, dk and dv (read out of
    dqkv, where the bf16 kernels write them in place) and the table
    gradients dcr and dcls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, cr, cls3, g = _relpos_inputs(B, window, H, dtype, seed=7)
    out, stats = fa.relpos_attention_fwd(qkv, cr, cls3, window, 0.125, H)
    dqkv, dcr, dcls = fa.relpos_attention_bwd(qkv, cr, cls3, out, stats, g,
                                              window, 0.125, H)
    rq, rc, rl = (x.clone().requires_grad_(True) for x in (qkv, cr, cls3))
    ref = fa.relpos_attention_reference(rq, rc, rl, window, 0.125, H)
    ref.backward(g)
    # as for K1: 4 bf16 ulps at the largest value, or the order of f32 sums
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    pairs = [(out, ref), (dqkv, rq.grad)]
    pairs += list(zip(dqkv.split(H * 64, dim=-1), rq.grad.split(H * 64,
                                                                dim=-1)))
    for got, want in pairs + [(dcr, rc.grad), (dcls, rl.grad)]:
        want = want.float()
        assert got.shape == want.shape and torch.isfinite(got).all()
        assert (got.float() - want).abs().max() <= tol * want.abs().max()


@pytest.mark.cuda
def test_relpos_backward_is_deterministic():
    """The table gradients are summed over the batch without atomics: two
    runs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, cr, cls3, g = _relpos_inputs(4, (24, 24), 12, torch.bfloat16, 8)
    out, stats = fa.relpos_attention_fwd(qkv, cr, cls3, (24, 24), 0.125, 12)
    first = fa.relpos_attention_bwd(qkv, cr, cls3, out, stats, g, (24, 24),
                                    0.125, 12)
    again = fa.relpos_attention_bwd(qkv, cr, cls3, out, stats, g, (24, 24),
                                    0.125, 12)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_relpos_bf16_backward_is_deterministic_at_the_main_shape():
    """The retrieval step's shape (B = 32, N = 577, H = 12): dqkv, dcr and
    dcls are written once each, without atomics, in the same bits every
    run; so is the forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, cr, cls3, g = _relpos_inputs(32, (24, 24), 12, torch.bfloat16, 10)
    out, stats = fa.relpos_attention_fwd(qkv, cr, cls3, (24, 24), 0.125, 12)
    again, _ = fa.relpos_attention_fwd(qkv, cr, cls3, (24, 24), 0.125, 12)
    assert torch.equal(out, again)
    first = fa.relpos_attention_bwd(qkv, cr, cls3, out, stats, g, (24, 24),
                                    0.125, 12)
    second = fa.relpos_attention_bwd(qkv, cr, cls3, out, stats, g, (24, 24),
                                     0.125, 12)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_beit_attention_relpos_autograd_matches_plain(monkeypatch):
    """Through `beit_attention_relpos` and autograd, as the retrieval step
    calls it (bf16 qkv, the table f32 and its compact form rounded to
    bf16): out, dqkv and the table gradient, carried back through
    `compact_rel_pos`, against the plain version; one kernel backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa
    from xfm_tpu_torch.ops.relpos import compact_rel_pos

    wh, ww, H, B = 24, 24, 4, 2
    r = np.random.RandomState(12)
    qkv = torch.from_numpy(r.randn(B, wh * ww + 1, 3 * H * 64).astype(
        np.float32)).cuda().to(torch.bfloat16)
    table = torch.from_numpy((0.5 * r.randn(
        (2 * wh - 1) * (2 * ww - 1) + 3, H)).astype(np.float32)).cuda()
    g = torch.from_numpy(r.randn(B, wh * ww + 1, H * 64).astype(
        np.float32)).cuda().to(torch.bfloat16)
    calls = []
    real_bwd = fa.relpos_attention_bwd

    def spy(*args):
        calls.append(args[0].shape)
        return real_bwd(*args)

    monkeypatch.setattr(fa, "relpos_attention_bwd", spy)

    def plain(x, t):
        cr, cls3 = compact_rel_pos(t, wh, ww)
        cr = cr.to(torch.bfloat16).reshape(H, ww, (2 * wh - 1) * ww)
        cls3 = cls3.to(torch.bfloat16).float()
        return fa.relpos_attention_reference(x, cr, cls3, (wh, ww), 0.125, H)

    runs = []
    for fn in (lambda x, t: fa.beit_attention_relpos(
            x, t, (wh, ww), 0.125, H, torch.bfloat16), plain):
        x, t = qkv.clone().requires_grad_(True), table.clone().requires_grad_(
            True)
        out = fn(x, t)
        out.backward(g)
        runs.append((out, x.grad, t.grad))
    assert calls == [qkv.shape]
    for got, want in zip(*runs):
        assert got.dtype == want.dtype and got.shape == want.shape
        want = want.float()
        assert (got.float() - want).abs().max() <= 2.0 ** -6 * want.abs().max()


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::xfm_attn_fwd_mma_kernel<(anonymous "
     "namespace)::RelposBias<__nv_bfloat16> >(__nv_bfloat16 const*, ...)",
     "k2_relpos_attention"),
    ("void (anonymous namespace)::xfm_attn_bwd_dkdv_mma_kernel<(anonymous "
     "namespace)::RelposBias<__nv_bfloat16> >(...)", "k2_relpos_attention"),
    ("(anonymous namespace)::relpos_bwd_db_mma_kernel(...)",
     "k2_relpos_attention"),
    ("(anonymous namespace)::relpos_fold_dcr_kernel(float const*, ...)",
     "k2_relpos_attention"),
    ("void (anonymous namespace)::xfm_attn_fwd_mma_kernel<(anonymous "
     "namespace)::DenseBias>(__nv_bfloat16 const*, ...)",
     "k3_flash_attention"),
    ("void (anonymous namespace)::xfm_attn_bwd_dq_mma_kernel<(anonymous "
     "namespace)::DenseBias>(...)", "k3_flash_attention"),
    ("void (anonymous namespace)::xfm_attn_bwd_db_kernel<float>(...)",
     "k3_flash_attention"),
    ("void (anonymous namespace)::packed_bwd_dkdv_kernel<__nv_bfloat16>()",
     "k1_packed_attention"),
    ("void (anonymous namespace)::xfm_attn_fwd_mma_kernel<(anonymous "
     "namespace)::PackedBias>(__nv_bfloat16 const*, ...)",
     "k1_packed_attention"),
    ("void (anonymous namespace)::xfm_attn_bwd_dkdv_mma_kernel<(anonymous "
     "namespace)::PackedBias>(...)", "k1_packed_attention"),
    ("void (anonymous namespace)::xfm_attn_bwd_db_mma_kernel<(anonymous "
     "namespace)::PackedBias>(...)", "k1_packed_attention"),
    ("void (anonymous namespace)::xfm_attn_bwd_db_mma_kernel<(anonymous "
     "namespace)::RelposBias<__nv_bfloat16> >(...)", "k2_relpos_attention"),
    ("void (anonymous namespace)::xfm_act_matmul_wgmma<0>(CUtensorMap, "
     "CUtensorMap, (anonymous namespace)::WArgs)", "k5_fused_mlp"),
    ("void (anonymous namespace)::xfm_act_matmul_wgmma<2>(...)",
     "k5_fused_mlp"),
    ("(anonymous namespace)::xfm_act_matmul_dw_sum(float const*, "
     "__nv_bfloat16*, int, int, int)", "k5_fused_mlp"),
    ("void (anonymous namespace)::xfm_act_matmul<float, 1>(...)",
     "k5_fused_mlp"),
    ("void (anonymous namespace)::xfm_ln_bwd_ring<__nv_bfloat16, 1, true>("
     "(anonymous namespace)::BwdArgs<__nv_bfloat16>)", "k4_fused_ln"),
    ("void (anonymous namespace)::xfm_ln_fwd<float, 8, false>(...)",
     "k4_fused_ln"),
])
def test_profile_groups_file_k2_and_k3_kernels_apart(name, group):
    """`profile_step` files K1's and K2's instantiations of the shared
    attention kernels under K1 and K2, not under K3's `xfm_attn_`, and every
    K4 and K5 kernel under its own (runs on the CPU)."""
    from xfm_tpu_torch.profile_step import _group

    assert _group(name) == group


def _flash_inputs(B, Nq, Nk, H, dtype, bias_kind, seed):
    """q, k, v, dout [B, N, H, 64] and a bias: None, "relpos" f32
    [1, H, Nq, Nk], "row" f32 [B, H, 1, Nk] or "mask" f32 [B, 1, 1, Nk]
    with masked tail keys."""
    r = np.random.RandomState(seed)
    q = torch.from_numpy(r.randn(B, Nq, H, 64).astype(np.float32))
    k, v = (torch.from_numpy(r.randn(B, Nk, H, 64).astype(np.float32))
            for _ in range(2))
    g = torch.from_numpy(r.randn(B, Nq, H, 64).astype(np.float32))
    bias = None
    if bias_kind in ("relpos", "row"):
        shape = (1, H, Nq, Nk) if bias_kind == "relpos" else (B, H, 1, Nk)
        bias = torch.from_numpy((0.5 * r.randn(*shape)).astype(
            np.float32)).cuda()
    elif bias_kind == "mask":
        from xfm_tpu_torch.ops.attention import mask_to_bias

        atts = np.ones((B, Nk), np.int64)
        for b in range(B):
            atts[b, Nk - 1 - 7 * b:] = 0
        bias = mask_to_bias(torch.from_numpy(atts)).cuda()
    return (*(x.cuda().to(dtype) for x in (q, k, v, g)), bias)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Nq,Nk,H,bias_kind", [
    (32, 577, 577, 12, None),        # the CLIP-ViT-B/16 shape at 384 px
    (2, 520, 700, 4, "relpos"),      # Nq != Nk, odd tails, a bias with rows
    (3, 577, 577, 2, "mask"),        # a padding mask, masked tails
    (2, 600, 600, 3, "row"),         # a per-(b, h) bias row
    (1, 37, 45, 2, "relpos"),        # shorter than one tile
])
def test_flash_attention_kernel_matches_plain(dtype, B, Nq, Nk, H,
                                              bias_kind):
    """K3 forward and backward (out, dq, dk, dv, db) against the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    q, k, v, g, bias = _flash_inputs(B, Nq, Nk, H, dtype, bias_kind, seed=5)
    out, stats = fa.flash_attention_fwd(q, k, v, bias, 0.125)
    dq, dk, dv, db = fa.flash_attention_bwd(q, k, v, bias, out, stats, g,
                                            0.125)
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    rb = bias.clone().requires_grad_(True) if bias is not None else None
    ref = fa.flash_attention_reference(*refs, rb, 0.125)
    ref.backward(g)
    pairs = [(out, ref), (dq, refs[0].grad), (dk, refs[1].grad),
             (dv, refs[2].grad)]
    if bias is not None:
        pairs.append((db, rb.grad))
    # as for K1: 4 bf16 ulps at the largest value, or the order of f32 sums
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    for got, want in pairs:
        want = want.float()
        assert got.shape == want.shape
        assert (got.float() - want).abs().max() <= tol * want.abs().max()


def _k3_case(B, Nq, Nk, H, bias_shape, bias_dtype, seed):
    """q, k, v, dout [B, N, H, 64] bf16 and a bias: None; a broadcast shape
    (entries 1, or "B", "H", "Nq" for the full size) of random values; or
    "dead_row", a [B, 1, 1, Nk] mask whose batch row 1 masks every key."""
    r = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(r.randn(B, n, H, 64).astype(np.float32))
                  .cuda().to(torch.bfloat16) for n in (Nq, Nk, Nk, Nq))
    bias = None
    if bias_shape == "dead_row":
        from xfm_tpu_torch.ops.attention import mask_to_bias

        atts = np.ones((B, Nk), np.int64)
        atts[1] = 0
        atts[0, -5:] = 0
        bias = mask_to_bias(torch.from_numpy(atts)).cuda()
    elif bias_shape is not None:
        full = {"B": B, "H": H, "Nq": Nq}
        shape = [full.get(x, x) for x in bias_shape] + [Nk]
        bias = torch.from_numpy((0.5 * r.randn(*shape)).astype(np.float32))
        bias = bias.cuda().to(bias_dtype)
    return q, k, v, g, bias


@pytest.mark.cuda
@pytest.mark.parametrize("Nq,Nk,bias_shape,bias_dtype", [
    (512, 512, None, None), (577, 577, None, None), (640, 640, None, None),
    (901, 901, None, None), (520, 700, None, None),
    (512, 512, (1, "H", "Nq"), torch.float32),
    (577, 577, (1, "H", "Nq"), torch.float32),
    (640, 640, (1, "H", "Nq"), torch.float32),
    (901, 901, (1, "H", "Nq"), torch.float32),
    (520, 700, (1, 1, 1), torch.float32),
    (520, 700, (1, 1, "Nq"), torch.float32),
    (520, 700, (1, "H", 1), torch.float32),
    (520, 700, (1, "H", "Nq"), torch.float32),
    (520, 700, ("B", 1, 1), torch.float32),
    (520, 700, ("B", 1, "Nq"), torch.float32),
    (520, 700, ("B", "H", 1), torch.float32),
    (520, 700, ("B", "H", "Nq"), torch.float32),
    (520, 700, (1, "H", "Nq"), torch.bfloat16),
    (577, 577, "dead_row", None),
    (700, 520, "dead_row", None),
])
def test_flash_attention_bf16_mma_kernels_match_plain(Nq, Nk, bias_shape,
                                                      bias_dtype):
    """The bf16 forward, dq and dk/dv kernels (mma.sync, cp.async) against
    the plain version: tiles ragged on the q side, the key side or both;
    every broadcast shape of the bias (its gradient from the db kernel),
    f32 and bf16; a padding mask with a fully masked row (averaged over
    exactly its Nk keys), which needs no gradient. 4 bf16 ulps at the
    largest value, as phase 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    q, k, v, g, bias = _k3_case(2, Nq, Nk, 2, bias_shape, bias_dtype,
                                seed=Nq + Nk)
    bias_grad = bias is not None and bias_shape != "dead_row"
    out, stats = fa.flash_attention_fwd(q, k, v, bias, 0.125)
    dq, dk, dv, db = fa.flash_attention_bwd(q, k, v, bias, out, stats, g,
                                            0.125, bias_grad)
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    rb = bias.clone().requires_grad_(bias_grad) if bias is not None else None
    ref = fa.flash_attention_reference(*refs, rb, 0.125)
    ref.backward(g)
    pairs = [(out, ref), (dq, refs[0].grad), (dk, refs[1].grad),
             (dv, refs[2].grad)]
    if bias_grad:
        pairs.append((db.to(bias.dtype), rb.grad))
    else:
        assert db is None
    for got, want in pairs:
        want = want.float()
        assert got.shape == want.shape and torch.isfinite(got).all()
        assert (got.float() - want).abs().max() <= 2.0 ** -6 * want.abs().max()
    if bias_shape == "dead_row":  # uniform over exactly its Nk keys
        mean = v[1].float().mean(0)
        tol = 2.0 ** -6 * ref.float().abs().max()
        assert (out[1].float() - mean).abs().max() <= tol


@pytest.mark.cuda
def test_flash_attention_bf16_backward_is_deterministic_at_the_main_shape():
    """The CLIP shape with no bias, as the retrieval step runs it: dq, dk
    and dv are written once each, without atomics, in the same bits every
    run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    q, k, v, g, _ = _k3_case(32, 577, 577, 12, None, None, seed=9)
    out, stats = fa.flash_attention_fwd(q, k, v, None, 0.125)
    again, _ = fa.flash_attention_fwd(q, k, v, None, 0.125)
    assert torch.equal(out, again)
    first = fa.flash_attention_bwd(q, k, v, None, out, stats, g, 0.125)
    second = fa.flash_attention_bwd(q, k, v, None, out, stats, g, 0.125)
    assert first[3] is None and second[3] is None
    assert all(torch.equal(a, b) for a, b in zip(first[:3], second[:3]))


@pytest.mark.cuda
def test_flash_attention_backward_is_deterministic():
    """dq, dk, dv and the bias gradient summed over the batch are written
    once each, without atomics: two runs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    q, k, v, g, bias = _flash_inputs(4, 577, 577, 12, torch.bfloat16,
                                     "relpos", seed=6)
    out, stats = fa.flash_attention_fwd(q, k, v, bias, 0.125)
    first = fa.flash_attention_bwd(q, k, v, bias, out, stats, g, 0.125)
    again = fa.flash_attention_bwd(q, k, v, bias, out, stats, g, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("U,gs,bias_kind", [
    (8, 256, "ones"),        # the eval's i2t chunk: q [8, 10240, 12, 64]
    (3, 256, "ones"),        # the corpus' last, smaller chunk
    (8, 16, "tails"),        # gs·T = 640; image masks with masked tails
    (3, 16, "row_view"),     # the per-row mask's bias[::gs], strided
])
def test_flash_attention_forward_at_the_grouped_rerank_shapes(dtype, U, gs,
                                                              bias_kind):
    """K3's forward as the grouped image → text rerank calls it: q the
    cross-attention's [U·gs, 40, 12, 64] projection viewed, without a copy,
    as [U, gs·40, 12, 64]; k/v [U, 577, 12, 64]; the bias [U, 1, 1, 577]
    from image masks, or the per-row [U·gs, 1, 1, 577] one read through
    `bias[::gs]` — against the plain version on the same view."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa
    from xfm_tpu_torch.ops.attention import mask_to_bias

    r = np.random.RandomState(11)
    T, Nk, H = 40, 577, 12
    proj = torch.from_numpy(r.randn(U * gs, T, H * 64).astype(np.float32))
    proj = proj.cuda().to(dtype)
    q = proj.view(U * gs, T, H, 64).view(U, gs * T, H, 64)
    assert q.data_ptr() == proj.data_ptr()
    k, v = (torch.from_numpy(r.randn(U, Nk, H, 64).astype(np.float32))
            .cuda().to(dtype) for _ in range(2))
    atts = np.ones((U, Nk), np.int64)
    if bias_kind != "ones":
        for u in range(U):
            atts[u, Nk - 5 - 40 * u:] = 0
    if bias_kind == "row_view":
        bias = mask_to_bias(torch.from_numpy(np.repeat(atts, gs, 0))).cuda()
        bias = bias[::gs]
        assert bias.stride(0) == gs * Nk
    else:
        bias = mask_to_bias(torch.from_numpy(atts)).cuda()
    out, _ = fa.flash_attention_fwd(q, k, v, bias, 0.125)
    ref = fa.flash_attention_reference(q, k, v, bias, 0.125)
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max() <= \
        tol * ref.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relpos_attention_forward_at_the_eval_batch(dtype):
    """K2's forward at the eval's stage-1 batch (qkv [64, 577, 2304],
    `batch_size_test` = 64) against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, cr, cls3, _ = _relpos_inputs(64, (24, 24), 12, dtype, seed=12)
    out, _ = fa.relpos_attention_fwd(qkv, cr, cls3, (24, 24), 0.125, 12)
    ref = fa.relpos_attention_reference(qkv, cr, cls3, (24, 24), 0.125, 12)
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max() <= \
        tol * ref.float().abs().max()


@pytest.mark.cuda
def test_flash_attention_reads_strided_views_in_place():
    """q, k, v as the [B, N, H, D] slices of one [B, N, 3, H, D] projection
    (row stride 3·H·D): the kernel reads them through their strides and
    gives what it gives on contiguous copies, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    r = np.random.RandomState(7)
    qkv = torch.from_numpy(r.randn(2, 577, 3, 4, 64).astype(np.float32)).cuda()
    qkv = qkv.to(torch.bfloat16)
    g = torch.from_numpy(r.randn(2, 577, 4, 64).astype(np.float32)).cuda()
    g = g.to(torch.bfloat16)
    views = [qkv[:, :, i] for i in range(3)]
    assert not views[0].is_contiguous()
    copies = [x.contiguous() for x in views]
    got, stats = fa.flash_attention_fwd(*views, None, 0.125)
    want, _ = fa.flash_attention_fwd(*copies, None, 0.125)
    assert torch.equal(got, want)
    for a, b in zip(fa.flash_attention_bwd(*views, None, got, stats, g, 0.125),
                    fa.flash_attention_bwd(*copies, None, want, stats, g,
                                           0.125)):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bias_kind,bias_dtype", [
    ("mask", torch.float32), ("relpos", torch.bfloat16)])
def test_flash_attention_autograd_matches_plain(bias_kind, bias_dtype,
                                                monkeypatch):
    """Through `flash_attention` and autograd: a mask that needs no gradient
    launches no db kernel (db stays None); a bf16 bias that does gets its
    gradient in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    q, k, v, g, bias = _flash_inputs(2, 577, 577, 4, torch.bfloat16,
                                     bias_kind, seed=8)
    bias = bias.to(bias_dtype)
    wants_db = bias_kind == "relpos"
    seen = []
    real_bwd = fa.flash_attention_bwd

    def spy(*args):
        out = real_bwd(*args)
        seen.append(out[3] is not None)
        return out

    monkeypatch.setattr(fa, "flash_attention_bwd", spy)
    runs = []
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
        b = bias.clone().requires_grad_(wants_db)
        out = fn(*ts, b, 0.125)
        out.backward(g)
        runs.append([out] + [t.grad for t in ts]
                    + ([b.grad] if wants_db else []))
    assert seen == [wants_db]
    for got, want in zip(*runs):
        assert got.dtype == want.dtype
        want = want.float()
        assert (got.float() - want).abs().max() <= 2.0 ** -6 * want.abs().max()


def _ln_inputs(R, C, dtype, seed):
    r = np.random.RandomState(seed)
    x, y, dh, dxn = (torch.from_numpy(r.randn(R, C).astype(np.float32))
                     .cuda().to(dtype) for _ in range(4))
    gamma = torch.from_numpy((0.3 * r.randn(C) + 1).astype(np.float32)).cuda()
    beta = torch.from_numpy((0.1 * r.randn(C)).astype(np.float32)).cuda()
    return x, y, gamma, beta, dh, dxn


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["plain", "post", "add"])
@pytest.mark.parametrize("R,C", [(1100, 768),   # ragged last block
                                 (300, 128),    # one vector a lane
                                 (77, 2048),    # two warps a row
                                 (40, 8192)])   # eight warps a row
def test_fused_ln_kernel_matches_plain(dtype, variant, R, C):
    """K4 forward (h, xn) and backward (dx, dγ, dβ) against the plain
    version, both backwards from the plain forward's sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import fused_ln as fl

    x, y, gamma, beta, dh, dxn = _ln_inputs(R, C, dtype, seed=11)
    y = None if variant == "plain" else y
    dxn = dxn if variant == "add" else None
    xn, h = fl.fused_ln_fwd(x, y, gamma, beta, 1e-6)
    rxn, rh = fl.fused_ln_reference(x, y, gamma, beta, 1e-6)
    pairs = [(h, rh), (xn, rxn)]
    pairs += list(zip(fl.fused_ln_bwd(rxn, dh, dxn, gamma, 1e-6),
                      fl.fused_ln_bwd_reference(rxn, dh, dxn, gamma, 1e-6)))
    # bf16: 4 ulps at the largest value (the same rounding points, sums in
    # other orders); f32: the order of sums
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    for got, want in pairs:
        want = want.float()
        assert got.shape == want.shape
        assert (got.float() - want).abs().max() <= tol * want.abs().max()


@pytest.mark.cuda
def test_fused_ln_backward_is_deterministic():
    """dγ and dβ are summed over the rows without atomics on the data
    (per-block partials, then a fold in block order inside the same
    launch): two runs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import fused_ln as fl

    x, y, gamma, beta, dh, dxn = _ln_inputs(18912, 768, torch.bfloat16, 12)
    first = fl.fused_ln_bwd(x, dh, dxn, gamma, 1e-6)
    again = fl.fused_ln_bwd(x, dh, dxn, gamma, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["post", "add"])
@pytest.mark.parametrize("R,C", [(1, 768),      # one row
                                 (50, 768),     # fewer row groups than SMs
                                 (1003, 768),   # a ragged last row group
                                 (999, 1152),   # two warps a row, lanes
                                                # holding unequal vectors
                                 (300, 8192)])  # the largest stage in f32
def test_fused_ln_backward_edges(dtype, variant, R, C):
    """K4's backward (dx, dγ, dβ) against the plain version at the edges
    of its plan: the row groups, the grid and the ring."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import fused_ln as fl

    x, _, gamma, _, dh, dxn = _ln_inputs(R, C, dtype, seed=R)
    dxn = dxn if variant == "add" else None
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    for got, want in zip(fl.fused_ln_bwd(x, dh, dxn, gamma, 1e-6),
                         fl.fused_ln_bwd_reference(x, dh, dxn, gamma, 1e-6)):
        want = want.float()
        assert got.shape == want.shape
        assert (got.float() - want).abs().max() <= tol * want.abs().max()


@pytest.mark.cuda
def test_fused_ln_backward_tickets_reset():
    """Calls at other R between two calls at R = 18,912 leave the bits of
    dx, dγ and dβ unchanged, and the fold's tickets at 0; the grid is the
    card's SM count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import fused_ln as fl

    x, _, gamma, _, dh, dxn = _ln_inputs(18912, 768, torch.bfloat16, 14)
    first = fl.fused_ln_bwd(x, dh, dxn, gamma, 1e-6)
    for r in (1, 1440, 5761, 18911):
        fl.fused_ln_bwd(x[:r], dh[:r], None, gamma, 1e-6)
    again = fl.fused_ln_bwd(x, dh, dxn, gamma, 1e-6)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert int(fl.fold_tickets(x.device, 0).abs().sum()) == 0
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    assert fl.bwd_plan(18912, 768, torch.bfloat16,
                       fl.sm_count(x.device)).blocks == sms


@pytest.mark.cuda
def test_fused_add_ln_autograd_matches_plain():
    """Through `fused_add_ln` and autograd on the card: the same values and
    gradients as the plain version's explicit backward on the CPU's path,
    and the residual's gradient equal to dx."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import fused_ln as fl

    x, y, gamma, beta, dh, dxn = _ln_inputs(500, 768, torch.bfloat16, 13)
    runs = []
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).clone().requires_grad_(True)
                  for t in (x, y, gamma, beta)]
        outs = fl.fused_add_ln(*leaves, 1e-6)
        torch.autograd.backward(outs, [dxn.to(dev), dh.to(dev)])
        runs.append([o.detach().cpu() for o in outs]
                    + [t.grad.cpu() for t in leaves])
    for got, want in zip(*runs):
        want = want.float()
        assert (got.float() - want).abs().max() <= 2.0 ** -6 * want.abs().max()
    assert torch.equal(runs[0][2], runs[0][3])


def _mlp_inputs(M, K, N, dtype, seed):
    r = np.random.RandomState(seed)
    h = torch.from_numpy((2 * r.randn(M, K)).astype(np.float32))
    w = torch.from_numpy((0.02 * r.randn(N, K)).astype(np.float32))
    b = torch.from_numpy((0.1 * r.randn(N)).astype(np.float32))
    g = torch.from_numpy(r.randn(M, N).astype(np.float32))
    return tuple(t.cuda().to(dtype) for t in (h, w, b, g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu_tanh", "gelu", "relu"])
@pytest.mark.parametrize("M,K,N", [(300, 3072, 768),   # the model's widths
                                   (1440, 3072, 768),  # the text rows
                                   (130, 3072, 768),   # a ragged row tile
                                   (48, 128, 64),      # one tile, narrow
                                   (130, 136, 72),     # tails everywhere
                                   (130, 200, 72)])
def test_fused_mlp_kernel_matches_plain(dtype, act, M, K, N):
    """K5 forward (y) and backward (dh, dW, db) against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import fused_mlp as fm

    h, w, b, g = _mlp_inputs(M, K, N, dtype, seed=14)
    pairs = [(fm.act_matmul_fwd(h, w, b, act),
              fm.act_matmul_reference(h, w, b, act))]
    pairs += list(zip(fm.act_matmul_bwd(h, w, g, act),
                      fm.act_matmul_bwd_reference(h, w, g, act)))
    # bf16: 4 ulps at the largest value (the same rounding points, sums in
    # other orders); f32: the order of sums (FMA on both sides, no TF32)
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    for got, want in pairs:
        assert got.shape == want.shape and got.dtype == want.dtype
        want = want.float()
        assert (got.float() - want).abs().max() <= tol * want.abs().max()


@pytest.mark.cuda
def test_fused_mlp_backward_is_deterministic():
    """dW sums over all M rows in one block per tile, in order, without
    atomics: two runs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import fused_mlp as fm

    h, w, _, g = _mlp_inputs(5760, 3072, 768, torch.bfloat16, 15)
    first = fm.act_matmul_bwd(h, w, g, "gelu_tanh")
    again = fm.act_matmul_bwd(h, w, g, "gelu_tanh")
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [18912, 1440])
def test_fused_mlp_bf16_split_dw_is_deterministic(M):
    """The bf16 dW cuts its sum over M into `dw_splits` chunks (8 at the
    BEiT rows, 2 at the text rows) and adds the partials in order: two runs
    give the same bits, and dW agrees with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import fused_mlp as fm

    h, w, _, g = _mlp_inputs(M, 3072, 768, torch.bfloat16, 16)
    assert fm.dw_splits(M, 3072, 768) > 1
    first = fm.act_matmul_bwd(h, w, g, "gelu_tanh")
    again = fm.act_matmul_bwd(h, w, g, "gelu_tanh")
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    want = fm.act_matmul_bwd_reference(h, w, g, "gelu_tanh")[1].float()
    assert (first[1].float() - want).abs().max() <= 2.0 ** -6 * want.abs().max()


# --- the retrieval fine-tune: dropout, the step, the prefetcher ----------

@pytest.mark.cuda
def test_dropout_masks_from_a_cuda_generator_repeat():
    """Masks drawn on the card from a CUDA generator: the same seed gives
    the same bits, another seed others; the keep share near 1 − p."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch.ops import dropout as drop

    x = torch.ones(96, 12, 40, 577, dtype=torch.bfloat16, device="cuda")
    outs = []
    for seed in (3, 3, 4):
        with drop.dropout_generator(
                torch.Generator(device="cuda").manual_seed(seed)):
            outs.append((drop.dropout(x, 0.1, False),
                         drop.drop_path(x, 0.1, False)))
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
    assert not torch.equal(outs[0][0], outs[2][0])
    kept = (outs[0][0] != 0).float().mean().item()
    assert abs(kept - 0.9) < 1e-3
    with pytest.raises(ValueError, match="torch.Generator"):
        drop.dropout(x, 0.1, False)


def _ft_slice(device, depth=2, seed=3):
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.models import XFMForRetrieval
    from xfm_tpu_torch.train.checkpoint import init_weights

    cfg = configs.xfm_retrieval_eval_config(
        dtype=torch.float32, layers=depth,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        drop_path_rate=0.0)
    model = XFMForRetrieval(cfg)
    init_weights(model, seed)
    return model.to(device), cfg


@pytest.mark.cuda
def test_finetune_step_dropout_off_matches_cpu():
    """A depth-2, f32, dropout-off fine-tune step (the task's loss with
    deterministic=False, the optimizer from the YAML, idx with a repeated
    image) on the CPU and on the card from the same weights, batch and
    hard negatives: the losses at rtol 1e-4, two steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import functools

    from xfm_tpu_torch import configs
    from xfm_tpu_torch.train.optim import create_optimizer_from_config
    from xfm_tpu_torch.train.schedules import schedule_from_config
    from xfm_tpu_torch.train.train_state import (TrainState,
                                                 make_train_step,
                                                 retrieval_loss_fn)

    nb = configs.make_retrieval_batch(4, 40, 384, 50265, seed=1)
    nb["idx"] = np.array([0, 1, 0, 2])
    neg = (torch.tensor([1, 3, 1, 0]), torch.tensor([3, 2, 3, 1]))
    step = make_train_step(functools.partial(retrieval_loss_fn,
                                             deterministic=False))
    losses = {}
    for dev in ("cpu", "cuda"):
        model, _ = _ft_slice(dev)
        state = TrainState.create(model, create_optimizer_from_config(
            model, configs.RETRIEVAL_COCO,
            schedule_from_config(configs.RETRIEVAL_COCO, 10)))
        batch = configs.batch_to_torch(nb, dev)
        batch["hard_negatives"] = tuple(n.to(dev) for n in neg)
        gen = torch.Generator(device=dev).manual_seed(0)
        losses[dev] = []
        for _ in range(2):
            state, m = step(state, batch, gen)
            losses[dev].append([m[k].item() for k in
                                ("loss", "loss_itc", "loss_itm")])
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.cuda
def test_finetune_step_with_drop_path_runs_k2():
    """Drop-path and dropout live at 384 px, depth 2, bf16: each step
    launches K2 twice forward and twice backward, and nothing else."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.models import XFMForRetrieval
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.train.checkpoint import init_weights
    from xfm_tpu_torch.train.train_state import retrieval_loss_fn

    cfg = configs.xfm_retrieval_eval_config(layers=2)
    assert cfg.vision.drop_path_rate == 0.1
    assert cfg.text.hidden_dropout_prob == 0.1
    model = XFMForRetrieval(cfg).cuda()
    init_weights(model, 0)
    batch = configs.batch_to_torch(configs.make_retrieval_batch(
        4, 40, 384, cfg.text.vocab_size), "cuda")
    batch["idx"] = torch.arange(4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels.reset_launch_counts()
    for _ in range(2):
        loss, _ = retrieval_loss_fn(model, batch, gen, deterministic=False)
        loss.backward()
        assert torch.isfinite(loss)
    want = {k: 0 for k in kernels.LAUNCHES}
    want.update(relpos_attention_fwd=4, relpos_attention_bwd=4)
    assert kernels.LAUNCHES == want


@pytest.mark.cuda
def test_prefetched_batches_arrive_equal():
    """`DeviceBatches` on the card: pinned host batches copied one batch
    ahead arrive equal to the host's, in order, as int64 / float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch.data.prefetch import DeviceBatches

    r = np.random.RandomState(0)
    host = [dict(images=r.randn(8, 64, 64, 3).astype(np.float32),
                 text_ids=r.randint(0, 99, (8, 40)).astype(np.int32),
                 idx=np.arange(8, dtype=np.int32) + i) for i in range(6)]
    batches = DeviceBatches(iter(host), "cuda")
    got = []
    for b in batches:
        assert all(t.is_cuda for t in b.values())
        got.append({k: v.cpu() for k, v in b.items()})
    batches.close()
    assert len(got) == len(host)
    for g, h in zip(got, host):
        assert g["text_ids"].dtype == torch.int64
        assert g["images"].dtype == torch.float32
        for k in h:
            assert np.array_equal(g[k].numpy(), h[k]), k
