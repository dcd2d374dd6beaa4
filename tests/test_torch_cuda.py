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
                                   (96, 197, 12),    # the pretrain pair pass
                                   (192, 197, 12),   # the pair pass at B 96
                                   (80, 197, 12),    # the region stream
                                   (64, 197, 12),    # caption pretrain
                                   (128, 197, 12),   # ImageNet fine-tune
                                   (512, 197, 12),   # the linear probe
                                   (192, 197, 16),   # BEiT-2-large's pair
                                   (80, 197, 16)])   # and region passes
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
    (16, (30, 30), 12),  # the VQA step at 480 px, its batch of 16
    (16, (24, 24), 12),  # the caption step at 384 px, its batch of 16
    (48, (24, 24), 12),  # the NLVR step: 24 pairs, 48 images
    (24, (24, 24), 12),  # the grounding step: 24 phrases
    (8, (24, 24), 12),   # the GradCAM batch of 8
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


# the pretrain task's model at depth 2 with head dim 64 (K1's), small
# batches of every stream
_STREAM_KEYS = dict(
    vision_depth=2, vision_embed_dim=128, vision_num_heads=2,
    text_hidden_size=128, text_num_attention_heads=2,
    text_intermediate_size=256, text_num_hidden_layers=2,
    text_fusion_start_at=2, fusion_num_hidden_layers=2, embed_dim=32,
    text_vocab_size=512, images={"batch_size": 4},
    images_imagenet={"batch_size": 4},
    regions={"batch_size": 6, "max_images": 5, "max_regions": 2},
    texts={"batch_size": 4, "max_tokens": 64, "max_masks": 8})


@pytest.mark.cuda
@pytest.mark.parametrize("stream,rows", [("image", 8), ("region", 5),
                                         ("imagenet", 8), ("text", 0)])
def test_pretrain_stream_launches_k1_per_image_stream(stream, rows,
                                                      monkeypatch):
    """The pretrain task's step on one stream, dropout and drop-path live,
    bf16: K1 depth forward and depth backward launches at the stream's
    vision rows (the 2B-row pair pass, the region stream's max_images),
    none for the text stream, and no other kernel; the losses finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.ops import flash_attention as fa
    from xfm_tpu_torch.ops import kernels

    seen = []
    real = fa.packed_attention_fwd

    def spy(qkv, *a, **k):
        seen.append(qkv.shape[0])
        return real(qkv, *a, **k)

    monkeypatch.setattr(fa, "packed_attention_fwd", spy)
    state, batches, step, gens = configs.make_pretrain_streams_run(
        **_STREAM_KEYS)
    kernels.reset_launch_counts()
    state, metrics = step(state, {stream: batches[stream]}, gens(0))
    torch.cuda.synchronize()
    assert all(torch.isfinite(v).all() for v in metrics.values())
    want = {k: 0 for k in kernels.LAUNCHES}
    if rows:
        want.update(packed_attention_fwd=2, packed_attention_bwd=2)
    assert kernels.LAUNCHES == want
    assert seen == [rows] * (2 if rows else 0)


@pytest.mark.cuda
def test_vqa_step_and_rank_launch_k2_only():
    """The VQA step at full width and depth (12 BEiT blocks at 480 px, bf16,
    dropout and drop-path live, B = 2): K2 12 + 12 launches and nothing
    else; the rank of its questions (the top 16 of 200 answers): K2 12
    forward and nothing else, the probabilities in descending order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.ops import kernels

    state, batch, step, rank = configs.make_vqa_run(B=2, k_test=16,
                                                    n_answers=200)
    gen = torch.Generator(device="cuda").manual_seed(0)
    none = {k: 0 for k in kernels.LAUNCHES}
    kernels.reset_launch_counts()
    state, m = step(state, batch, gen)
    assert dict(kernels.LAUNCHES) == dict(none, relpos_attention_fwd=12,
                                          relpos_attention_bwd=12)
    assert torch.isfinite(m["loss"])
    kernels.reset_launch_counts()
    ids, probs = rank()
    assert dict(kernels.LAUNCHES) == dict(none, relpos_attention_fwd=12)
    assert ids.shape == probs.shape == (2, 16)
    assert (probs[:, :-1] >= probs[:, 1:]).all()


@pytest.mark.cuda
def test_stable_topk_on_the_card_breaks_ties_by_lower_index():
    """`rank_answer`'s top-k on the card: the CPU's values and indices, and
    within a run of equal values the indices rising."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch.models.generation import stable_topk

    r = np.random.RandomState(0)
    x = torch.from_numpy(r.randint(0, 20, (16, 3129)).astype(np.float32))
    vals, idx = stable_topk(x.cuda(), 128)
    cpu_vals, cpu_idx = stable_topk(x, 128)
    assert torch.equal(idx.cpu(), cpu_idx)
    assert torch.equal(vals.cpu(), cpu_vals)
    same = vals[:, 1:] == vals[:, :-1]
    assert same.any() and (idx[:, 1:][same] > idx[:, :-1][same]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("unit,want", [
    ("caption_train", dict(relpos_attention_fwd=12, relpos_attention_bwd=12)),
    ("caption_beam", dict(relpos_attention_fwd=12)),
    ("caption_scst", dict(relpos_attention_fwd=36, relpos_attention_bwd=12)),
    ("caption_pretrain", dict(packed_attention_fwd=12,
                              packed_attention_bwd=12))])
def test_caption_units_launch_their_kernels_only(unit, want):
    """Captioning at full width and depth (12 BEiT blocks, a 12-layer
    decoder, bf16, B = 2): the fine-tune step K2 12 + 12; a beam eval
    batch K2 12 forward (the decode steps launch nothing of K1-K5); an
    SCST step with the greedy baseline K2 36 + 12; the domain pretrain's
    step at 224 px K1 12 + 12; nothing else."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.ops import kernels

    state, call = configs.make_caption_run(unit, B=2)
    kernels.reset_launch_counts()
    out = call(0)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == dict(
        {k: 0 for k in kernels.LAUNCHES}, **want)
    if unit == "caption_beam":
        assert out.shape == (2, 20) and (out[:, :4] == torch.tensor(
            [10, 11, 12, 13], device="cuda")).all()
    else:
        assert torch.isfinite(out["loss"])


@pytest.mark.cuda
def test_caption_decode_on_the_card_matches_cpu():
    """At depth 2 (2 BEiT blocks at 384 px, 2 decoder layers), f32, the
    full vocabulary: greedy (the prompt forced, `min_len` 5) and beam-3
    sequences on the card equal the CPU's token for token, the greedy
    log-probabilities within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.models import (XFMForCaptioning, beam_generate,
                                      generate)
    from xfm_tpu_torch.train.checkpoint import init_weights

    cfg = configs.caption_yaml(layers=2, compute_dtype="float32")
    cpu = XFMForCaptioning.from_yaml(cfg)
    init_weights(cpu, 4)
    gpu = XFMForCaptioning.from_yaml(cfg)
    gpu.load_state_dict(cpu.state_dict())
    gpu.cuda()
    images = torch.from_numpy(np.random.RandomState(5).randn(
        2, 384, 384, 3).astype(np.float32))
    kw = dict(bos_id=0, eos_id=2, pad_id=1, max_len=20, min_len=5,
              prompt_ids=(10, 11, 12, 13))
    cs, cl = generate(cpu, images, **kw)
    gs, gl = generate(gpu, images.cuda(), **kw)
    assert torch.equal(gs.cpu(), cs)
    assert (gl.cpu() - cl).abs().max() <= 1e-4
    assert torch.equal(beam_generate(gpu, images.cuda(), num_beams=3,
                                     **kw).cpu(),
                       beam_generate(cpu, images, num_beams=3, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("unit,want", [
    ("nlvr_train", dict(relpos_attention_fwd=12, relpos_attention_bwd=12)),
    ("grounding_train", dict(relpos_attention_fwd=12,
                             relpos_attention_bwd=12)),
    ("gradcam", dict(relpos_attention_fwd=12))])
def test_nlvr_and_grounding_units_launch_k2_only(unit, want):
    """At full width and depth (12 BEiT blocks at 384 px, bf16): the NLVR
    step (2 pairs: one 4-image tower pass), the grounding step (B = 2),
    dropout and drop-path live, K2 12 + 12; a GradCAM batch (B = 2, fusion
    layer 8) K2 12 forward, its backward through the fusion layers
    launching nothing; nothing else of K1-K5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.ops import kernels

    state, call = (configs.make_nlvr_run(B=2) if unit == "nlvr_train"
                   else configs.make_grounding_run(unit, B=2))
    kernels.reset_launch_counts()
    out = call(0)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == dict(
        {k: 0 for k in kernels.LAUNCHES}, **want)
    if unit == "gradcam":
        assert out.shape == (2, 576) and torch.isfinite(out).all()
        assert all(p.grad is None for p in state.model.parameters())
    else:
        assert torch.isfinite(out["loss"])


@pytest.mark.cuda
def test_gradcam_on_the_card_matches_cpu():
    """At depth 2 (2 BEiT blocks at 384 px, 2 text and fusion layers), f32,
    the full vocabulary: the cam at fusion layer 1 on the card within
    1e-4 of its largest value of the CPU's, and the same box chosen for
    each sample among 5 candidates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.models import (XFMForRetrieval, config_from_yaml,
                                      itm_gradcam, rank_boxes_by_cam)
    from xfm_tpu_torch.train.checkpoint import init_weights

    mcfg = config_from_yaml(configs.grounding_yaml(
        layers=2, compute_dtype="float32"), use_contrastive_loss=True,
        use_matching_loss=True)
    cpu = XFMForRetrieval(mcfg)
    init_weights(cpu, 6)
    gpu = XFMForRetrieval(mcfg)
    gpu.load_state_dict(cpu.state_dict())
    gpu.cuda()
    b = configs.make_grounding_batch(3, 30, 384, mcfg.text.vocab_size, 7)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    args = (tb["images"], tb["text_ids"].long(), tb["text_atts"].long())
    c = itm_gradcam(cpu, *args, block_num=1)
    g = itm_gradcam(gpu, *(x.cuda() for x in args), block_num=1).cpu()
    assert (g - c).abs().max() <= 1e-4 * c.abs().max()
    boxes = np.random.RandomState(8).randint(0, 384, (5, 4))
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 16)
    for i in range(3):
        assert np.argmax(rank_boxes_by_cam(c[i].numpy(), boxes, 384, 16)) \
            == np.argmax(rank_boxes_by_cam(g[i].numpy(), boxes, 384, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [128, 512])
def test_packed_attention_bf16_is_deterministic_at_classification_batches(B):
    """K1's bf16 forward and backward at the ImageNet fine-tune's and the
    linear probe's batches (qkv [128 | 512, 197, 2304]: 6,144 (b, h)
    pairs, element offsets up to 2.3e8; db summed over the batch in
    order): two runs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    qkv, bias, g = _inputs(B, 197, 12, 64, seed=12)
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
@pytest.mark.parametrize("unit,want", [
    ("imagenet_train", dict(packed_attention_fwd=12,
                            packed_attention_bwd=12)),
    ("imagenet_lp", dict(packed_attention_fwd=12)),
    ("glue_train", {})])
def test_classification_units_launch_k1_only(unit, want):
    """At full width and depth (12 BEiT blocks at 224 px, the 12-layer text
    encoder at T = 128, bf16), B = 2: the ImageNet fine-tune step (dropout
    and drop-path live, soft targets) K1 12 + 12; the linear probe's step
    K1 12 forward, its tower bit-equal after the step and its head moved;
    the GLUE step nothing of K1-K5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.ops import kernels

    state, call = (configs.make_glue_run(B=2) if unit == "glue_train"
                   else configs.make_imagenet_run(unit, B=2))
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    kernels.reset_launch_counts()
    out = call(0)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == dict(
        {k: 0 for k in kernels.LAUNCHES}, **want)
    assert torch.isfinite(out["loss"])
    moved = {n for n, p in state.model.named_parameters()
             if not torch.equal(p, before[n])}
    if unit == "imagenet_lp":
        assert moved and all(n.startswith("cls_head.") for n in moved)


def _tower_pair(seed, **kw):
    """A depth-2 BEiT tower at 224 px, f32, on the CPU and its copy on the
    card (the shared table, if any, set to random values)."""
    import copy

    from xfm_tpu_torch.models.beit2 import (BeitVisionTransformer,
                                            VisionConfig)
    from xfm_tpu_torch.train.checkpoint import init_weights

    cpu = BeitVisionTransformer(VisionConfig(image_res=224, depth=2,
                                             drop_path_rate=0.0, **kw))
    init_weights(cpu, seed)
    with torch.no_grad():
        for n, p in cpu.named_parameters():
            if n.endswith("relative_position_bias_table"):
                p.copy_(torch.randn(p.shape))
    return cpu, copy.deepcopy(cpu).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("kw,k1", [
    (dict(use_shared_rel_pos_bias=True), 2),
    (dict(use_rel_pos_bias=False, use_shared_rel_pos_bias=True), 2),
    (dict(local_attn_depth=1), 1)])
def test_shared_table_and_region_attention_match_cpu(kw, k1):
    """The shared table's bias (with and without per-block tables) through
    K1 in both blocks, and region attention in the last block (K1 in the
    first only, the masked rows on the plain attention): outputs and
    gradients card vs CPU in f32 (1e-4 of the largest value; gradients
    1e-3), K1 launched k1 + k1 times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch.ops import kernels

    torch.manual_seed(0)
    cpu, gpu = _tower_pair(1, **kw)
    x = torch.randn(3, 224, 224, 3)
    idx = torch.tensor([0, 0, 1, 2, 2])
    atts = (torch.rand(5, 197) < 0.5).long()
    atts[:, 0] = 1
    outs = {}
    for tag, m, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        kernels.reset_launch_counts()
        if kw.get("local_attn_depth"):
            r, f = m(x.to(dev), idx_to_group_img=idx.to(dev),
                     image_atts=atts.to(dev))
            y = torch.cat([r, f])
        else:
            y = m(x.to(dev))
        y.square().mean().backward()
        outs[tag] = (y.detach().cpu(), {n: p.grad.cpu() for n, p in
                                        m.named_parameters()
                                        if p.grad is not None})
    assert kernels.LAUNCHES["packed_attention_fwd"] == k1
    assert kernels.LAUNCHES["packed_attention_bwd"] == k1
    (yc, gc), (yg, gg) = outs["cpu"], outs["cuda"]
    assert (yc - yg).abs().max() <= 1e-4 * yc.abs().max()
    for n, a in gc.items():
        assert (a - gg[n]).abs().max() <= 1e-3 * a.abs().max() + 1e-7, n


@pytest.mark.cuda
def test_tokenizer_code_ids_on_the_card_match_cpu():
    """The frozen tokenizer at full width (depth 2, f32, 8,192 codes) on
    the card: its projections within 1e-4 of the CPU's, and an id differs
    only where the CPU's two best distances are within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import copy

    from xfm_tpu_torch import configs
    from xfm_tpu_torch.models.vqkd import l2norm
    from xfm_tpu_torch.tasks.pretrain import frozen_tokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, _ = frozen_tokenizer(dict(configs.PRETRAIN_VQKD_KEYS,
                                   tokenizer_depth=2), "cpu")
    gpu = copy.deepcopy(cpu).cuda()
    x = torch.randn(4, 224, 224, 3)
    with torch.no_grad():
        zc, zg = cpu._encode_z(x), gpu._encode_z(x.cuda()).cpu()
        ic, ig = cpu.quantize.indices(zc), gpu.quantize.indices(zg.cuda())
    assert (zc - zg).abs().max() <= 1e-4 * max(1.0, zc.abs().max())
    cb = cpu.quantize.embedding.weight
    flat = l2norm(zc).reshape(-1, 32)
    d = (flat ** 2).sum(-1, keepdim=True) - 2 * flat @ cb.T + (
        cb ** 2).sum(-1)
    two = d.topk(2, dim=-1, largest=False).values
    differ = ic.reshape(-1) != ig.cpu().reshape(-1)
    assert not (differ & (two[:, 1] - two[:, 0] > 1e-5)).any()


@pytest.mark.cuda
def test_bf16_params_fused_route_launches_k4_k5():
    """Under bf16 parameters (f32 compute) the fused route hands K4 its γ
    and β in f32 and K5 its W and b in the compute dtype: both launch, and
    the parameters' gradients come back bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch.configs import (batch_to_torch, make_batch,
                                       xfm_base_pretrain_config)
    from xfm_tpu_torch.models import XFMForPretrain
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.train.checkpoint import init_weights

    cfg = xfm_base_pretrain_config(layers=2, dtype=torch.float32,
                                   fused_ln=True, fused_mlp=True)
    model = XFMForPretrain(cfg).cuda()
    init_weights(model, 0)
    model.to(torch.bfloat16)
    batch = batch_to_torch(make_batch(4, 30, 15, 224, 196, cfg.text.vocab_size,
                                      seed=0), "cuda")
    kernels.reset_launch_counts()
    out = model.loss(**batch, ret_mim=True,
                     hard_negatives=(torch.tensor([1, 2, 3, 0]).cuda(),
                                     torch.tensor([2, 3, 0, 1]).cuda()))
    sum(out.values()).backward()
    for k in ("fused_ln_fwd", "fused_ln_bwd", "fused_mlp_fwd",
              "fused_mlp_bwd"):
        assert kernels.LAUNCHES[k] > 0, k
    w = model.vision_encoder.blocks[0].norm2.weight
    assert w.dtype == w.grad.dtype == torch.bfloat16
    assert torch.isfinite(w.grad.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("unit,k1", [("pretrain_vqkd", 33),
                                     ("pretrain_bf16", 36)])
def test_tokenizer_and_bf16_units_launch_k1_only(unit, k1):
    """The four-stream step at the YAML's batch sizes with the tokenizer
    and region attention in the last 3 blocks (K1 12 + 12 + 9 forward and
    as many backward: the region stream's first 9 blocks only), and with
    bf16 parameters (12 + 12 + 12): nothing else of K1-K5, finite losses,
    the bf16 unit's parameters bf16 after its step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch import configs, profile_step
    from xfm_tpu_torch.ops import kernels

    state, batches, step, gens = configs.make_pretrain_streams_run(
        **profile_step.STREAM_UNITS[unit])
    kernels.reset_launch_counts()
    state, metrics = step(state, batches, gens(0))
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == dict(
        {k: 0 for k in kernels.LAUNCHES}, packed_attention_fwd=k1,
        packed_attention_bwd=k1)
    assert all(torch.isfinite(v) for v in metrics.values() if v.dim() == 0)
    if unit == "pretrain_bf16":
        assert {p.dtype for p in state.model.parameters()} == {
            torch.bfloat16}


def _aug_batch(B, S=224, seed=0):
    """Seeded uint8 photo-like images [B, S, S, 3]: a colour, a wave and
    noise, so that every op moves pixels."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:S, 0:S]
    out = np.empty((B, S, S, 3), np.uint8)
    for b in range(B):
        wave = np.sin(xx * r.uniform(0.02, 0.1) + yy * r.uniform(0.02, 0.1))
        out[b] = np.clip(r.randint(0, 256, 3) + 60 * wave[..., None]
                         * r.uniform(-1, 1, 3) + r.normal(0, 10, (S, S, 3)),
                         0, 255)
    return torch.from_numpy(out)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["AutoContrast", "Equalize", "Brightness",
                                  "Sharpness", "ShearX", "ShearY",
                                  "TranslateX", "TranslateY", "Rotate"])
def test_randaugment_ops_on_the_card_match_cpu(name):
    """Each device RandAugment op on [8, 224, 224, 3] on the card within 1
    uint8 level of the same op on the CPU, both signs in the batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch.data import device_aug as da

    imgs = _aug_batch(8).float()
    sign = torch.tensor([1.0, -1.0] * 4)

    def run(dev):
        out = da.apply_op(name, imgs.to(dev), 7, sign.to(dev))
        return torch.round(torch.clamp(out, 0, 255)).cpu()

    d = (run("cuda") - run("cpu")).abs()
    assert d.max() <= 1.0, (name, float(d.max()))


@pytest.mark.cuda
def test_randaugment_batch_on_the_card_matches_cpu():
    """Two rounds from the same injected draws, card vs CPU, within 1 level
    a round; `randaugment_batch` from one card generator seed twice gives
    one output, uint8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch.data import device_aug as da

    imgs = _aug_batch(16, seed=1).float()
    g = torch.Generator().manual_seed(0)
    cpu, gpu = imgs, imgs.cuda()
    for _ in range(2):
        op, applied, neg = da.randaug_draws(16, 10, g)
        cpu = da.randaug_round(cpu, op, applied, neg)
        gpu = da.randaug_round(gpu, op.cuda(), applied.cuda(), neg.cuda())
        assert (gpu.cpu() - cpu).abs().max() <= 1.0
        cpu = gpu.cpu()
    u8 = imgs.to(torch.uint8).cuda()
    a = da.randaugment_batch(u8, torch.Generator("cuda").manual_seed(3))
    b = da.randaugment_batch(u8, torch.Generator("cuda").manual_seed(3))
    assert a.dtype == torch.uint8 and torch.equal(a, b)


@pytest.mark.cuda
def test_randaug_unit_launches_k1_only_on_uint8_batches():
    """`pretrain_randaug`: the image-text and ImageNet streams' images
    uint8 on the card and augmented there, K1 36 + 36 a step and nothing
    else, finite losses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch import configs, profile_step
    from xfm_tpu_torch.ops import kernels

    state, batches, step, gens = configs.make_pretrain_streams_run(
        **profile_step.STREAM_UNITS["pretrain_randaug"])
    assert {n: batches[n]["images"].dtype for n in ("image", "imagenet")} \
        == {"image": torch.uint8, "imagenet": torch.uint8}
    kernels.reset_launch_counts()
    state, metrics = step(state, batches, gens(0))
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == dict(
        {k: 0 for k in kernels.LAUNCHES}, packed_attention_fwd=36,
        packed_attention_bwd=36)
    assert all(torch.isfinite(v) for v in metrics.values() if v.dim() == 0)


@pytest.mark.cuda
def test_uint8_batches_reach_the_card_as_uint8():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch.data.prefetch import DeviceBatches

    host = [dict(images=_aug_batch(4, S=32, seed=i).numpy()) for i in range(3)]
    batches = DeviceBatches(iter(host), "cuda")
    got = [b["images"] for b in batches]
    batches.close()
    assert all(t.is_cuda and t.dtype == torch.uint8 for t in got)
    for g, h in zip(got, host):
        np.testing.assert_array_equal(g.cpu().numpy(), h["images"])


@pytest.mark.cuda
def test_flash_attention_at_deit_shape_with_no_bias():
    """K3 as DeiT-B/16's blocks call it at 384 px: q/k/v [32, 577, 12, 64]
    bf16 views of the qkv projection [32, 577, 2304], no bias: out, dq, dk
    and dv within 2⁻⁶ of their largest plain value (phase 8's gate), the
    same bits over two runs, and no db."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xfm_tpu_torch.ops import flash_attention as fa

    r = np.random.RandomState(11)
    qkv = torch.from_numpy(r.randn(32, 577, 2304).astype(np.float32)).cuda()
    qkv = qkv.to(torch.bfloat16)
    q, k, v = (t.reshape(32, 577, 12, 64) for t in qkv.split(768, -1))
    assert q.stride(1) == 2304
    g = torch.from_numpy(r.randn(32, 577, 12, 64).astype(np.float32)).cuda()
    g = g.to(torch.bfloat16)
    runs = []
    for _ in range(2):
        out, stats = fa.flash_attention_fwd(q, k, v, None, 0.125)
        grads = fa.flash_attention_bwd(q, k, v, None, out, stats, g, 0.125)
        assert grads[3] is None
        runs.append((out,) + grads[:3])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    refs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    ref = fa.flash_attention_reference(*refs, None, 0.125)
    ref.backward(g)
    for got, want in zip(runs[0], [ref] + [x.grad for x in refs]):
        want = want.float()
        assert (got.float() - want).abs().max() <= 2.0 ** -6 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("unit,k3", [("swin", 0), ("deit", 12)])
def test_tower_retrieval_steps_launch_their_kernels_only(unit, k3):
    """The full-width retrieval fine-tune step with Swin-B + BERT-base
    (no kernel: windows of 144 tokens, text and fusion under 512) and with
    DeiT-B/16 (K3 12 + 12 a step, nothing else), finite losses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from xfm_tpu_torch import configs
    from xfm_tpu_torch.ops import kernels

    make = (configs.make_swin_retrieval_train_run if unit == "swin"
            else configs.make_deit_retrieval_train_run)
    state, batch, step = make(32, 40)
    kernels.reset_launch_counts()
    state, metrics = step(state, batch,
                          torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == dict(
        {k: 0 for k in kernels.LAUNCHES}, flash_attention_fwd=k3,
        flash_attention_bwd=k3)
    assert torch.isfinite(metrics["loss"])


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["full", "dots", "except_attn",
                                    "attn_out"])
def test_checkpointing_on_the_card_matches_off(policy):
    """BEiT-2-large's width (1024, 16 heads) and the text side's at depth
    2, bf16, the image-text stream with dropout and drop-path live from one
    seeded generator, deterministic algorithms (PyTorch's atomic
    accumulations ordered; K1's bf16 kernels are deterministic): with
    checkpointing under `policy` the loss and every gradient are
    bit-equal to the plain step's; K1's forward runs again in each
    checkpointed block's recompute."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import dataclasses

    from xfm_tpu_torch import configs
    from xfm_tpu_torch.models import XFMForPretrain
    from xfm_tpu_torch.models.task_models import LOSS_KEYS
    from xfm_tpu_torch.models.xfm import config_from_yaml
    from xfm_tpu_torch.ops import kernels
    from xfm_tpu_torch.tasks.pretrain import stream_flags

    yaml_cfg = configs.pretrain_large_yaml(
        vision_depth=2, text_num_hidden_layers=2, text_fusion_start_at=2,
        fusion_num_hidden_layers=2, gradient_checkpointing=False)
    cfg = config_from_yaml(yaml_cfg, use_contrastive_loss=True,
                           use_matching_loss=True, use_mlm_loss=True,
                           use_bbox_loss=True, dtype=torch.bfloat16)
    nb = configs.make_stream_batches(
        dict(configs.stream_batch_sizes(yaml_cfg), image=8), 224,
        cfg.text.vocab_size, seed=4)
    batch = configs.batch_to_torch(nb["image"], "cuda")
    flags = stream_flags("image", 0, yaml_cfg)

    def run(c, weights=None):
        with torch.device("cuda"):
            model = XFMForPretrain(c)
        if weights is None:
            from xfm_tpu_torch.train.checkpoint import init_weights

            init_weights(model, 7)
        else:
            model.load_state_dict(weights)
        kernels.reset_launch_counts()
        g = torch.Generator(device="cuda").manual_seed(11)
        out = model.loss(**batch, **flags, generator=g, deterministic=False)
        loss = sum(out[k] for k in LOSS_KEYS)
        loss.backward()
        grads = {n: p.grad.float() for n, p in model.named_parameters()
                 if p.grad is not None}
        return (model.state_dict(), loss.item(), grads,
                kernels.LAUNCHES["packed_attention_fwd"], g.get_state())

    on = dict(remat=True, remat_policy=policy)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        weights, loss, grads, k1, state = run(cfg)
        _, loss2, grads2, k1_2, state2 = run(dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, **on),
            text=dataclasses.replace(cfg.text, **on),
            fusion=dataclasses.replace(cfg.fusion, **on)), weights)
    finally:
        torch.use_deterministic_algorithms(False)
    assert loss2 == loss
    assert torch.equal(state, state2)
    assert set(grads2) == set(grads)
    for name, want in grads.items():
        assert torch.equal(grads2[name], want), name
    assert k1_2 == (k1 if policy == "except_attn" else 2 * k1)
