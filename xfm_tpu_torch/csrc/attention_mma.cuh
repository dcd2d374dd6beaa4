// The bf16 attention kernels shared by K1 (packed_attention.cu, a shared f32
// bias [1, H, N, N]), K2 (relpos_attention.cu, the BEiT rel-pos bias from
// its compact table) and K3 (flash_attention.cu, a dense bias of any
// broadcast shape): forward, dq and dk/dv, and for a bias shared by the
// batch (K1, K2) the db kernel that sums its gradient over b, templated on
// the bias source. Head dim 64, blocks of 4 warps, each warp owning 16 rows (q rows,
// or keys in dk/dv) whose fixed operand it holds as mma.sync A fragments;
// the streamed tiles double-buffered in shared memory by cp.async (rows
// padded to 144 bytes, so ldmatrix is free of bank conflicts); every product
// mma.sync.m16n8k16 with f32 accumulators fed by ldmatrix (.trans where the
// tile is the [k][n] operand); each score tile (S, P, dP, dS) stays in
// registers and is rounded to bf16 in the accumulator layout to become the A
// operand of the next product.
//
// A bias source `Bias` gives, for one (b, h), `Bias::Head hb = bias.head(d,
// b, h)` with
//   hb.present()     false where no bias is added (then no row is read);
//   hb.row(q)        what the kernels keep of q row q (any q; rows past Nq
//                    give a row whose values are finite and never stored);
// and, as `Head::TILE` and `Head::TILE_F32` say, one of three ways to the
// values:
//   TILE false       hb.at(row, key), the bias of that row at a key < Nk in
//                    f32, read beside each score;
//   TILE true        hb.tile_async(tile, hb.stage(q0), k0) stages the bf16
//                    bias of q rows q0 .. q0 + 63 at keys k0 .. k0 + 63 into
//                    a [64 x LDT] tile by cp.async, in the caller's commit
//                    group, beside the K/V or Q/dO tiles it goes with
//                    (`stage` keeps what a thread needs of those rows); the
//                    kernels read it by ldmatrix straight into the score
//                    tile's layout (.trans in dk/dv, where S^T is the tile);
//                    hb.patch(v, row0, key0) turns a staged value v into
//                    the bias, where row0 / key0 say that its q row / key is
//                    0 (the entries the staged source does not hold);
//   TILE_F32 true    hb.tile_f32_async(tile, q0, k0) stages the f32 bias of
//                    q rows q0 .. q0 + 63 at keys k0 .. k0 + 63 into a
//                    [64 x LDB32] f32 tile by cp.async, in the caller's
//                    commit group (K1's dense bias, from a copy whose rows
//                    are padded to 16 bytes); the kernels read it as f32
//                    pairs beside each score pair.
// The [Nq, Nk] bias itself is never built.
//
// Rounding points (the TPU kernels' except two, which the source notes of
// K2 and K3 name): q is scaled in f32 and rounded to bf16 before QK^T;
// scores, the bias and the softmax in f32; keys past Nk excluded exactly
// (p = 0); the forward rounds the unnormalized exp(S - m) of each key tile
// to bf16 for PV and divides by the row sum at the end; delta =
// rowsum(dO (.) O) from the rounded output; dS = P (dP - delta) in f32,
// rounded to bf16 for dq and dk; P rounded for dv.
#pragma once

#include "attention_tiles.cuh"

namespace {

constexpr int KT = 64;            // key tile
constexpr int MT = 64;            // rows of a block's tile (q rows or keys)
constexpr int MMA_THREADS = 128;  // 4 warps, 16 rows of the block's 64 each
constexpr int LDB32 = KT + 4;     // row of a staged f32 bias tile: 272 bytes
constexpr int F32_TILE_BYTES = MT * LDB32 * 4;

// Sizes and element strides, in the order of K3's wrapper's int64 array.
struct Dims {
  long long B, Nq, Nk, H;
  long long q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, g_sb, g_sn;  // batch, row
  long long bias_sb, bias_sh, bias_sq;  // K3's bias: 0 along a broadcast dim
  long long bias_b, bias_h, bias_q;     // its sizes: 1 or B, H, Nq
  long long o_sb, o_sn, dq_sb, dq_sn, dkv_sb, dkv_sn;  // out (and delta's
                                                        // read of it), dq, dk/dv
};
static_assert(sizeof(Dims) == 24 * sizeof(long long), "Dims is the wrapper's int64[24]");

// K1's and K2's Dims: q, k and v read in place from qkv [B, N, 3C], dq, dk
// and dv written in place into dqkv, out and dout [B, N, C] contiguous
inline Dims qkv_dims(int B, int N, int H) {
  const long long C = (long long)H * 64, C3 = 3 * C;
  Dims d{};
  d.B = B;
  d.Nq = d.Nk = N;
  d.H = H;
  d.q_sb = d.k_sb = d.v_sb = d.dq_sb = d.dkv_sb = N * C3;
  d.q_sn = d.k_sn = d.v_sn = d.dq_sn = d.dkv_sn = C3;
  d.g_sb = d.o_sb = N * C;
  d.g_sn = d.o_sn = C;
  return d;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: nothing read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + 64) of one head's [N, D] slice (`base` at row 0 of this
// head, rows `stride` elements apart) into a [64 x LDT] tile, 16 bytes a
// cp.async, 4 of them a thread; rows past N are zero-filled. The row stride
// of LDT = 72 elements (144 bytes) puts the 8 rows of every ldmatrix phase
// on distinct banks.
__device__ __forceinline__ void tile_async(bf16* tile, const bf16* __restrict__ base,
                                           long long stride, int r0, int N) {
#pragma unroll
  for (int j = 0; j < MT * D / 8 / MMA_THREADS; ++j) {
    const int i = threadIdx.x + j * MMA_THREADS;
    const int r = i / (D / 8), c = (i % (D / 8)) * 8, n = r0 + r;
    cp_async16(tile + r * LDT + c, base + (size_t)(n < N ? n : 0) * stride + c, n < N);
  }
}

// Four 8x8 b16 matrices of the 16x16 block at (r0, c0) of a [* x LDT] tile:
// m0 = rows 0-7 / cols 0-7, m1 = rows 8-15 / cols 0-7, m2 = rows 0-7 /
// cols 8-15, m3 = rows 8-15 / cols 8-15. Read as an A operand (rows = M, cols
// = K) that is the m16n8k16 A fragment {m0, m1, m2, m3}; as a B operand
// stored [n][k] (rows = N) the fragments of n-tiles 0-7 and 8-15 are
// {m0, m2} and {m1, m3}; with .trans, as a B operand stored [k][n] (rows =
// K), they are {m0, m1} and {m2, m3}.
__device__ __forceinline__ void ldsm(unsigned (&r)[4], const bf16* tile, int r0, int c0) {
  const int l = threadIdx.x & 31;
  const bf16* p = tile + (r0 + (l & 7) + ((l >> 3) & 1) * 8) * LDT + c0 + (l >> 4) * 8;
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldsm_t(unsigned (&r)[4], const bf16* tile, int r0, int c0) {
  const int l = threadIdx.x & 31;
  const bf16* p = tile + (r0 + (l & 7) + ((l >> 3) & 1) * 8) * LDT + c0 + (l >> 4) * 8;
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 accumulators. Lane
// (g = lane / 4, t = lane % 4) holds c[g][2t, 2t+1] in c[0], c[1] and
// c[g+8][2t, 2t+1] in c[2], c[3].
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The mma kernels' exponentials: p = 2^((v - m) log2(e) - log2(l)) =
// exp(v - m) / l as one FADD, one FFMA and one ex2.approx (within 2 ulp of
// f32; -inf gives 0), where the plain version and the f32 kernels take expf
// and an IEEE division. v - m is formed first, so a fully masked row (v and
// m both about -1e9) loses nothing to the size of m. Every kernel that
// recomputes P takes it from this one expression.
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float prob2(float v, float m, float neg_log2_l) {
  return exp2_approx(fmaf(v - m, LOG2E, neg_log2_l));
}

// two f32 rounded to a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
// a bf16 pair times `scale` in f32, rounded back
__device__ __forceinline__ unsigned scale_bf16x2(unsigned x, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return pack_bf16(f.x * scale, f.y * scale);
}

// An accumulator tile of 16 rows x 64 columns (8 n-tiles) of f32, rounded to
// bf16 as the A operand of a product over its 64 columns: k-step kk takes
// n-tiles 2kk (its cols 0-7) and 2kk + 1 (cols 8-15), in the accumulator's
// own layout (no shuffle, no shared memory).
__device__ __forceinline__ void acc_to_a(unsigned (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// c[16 x 64] = a[16 x 64] op(B)[64 x 64] over one tile: `a` the warp's A
// fragments (4 k-steps), B a [64 x LDT] tile read as [n][k] (QK^T-like,
// `trans` false) or as [k][n] (PV-like, `trans` true). Each element sums its
// 4 k-steps in order, so two calls on the same tiles agree bit for bit.
template <bool TRANS>
__device__ __forceinline__ void warp_tile_mma(float (&c)[8][4], const unsigned (&a)[4][4],
                                              const bf16* tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned r[4];
      if (TRANS) {
        ldsm_t(r, tile, kk * 16, np * 16);
        mma_bf16(c[2 * np], a[kk], r[0], r[1]);
        mma_bf16(c[2 * np + 1], a[kk], r[2], r[3]);
      } else {
        ldsm(r, tile, np * 16, kk * 16);
        mma_bf16(c[2 * np], a[kk], r[0], r[2]);
        mma_bf16(c[2 * np + 1], a[kk], r[1], r[3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
}

// what a thread keeps of q rows q0 .. q0 + 63 to stage their bias tiles
// (nothing for a bias read beside each score)
template <class Head>
__device__ __forceinline__ auto stage_rows(const Head& hb, int q0) {
  if constexpr (Head::TILE)
    return hb.stage(q0);
  else
    return 0;
}

// staged f32 bias tile `buf` of a kernel's bias room `Bs`
__device__ __forceinline__ float* f32_tile(bf16* Bs, int buf) {
  return reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Bs) + buf * F32_TILE_BYTES);
}

// bf16 pair -> f32 pair, the lower column in .x
__device__ __forceinline__ float2 unpack_bf16(unsigned x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// A warp's S tile (its 16 q rows `row` x keys k0 .. k0 + 63) plus the bias
// rows `brow` of the lane's two rows, keys at or past Nk set to -inf; the
// bias is read only where it exists, the mask only on the last tile. A
// staged bias is read from `btile`, the staged tile at the warp's first row:
// bf16 by ldmatrix, r[2 * half + i] holding n-tile 2np + half of the lane's
// row i; f32 as the pair of the lane's two columns.
template <class Head>
__device__ __forceinline__ void add_bias_and_mask(float (&s)[8][4], const Head& hb,
                                                  const typename Head::Row (&brow)[2],
                                                  const int (&row)[2], int k0, int Nk, int t,
                                                  const void* btile) {
  const bool tail = k0 + KT > Nk;
  if constexpr (Head::TILE) {
    const bool key0 = k0 == 0 && t == 0;  // the lane holds key 0 (n-tile 0, c 0)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned r[4];
      ldsm(r, static_cast<const bf16*>(btile), 0, np * 16);
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int nt = 2 * np + half;
          const float2 f = unpack_bf16(r[2 * half + i]);
          s[nt][2 * i] += hb.patch(f.x, row[i] == 0, key0 && nt == 0);
          s[nt][2 * i + 1] += hb.patch(f.y, row[i] == 0, false);
        }
    }
  } else if constexpr (Head::TILE_F32) {
    const float* bt = static_cast<const float*>(btile) + (threadIdx.x % 32 / 4) * LDB32 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 f = *reinterpret_cast<const float2*>(bt + 8 * i * LDB32 + nt * 8);
        s[nt][2 * i] += f.x;
        s[nt][2 * i + 1] += f.y;
      }
  } else if (hb.present()) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + nt * 8 + 2 * t + (c & 1);
        if (key < Nk) s[nt][c] += hb.at(brow[c / 2], key);
      }
  }
  if (!tail) return;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (k0 + nt * 8 + 2 * t + (c & 1) >= Nk) s[nt][c] = -INFINITY;
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(Nq/64), H, B), 128 threads. One pass over the key
// tiles with an online softmax; warp w owns q rows 16w .. 16w + 15. stats:
// [2][B*H*Nq] = row max, row sum.

template <class Bias>
__global__ void __launch_bounds__(MMA_THREADS)
xfm_attn_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, Bias bias, bf16* __restrict__ out,
                        float* __restrict__ stats, Dims d, float scale) {
  const int q0 = blockIdx.x * MT, h = blockIdx.y, b = blockIdx.z;
  const int Nq = (int)d.Nq, Nk = (int)d.Nk, H = (int)d.H;
  const int nkt = (Nk + KT - 1) / KT;
  const size_t BHN = (size_t)d.B * H * Nq;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + MT * LDT;      // two K tiles
  bf16* Vs = Ks + 2 * KT * LDT;  // two V tiles
  bf16* Bs = Vs + 2 * KT * LDT;  // two staged bias tiles (Head::TILE, TILE_F32)
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane / 4, t = lane % 4;
  const bf16* kb = k + (size_t)b * d.k_sb + h * D;
  const bf16* vb = v + (size_t)b * d.v_sb + h * D;
  const auto hb = bias.head(d, b, h);
  constexpr bool TILE = Bias::Head::TILE, TILE_F32 = Bias::Head::TILE_F32;
  const auto bst = stage_rows(hb, q0);

  tile_async(Qs, q + (size_t)b * d.q_sb + h * D, d.q_sn, q0, Nq);
  tile_async(Ks, kb, d.k_sn, 0, Nk);
  tile_async(Vs, vb, d.v_sn, 0, Nk);
  if constexpr (TILE) hb.tile_async(Bs, bst, 0);
  if constexpr (TILE_F32) hb.tile_f32_async(f32_tile(Bs, 0), q0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // the warp's q rows as A fragments, q * scale in f32 rounded to bf16
  unsigned qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldsm(qf[kk], Qs, warp * 16, kk * 16);
#pragma unroll
    for (int i = 0; i < 4; ++i) qf[kk][i] = scale_bf16x2(qf[kk][i], scale);
  }
  // this lane's two rows: g and g + 8 of the warp's 16
  int row[2];
  typename Bias::Head::Row brow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + g + 8 * i;
    brow[i] = hb.row(row[i]);
  }

  float o[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  zero(o);
  for (int j = 0; j < nkt; ++j) {
    const int k0 = j * KT;
    const bf16* Kt = Ks + (j & 1) * KT * LDT;
    const bf16* Vt = Vs + (j & 1) * KT * LDT;
    if (j + 1 < nkt) {  // the next tiles land while this one computes
      tile_async(Ks + ((j + 1) & 1) * KT * LDT, kb, d.k_sn, k0 + KT, Nk);
      tile_async(Vs + ((j + 1) & 1) * KT * LDT, vb, d.v_sn, k0 + KT, Nk);
      if constexpr (TILE) hb.tile_async(Bs + ((j + 1) & 1) * MT * LDT, bst, k0 + KT);
      if constexpr (TILE_F32) hb.tile_f32_async(f32_tile(Bs, (j + 1) & 1), q0, k0 + KT);
      cp_async_commit();
    }
    float s[8][4];
    zero(s);
    warp_tile_mma<false>(s, qf, Kt);
    add_bias_and_mask(s, hb, brow, row, k0, Nk, t,
                      TILE_F32 ? static_cast<const void*>(f32_tile(Bs, j & 1) + warp * 16 * LDB32)
                               : Bs + ((j & 1) * MT + warp * 16) * LDT);
    // online softmax: the new row max over the quad that shares the row,
    // the old sums and outputs rescaled (every tile holds a key < Nk, so
    // the max is finite and exp(-inf - max) = 0 starts the sums)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float alpha = prob2(m[i], mx[i], 0.f);
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        o[nt][2 * i] *= alpha;
        o[nt][2 * i + 1] *= alpha;
      }
    }
    // p = exp(s - m) in f32 for the sums, rounded to bf16 for PV
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[nt][c] = prob2(s[nt][c], m[c / 2], 0.f);
        l[c / 2] += s[nt][c];
      }
    unsigned pf[4][4];
    acc_to_a(pf, s);
    warp_tile_mma<true>(o, pf, Vt);
    if (j + 1 < nkt) cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  bf16* ob = out + (size_t)b * d.o_sb + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Nq) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<unsigned*>(ob + (size_t)row[i] * d.o_sn + nt * 8 + 2 * t) =
          pack_bf16(o[nt][2 * i] / l[i], o[nt][2 * i + 1] / l[i]);
    if (t == 0) {
      const size_t idx = ((size_t)b * H + h) * Nq + row[i];
      stats[idx] = m[i];
      stats[BHN + idx] = l[i];
    }
  }
}

// ---------------------------------------------------------------------------
// backward, 1/2: delta and dq. grid (ceil(Nq/64), H, B), 128 threads; warp
// w owns q rows 16w .. 16w + 15 and makes one pass over the key tiles.

template <class Bias>
__global__ void __launch_bounds__(MMA_THREADS)
xfm_attn_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, Bias bias,
                           const bf16* __restrict__ out, const bf16* __restrict__ dout,
                           const float* __restrict__ stats, float* __restrict__ delta_out,
                           bf16* __restrict__ dq, Dims d, float scale) {
  const int q0 = blockIdx.x * MT, h = blockIdx.y, b = blockIdx.z;
  const int Nq = (int)d.Nq, Nk = (int)d.Nk, H = (int)d.H;
  const int nkt = (Nk + KT - 1) / KT;
  const size_t BHN = (size_t)d.B * H * Nq;
  const size_t row0 = ((size_t)b * H + h) * Nq;  // (b, h, q = 0)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + MT * LDT;      // dO
  bf16* Ks = Gs + MT * LDT;      // two K tiles
  bf16* Vs = Ks + 2 * KT * LDT;  // two V tiles
  bf16* Bs = Vs + 2 * KT * LDT;  // two staged bias tiles (Head::TILE, TILE_F32)
  __shared__ float row_delta[MT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane / 4, t = lane % 4;
  const bf16* kb = k + (size_t)b * d.k_sb + h * D;
  const bf16* vb = v + (size_t)b * d.v_sb + h * D;
  const bf16* gb = dout + (size_t)b * d.g_sb + h * D;
  const auto hb = bias.head(d, b, h);
  constexpr bool TILE = Bias::Head::TILE, TILE_F32 = Bias::Head::TILE_F32;
  const auto bst = stage_rows(hb, q0);

  tile_async(Qs, q + (size_t)b * d.q_sb + h * D, d.q_sn, q0, Nq);
  tile_async(Gs, gb, d.g_sn, q0, Nq);
  tile_async(Ks, kb, d.k_sn, 0, Nk);
  tile_async(Vs, vb, d.v_sn, 0, Nk);
  if constexpr (TILE) hb.tile_async(Bs, bst, 0);
  if constexpr (TILE_F32) hb.tile_f32_async(f32_tile(Bs, 0), q0, 0);
  cp_async_commit();
  {  // delta = rowsum(dO (.) O) in f32 while the tiles land: two threads a
     // row, 32 products each in order, then their sum
    const int r = threadIdx.x / 2, half = threadIdx.x % 2, qq = q0 + r;
    float acc = 0.f;
    if (qq < Nq) {
      const bf16* op = out + (size_t)b * d.o_sb + (size_t)qq * d.o_sn + h * D + half * 32;
      const bf16* gp = gb + (size_t)qq * d.g_sn + half * 32;
#pragma unroll
      for (int c = 0; c < 32; c += 8) {
        uint4 ov = *reinterpret_cast<const uint4*>(op + c);
        uint4 gv = *reinterpret_cast<const uint4*>(gp + c);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
        const bf16* ge = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += to_f(oe[e]) * to_f(ge[e]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      row_delta[r] = acc;
      if (qq < Nq) delta_out[row0 + qq] = acc;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  unsigned qf[4][4], gf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldsm(qf[kk], Qs, warp * 16, kk * 16);
    ldsm(gf[kk], Gs, warp * 16, kk * 16);
#pragma unroll
    for (int i = 0; i < 4; ++i) qf[kk][i] = scale_bf16x2(qf[kk][i], scale);
  }
  int row[2];
  typename Bias::Head::Row brow[2];
  float m[2], nl[2], dl[2];  // row max, -log2(row sum), delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    row[i] = q0 + r;
    brow[i] = hb.row(row[i]);
    const bool in = row[i] < Nq;
    m[i] = in ? stats[row0 + row[i]] : 0.f;  // rows past Nq: dO = 0, so ds = 0
    nl[i] = in ? -log2f(stats[BHN + row0 + row[i]]) : 0.f;
    dl[i] = row_delta[r];
  }

  float dqa[8][4];
  zero(dqa);
  for (int j = 0; j < nkt; ++j) {
    const int k0 = j * KT;
    const bf16* Kt = Ks + (j & 1) * KT * LDT;
    const bf16* Vt = Vs + (j & 1) * KT * LDT;
    if (j + 1 < nkt) {
      tile_async(Ks + ((j + 1) & 1) * KT * LDT, kb, d.k_sn, k0 + KT, Nk);
      tile_async(Vs + ((j + 1) & 1) * KT * LDT, vb, d.v_sn, k0 + KT, Nk);
      if constexpr (TILE) hb.tile_async(Bs + ((j + 1) & 1) * MT * LDT, bst, k0 + KT);
      if constexpr (TILE_F32) hb.tile_f32_async(f32_tile(Bs, (j + 1) & 1), q0, k0 + KT);
      cp_async_commit();
    }
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    warp_tile_mma<false>(s, qf, Kt);   // S = (q*scale) K^T
    warp_tile_mma<false>(dp, gf, Vt);  // dP = dO V^T
    add_bias_and_mask(s, hb, brow, row, k0, Nk, t,
                      TILE_F32 ? static_cast<const void*>(f32_tile(Bs, j & 1) + warp * 16 * LDB32)
                               : Bs + ((j & 1) * MT + warp * 16) * LDT);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c / 2;
        s[nt][c] = prob2(s[nt][c], m[i], nl[i]) * (dp[nt][c] - dl[i]);  // ds
      }
    unsigned dsf[4][4];
    acc_to_a(dsf, s);
    warp_tile_mma<true>(dqa, dsf, Kt);  // dQ += dS K
    if (j + 1 < nkt) cp_async_wait_all();
    __syncthreads();
  }
  bf16* qb = dq + (size_t)b * d.dq_sb + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Nq) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<unsigned*>(qb + (size_t)row[i] * d.dq_sn + nt * 8 + 2 * t) =
          pack_bf16(dqa[nt][2 * i] * scale, dqa[nt][2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// backward, 2/2: dk and dv. grid (ceil(Nk/64), H, B), 128 threads; warp w
// owns keys 16w .. 16w + 15 (K and V as A fragments in registers) and the
// block loops over the q tiles in order, Q, dO and their rows' (m, l, delta,
// bias row) double-buffered; S^T, P^T, dP^T and dS^T never leave registers.

// the [64 x LDT] q tile's chunks that this thread copied, times `scale` in
// f32 and rounded to bf16 (after its own cp.async have landed)
__device__ __forceinline__ void scale_own_chunks(bf16* tile, float scale) {
#pragma unroll
  for (int j = 0; j < MT * D / 8 / MMA_THREADS; ++j) {
    const int i = threadIdx.x + j * MMA_THREADS;
    uint4* p = reinterpret_cast<uint4*>(tile + (i / (D / 8)) * LDT + (i % (D / 8)) * 8);
    uint4 x = *p;
    x.x = scale_bf16x2(x.x, scale);
    x.y = scale_bf16x2(x.y, scale);
    x.z = scale_bf16x2(x.z, scale);
    x.w = scale_bf16x2(x.w, scale);
    *p = x;
  }
}

template <class Bias>
__global__ void __launch_bounds__(MMA_THREADS)
xfm_attn_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, Bias bias,
                             const bf16* __restrict__ dout, const float* __restrict__ stats,
                             const float* __restrict__ delta, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, Dims d, float scale) {
  using Row = typename Bias::Head::Row;
  const int k0 = blockIdx.x * KT, h = blockIdx.y, b = blockIdx.z;
  const int Nq = (int)d.Nq, Nk = (int)d.Nk, H = (int)d.H;
  const int nqt = (Nq + MT - 1) / MT;
  const size_t BHN = (size_t)d.B * H * Nq;
  const size_t row0 = ((size_t)b * H + h) * Nq;  // (b, h, q = 0)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + KT * LDT;
  bf16* Qs = Vs + KT * LDT;      // two q tiles (scaled)
  bf16* Gs = Qs + 2 * MT * LDT;  // two dO tiles
  bf16* Bs = Gs + 2 * MT * LDT;  // two staged bias tiles [q][key] (TILE, TILE_F32)
  __shared__ __align__(16) float sm[2][MT], snl[2][MT], sd[2][MT];
  __shared__ Row srow[2][MT];  // the q rows' bias rows (read beside each score)
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane / 4, t = lane % 4;
  const bf16* qb = q + (size_t)b * d.q_sb + h * D;
  const bf16* gb = dout + (size_t)b * d.g_sb + h * D;
  const auto hb = bias.head(d, b, h);
  constexpr bool TILE = Bias::Head::TILE, TILE_F32 = Bias::Head::TILE_F32;
  // q tile `jt`: its bias tile into buffer `buf` (in the open commit
  // group) and its rows' statistics into registers: max, sum, delta, bias
  // row; rows past Nq get m = +inf, so their p = 2^-inf = 0. `put` stores
  // them into the buffer, the sum as -log2(sum), after the current tile's
  // compute, by when they have landed.
  float pm = INFINITY, pl = 0.f, pd = 0.f;
  bool pin = false;
  Row prow{};
  auto fetch_stats = [&](int buf, int jt) {
    if constexpr (TILE) hb.tile_async(Bs + buf * MT * LDT, hb.stage(jt * MT), k0);
    if constexpr (TILE_F32) hb.tile_f32_async(f32_tile(Bs, buf), jt * MT, k0);
    if (threadIdx.x < MT) {
      const int qq = jt * MT + threadIdx.x;
      pin = qq < Nq;
      if (pin) {
        pm = stats[row0 + qq];
        pl = stats[BHN + row0 + qq];
        pd = delta[row0 + qq];
      } else {
        pm = INFINITY;
        pd = 0.f;
      }
      if constexpr (!TILE && !TILE_F32) prow = hb.row(qq);
    }
  };
  auto put = [&](int buf) {
    if (threadIdx.x < MT) {
      sm[buf][threadIdx.x] = pm;
      snl[buf][threadIdx.x] = pin ? -log2f(pl) : 0.f;
      sd[buf][threadIdx.x] = pd;
      srow[buf][threadIdx.x] = prow;
    }
  };

  tile_async(Ks, k + (size_t)b * d.k_sb + h * D, d.k_sn, k0, Nk);
  tile_async(Vs, v + (size_t)b * d.v_sb + h * D, d.v_sn, k0, Nk);
  tile_async(Qs, qb, d.q_sn, 0, Nq);
  tile_async(Gs, gb, d.g_sn, 0, Nq);
  fetch_stats(0, 0);
  cp_async_commit();
  put(0);
  cp_async_wait_all();
  scale_own_chunks(Qs, scale);
  __syncthreads();

  unsigned kf[4][4], vf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldsm(kf[kk], Ks, warp * 16, kk * 16);
    ldsm(vf[kk], Vs, warp * 16, kk * 16);
  }
  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = k0 + warp * 16 + g + 8 * i;

  float dka[8][4], dva[8][4];
  zero(dka);
  zero(dva);
  for (int j = 0; j < nqt; ++j) {
    const int cur = j & 1;
    const bf16* Qt = Qs + cur * MT * LDT;
    const bf16* Gt = Gs + cur * MT * LDT;
    if (j + 1 < nqt) {
      tile_async(Qs + (cur ^ 1) * MT * LDT, qb, d.q_sn, (j + 1) * MT, Nq);
      tile_async(Gs + (cur ^ 1) * MT * LDT, gb, d.g_sn, (j + 1) * MT, Nq);
      fetch_stats(cur ^ 1, j + 1);
      cp_async_commit();
    }
    float st[8][4];  // S^T: this warp's 16 keys x the tile's 64 q
    zero(st);
    warp_tile_mma<false>(st, kf, Qt);
    if constexpr (TILE) {  // the staged [q][key] tile read transposed:
      // r[2 * i + half] holds n-tile 2np + half of the lane's key i
      const bool row0 = j == 0 && t == 0;  // the lane holds q row 0 (n-tile 0, c 0)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned r[4];
        ldsm_t(r, Bs + cur * MT * LDT, np * 16, warp * 16);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int nt = 2 * np + half;
            const float2 f = unpack_bf16(r[2 * i + half]);
            if (key[i] < Nk) {
              st[nt][2 * i] += hb.patch(f.x, row0 && nt == 0, key[i] == 0);
              st[nt][2 * i + 1] += hb.patch(f.y, false, key[i] == 0);
            }
          }
      }
    } else if constexpr (TILE_F32) {  // the staged [q][key] tile read down its columns
      const float* bt = f32_tile(Bs, cur) + 2 * t * LDB32 + warp * 16 + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (key[i] < Nk) {
            st[nt][2 * i] += bt[nt * 8 * LDB32 + 8 * i];
            st[nt][2 * i + 1] += bt[(nt * 8 + 1) * LDB32 + 8 * i];
          }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + 2 * t;  // and col + 1
      const float2 cm = *reinterpret_cast<const float2*>(&sm[cur][col]);
      const float2 cl = *reinterpret_cast<const float2*>(&snl[cur][col]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c / 2;
        float v = st[nt][c];
        if constexpr (!TILE && !TILE_F32)
          if (hb.present() && key[i] < Nk) v += hb.at(srow[cur][col + (c & 1)], key[i]);
        st[nt][c] = prob2(v, c & 1 ? cm.y : cm.x, c & 1 ? cl.y : cl.x);  // P^T
      }
    }
    unsigned af[4][4];
    acc_to_a(af, st);
    warp_tile_mma<true>(dva, af, Gt);  // dV += P^T dO
    float dpt[8][4];                   // dP^T = V dO^T
    zero(dpt);
    warp_tile_mma<false>(dpt, vf, Gt);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 cd = *reinterpret_cast<const float2*>(&sd[cur][nt * 8 + 2 * t]);
#pragma unroll
      for (int c = 0; c < 4; ++c) st[nt][c] *= dpt[nt][c] - (c & 1 ? cd.y : cd.x);  // dS^T
    }
    acc_to_a(af, st);
    warp_tile_mma<true>(dka, af, Qt);  // dK += dS^T (q*scale)
    if (j + 1 < nqt) {
      put(cur ^ 1);
      cp_async_wait_all();
      scale_own_chunks(Qs + (cur ^ 1) * MT * LDT, scale);
    }
    __syncthreads();
  }
  bf16* kout = dk + (size_t)b * d.dkv_sb + h * D;
  bf16* vout = dv + (size_t)b * d.dkv_sb + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Nk) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const size_t off = (size_t)key[i] * d.dkv_sn + nt * 8 + 2 * t;
      *reinterpret_cast<unsigned*>(kout + off) = pack_bf16(dka[nt][2 * i], dka[nt][2 * i + 1]);
      *reinterpret_cast<unsigned*>(vout + off) = pack_bf16(dva[nt][2 * i], dva[nt][2 * i + 1]);
    }
  }
}

// shared memory of the three kernels: fwd Q + two K + two V tiles; dq and
// dk/dv six tiles each; room for two more of a staged bias
constexpr size_t TILE_BYTES = (size_t)MT * LDT * sizeof(bf16);
template <class Head>
constexpr size_t bias_tile_bytes() {
  return Head::TILE ? TILE_BYTES : Head::TILE_F32 ? F32_TILE_BYTES : 0;
}
template <class Bias>
constexpr size_t mma_smem(int tiles) {
  return tiles * TILE_BYTES + 2 * bias_tile_bytes<typename Bias::Head>();
}

// The forward and the dq, dk/dv pair on the current stream, each checked
// for a launch error; a cudaError_t, 0 on success.
template <class Bias>
int launch_fwd_mma(const bf16* q, const bf16* k, const bf16* v, const Bias& bias, bf16* out,
                   float* stats, const Dims& d, float scale, cudaStream_t st) {
  const size_t smem = mma_smem<Bias>(5);
  cudaError_t e = allow_smem(xfm_attn_fwd_mma_kernel<Bias>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((d.Nq + MT - 1) / MT), (unsigned)d.H, (unsigned)d.B);
  xfm_attn_fwd_mma_kernel<Bias><<<grid, MMA_THREADS, smem, st>>>(q, k, v, bias, out, stats, d,
                                                                 scale);
  return (int)cudaGetLastError();
}

template <class Bias>
int launch_bwd_mma(const bf16* q, const bf16* k, const bf16* v, const Bias& bias,
                   const bf16* out, const bf16* dout, const float* stats, float* delta,
                   bf16* dq, bf16* dk, bf16* dv, const Dims& d, float scale, cudaStream_t st) {
  const size_t smem = mma_smem<Bias>(6);
  cudaError_t e;
  if ((e = allow_smem(xfm_attn_bwd_dq_mma_kernel<Bias>, smem)) != cudaSuccess) return (int)e;
  dim3 g1((unsigned)((d.Nq + MT - 1) / MT), (unsigned)d.H, (unsigned)d.B);
  xfm_attn_bwd_dq_mma_kernel<Bias><<<g1, MMA_THREADS, smem, st>>>(
      q, k, v, bias, out, dout, stats, delta, dq, d, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = allow_smem(xfm_attn_bwd_dkdv_mma_kernel<Bias>, smem)) != cudaSuccess) return (int)e;
  dim3 g2((unsigned)((d.Nk + KT - 1) / KT), (unsigned)d.H, (unsigned)d.B);
  xfm_attn_bwd_dkdv_mma_kernel<Bias><<<g2, MMA_THREADS, smem, st>>>(
      q, k, v, bias, dout, stats, delta, dk, dv, d, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward, after dq and dk/dv, for a bias shared by the batch (K1's dense
// [1, H, Nq, Nk], K2's table): db [H, Nq, Nk] f32, ds summed over b = 0, 1,
// ... in order. grid (ceil(Nk/64) key tiles, ceil(Nq/64) q tiles, H), 128
// threads; warp w owns q rows 16w .. 16w + 15 of the tile (the dq kernel's
// layout, so S, dP and P are that kernel's bits).

template <class Bias>
__global__ void __launch_bounds__(MMA_THREADS)
xfm_attn_bwd_db_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, Bias bias,
                           const bf16* __restrict__ dout, const float* __restrict__ stats,
                           const float* __restrict__ delta, float* __restrict__ db, Dims d,
                           float scale) {
  const int k0 = blockIdx.x * KT, q0 = blockIdx.y * MT, h = blockIdx.z;
  const int B = (int)d.B, Nq = (int)d.Nq, Nk = (int)d.Nk, H = (int)d.H;
  const size_t BHN = (size_t)B * H * Nq;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // two q tiles
  bf16* Gs = Qs + 2 * MT * LDT;              // two dO tiles
  bf16* Ks = Gs + 2 * MT * LDT;              // two K tiles
  bf16* Vs = Ks + 2 * KT * LDT;              // two V tiles
  bf16* Bs = Vs + 2 * KT * LDT;              // the staged bias tile (TILE, TILE_F32)
  __shared__ float sm[2][MT], snl[2][MT], sd[2][MT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane / 4, t = lane % 4;
  const auto hb = bias.head(d, 0, h);  // the same for every b
  // row b's tiles into buffer `buf`, and its rows' statistics (m, l,
  // delta) into registers; `put` stores them into the buffer, l as
  // -log2(l) and (0, 0, 0) past Nq as the dq kernel takes them, after the
  // current b's compute, by when they have landed
  const int sq = q0 + threadIdx.x;  // the q row whose statistics this thread keeps
  float pm = 0.f, pl = 0.f, pd = 0.f;
  auto fetch = [&](int buf, int b) {
    const size_t hd = (size_t)h * D;
    tile_async(Qs + buf * MT * LDT, q + b * d.q_sb + hd, d.q_sn, q0, Nq);
    tile_async(Gs + buf * MT * LDT, dout + b * d.g_sb + hd, d.g_sn, q0, Nq);
    tile_async(Ks + buf * KT * LDT, k + b * d.k_sb + hd, d.k_sn, k0, Nk);
    tile_async(Vs + buf * KT * LDT, v + b * d.v_sb + hd, d.v_sn, k0, Nk);
    cp_async_commit();
    if (threadIdx.x < MT && sq < Nq) {
      const size_t row0 = ((size_t)b * H + h) * Nq;
      pm = stats[row0 + sq];
      pl = stats[BHN + row0 + sq];
      pd = delta[row0 + sq];
    }
  };
  auto put = [&](int buf) {
    if (threadIdx.x < MT) {
      sm[buf][threadIdx.x] = pm;
      snl[buf][threadIdx.x] = sq < Nq ? -log2f(pl) : 0.f;
      sd[buf][threadIdx.x] = pd;
    }
  };

  if constexpr (Bias::Head::TILE) hb.tile_async(Bs, hb.stage(q0), k0);
  if constexpr (Bias::Head::TILE_F32) hb.tile_f32_async(f32_tile(Bs, 0), q0, k0);
  fetch(0, 0);
  put(0);
  cp_async_wait_all();
  __syncthreads();
  // the block's bias tile, the same for every b: the lane's two rows at its
  // 16 keys, -inf past Nk (0 + bias is the bias, so s + bt is the dq
  // kernel's s + bias)
  float bt[8][4];
  zero(bt);
  {
    const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
    const typename Bias::Head::Row brow[2] = {hb.row(row[0]), hb.row(row[1])};
    add_bias_and_mask(bt, hb, brow, row, k0, Nk, t,
                      Bias::Head::TILE_F32
                          ? static_cast<const void*>(f32_tile(Bs, 0) + warp * 16 * LDB32)
                          : Bs + warp * 16 * LDT);
  }
  float acc[8][4];
  zero(acc);
  for (int b = 0; b < B; ++b) {
    const int cur = b & 1;
    if (b + 1 < B) fetch(cur ^ 1, b + 1);  // lands while this b computes
    unsigned qf[4][4], gf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldsm(qf[kk], Qs + cur * MT * LDT, warp * 16, kk * 16);
      ldsm(gf[kk], Gs + cur * MT * LDT, warp * 16, kk * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[kk][i] = scale_bf16x2(qf[kk][i], scale);
    }
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    warp_tile_mma<false>(s, qf, Ks + cur * KT * LDT);  // S = (q*scale) K^T
    warp_tile_mma<false>(dp, gf, Vs + cur * KT * LDT);  // dP = dO V^T
    float m[2], nl[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
      m[i] = sm[cur][r];
      nl[i] = snl[cur][r];
      dl[i] = sd[cur][r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c / 2;
        // ds in f32, rounded before the sum (no fused multiply-add)
        acc[nt][c] += __fmul_rn(prob2(s[nt][c] + bt[nt][c], m[i], nl[i]), dp[nt][c] - dl[i]);
      }
    if (b + 1 < B) {
      put(cur ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }
  float* out = db + (size_t)h * Nq * Nk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qq = q0 + warp * 16 + g + 8 * i;
    if (qq >= Nq) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + nt * 8 + 2 * t + c;
        if (key < Nk) out[(size_t)qq * Nk + key] = acc[nt][2 * i + c];
      }
  }
}

// The db kernel on the current stream: two stages of Q, dO, K and V tiles,
// and a staged bias tile where the source stages one.
template <class Bias>
int launch_db_mma(const bf16* q, const bf16* k, const bf16* v, const Bias& bias,
                  const bf16* dout, const float* stats, const float* delta, float* db,
                  const Dims& d, float scale, cudaStream_t st) {
  const size_t smem = 8 * TILE_BYTES + bias_tile_bytes<typename Bias::Head>();
  cudaError_t e = allow_smem(xfm_attn_bwd_db_mma_kernel<Bias>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((d.Nk + KT - 1) / KT), (unsigned)((d.Nq + MT - 1) / MT), (unsigned)d.H);
  xfm_attn_bwd_db_mma_kernel<Bias><<<grid, MMA_THREADS, smem, st>>>(q, k, v, bias, dout, stats,
                                                                    delta, db, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace
