// Generic attention over [B, N, H, D] tensors with an additive bias of any
// broadcast shape, forward and backward, for Hopper (sm_90a). Plain C
// interface, loaded with ctypes by xfm_tpu_torch/ops/flash_attention.py.
//
// Replaces the TPU kernels of xfm_tpu/ops/flash_attention.py
// `flash_attention` (:1311): the forward `_attn_fwd_kernel` (:71), called by
// `_fused_attention_fwd_impl` at :188 and :200, and the two backward bodies
// `_attn_bwd_loopq_kernel` (:334, called at :476; the default at N >= 512)
// and `_attn_bwd_kernel` (:227, called at :613), which compute the same
// function and differ only in how they fit VMEM: both are this one
// backward. Computes, per (row b, head h),
//     out = softmax((q*scale) k^T + bias[b, h]) v
// with q [B, Nq, H, D], k and v [B, Nk, H, D] read in place (each row's
// [H, D] block dense, rows and batches at the strides the wrapper passes: the
// q/k/v projections reshaped, no transposes), D = 64, bf16 (tensor cores
// through WMMA, i.e. mma.sync) or f32 (CUDA-core FMA). The bias is f32 or
// bf16, broadcast as [1|B, 1|H, 1|Nq, Nk] (a stride of 0 along each broadcast
// dim), or absent; out, dq, dk, dv are written [B, N, H, D] contiguous.
//
// Rounding points are the TPU kernels': q is scaled in f32 and rounded to
// the input dtype before QK^T; scores, the bias (upcast exactly) and the
// softmax in f32; keys past Nk are excluded exactly (p = 0); P is rounded to
// the input dtype before PV and dV; dp = dO V^T; ds = p * (dp - delta) in
// f32, rounded to the input dtype for dq = ds k * scale and dk = ds^T
// (q*scale, rounded); db is the f32 ds, unrounded, summed to the bias's own
// shape. A row whose keys are all masked (bias -1e9) gets the uniform softmax
// over its Nk keys, as the plain version does: the row max starts at -inf and
// every key < Nk is finite. Two points move in the bf16 kernels, and
// tests/test_torch_long_attention.py emulates both and holds them to the
// card's bf16 gate (2^-6 max|ref|) against the Pallas kernel:
//   - the forward rounds the unnormalized exp(S - m) of each key tile to
//     bf16 for PV and divides the f32 sums by the row sum at the end, where
//     the TPU kernel rounds the normalized P (:83-86);
//   - delta = rowsum(dO (.) O), FA-2's, from the rounded output the forward
//     saved, where the TPU kernel and the f32 kernels here sum P (.) dP; it
//     takes one row pass over [Nq, D] instead of a pass over the keys.
//
// Design. The TPU kernels keep the whole [Nk, D] K/V and an [Nq, Nk] f32
// score block of one (b, h) in VMEM and carry db across a sequential grid. A
// Hopper block has 227 KB of shared memory (one [64, 901] f32 score block is
// 231 KB) and blocks run in parallel in no order. bf16 runs on the tensor
// cores' warp-level path: blocks of 4 warps, each warp owning 16 rows (q
// rows, or keys in dk/dv) whose fixed operand it holds as mma.sync A
// fragments; the streamed tiles double-buffered in shared memory by
// cp.async (rows padded to 144 bytes, so ldmatrix is free of bank
// conflicts); every product mma.sync.m16n8k16 with f32 accumulators fed by
// ldmatrix (.trans where the tile is the [k][n] operand); each score tile
// (S, P, dP, dS) stays in registers and is rounded to bf16 in the
// accumulator layout to become the A operand of the next product. f32 runs
// the older kernels on the CUDA cores through shared tiles shaped for WMMA.
//   fwd   one block per (q tile of 64, h, b). bf16: one pass over 64-key
//         tiles, S = QK^T, an online softmax (row max and sum over the lane
//         quad that shares a row, the O sums rescaled), O += round(exp(S -
//         m)) V. f32: a pass for each row's max and sum, a second for the
//         normalized P and PV. Both save (m, l) [2, B*H*Nq].
//   bwd   bf16, two kernels on the current stream, each output written
//         once (no atomics: the backward gives the same bits every run):
//         dq    one block per (q tile, h, b): delta for its rows from
//               (dO, O) while its first tiles land, saved [B*H*Nq]; then one
//               pass over the key tiles: S, dP = dO V^T, P from (m, l),
//               dS = P (dP - delta), dQ += dS K;
//         dkdv  one block per (k tile, h, b), K and V in registers, looping
//               over the q tiles in order (as `_attn_bwd_loopq_kernel` loops
//               its q blocks) with Q, dO and their rows' (m, l, delta)
//               double-buffered: S^T = K Q^T, P^T, dV += P^T dO,
//               dP^T = V dO^T, dS^T, dK += dS^T (q*scale).
//         That is seven tile products where five would do (S and dP are
//         formed in both kernels): the price of no atomics on dq.
//         f32: the same two kernels' older form (dq makes a first pass for
//         delta = sum(p * dp)).
//         db    (both dtypes) one block per (k tile, q tile or all of q,
//               cell of the bias): loops over the (b, h) that share this
//               bias cell, b = 0, 1, ... outermost, then h, then the q tiles
//               in order, recomputes S, P, dP and ds and sums ds in
//               registers; a bias with one q row sums its columns over the
//               block's rows in a fixed order. Each db element is written
//               once by one block: no atomics and no [B, H, Nq, Nk] scratch.
//               Without a bias, or with one that needs no gradient (a
//               padding mask), it is not launched.
//
// What bounds it. At the CLIP-ViT-B/16 shape (B = 32, N = 577, H = 12,
// bf16, no bias) the forward must move 113.4 MB (q, k, v in; out) and do
// 32.7 GFLOP: 0.034 ms by bytes at 3.35 TB/s; the backward 198.5 MB (q, k, v,
// dout in; dq, dk, dv out) and 81.8 GFLOP: 0.083 ms by operations at
// 989 TFLOP/s. The tile products are bounded by the mma.sync rate, below
// wgmma's, at 2 or 3 blocks of 4 warps an SM (163 to 228 registers a
// thread) over 3,840 blocks; the 64-row tiles pad 577 to 640 (23 % more
// products), and the backward's seven products where five would do cost
// 40 % more. wgmma fed by TMA, with a producer warp, is the next step.
#include "attention_tiles.cuh"

#include <cstring>

namespace {

constexpr int KT = 64;          // key tile
constexpr int QT = 64;          // q tile of the forward, dq and db kernels
constexpr int QT_DKV = 32;      // q tile of the dk/dv kernel
constexpr int ROWS_PER_WARP = QT / WARPS;

// Sizes and element strides, in the order of the wrapper's int64 array.
struct Dims {
  long long B, Nq, Nk, H;
  long long q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, g_sb, g_sn;  // batch, row
  long long bias_sb, bias_sh, bias_sq;  // 0 along a broadcast dim
  long long bias_b, bias_h, bias_q;     // the bias's sizes: 1 or B, H, Nq
};
static_assert(sizeof(Dims) == 18 * sizeof(long long), "Dims is the wrapper's int64[18]");

// The bias, f32 or bf16, or none (a null base adds 0 to every score).
struct Bias {
  const void* base;
  int is_bf16;

  // row (b, h, q) of the bias, or null
  __device__ const void* row(const Dims& d, int b, int h, int q) const {
    if (!base) return nullptr;
    const size_t off =
        (size_t)b * d.bias_sb + (size_t)h * d.bias_sh + (size_t)q * d.bias_sq;
    return is_bf16 ? static_cast<const void*>(static_cast<const bf16*>(base) + off)
                   : static_cast<const void*>(static_cast<const float*>(base) + off);
  }
  __device__ float at(const void* r, int k) const {
    if (!r) return 0.f;
    return is_bf16 ? __bfloat162float(static_cast<const bf16*>(r)[k])
                   : static_cast<const float*>(r)[k];
  }
};

// softmax probability from the score, its bias and the row's max and sum;
// the same expression in every kernel
__device__ __forceinline__ float prob(float s, float bias, float m, float l) {
  const float v = s + bias;
  return expf(v - m) / l;
}

__device__ __forceinline__ int tiles_up(int n, int t) { return (n + t - 1) / t * t; }

// ---------------------------------------------------------------------------
// forward: grid (ceil(Nq/64), H, B). stats: [2][B*H*Nq] = row max, row sum.

template <typename T>
__global__ void __launch_bounds__(THREADS)
xfm_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, Bias bias, T* __restrict__ out,
                    float* __restrict__ stats, Dims d, float scale) {
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int Nq = (int)d.Nq, Nk = (int)d.Nk, H = (int)d.H, C = H * D;
  const int Nkp = tiles_up(Nk, KT);
  const size_t BHN = (size_t)d.B * H * Nq;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* KV = Qs + QT * LDT;
  T* Ps = KV + KT * LDT;
  float* S = reinterpret_cast<float*>(Ps + QT * LDT);
  float* O = S + QT * LDF;
  __shared__ float row_m[QT], row_l[QT];
  __shared__ const void* brow[QT];

  if (threadIdx.x < QT) {
    const int qq = q0 + threadIdx.x;
    brow[threadIdx.x] = qq < Nq ? bias.row(d, b, h, qq) : nullptr;
  }
  const T* qb = q + (size_t)b * d.q_sb + h * D;
  const T* kb = k + (size_t)b * d.k_sb + h * D;
  const T* vb = v + (size_t)b * d.v_sb + h * D;
  RowFetch<T, KT> kv;
  kv.fetch(kb, (int)d.k_sn, 0, Nk);
  load_rows<T, QT>(qb, (int)d.q_sn, q0, Nq, Qs, true, scale);

  // pass 1: row max and sum, online over the key tiles; warp w owns rows
  // w, w + 8, ...
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float m[ROWS_PER_WARP], l[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < Nkp; k0 += KT) {
    kv.put(KV, false, 1.f);
    __syncthreads();
    // next K tile, or the first one again for pass 2
    kv.fetch(kb, (int)d.k_sn, k0 + KT < Nkp ? k0 + KT : 0, Nk);
    tile_mma<T, QT, D, false, true>(Qs, LDT, KV, LDT, S, LDF, false);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp + i * WARPS;
      if (q0 + r >= Nq) continue;
      float x[2], tmax = -INFINITY;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t, kk = k0 + c;
        x[t] = kk < Nk ? S[r * LDF + c] + bias.at(brow[r], kk) : -INFINITY;
        tmax = fmaxf(tmax, x[t]);
      }
      const float mn = fmaxf(m[i], warp_max(tmax));
      float e = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t)
        if (k0 + lane + 32 * t < Nk) e += expf(x[t] - mn);
      l[i] = l[i] * expf(m[i] - mn) + warp_sum(e);
      m[i] = mn;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp + i * WARPS, qq = q0 + r;
      row_m[r] = m[i];
      row_l[r] = l[i];
      if (qq < Nq) {
        const size_t idx = ((size_t)b * H + h) * Nq + qq;
        stats[idx] = m[i];
        stats[BHN + idx] = l[i];
      }
    }
  }

  // pass 2: normalized P, rounded, times V
  for (int k0 = 0; k0 < Nkp; k0 += KT) {
    kv.put(KV, false, 1.f);  // K tile k0
    __syncthreads();
    kv.fetch(vb, (int)d.v_sn, k0, Nk);  // V tile k0 lands during the products
    tile_mma<T, QT, D, false, true>(Qs, LDT, KV, LDT, S, LDF, false);
    __syncthreads();
    for (int i = threadIdx.x; i < QT * KT; i += THREADS) {
      const int r = i / KT, c = i % KT, kk = k0 + c;
      float p = 0.f;
      if (q0 + r < Nq && kk < Nk)
        p = prob(S[r * LDF + c], bias.at(brow[r], kk), row_m[r], row_l[r]);
      Ps[r * LDT + c] = from_f<T>(p);
    }
    kv.put(KV, false, 1.f);  // V tile k0
    __syncthreads();
    if (k0 + KT < Nkp) kv.fetch(kb, (int)d.k_sn, k0 + KT, Nk);
    tile_mma<T, QT, KT, false, false>(Ps, LDT, KV, LDT, O, LDF, k0 > 0);
    __syncthreads();
  }
  store_rows<T, QT>(O, out + (size_t)b * Nq * C + h * D, C, q0, Nq, 1.f);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores' warp-level path: mma.sync.m16n8k16 products whose
// operands come from shared memory through ldmatrix and whose accumulators
// (S, P, O) stay in registers; tiles reach shared memory through cp.async,
// the next one while this one computes.

constexpr int MMA_THREADS = 128;  // 4 warps, 16 rows of the block's 64 each
constexpr int MT = 64;            // rows of a block's tile (q rows or keys)
static_assert(MT == QT && MT == KT, "the mma kernels tile q and keys by 64");

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
// m both about -1e9) loses nothing to the size of m.
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

// A warp's S tile (its 16 q rows x keys k0 .. k0 + 63) plus the bias rows
// `brow` of the lane's two rows (null: none), keys at or past Nk set to
// -inf; the bias is read only where it exists, the mask only on the last
// tile.
__device__ __forceinline__ void add_bias_and_mask(float (&s)[8][4], const Bias& bias,
                                                  const void* const (&brow)[2], int k0,
                                                  int Nk, int t) {
  const bool tail = k0 + KT > Nk;
  if (!bias.base && !tail) return;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = k0 + nt * 8 + 2 * t + (c & 1);
      if (key >= Nk)
        s[nt][c] = -INFINITY;
      else if (bias.base)
        s[nt][c] += bias.at(brow[c / 2], key);
    }
}

// ---------------------------------------------------------------------------
// forward, bf16: grid (ceil(Nq/64), H, B), 128 threads. One pass over the key
// tiles with an online softmax; warp w owns q rows 16w .. 16w + 15.

__global__ void __launch_bounds__(MMA_THREADS)
xfm_attn_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, Bias bias, bf16* __restrict__ out,
                        float* __restrict__ stats, Dims d, float scale) {
  const int q0 = blockIdx.x * MT, h = blockIdx.y, b = blockIdx.z;
  const int Nq = (int)d.Nq, Nk = (int)d.Nk, H = (int)d.H, C = H * D;
  const int nkt = (Nk + KT - 1) / KT;
  const size_t BHN = (size_t)d.B * H * Nq;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + MT * LDT;      // two K tiles
  bf16* Vs = Ks + 2 * KT * LDT;  // two V tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane / 4, t = lane % 4;
  const bf16* kb = k + (size_t)b * d.k_sb + h * D;
  const bf16* vb = v + (size_t)b * d.v_sb + h * D;

  tile_async(Qs, q + (size_t)b * d.q_sb + h * D, d.q_sn, q0, Nq);
  tile_async(Ks, kb, d.k_sn, 0, Nk);
  tile_async(Vs, vb, d.v_sn, 0, Nk);
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
  const void* brow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + g + 8 * i;
    brow[i] = row[i] < Nq ? bias.row(d, b, h, row[i]) : nullptr;
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
      cp_async_commit();
    }
    float s[8][4];
    zero(s);
    warp_tile_mma<false>(s, qf, Kt);
    add_bias_and_mask(s, bias, brow, k0, Nk, t);
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
  bf16* ob = out + (size_t)b * Nq * C + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Nq) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<unsigned*>(ob + (size_t)row[i] * C + nt * 8 + 2 * t) =
          pack_bf16(o[nt][2 * i] / l[i], o[nt][2 * i + 1] / l[i]);
    if (t == 0) {
      const size_t idx = ((size_t)b * H + h) * Nq + row[i];
      stats[idx] = m[i];
      stats[BHN + idx] = l[i];
    }
  }
}

// ---------------------------------------------------------------------------
// backward, bf16, 1/2: delta and dq. grid (ceil(Nq/64), H, B), 128 threads;
// warp w owns q rows 16w .. 16w + 15 and makes one pass over the key tiles.

__global__ void __launch_bounds__(MMA_THREADS)
xfm_attn_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, Bias bias,
                           const bf16* __restrict__ out, const bf16* __restrict__ dout,
                           const float* __restrict__ stats, float* __restrict__ delta_out,
                           bf16* __restrict__ dq, Dims d, float scale) {
  const int q0 = blockIdx.x * MT, h = blockIdx.y, b = blockIdx.z;
  const int Nq = (int)d.Nq, Nk = (int)d.Nk, H = (int)d.H, C = H * D;
  const int nkt = (Nk + KT - 1) / KT;
  const size_t BHN = (size_t)d.B * H * Nq;
  const size_t row0 = ((size_t)b * H + h) * Nq;  // (b, h, q = 0)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + MT * LDT;      // dO
  bf16* Ks = Gs + MT * LDT;      // two K tiles
  bf16* Vs = Ks + 2 * KT * LDT;  // two V tiles
  __shared__ float row_delta[MT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane / 4, t = lane % 4;
  const bf16* kb = k + (size_t)b * d.k_sb + h * D;
  const bf16* vb = v + (size_t)b * d.v_sb + h * D;
  const bf16* gb = dout + (size_t)b * d.g_sb + h * D;

  tile_async(Qs, q + (size_t)b * d.q_sb + h * D, d.q_sn, q0, Nq);
  tile_async(Gs, gb, d.g_sn, q0, Nq);
  tile_async(Ks, kb, d.k_sn, 0, Nk);
  tile_async(Vs, vb, d.v_sn, 0, Nk);
  cp_async_commit();
  {  // delta = rowsum(dO (.) O) in f32 while the tiles land: two threads a
     // row, 32 products each in order, then their sum
    const int r = threadIdx.x / 2, half = threadIdx.x % 2, qq = q0 + r;
    float acc = 0.f;
    if (qq < Nq) {
      const bf16* op = out + ((size_t)b * Nq + qq) * C + h * D + half * 32;
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
  const void* brow[2];
  float m[2], nl[2], dl[2];  // row max, -log2(row sum), delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    row[i] = q0 + r;
    const bool in = row[i] < Nq;
    brow[i] = in ? bias.row(d, b, h, row[i]) : nullptr;
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
      cp_async_commit();
    }
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    warp_tile_mma<false>(s, qf, Kt);   // S = (q*scale) K^T
    warp_tile_mma<false>(dp, gf, Vt);  // dP = dO V^T
    add_bias_and_mask(s, bias, brow, k0, Nk, t);
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
  bf16* qb = dq + (size_t)b * Nq * C + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Nq) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<unsigned*>(qb + (size_t)row[i] * C + nt * 8 + 2 * t) =
          pack_bf16(dqa[nt][2 * i] * scale, dqa[nt][2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// backward, bf16, 2/2: dk and dv. grid (ceil(Nk/64), H, B), 128 threads;
// warp w owns keys 16w .. 16w + 15 (K and V as A fragments in registers) and
// the block loops over the q tiles in order, Q, dO and their rows' (m, l,
// delta) double-buffered; S^T, P^T, dP^T and dS^T never leave registers.

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

__global__ void __launch_bounds__(MMA_THREADS)
xfm_attn_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, Bias bias,
                             const bf16* __restrict__ dout, const float* __restrict__ stats,
                             const float* __restrict__ delta, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, Dims d, float scale) {
  const int k0 = blockIdx.x * KT, h = blockIdx.y, b = blockIdx.z;
  const int Nq = (int)d.Nq, Nk = (int)d.Nk, H = (int)d.H, C = H * D;
  const int nqt = (Nq + MT - 1) / MT;
  const size_t BHN = (size_t)d.B * H * Nq;
  const size_t row0 = ((size_t)b * H + h) * Nq;  // (b, h, q = 0)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + KT * LDT;
  bf16* Qs = Vs + KT * LDT;      // two q tiles (scaled)
  bf16* Gs = Qs + 2 * MT * LDT;  // two dO tiles
  __shared__ __align__(16) float sm[2][MT], snl[2][MT], sd[2][MT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane / 4, t = lane % 4;
  const bf16* qb = q + (size_t)b * d.q_sb + h * D;
  const bf16* gb = dout + (size_t)b * d.g_sb + h * D;
  // the row statistics of q tile `jt` into buffer `buf`: max, -log2(sum),
  // delta; rows past Nq get m = +inf, so their p = 2^-inf = 0
  auto stats_into = [&](int buf, int jt) {
    if (threadIdx.x < MT) {
      const int qq = jt * MT + threadIdx.x;
      const bool in = qq < Nq;
      sm[buf][threadIdx.x] = in ? stats[row0 + qq] : INFINITY;
      snl[buf][threadIdx.x] = in ? -log2f(stats[BHN + row0 + qq]) : 0.f;
      sd[buf][threadIdx.x] = in ? delta[row0 + qq] : 0.f;
    }
  };

  tile_async(Ks, k + (size_t)b * d.k_sb + h * D, d.k_sn, k0, Nk);
  tile_async(Vs, v + (size_t)b * d.v_sb + h * D, d.v_sn, k0, Nk);
  tile_async(Qs, qb, d.q_sn, 0, Nq);
  tile_async(Gs, gb, d.g_sn, 0, Nq);
  cp_async_commit();
  stats_into(0, 0);
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
    const int q0 = j * MT, cur = j & 1;
    const bf16* Qt = Qs + cur * MT * LDT;
    const bf16* Gt = Gs + cur * MT * LDT;
    if (j + 1 < nqt) {
      tile_async(Qs + (cur ^ 1) * MT * LDT, qb, d.q_sn, q0 + MT, Nq);
      tile_async(Gs + (cur ^ 1) * MT * LDT, gb, d.g_sn, q0 + MT, Nq);
      cp_async_commit();
      stats_into(cur ^ 1, j + 1);
    }
    float st[8][4];  // S^T: this warp's 16 keys x the tile's 64 q
    zero(st);
    warp_tile_mma<false>(st, kf, Qt);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + 2 * t;  // and col + 1
      const float2 cm = *reinterpret_cast<const float2*>(&sm[cur][col]);
      const float2 cl = *reinterpret_cast<const float2*>(&snl[cur][col]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qq = q0 + col + (c & 1), i = c / 2;
        float v = st[nt][c];
        if (bias.base && qq < Nq && key[i] < Nk) v += bias.at(bias.row(d, b, h, qq), key[i]);
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
      cp_async_wait_all();
      scale_own_chunks(Qs + (cur ^ 1) * MT * LDT, scale);
    }
    __syncthreads();
  }
  bf16* kout = dk + (size_t)b * Nk * C + h * D;
  bf16* vout = dv + (size_t)b * Nk * C + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Nk) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const size_t off = (size_t)key[i] * C + nt * 8 + 2 * t;
      *reinterpret_cast<unsigned*>(kout + off) = pack_bf16(dka[nt][2 * i], dka[nt][2 * i + 1]);
      *reinterpret_cast<unsigned*>(vout + off) = pack_bf16(dva[nt][2 * i], dva[nt][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward 1/3: delta and dq. grid (ceil(Nq/64), H, B).

template <typename T>
__global__ void __launch_bounds__(THREADS)
xfm_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, Bias bias, const T* __restrict__ dout,
                       const float* __restrict__ stats, float* __restrict__ delta_out,
                       T* __restrict__ dq, Dims d, float scale) {
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int Nq = (int)d.Nq, Nk = (int)d.Nk, H = (int)d.H, C = H * D;
  const int Nkp = tiles_up(Nk, KT);
  const size_t BHN = (size_t)d.B * H * Nq;
  const size_t row0 = ((size_t)b * H + h) * Nq;  // (b, h, q = 0)
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + QT * LDT;
  T* Ds = dOs + QT * LDT;
  T* Ks = Ds + QT * LDT;
  T* Vs = Ks + KT * LDT;
  float* S = reinterpret_cast<float*>(Vs + KT * LDT);
  float* dP = S + QT * LDF;
  float* dQ = dP + QT * LDF;
  __shared__ float row_m[QT], row_l[QT];
  __shared__ const void* brow[QT];

  if (threadIdx.x < QT) {
    const int qq = q0 + threadIdx.x;
    brow[threadIdx.x] = qq < Nq ? bias.row(d, b, h, qq) : nullptr;
    if (qq < Nq) {
      row_m[threadIdx.x] = stats[row0 + qq];
      row_l[threadIdx.x] = stats[BHN + row0 + qq];
    }
  }
  const T* kb = k + (size_t)b * d.k_sb + h * D;
  const T* vb = v + (size_t)b * d.v_sb + h * D;
  load_rows<T, QT>(q + (size_t)b * d.q_sb + h * D, (int)d.q_sn, q0, Nq, Qs, true, scale);
  load_rows<T, QT>(dout + (size_t)b * d.g_sb + h * D, (int)d.g_sn, q0, Nq, dOs, false, 1.f);

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float delta[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) delta[i] = 0.f;
  // pass A: delta = sum over keys of p * dp (per-lane partial sums)
  for (int k0 = 0; k0 < Nkp; k0 += KT) {
    load_rows<T, KT>(kb, (int)d.k_sn, k0, Nk, Ks, false, 1.f);
    load_rows<T, KT>(vb, (int)d.v_sn, k0, Nk, Vs, false, 1.f);
    __syncthreads();
    tile_mma<T, QT, D, false, true>(Qs, LDT, Ks, LDT, S, LDF, false);
    tile_mma<T, QT, D, false, true>(dOs, LDT, Vs, LDT, dP, LDF, false);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp + i * WARPS;
      if (q0 + r >= Nq) continue;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t, kk = k0 + c;
        if (kk < Nk)
          delta[i] += prob(S[r * LDF + c], bias.at(brow[r], kk), row_m[r], row_l[r]) *
                      dP[r * LDF + c];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    delta[i] = warp_sum(delta[i]);
    const int qq = q0 + warp + i * WARPS;
    if (lane == 0 && qq < Nq) delta_out[row0 + qq] = delta[i];
  }

  // pass B: ds = p * (dp - delta), rounded, into dq
  for (int k0 = 0; k0 < Nkp; k0 += KT) {
    load_rows<T, KT>(kb, (int)d.k_sn, k0, Nk, Ks, false, 1.f);
    load_rows<T, KT>(vb, (int)d.v_sn, k0, Nk, Vs, false, 1.f);
    __syncthreads();
    tile_mma<T, QT, D, false, true>(Qs, LDT, Ks, LDT, S, LDF, false);
    tile_mma<T, QT, D, false, true>(dOs, LDT, Vs, LDT, dP, LDF, false);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp + i * WARPS;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t, kk = k0 + c;
        float ds = 0.f;
        if (q0 + r < Nq && kk < Nk) {
          const float p = prob(S[r * LDF + c], bias.at(brow[r], kk), row_m[r], row_l[r]);
          ds = p * (dP[r * LDF + c] - delta[i]);
        }
        Ds[r * LDT + c] = from_f<T>(ds);
      }
    }
    __syncthreads();
    tile_mma<T, QT, KT, false, false>(Ds, LDT, Ks, LDT, dQ, LDF, k0 > 0);
    __syncthreads();
  }
  store_rows<T, QT>(dQ, dq + (size_t)b * Nq * C + h * D, C, q0, Nq, scale);
}

// ---------------------------------------------------------------------------
// backward 2/3: dk and dv. grid (ceil(Nk/64), H, B). P is recomputed from S
// and the forward's row max and sum, ds from dP and the saved delta.

template <typename T>
__global__ void __launch_bounds__(THREADS)
xfm_attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, Bias bias, const T* __restrict__ dout,
                         const float* __restrict__ stats, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, Dims d, float scale) {
  constexpr int M = QT_DKV;
  const int k0 = blockIdx.x * KT, h = blockIdx.y, b = blockIdx.z;
  const int Nq = (int)d.Nq, Nk = (int)d.Nk, H = (int)d.H, C = H * D;
  const size_t BHN = (size_t)d.B * H * Nq;
  const size_t row0 = ((size_t)b * H + h) * Nq;  // (b, h, q = 0)
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + KT * LDT;
  T* Qs = Vs + KT * LDT;
  T* dOs = Qs + M * LDT;
  T* Ps = dOs + M * LDT;
  T* Ds = Ps + M * LDT;
  float* St = reinterpret_cast<float*>(Ds + M * LDT);
  float* dPt = St + M * LDF;
  float* dK = dPt + M * LDF;
  float* dV = dK + KT * LDF;
  __shared__ float row_m[M], row_l[M], row_d[M];
  __shared__ const void* brow[M];

  const T* qb = q + (size_t)b * d.q_sb + h * D;
  const T* gb = dout + (size_t)b * d.g_sb + h * D;
  RowFetch<T, M> qf, gf;
  qf.fetch(qb, (int)d.q_sn, 0, Nq);
  gf.fetch(gb, (int)d.g_sn, 0, Nq);
  load_rows<T, KT>(k + (size_t)b * d.k_sb + h * D, (int)d.k_sn, k0, Nk, Ks, false, 1.f);
  load_rows<T, KT>(v + (size_t)b * d.v_sb + h * D, (int)d.v_sn, k0, Nk, Vs, false, 1.f);
  for (int q0 = 0; q0 < Nq; q0 += M) {
    qf.put(Qs, true, scale);
    gf.put(dOs, false, 1.f);
    if (threadIdx.x < M) {
      const int qq = q0 + threadIdx.x;
      brow[threadIdx.x] = qq < Nq ? bias.row(d, b, h, qq) : nullptr;
      if (qq < Nq) {
        row_m[threadIdx.x] = stats[row0 + qq];
        row_l[threadIdx.x] = stats[BHN + row0 + qq];
        row_d[threadIdx.x] = delta[row0 + qq];
      }
    }
    __syncthreads();
    if (q0 + M < Nq) {
      qf.fetch(qb, (int)d.q_sn, q0 + M, Nq);
      gf.fetch(gb, (int)d.g_sn, q0 + M, Nq);
    }
    tile_mma<T, M, D, false, true>(Qs, LDT, Ks, LDT, St, LDF, false);
    tile_mma<T, M, D, false, true>(dOs, LDT, Vs, LDT, dPt, LDF, false);
    __syncthreads();
    for (int i = threadIdx.x; i < M * KT; i += THREADS) {
      const int r = i / KT, c = i % KT, kk = k0 + c;
      float p = 0.f, ds = 0.f;
      if (q0 + r < Nq && kk < Nk) {
        p = prob(St[r * LDF + c], bias.at(brow[r], kk), row_m[r], row_l[r]);
        ds = p * (dPt[r * LDF + c] - row_d[r]);
      }
      Ps[r * LDT + c] = from_f<T>(p);
      Ds[r * LDT + c] = from_f<T>(ds);
    }
    __syncthreads();
    tile_mma<T, KT, M, true, false>(Ps, LDT, dOs, LDT, dV, LDF, q0 > 0);
    tile_mma<T, KT, M, true, false>(Ds, LDT, Qs, LDT, dK, LDF, q0 > 0);
    __syncthreads();
  }
  store_rows<T, KT>(dK, dk + (size_t)b * Nk * C + h * D, C, k0, Nk, 1.f);
  store_rows<T, KT>(dV, dv + (size_t)b * Nk * C + h * D, C, k0, Nk, 1.f);
}

// ---------------------------------------------------------------------------
// backward 3/3: db, f32 [bias_b, bias_h, bias_q, Nk] contiguous.
// grid (ceil(Nk/64), bias_q > 1 ? ceil(Nq/64) : 1, bias_b * bias_h).

template <typename T>
__global__ void __launch_bounds__(THREADS)
xfm_attn_bwd_db_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, Bias bias, const T* __restrict__ dout,
                       const float* __restrict__ stats, const float* __restrict__ delta,
                       float* __restrict__ db, Dims d, float scale) {
  constexpr int PER = QT * KT / THREADS;  // elements of a tile per thread
  const int k0 = blockIdx.x * KT, cell = blockIdx.z;
  const int B = (int)d.B, Nq = (int)d.Nq, Nk = (int)d.Nk, H = (int)d.H;
  const int Bb = (int)d.bias_b, Hb = (int)d.bias_h;
  const int bo = cell / Hb, ho = cell % Hb;
  const bool rows = d.bias_q > 1;  // db keeps the q rows
  const int b_lo = Bb > 1 ? bo : 0, b_hi = Bb > 1 ? bo + 1 : B;
  const int h_lo = Hb > 1 ? ho : 0, h_hi = Hb > 1 ? ho + 1 : H;
  const int q_lo = rows ? blockIdx.y * QT : 0;
  const int q_hi = rows ? min(q_lo + QT, Nq) : Nq;
  const size_t BHN = (size_t)B * H * Nq;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + QT * LDT;
  T* Ks = dOs + QT * LDT;
  T* Vs = Ks + KT * LDT;
  float* S = reinterpret_cast<float*>(Vs + KT * LDT);
  float* dP = S + QT * LDF;
  __shared__ float row_m[QT], row_l[QT], row_d[QT];
  __shared__ const void* brow[QT];

  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.f;
  for (int b = b_lo; b < b_hi; ++b) {
    for (int h = h_lo; h < h_hi; ++h) {
      const size_t row0 = ((size_t)b * H + h) * Nq;
      load_rows<T, KT>(k + (size_t)b * d.k_sb + h * D, (int)d.k_sn, k0, Nk, Ks, false, 1.f);
      load_rows<T, KT>(v + (size_t)b * d.v_sb + h * D, (int)d.v_sn, k0, Nk, Vs, false, 1.f);
      for (int q0 = q_lo; q0 < q_hi; q0 += QT) {
        load_rows<T, QT>(q + (size_t)b * d.q_sb + h * D, (int)d.q_sn, q0, Nq, Qs, true,
                         scale);
        load_rows<T, QT>(dout + (size_t)b * d.g_sb + h * D, (int)d.g_sn, q0, Nq, dOs,
                         false, 1.f);
        if (threadIdx.x < QT) {
          const int qq = q0 + threadIdx.x;
          brow[threadIdx.x] = qq < Nq ? bias.row(d, b, h, qq) : nullptr;
          if (qq < Nq) {
            row_m[threadIdx.x] = stats[row0 + qq];
            row_l[threadIdx.x] = stats[BHN + row0 + qq];
            row_d[threadIdx.x] = delta[row0 + qq];
          }
        }
        __syncthreads();
        tile_mma<T, QT, D, false, true>(Qs, LDT, Ks, LDT, S, LDF, false);
        tile_mma<T, QT, D, false, true>(dOs, LDT, Vs, LDT, dP, LDF, false);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int i = threadIdx.x + j * THREADS;
          const int r = i / KT, c = i % KT, kk = k0 + c;
          if (q0 + r < Nq && kk < Nk) {
            const float p = prob(S[r * LDF + c], bias.at(brow[r], kk), row_m[r], row_l[r]);
            acc[j] += p * (dP[r * LDF + c] - row_d[r]);
          }
        }
        __syncthreads();
      }
    }
  }
  const size_t out0 = (size_t)cell * (rows ? Nq : 1) * Nk;
  if (rows) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / KT, c = i % KT, qq = q_lo + r, kk = k0 + c;
      if (qq < Nq && kk < Nk) db[out0 + (size_t)qq * Nk + kk] = acc[j];
    }
  } else {
    // every element a thread holds is in column threadIdx.x % KT (THREADS is
    // a multiple of KT): sum them in order, then the THREADS / KT partial
    // sums of each column in a fixed order
    __shared__ float red[THREADS];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) s += acc[j];
    red[threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.x < KT) {
      float t = 0.f;
      for (int g = 0; g < THREADS / KT; ++g) t += red[g * KT + threadIdx.x];
      if (k0 + threadIdx.x < Nk) db[out0 + k0 + threadIdx.x] = t;
    }
  }
}

// ---------------------------------------------------------------------------
// host side

template <typename T>
size_t fwd_smem() {
  return (size_t)(2 * QT + KT) * LDT * sizeof(T) + (size_t)2 * QT * LDF * sizeof(float);
}
template <typename T>
size_t dq_smem() {
  return (size_t)(3 * QT + 2 * KT) * LDT * sizeof(T) + (size_t)3 * QT * LDF * sizeof(float);
}
template <typename T>
size_t dkdv_smem() {
  return (size_t)(2 * KT + 4 * QT_DKV) * LDT * sizeof(T) +
         (size_t)(2 * QT_DKV + 2 * KT) * LDF * sizeof(float);
}
template <typename T>
size_t db_smem() {
  return (size_t)(2 * QT + 2 * KT) * LDT * sizeof(T) + (size_t)2 * QT * LDF * sizeof(float);
}

Dims read_dims(const long long* v) {
  Dims d;
  std::memcpy(&d, v, sizeof(Dims));
  return d;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, Bias bias, void* out,
               void* stats, const Dims& d, float scale, cudaStream_t st) {
  dim3 grid((unsigned)((d.Nq + QT - 1) / QT), (unsigned)d.H, (unsigned)d.B);
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = (size_t)(MT + 4 * KT) * LDT * sizeof(bf16);
    cudaError_t e = allow_smem(xfm_attn_fwd_mma_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    xfm_attn_fwd_mma_kernel<<<grid, MMA_THREADS, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), bias, static_cast<bf16*>(out),
        static_cast<float*>(stats), d, scale);
  } else {
    const size_t smem = fwd_smem<T>();
    cudaError_t e = allow_smem(xfm_attn_fwd_kernel<T>, smem);
    if (e != cudaSuccess) return (int)e;
    xfm_attn_fwd_kernel<T><<<grid, THREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
        static_cast<T*>(out), static_cast<float*>(stats), d, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, Bias bias, const void* out,
               const void* dout, const void* stats, void* delta, void* dq, void* dk,
               void* dv, void* db, const Dims& d, float scale, cudaStream_t st) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* g = static_cast<const T*>(dout);
  const float* sts = static_cast<const float*>(stats);
  float* dl = static_cast<float*>(delta);
  cudaError_t e;
  dim3 g1((unsigned)((d.Nq + QT - 1) / QT), (unsigned)d.H, (unsigned)d.B);
  dim3 g2((unsigned)((d.Nk + KT - 1) / KT), (unsigned)d.H, (unsigned)d.B);

  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = (size_t)6 * MT * LDT * sizeof(bf16);
    if ((e = allow_smem(xfm_attn_bwd_dq_mma_kernel, smem)) != cudaSuccess) return (int)e;
    xfm_attn_bwd_dq_mma_kernel<<<g1, MMA_THREADS, smem, st>>>(
        tq, tk, tv, bias, static_cast<const bf16*>(out), g, sts, dl, static_cast<bf16*>(dq), d,
        scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if ((e = allow_smem(xfm_attn_bwd_dkdv_mma_kernel, smem)) != cudaSuccess) return (int)e;
    xfm_attn_bwd_dkdv_mma_kernel<<<g2, MMA_THREADS, smem, st>>>(
        tq, tk, tv, bias, g, sts, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv), d,
        scale);
  } else {
    size_t smem = dq_smem<T>();
    if ((e = allow_smem(xfm_attn_bwd_dq_kernel<T>, smem)) != cudaSuccess) return (int)e;
    xfm_attn_bwd_dq_kernel<T><<<g1, THREADS, smem, st>>>(tq, tk, tv, bias, g, sts, dl,
                                                         static_cast<T*>(dq), d, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    smem = dkdv_smem<T>();
    if ((e = allow_smem(xfm_attn_bwd_dkdv_kernel<T>, smem)) != cudaSuccess) return (int)e;
    xfm_attn_bwd_dkdv_kernel<T><<<g2, THREADS, smem, st>>>(
        tq, tk, tv, bias, g, sts, dl, static_cast<T*>(dk), static_cast<T*>(dv), d, scale);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (!db) return 0;

  const size_t smem = db_smem<T>();
  if ((e = allow_smem(xfm_attn_bwd_db_kernel<T>, smem)) != cudaSuccess) return (int)e;
  dim3 g3((unsigned)((d.Nk + KT - 1) / KT),
          (unsigned)(d.bias_q > 1 ? (d.Nq + QT - 1) / QT : 1),
          (unsigned)(d.bias_b * d.bias_h));
  xfm_attn_bwd_db_kernel<T><<<g3, THREADS, smem, st>>>(tq, tk, tv, bias, g, sts, dl,
                                                       static_cast<float*>(db), d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dims: int64[18] in the order of `Dims`. bias: null, or f32 (bias_bf16 = 0)
// or bf16 (bias_bf16 = 1). is_bf16: 1 for bf16 q/k/v/out, 0 for f32.
// out [B, Nq, H, 64] contiguous; stats f32 [2, B*H*Nq]. Returns a
// cudaError_t (0 on success).
extern "C" int xfm_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* bias, void* out, void* stats,
                                       const long long* dims, int bias_bf16, float scale,
                                       int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = read_dims(dims);
  const Bias bb{bias, bias_bf16};
  return is_bf16 ? launch_fwd<bf16>(q, k, v, bb, out, stats, d, scale, st)
                 : launch_fwd<float>(q, k, v, bb, out, stats, d, scale, st);
}

// out: the forward's output [B, Nq, H, 64] contiguous (the bf16 kernels take
// delta = rowsum(dout (.) out) from it; the f32 ones sum p * dp and do not
// read it). dq like q, dk and dv like k, contiguous; delta f32 [B*H*Nq]
// (scratch); db f32 [bias_b, bias_h, bias_q, Nk] contiguous, or null for no
// bias gradient.
extern "C" int xfm_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* bias, const void* out, const void* dout,
                                       const void* stats, void* delta, void* dq, void* dk,
                                       void* dv, void* db, const long long* dims,
                                       int bias_bf16, float scale, int is_bf16,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = read_dims(dims);
  const Bias bb{bias, bias_bf16};
  return is_bf16 ? launch_bwd<bf16>(q, k, v, bb, out, dout, stats, delta, dq, dk, dv, db, d,
                                    scale, st)
                 : launch_bwd<float>(q, k, v, bb, out, dout, stats, delta, dq, dk, dv, db, d,
                                     scale, st);
}
