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
// 231 KB) and blocks run in parallel in no order. bf16 runs the kernels of
// attention_mma.cuh, shared with K2 (relpos_attention.cu) and instantiated
// here with `DenseBias`: mma.sync tiles held in registers, fed by cp.async
// (that header's note has the tile design). f32 runs the older kernels
// below on the CUDA cores through shared tiles shaped for WMMA.
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
//               its q blocks) with Q, dO and their rows' (m, l, delta, bias
//               row) double-buffered: S^T = K Q^T, P^T, dV += P^T dO,
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
#include "attention_mma.cuh"

#include <cstring>

namespace {

constexpr int QT = 64;          // q tile of the f32 forward, dq and db kernels
constexpr int QT_DKV = 32;      // q tile of the f32 dk/dv kernel
constexpr int ROWS_PER_WARP = QT / WARPS;

// The bias, f32 or bf16, [1|B, 1|H, 1|Nq, Nk] at the strides of Dims, or
// none (a null base adds 0 to every score).
struct DenseBias {
  const void* base;
  int is_bf16;

  // the bias of one (b, h): a row is a pointer to its Nk values, null past
  // Nq or without a bias (attention_mma.cuh names the interface)
  struct Head {
    const void* base;  // (b, h, q = 0), or null
    long long sq;
    int Nq, is_bf16;
    using Row = const void*;
    static constexpr bool TILE = false;  // read beside each score
    static constexpr bool TILE_F32 = false;

    __device__ bool present() const { return base != nullptr; }
    __device__ Row row(int q) const {
      if (!base || q >= Nq) return nullptr;
      return is_bf16 ? static_cast<Row>(static_cast<const bf16*>(base) + (size_t)q * sq)
                     : static_cast<Row>(static_cast<const float*>(base) + (size_t)q * sq);
    }
    __device__ float at(Row r, int k) const {
      if (!r) return 0.f;
      return is_bf16 ? __bfloat162float(static_cast<const bf16*>(r)[k])
                     : static_cast<const float*>(r)[k];
    }
  };

  __device__ Head head(const Dims& d, int b, int h) const {
    const size_t off = (size_t)b * d.bias_sb + (size_t)h * d.bias_sh;
    const void* p = !base    ? nullptr
                    : is_bf16 ? static_cast<const void*>(static_cast<const bf16*>(base) + off)
                              : static_cast<const void*>(static_cast<const float*>(base) + off);
    return Head{p, d.bias_sq, (int)d.Nq, is_bf16};
  }
};

// softmax probability from the score, its bias and the row's max and sum;
// the same expression in every f32 kernel
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
                    const T* __restrict__ v, DenseBias bias, T* __restrict__ out,
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
  const auto hb = bias.head(d, b, h);

  if (threadIdx.x < QT) {
    const int qq = q0 + threadIdx.x;
    brow[threadIdx.x] = hb.row(qq);
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
        x[t] = kk < Nk ? S[r * LDF + c] + hb.at(brow[r], kk) : -INFINITY;
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
        p = prob(S[r * LDF + c], hb.at(brow[r], kk), row_m[r], row_l[r]);
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
// backward 1/3: delta and dq. grid (ceil(Nq/64), H, B).

template <typename T>
__global__ void __launch_bounds__(THREADS)
xfm_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, DenseBias bias, const T* __restrict__ dout,
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
  const auto hb = bias.head(d, b, h);

  if (threadIdx.x < QT) {
    const int qq = q0 + threadIdx.x;
    brow[threadIdx.x] = hb.row(qq);
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
          delta[i] += prob(S[r * LDF + c], hb.at(brow[r], kk), row_m[r], row_l[r]) *
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
          const float p = prob(S[r * LDF + c], hb.at(brow[r], kk), row_m[r], row_l[r]);
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
                         const T* __restrict__ v, DenseBias bias, const T* __restrict__ dout,
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
  const auto hb = bias.head(d, b, h);

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
      brow[threadIdx.x] = hb.row(qq);
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
        p = prob(St[r * LDF + c], hb.at(brow[r], kk), row_m[r], row_l[r]);
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
                       const T* __restrict__ v, DenseBias bias, const T* __restrict__ dout,
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
      const auto hb = bias.head(d, b, h);
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
          brow[threadIdx.x] = hb.row(qq);
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
            const float p = prob(S[r * LDF + c], hb.at(brow[r], kk), row_m[r], row_l[r]);
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
int launch_fwd(const void* q, const void* k, const void* v, DenseBias bias, void* out,
               void* stats, const Dims& d, float scale, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_fwd_mma(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), bias, static_cast<bf16*>(out),
                          static_cast<float*>(stats), d, scale, st);
  } else {
    dim3 grid((unsigned)((d.Nq + QT - 1) / QT), (unsigned)d.H, (unsigned)d.B);
    const size_t smem = fwd_smem<T>();
    cudaError_t e = allow_smem(xfm_attn_fwd_kernel<T>, smem);
    if (e != cudaSuccess) return (int)e;
    xfm_attn_fwd_kernel<T><<<grid, THREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
        static_cast<T*>(out), static_cast<float*>(stats), d, scale);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, DenseBias bias, const void* out,
               const void* dout, const void* stats, void* delta, void* dq, void* dk,
               void* dv, void* db, const Dims& d, float scale, cudaStream_t st) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* g = static_cast<const T*>(dout);
  const float* sts = static_cast<const float*>(stats);
  float* dl = static_cast<float*>(delta);
  cudaError_t e;
  if constexpr (std::is_same<T, bf16>::value) {
    const int rc = launch_bwd_mma(tq, tk, tv, bias, static_cast<const bf16*>(out), g, sts,
                                  dl, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                                  static_cast<bf16*>(dv), d, scale, st);
    if (rc != 0) return rc;
  } else {
    dim3 g1((unsigned)((d.Nq + QT - 1) / QT), (unsigned)d.H, (unsigned)d.B);
    dim3 g2((unsigned)((d.Nk + KT - 1) / KT), (unsigned)d.H, (unsigned)d.B);
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

// dims: int64[24] in the order of `Dims` (attention_mma.cuh). bias: null, or
// f32 (bias_bf16 = 0) or bf16 (bias_bf16 = 1). is_bf16: 1 for bf16
// q/k/v/out, 0 for f32. out [B, Nq, H, 64] contiguous (its strides in dims;
// the f32 kernels take them as such); stats f32 [2, B*H*Nq]. Returns a
// cudaError_t (0 on success).
extern "C" int xfm_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* bias, void* out, void* stats,
                                       const long long* dims, int bias_bf16, float scale,
                                       int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = read_dims(dims);
  const DenseBias bb{bias, bias_bf16};
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
  const DenseBias bb{bias, bias_bf16};
  return is_bf16 ? launch_bwd<bf16>(q, k, v, bb, out, dout, stats, delta, dq, dk, dv, db, d,
                                    scale, st)
                 : launch_bwd<float>(q, k, v, bb, out, dout, stats, delta, dq, dk, dv, db, d,
                                     scale, st);
}
