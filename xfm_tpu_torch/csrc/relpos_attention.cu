// BEiT self-attention with the relative-position bias expanded inside the
// kernel from its compact block-Toeplitz form, forward and backward, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// xfm_tpu_torch/ops/flash_attention.py.
//
// Replaces the TPU kernels of xfm_tpu/ops/flash_attention.py
// `beit_attention_relpos` (:932): `_relpos_fwd_kernel` (:689) with
// `_relpos_scr_build` (:656), called at :838, and `_relpos_bwd_kernel`
// (:717), called at :880. Computes, per (row b, head h),
//     out = softmax((q*scale) k^T + bias_h) v
// with q, k, v read straight out of qkv [B, N, 3*H*D] (layout [q | k | v],
// heads contiguous inside each section), N = wh*ww + 1 for any window
// (wh, ww), D = 64, bf16 (tensor cores through WMMA, i.e. mma.sync) or f32
// (CUDA-core FMA). The table has the dtype of qkv.
//
// The compact bias (xfm_tpu/ops/relpos.py `compact_rel_pos`): cr [H, ww, L],
// L = (2wh-1)*ww, with the row-delta axis reversed, and cls3 [H, 3] f32 =
// (cls->patch, patch->cls, cls->cls). The bias it stands for is
//     bias[0, 0] = cc, bias[0, 1:] = c2a, bias[1:, 0] = a2c,
//     bias[1 + a*ww + ci, 1 + j] = cr[h, ci, (wh-1-a)*ww + j],  j < wh*ww,
// so the bias row of query 1 + a*ww + ci is one contiguous slice of the
// table: the kernels compute its offset once per row and read the bias
// element beside each score, coalesced, from the table (54 KB per head in
// bf16 at 384 px; it stays in L1/L2). The [H, N, N] bias never exists.
//
// Rounding points are the TPU kernel's: q is scaled in f32 and rounded to the
// input dtype before QK^T; scores plus bias and the softmax in f32; keys past
// N are masked out; the normalized P is rounded to the input dtype before PV
// and dV; ds = p * (dp - sum(p * dp)) in f32, rounded to the input dtype for
// dq and dk; dq is multiplied by the scale after its product; dk uses the
// rounded, scaled q; dk and dv accumulate in f32 and are rounded once.
//
// Design. The TPU kernel holds a whole [Nq, Nk] score block and the expanded
// bias in VMEM and carries the ds batch sum in scratch across a sequential
// grid. A Hopper block has 227 KB of shared memory (a [64, 960] f32 score
// block at 480 px alone is 246 KB) and blocks run in parallel in no order:
//   fwd   one block per (q tile of 64, h, b), two passes over 64-key tiles:
//         the first finds the row max and sum (online), the second forms the
//         normalized P, rounds it and accumulates PV; the row max and sum are
//         saved [2, B*H*N] for the backward.
//   bwd   four kernels on the current stream:
//         dq    one block per (q tile of 64, h, b): a pass over key tiles for
//               delta = sum(p * dp), a second pass for ds, which it writes as
//               f32 rows to a scratch [B, H, N, Npad], and dq = ds k;
//         dkdv  one block per (k tile of 64, h, b), looping over q tiles of
//               32: recomputes P from S and the saved row statistics, reads
//               ds back, dv += P^T dO, dk += ds^T q;
//         fold  one thread per dcr element sums the scratch over b (b = 0, 1,
//               ...) and then over the stripes a (a = 0, 1, ...), the TPU
//               kernel's order; one block per dcls entry sums its row or
//               column of the scratch in a fixed tree. No atomics, so dcr and
//               dcls are the same from run to run.
// S is recomputed from the same tiles in the same order in every kernel, so
// all of them see bit-identical probabilities.
//
// What bounds it. At the main shape (B = 32, N = 577, H = 12, bf16) the
// forward must move 114.1 MB and do 32.7 GFLOP: 0.034 ms by bytes at
// 3.35 TB/s; the backward 200.5 MB and 81.8 GFLOP: 0.083 ms by operations at
// 989 TFLOP/s. This first version is bounded by its own design, in order:
// the ds scratch, B*H*N*Npad*4 = 567 MB written once (dq) and read twice
// (dkdv, fold), 1.70 GB, holds the backward at 0.51 ms or more, 6x its
// bound; the forward computes QK^T twice and the backward S three times
// and dP twice (8 tile products where 5 would do); tiles are staged through
// shared memory with no TMA or wgmma. A scratch-free backward (ds summed
// over b inside a per-(h, q tile, k tile) block from the saved statistics)
// is the next step.
#include "attention_tiles.cuh"

namespace {

constexpr int KT = 64;          // key tile
constexpr int QT = 64;          // q tile of the forward and the dq kernel
constexpr int QT_DKV = 32;      // q tile of the dk/dv kernel
constexpr int ROWS_PER_WARP = QT / WARPS;

// Row code of a query row: its offset into the flattened table [H, ww, L]
// (the element of key column 1), or one of these.
constexpr int CLS_ROW = -1;     // row 0: the cls token's bias row
constexpr int PAD_ROW = -2;     // past N: never stored

struct ClsBias {
  float c2a, a2c, cc;
};

__device__ __forceinline__ int row_code(int q, int N, int h, int wh, int ww, int L) {
  if (q >= N) return PAD_ROW;
  if (q == 0) return CLS_ROW;
  const int i = q - 1, a = i / ww, ci = i - a * ww;
  return (h * ww + ci) * L + (wh - 1 - a) * ww;
}

// bias(q, k) of a row with code `rc` != PAD_ROW, for a key k < N
template <typename T>
__device__ __forceinline__ float bias_at(const T* __restrict__ cr, const ClsBias& cls,
                                         int rc, int k) {
  if (rc == CLS_ROW) return k == 0 ? cls.cc : cls.c2a;
  return k == 0 ? cls.a2c : to_f(cr[rc + k - 1]);
}

// softmax probability from the score, its bias and the row's max and sum;
// the same expression in every kernel
__device__ __forceinline__ float prob(float s, float bias, float m, float l) {
  const float v = s + bias;
  return expf(v - m) / l;
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(N/64), H, B). stats: [2][B*H*N] = row max, row sum.

template <typename T>
__global__ void __launch_bounds__(THREADS)
relpos_fwd_kernel(const T* __restrict__ qkv, const T* __restrict__ cr,
                  const float* __restrict__ cls3, T* __restrict__ out,
                  float* __restrict__ stats, int B, int N, int H, int wh, int ww,
                  int Npad, float scale) {
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D, C3 = 3 * C, L = (2 * wh - 1) * ww;
  const size_t BHN = (size_t)B * H * N;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* KV = Qs + QT * LDT;
  T* Ps = KV + KT * LDT;
  float* S = reinterpret_cast<float*>(Ps + QT * LDT);
  float* O = S + QT * LDF;
  __shared__ float row_m[QT], row_l[QT];
  __shared__ int rcode[QT];

  const ClsBias cls{cls3[h * 3], cls3[h * 3 + 1], cls3[h * 3 + 2]};
  if (threadIdx.x < QT) rcode[threadIdx.x] = row_code(q0 + threadIdx.x, N, h, wh, ww, L);
  const T* base = qkv + (size_t)b * N * C3 + h * D;
  RowFetch<T, KT> kv;
  kv.fetch(base + C, C3, 0, N);
  load_rows<T, QT>(base, C3, q0, N, Qs, true, scale);

  // pass 1: row max and sum, online over the key tiles; warp w owns rows
  // w, w + 8, ...
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float m[ROWS_PER_WARP], l[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < Npad; k0 += KT) {
    kv.put(KV, false, 1.f);
    __syncthreads();
    // next K tile, or the first one again for pass 2
    kv.fetch(base + C, C3, k0 + KT < Npad ? k0 + KT : 0, N);
    tile_mma<T, QT, D, false, true>(Qs, LDT, KV, LDT, S, LDF, false);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp + i * WARPS, rc = rcode[r];
      if (rc == PAD_ROW) continue;
      float v[2], tmax = -INFINITY;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t, k = k0 + c;
        v[t] = k < N ? S[r * LDF + c] + bias_at(cr, cls, rc, k) : -INFINITY;
        tmax = fmaxf(tmax, v[t]);
      }
      const float mn = fmaxf(m[i], warp_max(tmax));
      float e = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t)
        if (k0 + lane + 32 * t < N) e += expf(v[t] - mn);
      l[i] = l[i] * expf(m[i] - mn) + warp_sum(e);
      m[i] = mn;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp + i * WARPS, q = q0 + r;
      row_m[r] = m[i];
      row_l[r] = l[i];
      if (q < N) {
        const size_t idx = ((size_t)b * H + h) * N + q;
        stats[idx] = m[i];
        stats[BHN + idx] = l[i];
      }
    }
  }

  // pass 2: normalized P, rounded, times V
  for (int k0 = 0; k0 < Npad; k0 += KT) {
    kv.put(KV, false, 1.f);  // K tile k0
    __syncthreads();
    kv.fetch(base + 2 * C, C3, k0, N);  // V tile k0 lands during the products
    tile_mma<T, QT, D, false, true>(Qs, LDT, KV, LDT, S, LDF, false);
    __syncthreads();
    for (int i = threadIdx.x; i < QT * KT; i += THREADS) {
      const int r = i / KT, c = i % KT, k = k0 + c, rc = rcode[r];
      float p = 0.f;
      if (rc != PAD_ROW && k < N)
        p = prob(S[r * LDF + c], bias_at(cr, cls, rc, k), row_m[r], row_l[r]);
      Ps[r * LDT + c] = from_f<T>(p);
    }
    kv.put(KV, false, 1.f);  // V tile k0
    __syncthreads();
    if (k0 + KT < Npad) kv.fetch(base + C, C3, k0 + KT, N);
    tile_mma<T, QT, KT, false, false>(Ps, LDT, KV, LDT, O, LDF, k0 > 0);
    __syncthreads();
  }
  store_rows<T, QT>(O, out + (size_t)b * N * C + h * D, C, q0, N, 1.f);
}

// ---------------------------------------------------------------------------
// backward 1/3: dq and the ds scratch. grid (ceil(N/64), H, B).

template <typename T>
__global__ void __launch_bounds__(THREADS)
relpos_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ cr,
                     const float* __restrict__ cls3, const float* __restrict__ stats,
                     const T* __restrict__ dout, T* __restrict__ dqkv,
                     float* __restrict__ ds_rows, int B, int N, int H, int wh,
                     int ww, int Npad, float scale) {
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D, C3 = 3 * C, L = (2 * wh - 1) * ww;
  const size_t BHN = (size_t)B * H * N;
  const size_t row0 = ((size_t)b * H + h) * N;  // (b, h, q = 0)
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
  __shared__ int rcode[QT];

  const ClsBias cls{cls3[h * 3], cls3[h * 3 + 1], cls3[h * 3 + 2]};
  if (threadIdx.x < QT) {
    const int q = q0 + threadIdx.x;
    rcode[threadIdx.x] = row_code(q, N, h, wh, ww, L);
    if (q < N) {
      row_m[threadIdx.x] = stats[row0 + q];
      row_l[threadIdx.x] = stats[BHN + row0 + q];
    }
  }
  const T* base = qkv + (size_t)b * N * C3 + h * D;
  load_rows<T, QT>(base, C3, q0, N, Qs, true, scale);
  load_rows<T, QT>(dout + (size_t)b * N * C + h * D, C, q0, N, dOs, false, 1.f);

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float delta[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) delta[i] = 0.f;
  // pass A: delta = sum over keys of p * dp (per-lane partial sums)
  for (int k0 = 0; k0 < Npad; k0 += KT) {
    load_rows<T, KT>(base + C, C3, k0, N, Ks, false, 1.f);
    load_rows<T, KT>(base + 2 * C, C3, k0, N, Vs, false, 1.f);
    __syncthreads();
    tile_mma<T, QT, D, false, true>(Qs, LDT, Ks, LDT, S, LDF, false);
    tile_mma<T, QT, D, false, true>(dOs, LDT, Vs, LDT, dP, LDF, false);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp + i * WARPS, rc = rcode[r];
      if (rc == PAD_ROW) continue;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t, k = k0 + c;
        if (k < N)
          delta[i] += prob(S[r * LDF + c], bias_at(cr, cls, rc, k), row_m[r], row_l[r]) *
                      dP[r * LDF + c];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) delta[i] = warp_sum(delta[i]);

  // pass B: ds = p * (dp - delta) to the scratch and, rounded, into dq
  for (int k0 = 0; k0 < Npad; k0 += KT) {
    load_rows<T, KT>(base + C, C3, k0, N, Ks, false, 1.f);
    load_rows<T, KT>(base + 2 * C, C3, k0, N, Vs, false, 1.f);
    __syncthreads();
    tile_mma<T, QT, D, false, true>(Qs, LDT, Ks, LDT, S, LDF, false);
    tile_mma<T, QT, D, false, true>(dOs, LDT, Vs, LDT, dP, LDF, false);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp + i * WARPS, rc = rcode[r];
      float* ds_row = ds_rows + (row0 + q0 + r) * Npad;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t, k = k0 + c;
        float ds = 0.f;
        if (rc != PAD_ROW && k < N) {
          const float p = prob(S[r * LDF + c], bias_at(cr, cls, rc, k), row_m[r], row_l[r]);
          ds = p * (dP[r * LDF + c] - delta[i]);
          ds_row[k] = ds;
        }
        Ds[r * LDT + c] = from_f<T>(ds);
      }
    }
    __syncthreads();
    tile_mma<T, QT, KT, false, false>(Ds, LDT, Ks, LDT, dQ, LDF, k0 > 0);
    __syncthreads();
  }
  store_rows<T, QT>(dQ, dqkv + (size_t)b * N * C3 + h * D, C3, q0, N, scale);
}

// ---------------------------------------------------------------------------
// backward 2/3: dk and dv. grid (Npad/64, H, B). P is recomputed from S and
// the forward's row max and sum; ds is read back from the scratch.

template <typename T>
__global__ void __launch_bounds__(THREADS)
relpos_bwd_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ cr,
                       const float* __restrict__ cls3, const float* __restrict__ stats,
                       const T* __restrict__ dout, T* __restrict__ dqkv,
                       const float* __restrict__ ds_rows, int B, int N, int H,
                       int wh, int ww, int Npad, float scale) {
  constexpr int M = QT_DKV;
  const int k0 = blockIdx.x * KT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D, C3 = 3 * C, L = (2 * wh - 1) * ww;
  const size_t BHN = (size_t)B * H * N;
  const size_t row0 = ((size_t)b * H + h) * N;  // (b, h, q = 0)
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Qs = Ks + KT * LDT;
  T* dOs = Qs + M * LDT;
  T* Ps = dOs + M * LDT;
  T* Ds = Ps + M * LDT;
  float* St = reinterpret_cast<float*>(Ds + M * LDT);
  float* dK = St + M * LDF;
  float* dV = dK + KT * LDF;
  __shared__ float row_m[M], row_l[M];
  __shared__ int rcode[M];

  const ClsBias cls{cls3[h * 3], cls3[h * 3 + 1], cls3[h * 3 + 2]};
  const T* base = qkv + (size_t)b * N * C3 + h * D;
  const T* dbase = dout + (size_t)b * N * C + h * D;
  RowFetch<T, M> qf, gf;
  qf.fetch(base, C3, 0, N);
  gf.fetch(dbase, C, 0, N);
  load_rows<T, KT>(base + C, C3, k0, N, Ks, false, 1.f);
  for (int q0 = 0; q0 < N; q0 += M) {
    qf.put(Qs, true, scale);
    gf.put(dOs, false, 1.f);
    if (threadIdx.x < M) {
      const int q = q0 + threadIdx.x;
      rcode[threadIdx.x] = row_code(q, N, h, wh, ww, L);
      if (q < N) {
        row_m[threadIdx.x] = stats[row0 + q];
        row_l[threadIdx.x] = stats[BHN + row0 + q];
      }
    }
    __syncthreads();
    if (q0 + M < N) {
      qf.fetch(base, C3, q0 + M, N);
      gf.fetch(dbase, C, q0 + M, N);
    }
    tile_mma<T, M, D, false, true>(Qs, LDT, Ks, LDT, St, LDF, false);
    __syncthreads();
    for (int i = threadIdx.x; i < M * KT; i += THREADS) {
      const int r = i / KT, c = i % KT, k = k0 + c, rc = rcode[r];
      float p = 0.f, ds = 0.f;
      if (rc != PAD_ROW && k < N) {
        p = prob(St[r * LDF + c], bias_at(cr, cls, rc, k), row_m[r], row_l[r]);
        ds = ds_rows[(row0 + q0 + r) * Npad + k];
      }
      Ps[r * LDT + c] = from_f<T>(p);
      Ds[r * LDT + c] = from_f<T>(ds);
    }
    __syncthreads();
    tile_mma<T, KT, M, true, false>(Ps, LDT, dOs, LDT, dV, LDF, q0 > 0);
    tile_mma<T, KT, M, true, false>(Ds, LDT, Qs, LDT, dK, LDF, q0 > 0);
    __syncthreads();
  }
  T* gbase = dqkv + (size_t)b * N * C3 + h * D;
  store_rows<T, KT>(dK, gbase + C, C3, k0, N, 1.f);
  store_rows<T, KT>(dV, gbase + 2 * C, C3, k0, N, 1.f);
}

// ---------------------------------------------------------------------------
// backward 3/3: the scratch folded into the compact gradients.
// dcr[h, ci, e] = sum over stripes a = 0, 1, ... of (sum over b = 0, 1, ...
// of ds[b, h, 1 + a*ww + ci, 1 + j]), j = e - (wh-1-a)*ww in [0, wh*ww).

__global__ void __launch_bounds__(THREADS)
relpos_fold_dcr_kernel(const float* __restrict__ ds_rows, float* __restrict__ dcr,
                       int B, int N, int H, int wh, int ww, int Npad) {
  const int L = (2 * wh - 1) * ww, P = wh * ww, total = H * ww * L;
  const size_t batch_stride = (size_t)H * N * Npad;
  for (int idx = blockIdx.x * THREADS + threadIdx.x; idx < total;
       idx += gridDim.x * THREADS) {
    const int h = idx / (ww * L), rem = idx - h * ww * L;
    const int ci = rem / L, e = rem - ci * L;
    float acc = 0.f;
    for (int a = 0; a < wh; ++a) {
      const int j = e - (wh - 1 - a) * ww;
      if (j < 0 || j >= P) continue;
      const size_t off = ((size_t)h * N + 1 + a * ww + ci) * Npad + 1 + j;
      float t = 0.f;
      for (int bb = 0; bb < B; ++bb) t += ds_rows[off + bb * batch_stride];
      acc += t;
    }
    dcr[idx] = acc;
  }
}

// dcls[h] = (sum of ds[:, h, 0, 1:], sum of ds[:, h, 1:, 0], sum of
// ds[:, h, 0, 0]): one block per entry, each thread sums over b then over
// its keys, and the block sums the threads in a fixed tree.
__global__ void __launch_bounds__(THREADS)
relpos_fold_dcls_kernel(const float* __restrict__ ds_rows, float* __restrict__ dcls,
                        int B, int N, int H, int Npad) {
  const int h = blockIdx.x / 3, which = blockIdx.x % 3;
  const size_t batch_stride = (size_t)H * N * Npad, head = (size_t)h * N * Npad;
  float acc = 0.f;
  if (which == 2) {
    if (threadIdx.x == 0)
      for (int bb = 0; bb < B; ++bb) acc += ds_rows[head + bb * batch_stride];
  } else {
    for (int j = 1 + threadIdx.x; j < N; j += THREADS) {
      const size_t off = head + (which == 0 ? (size_t)j : (size_t)j * Npad);
      float t = 0.f;
      for (int bb = 0; bb < B; ++bb) t += ds_rows[off + bb * batch_stride];
      acc += t;
    }
  }
  __shared__ float red[THREADS];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) dcls[h * 3 + which] = red[0];
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
  return (size_t)(KT + 4 * QT_DKV) * LDT * sizeof(T) +
         (size_t)(QT_DKV + 2 * KT) * LDF * sizeof(float);
}

template <typename T>
int launch_fwd(const void* qkv, const void* cr, const void* cls3, void* out,
               void* stats, int B, int N, int H, int wh, int ww, float scale,
               cudaStream_t st) {
  const int Npad = round_up(N, KT);
  const size_t smem = fwd_smem<T>();
  cudaError_t e = allow_smem(relpos_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + QT - 1) / QT, H, B);
  relpos_fwd_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(cr),
      static_cast<const float*>(cls3), static_cast<T*>(out),
      static_cast<float*>(stats), B, N, H, wh, ww, Npad, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* qkv, const void* cr, const void* cls3, const void* stats,
               const void* dout, void* dqkv, void* dcr, void* dcls, void* ds_rows,
               int B, int N, int H, int wh, int ww, float scale, cudaStream_t st) {
  const int Npad = round_up(N, KT);
  const T* q = static_cast<const T*>(qkv);
  const T* tab = static_cast<const T*>(cr);
  const float* cls = static_cast<const float*>(cls3);
  const float* sts = static_cast<const float*>(stats);
  const T* g = static_cast<const T*>(dout);
  T* dq = static_cast<T*>(dqkv);
  float* dsr = static_cast<float*>(ds_rows);
  cudaError_t e;

  size_t smem = dq_smem<T>();
  if ((e = allow_smem(relpos_bwd_dq_kernel<T>, smem)) != cudaSuccess) return (int)e;
  dim3 g1((N + QT - 1) / QT, H, B);
  relpos_bwd_dq_kernel<T><<<g1, THREADS, smem, st>>>(q, tab, cls, sts, g, dq, dsr, B, N,
                                                     H, wh, ww, Npad, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  smem = dkdv_smem<T>();
  if ((e = allow_smem(relpos_bwd_dkdv_kernel<T>, smem)) != cudaSuccess) return (int)e;
  dim3 g2(Npad / KT, H, B);
  relpos_bwd_dkdv_kernel<T><<<g2, THREADS, smem, st>>>(q, tab, cls, sts, g, dq, dsr, B,
                                                       N, H, wh, ww, Npad, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const int total = H * ww * (2 * wh - 1) * ww;
  const int g3 = (total + THREADS - 1) / THREADS < 132 * 8
                     ? (total + THREADS - 1) / THREADS : 132 * 8;
  relpos_fold_dcr_kernel<<<g3, THREADS, 0, st>>>(dsr, static_cast<float*>(dcr), B, N,
                                                 H, wh, ww, Npad);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  relpos_fold_dcls_kernel<<<3 * H, THREADS, 0, st>>>(dsr, static_cast<float*>(dcls),
                                                     B, N, H, Npad);
  return (int)cudaGetLastError();
}

}  // namespace

// is_bf16: 1 for bf16 qkv/cr/out, 0 for f32. cr [H, ww, (2wh-1)*ww] in the
// dtype of qkv, cls3 f32 [H, 3], out [B, N, H*64], stats f32 [2, B*H*N].
// Returns a cudaError_t (0 on success).
extern "C" int xfm_relpos_attention_fwd(const void* qkv, const void* cr,
                                        const void* cls3, void* out, void* stats,
                                        int B, int N, int H, int wh, int ww,
                                        float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<bf16>(qkv, cr, cls3, out, stats, B, N, H, wh, ww, scale, st)
                 : launch_fwd<float>(qkv, cr, cls3, out, stats, B, N, H, wh, ww, scale, st);
}

// dqkv like qkv; dcr f32 [H, ww, (2wh-1)*ww]; dcls f32 [H, 3]; scratch
// ds_rows f32 [B, H, N, round_up(N, 64)].
extern "C" int xfm_relpos_attention_bwd(const void* qkv, const void* cr,
                                        const void* cls3, const void* stats,
                                        const void* dout, void* dqkv, void* dcr,
                                        void* dcls, void* ds_rows, int B, int N,
                                        int H, int wh, int ww, float scale,
                                        int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<bf16>(qkv, cr, cls3, stats, dout, dqkv, dcr, dcls, ds_rows,
                                    B, N, H, wh, ww, scale, st)
                 : launch_bwd<float>(qkv, cr, cls3, stats, dout, dqkv, dcr, dcls,
                                     ds_rows, B, N, H, wh, ww, scale, st);
}
