// BEiT self-attention over the packed qkv projection, forward and backward,
// for Hopper (sm_90a). Plain C interface, loaded with ctypes by
// xfm_tpu_torch/ops/flash_attention.py.
//
// Replaces the TPU kernels xfm_tpu/ops/flash_attention.py
// `_packed_fwd_kernel` / `_packed_bwd_kernel` (public entry
// `flash_attention_packed`). Computes, per (row b, head h),
//     out = softmax((q*scale) k^T + bias) v
// with q, k, v read straight out of qkv [B, N, 3*H*D] (layout [q | k | v],
// heads contiguous inside each section) and bias [1, H, N, N] f32 shared by
// the batch. D = 64. Input dtype bf16 (tensor cores through WMMA, i.e.
// mma.sync) or f32 (CUDA-core FMA, full f32 products).
//
// Rounding points are the TPU kernel's: q is scaled in f32 and rounded to the
// input dtype before QK^T; softmax in f32; P is rounded to the input dtype
// before PV and dV; ds = p * (dp - sum(p * dp)) in f32, rounded to the input
// dtype for dq/dk; dq is multiplied by the scale after the product; dk uses
// the rounded, scaled q; db is accumulated in f32.
//
// What bounds it: at the XFM-base pair pass (2B = 96 rows, N = 197, H = 12)
// both directions do ~10-30 GFLOP against ~120-240 MB of traffic, so a good
// kernel sits near the memory bound; this first version is bounded by its
// own simple tiling (tiles staged through shared memory, no TMA or wgmma,
// K/V re-read from L2 by every q tile) and its times are in PERF.md.
//
// Design. The TPU kernel walks a sequential grid with the batch innermost and
// carries db across grid steps. Hopper blocks run in parallel and in no
// order, so the sum over the batch is made deterministic without atomics:
//   fwd   one block per (q tile of 64, h, b); the whole score row block
//         [64, Npad] stays in shared memory (N < 512), k/v stream in 64-key
//         tiles; the ragged edge (197 is no multiple of a tile) is masked.
//   bwd   three kernels on the current stream:
//         dq    one block per (q tile of 32, h, b): recomputes the full P and
//               dP rows, writes dq, the row statistics (max, sum) and the
//               f32 ds rows of every (b, h) to a scratch buffer [B, H, N, N];
//         dkdv  one block per (k tile of 64, h, b), looping over q tiles:
//               recomputes P from S and the row max and sum, reads ds back;
//         db    one thread per db element sums the scratch over b in the
//               order b = 0, 1, ... (the TPU kernel's order), so db is
//               deterministic. The scratch costs one write and two reads
//               (dkdv, db) of B*H*N*N f32, ~180 MB each at the pair pass:
//               ~540 MB on top of the function's own ~207 MB, so this
//               design alone keeps the backward at 3.6x its byte bound or
//               more.
//               A db kernel with one block per (h, q tile, k tile) that
//               loops over b and recomputes its ds tiles would need no
//               scratch; that is the next step for the backward.
// S is recomputed from the same tiles in the same order in the dq and dkdv
// kernels, so both see bit-identical probabilities.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <math.h>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int D = 64;           // head dim
constexpr int KT = 64;          // key tile
constexpr int QT_FWD = 64;      // q tile of the forward
constexpr int QT_BWD = 32;      // q tile of the backward kernels
constexpr int LDT = D + 8;      // leading dim (elements) of input-dtype tiles
constexpr int LDF = 64 + 4;     // leading dim of f32 [*, 64] tiles
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// C[M x 64] (+)= op(A)[M x K] * op(B)[K x 64], f32 accumulation, all tiles in
// shared memory. op(A)(m, k) = AT ? A[k*lda + m] : A[m*lda + k];
// op(B)(k, n) = BT ? B[n*ldb + k] : B[k*ldb + n]. Every thread calls it.
template <typename T, int M, int K, bool AT, bool BT>
__device__ void tile_mma(const T* A, int lda, const T* B, int ldb, float* C,
                         int ldc, bool accumulate) {
  if constexpr (std::is_same<T, bf16>::value) {
    using LA = typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
    constexpr int FC = 64 / 16;
    const int warp = threadIdx.x / 32;
    for (int f = warp; f < (M / 16) * FC; f += WARPS) {
      const int m0 = (f / FC) * 16, n0 = (f % FC) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (accumulate)
        wmma::load_matrix_sync(c, C + m0 * ldc + n0, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
        wmma::load_matrix_sync(a, AT ? A + k0 * lda + m0 : A + m0 * lda + k0, lda);
        wmma::load_matrix_sync(b, BT ? B + n0 * ldb + k0 : B + k0 * ldb + n0, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + m0 * ldc + n0, c, ldc, wmma::mem_row_major);
    }
  } else {
    // 16 x 16 thread grid: M/16 rows and 4 columns per thread
    constexpr int RM = M / 16;
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
    float acc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = accumulate ? C[(tr * RM + i) * ldc + tc * 4 + j] : 0.f;
    for (int k = 0; k < K; ++k) {
      float a[RM], b[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int m = tr * RM + i;
        a[i] = to_f(AT ? A[k * lda + m] : A[m * lda + k]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tc * 4 + j;
        b[j] = to_f(BT ? B[n * ldb + k] : B[k * ldb + n]);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) C[(tr * RM + i) * ldc + tc * 4 + j] = acc[i][j];
  }
}

// Rows [r0, r0 + R) of one head's [N, D] slice, held in registers between
// `fetch` and `put` so that the next tile's global loads overlap the current
// tile's products. `base` points at (row 0, this head's first column) and
// consecutive rows are `stride` elements apart; 16-byte vectors (the callers'
// offsets are multiples of D elements); rows past N are zero.
template <typename T, int R>
struct RowFetch {
  static constexpr int VEC = 16 / sizeof(T), PER_ROW = D / VEC;
  static constexpr int PER_THREAD = R * PER_ROW / THREADS;
  static_assert(PER_THREAD * THREADS == R * PER_ROW, "tile / block mismatch");
  uint4 v[PER_THREAD];

  __device__ void fetch(const T* __restrict__ base, int stride, int r0, int N) {
#pragma unroll
    for (int t = 0; t < PER_THREAD; ++t) {
      const int i = threadIdx.x + t * THREADS;
      const int n = r0 + i / PER_ROW, c = (i % PER_ROW) * VEC;
      v[t] = n < N ? *reinterpret_cast<const uint4*>(base + (size_t)n * stride + c)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // into a tile [R x LDT]; with `scaled`, each value is multiplied by
  // `scale` in f32 and rounded back to T
  __device__ void put(T* tile, bool scaled, float scale) const {
#pragma unroll
    for (int t = 0; t < PER_THREAD; ++t) {
      const int i = threadIdx.x + t * THREADS;
      uint4 x = v[t];
      if (scaled) {
        T* e = reinterpret_cast<T*>(&x);
#pragma unroll
        for (int j = 0; j < VEC; ++j) e[j] = from_f<T>(to_f(e[j]) * scale);
      }
      *reinterpret_cast<uint4*>(tile + (i / PER_ROW) * LDT + (i % PER_ROW) * VEC) = x;
    }
  }
};

template <typename T, int R>
__device__ void load_rows(const T* __restrict__ base, int stride, int r0, int N,
                          T* tile, bool scaled, float scale) {
  RowFetch<T, R> f;
  f.fetch(base, stride, r0, N);
  f.put(tile, scaled, scale);
}

// Rows [r0, r0 + R) of an f32 tile [R x LDF], times `mul` and rounded to T,
// into one head's [N, D] slice (rows past N are skipped); 16-byte stores.
template <typename T, int R>
__device__ void store_rows(const float* tile, T* __restrict__ base, int stride,
                           int r0, int N, float mul) {
  constexpr int VEC = 16 / sizeof(T), PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < R * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC, n = r0 + r;
    if (n >= N) continue;
    uint4 v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = from_f<T>(tile[r * LDF + c + j] * mul);
    *reinterpret_cast<uint4*>(base + (size_t)n * stride + c) = v;
  }
}

// One warp: row s[0, N) of raw scores plus the bias row -> softmax
// probabilities in place; s[N, Npad) = 0. Returns the row max and sum.
__device__ void warp_softmax_row(float* s, const float* __restrict__ brow, int N,
                                 int Npad, float& m_out, float& l_out) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int j = lane; j < N; j += 32) {
    const float v = s[j] + brow[j];
    s[j] = v;
    m = fmaxf(m, v);
  }
  m = warp_max(m);
  float l = 0.f;
  for (int j = lane; j < N; j += 32) {
    const float e = expf(s[j] - m);
    s[j] = e;
    l += e;
  }
  l = warp_sum(l);
  for (int j = lane; j < Npad; j += 32) s[j] = j < N ? s[j] / l : 0.f;
  m_out = m;
  l_out = l;
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(N/64), H, B)

template <typename T>
__global__ void __launch_bounds__(THREADS)
packed_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                  T* __restrict__ out, int N, int H, int Npad, float scale) {
  constexpr int M = QT_FWD;
  const int q0 = blockIdx.x * M, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D, C3 = 3 * C, LDS = Npad + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* KV = Qs + M * LDT;
  T* Ps = KV + KT * LDT;
  float* S = reinterpret_cast<float*>(Ps + M * LDT);
  float* O = S + M * LDS;

  const T* base = qkv + (size_t)b * N * C3 + h * D;
  RowFetch<T, KT> kv;
  kv.fetch(base + C, C3, 0, N);
  load_rows<T, M>(base, C3, q0, N, Qs, true, scale);
  for (int k0 = 0; k0 < Npad; k0 += KT) {
    kv.put(KV, false, 1.f);
    __syncthreads();
    // next K tile, or the first V tile (it lands during the softmax)
    if (k0 + KT < Npad) kv.fetch(base + C, C3, k0 + KT, N);
    else kv.fetch(base + 2 * C, C3, 0, N);
    tile_mma<T, M, D, false, true>(Qs, LDT, KV, LDT, S + k0, LDS, false);
    __syncthreads();
  }
  const int warp = threadIdx.x / 32;
  for (int r = warp; r < M; r += WARPS) {
    float* s = S + r * LDS;
    if (q0 + r >= N) {
      for (int j = threadIdx.x & 31; j < Npad; j += 32) s[j] = 0.f;
      continue;
    }
    float m, l;
    warp_softmax_row(s, bias + ((size_t)h * N + q0 + r) * N, N, Npad, m, l);
  }
  __syncthreads();
  for (int k0 = 0; k0 < Npad; k0 += KT) {
    for (int i = threadIdx.x; i < M * KT; i += THREADS) {
      const int r = i / KT, c = i % KT;
      Ps[r * LDT + c] = from_f<T>(S[r * LDS + k0 + c]);
    }
    kv.put(KV, false, 1.f);
    __syncthreads();
    if (k0 + KT < Npad) kv.fetch(base + 2 * C, C3, k0 + KT, N);
    tile_mma<T, M, KT, false, false>(Ps, LDT, KV, LDT, O, LDF, k0 > 0);
    __syncthreads();
  }
  store_rows<T, M>(O, out + (size_t)b * N * C + h * D, C, q0, N, 1.f);
}

// ---------------------------------------------------------------------------
// backward 1/3: dq and row statistics. grid (ceil(N/32), H, B).
// stats: [2][B*H*N] = row max, row sum.

template <typename T>
__global__ void __launch_bounds__(THREADS)
packed_bwd_dq_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                     const T* __restrict__ dout, T* __restrict__ dqkv,
                     float* __restrict__ stats, float* __restrict__ ds_rows,
                     int B, int N, int H, int Npad, float scale) {
  constexpr int M = QT_BWD;
  const int q0 = blockIdx.x * M, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D, C3 = 3 * C, LDS = Npad + 4;
  const size_t BHN = (size_t)B * H * N;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + M * LDT;
  T* Ds = dOs + M * LDT;
  T* KV = Ds + M * LDT;
  float* S = reinterpret_cast<float*>(KV + KT * LDT);
  float* dP = S + M * LDS;
  float* dQ = dP + M * LDS;

  const T* base = qkv + (size_t)b * N * C3 + h * D;
  RowFetch<T, KT> kv;
  kv.fetch(base + C, C3, 0, N);
  load_rows<T, M>(base, C3, q0, N, Qs, true, scale);
  load_rows<T, M>(dout + (size_t)b * N * C + h * D, C, q0, N, dOs, false, 1.f);
  for (int k0 = 0; k0 < Npad; k0 += KT) {
    kv.put(KV, false, 1.f);
    __syncthreads();
    kv.fetch(base + 2 * C, C3, k0, N);
    tile_mma<T, M, D, false, true>(Qs, LDT, KV, LDT, S + k0, LDS, false);
    __syncthreads();
    kv.put(KV, false, 1.f);
    __syncthreads();
    // next K tile, or the first again for the dq products
    kv.fetch(base + C, C3, k0 + KT < Npad ? k0 + KT : 0, N);
    tile_mma<T, M, D, false, true>(dOs, LDT, KV, LDT, dP + k0, LDS, false);
    __syncthreads();
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int r = warp; r < M; r += WARPS) {
    float* s = S + r * LDS;
    const float* dp = dP + r * LDS;
    const int q = q0 + r;
    if (q >= N) {
      for (int j = lane; j < Npad; j += 32) s[j] = 0.f;
      continue;
    }
    float m, l;
    warp_softmax_row(s, bias + ((size_t)h * N + q) * N, N, Npad, m, l);
    float delta = 0.f;
    for (int j = lane; j < N; j += 32) delta += s[j] * dp[j];
    delta = warp_sum(delta);
    const size_t idx = ((size_t)b * H + h) * N + q;
    float* ds_row = ds_rows + idx * N;
    for (int j = lane; j < N; j += 32) {
      const float ds = s[j] * (dp[j] - delta);
      s[j] = ds;
      ds_row[j] = ds;
    }
    if (lane == 0) {
      stats[idx] = m;
      stats[BHN + idx] = l;
    }
  }
  __syncthreads();
  for (int k0 = 0; k0 < Npad; k0 += KT) {
    for (int i = threadIdx.x; i < M * KT; i += THREADS) {
      const int r = i / KT, c = i % KT;
      Ds[r * LDT + c] = from_f<T>(S[r * LDS + k0 + c]);
    }
    kv.put(KV, false, 1.f);
    __syncthreads();
    if (k0 + KT < Npad) kv.fetch(base + C, C3, k0 + KT, N);
    tile_mma<T, M, KT, false, false>(Ds, LDT, KV, LDT, dQ, LDF, k0 > 0);
    __syncthreads();
  }
  store_rows<T, M>(dQ, dqkv + (size_t)b * N * C3 + h * D, C3, q0, N, scale);
}

// ---------------------------------------------------------------------------
// backward 2/3: dk and dv. grid (ceil(N/64), H, B). P is recomputed from S
// with the dq kernel's row max and sum; ds is read back from its scratch.

template <typename T>
__global__ void __launch_bounds__(THREADS)
packed_bwd_dkdv_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                       const T* __restrict__ dout, T* __restrict__ dqkv,
                       const float* __restrict__ stats,
                       const float* __restrict__ ds_rows, int B, int N, int H,
                       float scale) {
  constexpr int M = QT_BWD;
  const int k0 = blockIdx.x * KT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D, C3 = 3 * C;
  const size_t BHN = (size_t)B * H * N;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Qs = Ks + KT * LDT;
  T* dOs = Qs + M * LDT;
  T* Ps = dOs + M * LDT;
  T* Ds = Ps + M * LDT;
  float* St = reinterpret_cast<float*>(Ds + M * LDT);
  float* dK = St + M * LDF;
  float* dV = dK + KT * LDF;

  const T* base = qkv + (size_t)b * N * C3 + h * D;
  const T* dbase = dout + (size_t)b * N * C + h * D;
  const size_t row0 = ((size_t)b * H + h) * N;  // (b, h, q = 0)
  __shared__ float row_max[M], row_sum[M];
  RowFetch<T, M> qf, gf;
  qf.fetch(base, C3, 0, N);
  gf.fetch(dbase, C, 0, N);
  load_rows<T, KT>(base + C, C3, k0, N, Ks, false, 1.f);
  for (int q0 = 0; q0 < N; q0 += M) {
    qf.put(Qs, true, scale);
    gf.put(dOs, false, 1.f);
    if (threadIdx.x < M && q0 + threadIdx.x < N) {
      row_max[threadIdx.x] = stats[row0 + q0 + threadIdx.x];
      row_sum[threadIdx.x] = stats[BHN + row0 + q0 + threadIdx.x];
    }
    __syncthreads();
    if (q0 + M < N) {
      qf.fetch(base, C3, q0 + M, N);
      gf.fetch(dbase, C, q0 + M, N);
    }
    tile_mma<T, M, D, false, true>(Qs, LDT, Ks, LDT, St, LDF, false);
    __syncthreads();
    for (int i = threadIdx.x; i < M * KT; i += THREADS) {
      const int r = i / KT, c = i % KT, q = q0 + r, k = k0 + c;
      float p = 0.f, ds = 0.f;
      if (q < N && k < N) {
        p = expf(St[r * LDF + c] + bias[((size_t)h * N + q) * N + k] - row_max[r]) /
            row_sum[r];
        ds = ds_rows[(row0 + q) * N + k];
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
// backward 3/3: db[h] = sum over b of ds[b, h], in the order b = 0, 1, ...
// (the TPU kernel's order). ds_rows: [B, H*N*N] f32 from the dq kernel.

__global__ void __launch_bounds__(THREADS)
packed_bwd_db_kernel(const float* __restrict__ ds_rows, float* __restrict__ db,
                     int B, size_t HNN) {
  for (size_t i = blockIdx.x * (size_t)THREADS + threadIdx.x; i < HNN;
       i += (size_t)gridDim.x * THREADS) {
    float acc = 0.f;
    for (int b = 0; b < B; ++b) acc += ds_rows[b * HNN + i];
    db[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// host side

int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <typename T>
size_t fwd_smem(int Npad) {
  return (size_t)(QT_FWD + KT + QT_FWD) * LDT * sizeof(T) +
         (size_t)(QT_FWD * (Npad + 4) + QT_FWD * LDF) * sizeof(float);
}
template <typename T>
size_t dq_smem(int Npad) {
  return (size_t)(3 * QT_BWD + KT) * LDT * sizeof(T) +
         (size_t)(2 * QT_BWD * (Npad + 4) + QT_BWD * LDF) * sizeof(float);
}
template <typename T>
size_t dkdv_smem() {
  return (size_t)(KT + 4 * QT_BWD) * LDT * sizeof(T) +
         (size_t)(QT_BWD + 2 * KT) * LDF * sizeof(float);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int launch_fwd(const void* qkv, const void* bias, void* out, int B, int N, int H,
               float scale, cudaStream_t st) {
  const int Npad = round_up(N, KT);
  const size_t smem = fwd_smem<T>(Npad);
  cudaError_t e = allow_smem(packed_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + QT_FWD - 1) / QT_FWD, H, B);
  packed_fwd_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<T*>(out), N, H, Npad, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* qkv, const void* bias, const void* dout, void* dqkv,
               void* db, void* stats, void* ds_rows, int B, int N, int H,
               float scale, cudaStream_t st) {
  const int Npad = round_up(N, KT);
  const T* q = static_cast<const T*>(qkv);
  const float* bi = static_cast<const float*>(bias);
  const T* g = static_cast<const T*>(dout);
  T* dq = static_cast<T*>(dqkv);
  float* sts = static_cast<float*>(stats);
  cudaError_t e;

  size_t smem = dq_smem<T>(Npad);
  if ((e = allow_smem(packed_bwd_dq_kernel<T>, smem)) != cudaSuccess) return (int)e;
  dim3 g1((N + QT_BWD - 1) / QT_BWD, H, B);
  float* dsr = static_cast<float*>(ds_rows);
  packed_bwd_dq_kernel<T><<<g1, THREADS, smem, st>>>(q, bi, g, dq, sts, dsr, B, N, H,
                                                     Npad, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  smem = dkdv_smem<T>();
  if ((e = allow_smem(packed_bwd_dkdv_kernel<T>, smem)) != cudaSuccess) return (int)e;
  dim3 g2(Npad / KT, H, B);
  packed_bwd_dkdv_kernel<T><<<g2, THREADS, smem, st>>>(q, bi, g, dq, sts, dsr, B, N,
                                                       H, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const size_t HNN = (size_t)H * N * N;
  const int g3 = (int)((HNN + THREADS - 1) / THREADS < 132 * 8
                           ? (HNN + THREADS - 1) / THREADS : 132 * 8);
  packed_bwd_db_kernel<<<g3, THREADS, 0, st>>>(dsr, static_cast<float*>(db), B, HNN);
  return (int)cudaGetLastError();
}

}  // namespace

// is_bf16: 1 for bf16 qkv/out, 0 for f32. bias is f32 [1, H, N, N].
// Returns a cudaError_t (0 on success).
extern "C" int xfm_packed_attention_fwd(const void* qkv, const void* bias, void* out,
                                        int B, int N, int H, float scale,
                                        int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<bf16>(qkv, bias, out, B, N, H, scale, st)
                 : launch_fwd<float>(qkv, bias, out, B, N, H, scale, st);
}

// dqkv like qkv; db f32 [1, H, N, N]; scratch: stats f32 [2, B*H*N] and
// ds_rows f32 [B, H, N, N].
extern "C" int xfm_packed_attention_bwd(const void* qkv, const void* bias,
                                        const void* dout, void* dqkv, void* db,
                                        void* stats, void* ds_rows, int B, int N,
                                        int H, float scale, int is_bf16,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<bf16>(qkv, bias, dout, dqkv, db, stats, ds_rows, B, N,
                                    H, scale, st)
                 : launch_bwd<float>(qkv, bias, dout, dqkv, db, stats, ds_rows, B, N,
                                     H, scale, st);
}
