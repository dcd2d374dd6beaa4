// Tile helpers shared by the port's attention kernels (packed_attention.cu,
// relpos_attention.cu): head dim 64, blocks of 256 threads, tiles staged
// through shared memory, products through WMMA (mma.sync) for bf16 and
// CUDA-core FMA for f32.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <math.h>
#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int D = 64;           // head dim
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
// Each output element sums over k in the order 0, 1, ... whatever M is, so
// two calls on the same rows give bit-identical results.
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

int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
