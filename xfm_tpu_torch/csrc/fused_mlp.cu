// K5: the MLP's second projection with the activation fused into the
// matmuls, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of xfm_tpu/ops/fused_mlp.py: `_fwd_kernel`
// (fused_mlp.py:75, called from `_act_matmul_fwd_impl` :132), `_dw_kernel`
// (:84, called from `_act_matmul_bwd` :158) and `_dh_kernel` (:99, called
// :168). With h [M, K], the nn.Linear weight W [N, K] (the transpose of the
// JAX kernel, read in place) and b [N]:
//
//   forward  y  = act(h)·Wᵀ + b   act in f32, rounded to h's dtype before
//                                  the product; f32 sums; b added in f32
//   dW       dW = gᵀ·act(h)        summed over all M in f32, in W's dtype
//   dh       dh = (g·W)·act'(h)    in f32, rounded to h's dtype
//
// (db = Σ g stays a torch reduction, as the JAX package leaves it to XLA.)
// act(h) never exists in device memory: each kernel applies it while it
// stages a tile of h into shared memory, and dh applies act'(h) in its
// epilogue.
//
// What bounds it on an H100: operations. At the BEiT site (M = 18,912,
// K = 3,072, N = 768, bf16) the forward is 89.2 GFLOP, 0.090 ms at 989
// TFLOP/s, against 150 MB of bytes (0.045 ms); the backward twice that.
// This first version is simple and right, not fast: one 128 × 128 output
// tile per block of 8 warps, a 32-deep reduction step staged through shared
// memory with the next step's global loads in flight in registers, the
// products through WMMA (mma.sync) in bf16, and CUDA-core FMAs in f32 (no
// TF32, so that f32 runs agree with the CPU). No TMA, no wgmma.
//
// dW sums over every row of h: the TPU accumulated it across a sequential
// grid. Here each block owns one 128 × 128 tile of dW and loops over all M
// rows in order, recomputing act(h) for each staged tile: no atomics, no
// split-M scratch, and every element is summed in the same order in every
// run.
#include "attention_tiles.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32;  // output tile, reduction step
enum Mode { FWD = 0, DH = 1, DW = 2 };
enum Act { GELU_TANH = 0, GELU = 1, RELU = 2 };  // ops/activations FUSED_ACT_ID

constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;
constexpr float GELU_C = 0.044715f;
constexpr float GELU_3C = (float)(3 * 0.044715);
constexpr float INV_SQRT_2PI = 0.3989422804014327f;

// Φ̂ of xfm_tpu/ops/activations.py (`_phi_hat`, coefficients `_C`)
__device__ __forceinline__ float phi_hat(float xc) {
  const float u = xc * xc;
  float q = 1.48881406403234e-06f;
  q = q * u + -3.7987665564287454e-05f;
  q = q * u + -7.985177944647148e-05f;
  q = q * u + 0.03637675940990448f;
  q = q * u + 0.7978764176368713f;
  return 0.5f * (1.f + tanhf(xc * q));
}

__device__ __forceinline__ float clip6(float x) { return fminf(fmaxf(x, -6.f), 6.f); }

__device__ __forceinline__ float act_f(int act, float x) {
  if (act == GELU_TANH)
    return 0.5f * x * (1.f + tanhf(SQRT_2_OVER_PI * (x + GELU_C * x * x * x)));
  if (act == GELU) return x * phi_hat(clip6(x));
  return fmaxf(x, 0.f);
}

__device__ __forceinline__ float act_df(int act, float x) {
  if (act == GELU_TANH) {
    const float t = tanhf(SQRT_2_OVER_PI * (x + GELU_C * x * x * x));
    const float dt = (1.f - t * t) * SQRT_2_OVER_PI * (1.f + GELU_3C * x * x);
    return 0.5f * (1.f + t) + 0.5f * x * dt;
  }
  if (act == GELU) {
    if (x >= 6.f) return 1.f;   // beyond the clamp the function is x
    if (x <= -6.f) return 0.f;  // or −0
    const float xc = clip6(x);
    return phi_hat(xc) + x * (expf(-0.5f * xc * xc) * INV_SQRT_2PI);
  }
  return x > 0.f ? 1.f : 0.f;
}

// Shared-memory layout of one step: the A tile [BM x BK] (or [BK x BM] when
// A_KM), the B tile [BK x BN] (or [BN x BK] when B_NK), padded by 16 bytes a
// row; after the loop the f32 output tile [BM x BN] reuses the space.
template <typename T, bool A_KM, bool B_NK>
struct Lay {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int AR = A_KM ? BK : BM, AC = A_KM ? BM : BK;
  static constexpr int BR = B_NK ? BN : BK, BC = B_NK ? BK : BN;
  static constexpr int LDA = AC + PAD, LDB = BC + PAD, LDC = BN + 4;
  static constexpr size_t A_BYTES = (size_t)AR * LDA * sizeof(T);
  static constexpr size_t B_BYTES = (size_t)BR * LDB * sizeof(T);
  static constexpr size_t C_BYTES = (size_t)BM * LDC * sizeof(float);
  static constexpr size_t SMEM =
      A_BYTES + B_BYTES > C_BYTES ? A_BYTES + B_BYTES : C_BYTES;
};

// One tile [TR x TC] of a row-major matrix X [nrows, ncols] (leading dim
// ld), held in registers between `fetch` and `put`; 16-byte vectors,
// outside the matrix zero.
template <typename T, int TR, int TC>
struct TileFetch {
  static constexpr int VEC = 16 / sizeof(T), PER_ROW = TC / VEC;
  static constexpr int PER_THREAD = TR * PER_ROW / THREADS;
  static_assert(PER_THREAD * THREADS == TR * PER_ROW, "tile / block mismatch");
  uint4 v[PER_THREAD];

  __device__ void fetch(const T* __restrict__ X, int ld, int nrows, int ncols,
                        int row0, int col0) {
#pragma unroll
    for (int t = 0; t < PER_THREAD; ++t) {
      const int i = threadIdx.x + t * THREADS;
      const int r = row0 + i / PER_ROW, c = col0 + (i % PER_ROW) * VEC;
      v[t] = r < nrows && c < ncols
                 ? *reinterpret_cast<const uint4*>(X + (size_t)r * ld + c)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // into S [TR x (TC + PAD)]; act >= 0: act in f32, rounded back to T
  // (act(0) = 0, so the zero outside stays zero)
  __device__ void put(T* S, int act) const {
    constexpr int LD = TC + 16 / sizeof(T);
#pragma unroll
    for (int t = 0; t < PER_THREAD; ++t) {
      const int i = threadIdx.x + t * THREADS;
      uint4 x = v[t];
      if (act >= 0) {
        T* e = reinterpret_cast<T*>(&x);
#pragma unroll
        for (int j = 0; j < VEC; ++j) e[j] = from_f<T>(act_f(act, to_f(e[j])));
      }
      *reinterpret_cast<uint4*>(S + (i / PER_ROW) * LD + (i % PER_ROW) * VEC) = x;
    }
  }
};

// The block's [BM x BN] f32 sums. bf16: WMMA fragments, warps in a 2 x 4
// grid of 64 x 32 each. f32: a 16 x 16 thread grid, 8 x 8 outputs a thread.
// Either way each output sums over the reduction in the order of its steps.
template <typename T, bool A_KM, bool B_NK>
struct Acc;

template <bool A_KM, bool B_NK>
struct Acc<bf16, A_KM, B_NK> {
  using L = Lay<bf16, A_KM, B_NK>;
  using LA = typename std::conditional<A_KM, wmma::col_major, wmma::row_major>::type;
  using LB = typename std::conditional<B_NK, wmma::col_major, wmma::row_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[4][2];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);
  }

  __device__ void mma(const bf16* As, const bf16* Bs) {
    const int warp = threadIdx.x / 32, wm = (warp / 4) * 64, wn = (warp % 4) * 32;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm + 16 * i;
        wmma::load_matrix_sync(a[i], A_KM ? As + kk * L::LDA + m : As + m * L::LDA + kk,
                               L::LDA);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn + 16 * j;
        wmma::load_matrix_sync(b[j], B_NK ? Bs + n * L::LDB + kk : Bs + kk * L::LDB + n,
                               L::LDB);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
  }

  __device__ void store(float* Cs) const {
    const int warp = threadIdx.x / 32, wm = (warp / 4) * 64, wn = (warp % 4) * 32;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm + 16 * i) * L::LDC + wn + 16 * j, c[i][j],
                                L::LDC, wmma::mem_row_major);
  }
};

template <bool A_KM, bool B_NK>
struct Acc<float, A_KM, B_NK> {
  using L = Lay<float, A_KM, B_NK>;
  float c[8][8];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
  }

  __device__ void mma(const float* As, const float* Bs) {
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = tr + 16 * i;
        a[i] = A_KM ? As[k * L::LDA + m] : As[m * L::LDA + k];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tc + 16 * j;
        b[j] = B_NK ? Bs[n * L::LDB + k] : Bs[k * L::LDB + n];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }

  __device__ void store(float* Cs) const {
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Cs[(tr + 16 * i) * L::LDC + tc + 16 * j] = c[i][j];
  }
};

struct Args {
  const void* h;  // [M, K]
  const void* w;  // [N, K]
  const void* b;  // [N] (forward)
  const void* g;  // [M, N] (backward)
  void* out;      // y [M, N], dh [M, K] or dW [N, K]
  int M, K, N, act;
};

// One [BM x BN] tile of the output of MODE per block: blockIdx.x over its
// rows, blockIdx.y over its columns.
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS) xfm_act_matmul(const Args p) {
  constexpr bool A_KM = MODE == DW, B_NK = MODE == FWD;
  using L = Lay<T, A_KM, B_NK>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + L::A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);
  const T* h = static_cast<const T*>(p.h);
  const T* w = static_cast<const T*>(p.w);
  const T* g = static_cast<const T*>(p.g);
  const int M = p.M, K = p.K, N = p.N;
  const int r0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int depth = MODE == FWD ? K : MODE == DH ? N : M;  // reduction

  TileFetch<T, L::AR, L::AC> fa;
  TileFetch<T, L::BR, L::BC> fb;
  auto fetch = [&](int l0) {
    if constexpr (MODE == FWD) {         // act(h)[m, k], W[n, k]
      fa.fetch(h, K, M, K, r0, l0);
      fb.fetch(w, K, N, K, c0, l0);
    } else if constexpr (MODE == DH) {   // g[m, n], W[n, k]
      fa.fetch(g, N, M, N, r0, l0);
      fb.fetch(w, K, N, K, l0, c0);
    } else {                             // g[m, n] as [m][n], act(h)[m, k]
      fa.fetch(g, N, M, N, l0, r0);
      fb.fetch(h, K, M, K, l0, c0);
    }
  };

  Acc<T, A_KM, B_NK> acc;
  acc.zero();
  fetch(0);
  for (int l0 = 0; l0 < depth; l0 += BK) {
    fa.put(As, MODE == FWD ? p.act : -1);
    fb.put(Bs, MODE == DW ? p.act : -1);
    __syncthreads();
    if (l0 + BK < depth) fetch(l0 + BK);
    acc.mma(As, Bs);
    __syncthreads();
  }
  acc.store(Cs);
  __syncthreads();

  // epilogue: + b (forward), · act'(h) (dh), rounded to T; 16-byte stores
  const int out_rows = MODE == DW ? N : M, out_cols = MODE == FWD ? N : K;
  constexpr int VEC = 16 / sizeof(T), PER_ROW = BN / VEC;
  T* out = static_cast<T*>(p.out);
  for (int i = threadIdx.x; i < BM * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    const int gr = r0 + r, gc = c0 + c;
    if (gr >= out_rows || gc >= out_cols) continue;
    const float* src = Cs + r * L::LDC + c;
    uint4 o;
    T* e = reinterpret_cast<T*>(&o);
    if constexpr (MODE == FWD) {
      const uint4 bv = *reinterpret_cast<const uint4*>(static_cast<const T*>(p.b) + gc);
      const T* be = reinterpret_cast<const T*>(&bv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[j] = from_f<T>(src[j] + to_f(be[j]));
    } else if constexpr (MODE == DH) {
      const uint4 hv = *reinterpret_cast<const uint4*>(h + (size_t)gr * K + gc);
      const T* he = reinterpret_cast<const T*>(&hv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[j] = from_f<T>(src[j] * act_df(p.act, to_f(he[j])));
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[j] = from_f<T>(src[j]);
    }
    *reinterpret_cast<uint4*>(out + (size_t)gr * out_cols + gc) = o;
  }
}

template <typename T, int MODE>
cudaError_t launch(const Args& p, cudaStream_t st) {
  using L = Lay<T, MODE == DW, MODE == FWD>;
  auto kernel = xfm_act_matmul<T, MODE>;
  cudaError_t e = allow_smem(kernel, L::SMEM);
  if (e != cudaSuccess) return e;
  const int rows = MODE == DW ? p.N : p.M, cols = MODE == FWD ? p.N : p.K;
  const dim3 grid((rows + BM - 1) / BM, (cols + BN - 1) / BN);
  kernel<<<grid, THREADS, L::SMEM, st>>>(p);
  return cudaGetLastError();
}

bool dims_ok(int M, int K, int N, int act) {
  return M > 0 && K > 0 && N > 0 && K % 8 == 0 && N % 8 == 0 && act >= 0 &&
         act <= RELU;
}

}  // namespace

// h [M, K], w [N, K], b [N], y [M, N], one dtype; 16-byte aligned,
// contiguous; K, N multiples of 8.
extern "C" int xfm_act_matmul_fwd(const void* h, const void* w, const void* b,
                                  void* y, int M, int K, int N, int act,
                                  int is_bf16, void* stream) {
  if (!dims_ok(M, K, N, act)) return (int)cudaErrorInvalidValue;
  const Args p{h, w, b, nullptr, y, M, K, N, act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16, FWD>(p, st) : launch<float, FWD>(p, st);
}

// g [M, N] → dh [M, K] and dw [N, K] (the dW kernel, then the dh kernel)
extern "C" int xfm_act_matmul_bwd(const void* h, const void* w, const void* g,
                                  void* dh, void* dw, int M, int K, int N,
                                  int act, int is_bf16, void* stream) {
  if (!dims_ok(M, K, N, act)) return (int)cudaErrorInvalidValue;
  const Args pw{h, w, nullptr, g, dw, M, K, N, act};
  const Args ph{h, w, nullptr, g, dh, M, K, N, act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16 ? launch<bf16, DW>(pw, st) : launch<float, DW>(pw, st);
  if (e != cudaSuccess) return (int)e;
  return is_bf16 ? launch<bf16, DH>(ph, st) : launch<float, DH>(ph, st);
}
