// K5: the MLP's second projection with the activation fused into the
// matmuls, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of xfm_tpu/ops/fused_mlp.py: `_fwd_kernel`
// (fused_mlp.py:75, called from `_act_matmul_fwd_impl` :132), `_dw_kernel`
// (:84, called from `_act_matmul_bwd` :158) and `_dh_kernel` (:99, called
// :168); public function `act_matmul` (:118). With h [M, K], the nn.Linear
// weight W [N, K] (the transpose of the JAX kernel, read in place) and b [N]:
//
//   forward  y  = act(h)·Wᵀ + b   act in f32, rounded to h's dtype before
//                                  the product; f32 sums; b added in f32
//                                  (b may be null: no bias; in bf16 y may
//                                  be f32, unrounded: a tensor-parallel
//                                  row layer's partial sum, rounded once
//                                  after the group's all-reduce)
//   dW       dW = gᵀ·act(h)        summed over all M in f32, in W's dtype
//   dh       dh = (g·W)·act'(h)    in f32, rounded to h's dtype
//
// (db = Σ g stays a torch reduction, as the JAX package leaves it to XLA.)
// act(h) never exists in device memory, and dh applies act'(h) in its
// epilogue.
//
// What bounds it on an H100: operations. At the BEiT site (M = 18,912,
// K = 3,072, N = 768, bf16) the forward is 89.2 GFLOP, 0.090 ms at 989
// TFLOP/s, against 150 MB of bytes (0.045 ms); the backward twice that.
// This design takes 0.34 / 0.83 ms there (NVIDIA H100 80GB HBM3, 700 W;
// the first design 0.87 / 2.45): act with IEEE tanhf on every staged tile
// of h is 0.11 ms of the forward (ReLU: 0.22 ms), and each 64-deep step
// takes about 1.2 µs where the tensor cores need 0.56 (one block an SM,
// a barrier a step, the stage's act pass and the TMA writes sharing shared
// memory's bandwidth with wgmma). A producer warp, persistent blocks and
// act in registers (wgmma with A from registers) are the next step.
//
// bf16: one kernel, `xfm_act_matmul_wgmma<MODE>`, for the three products,
// whose operands differ only in their layout in shared memory:
//
//   product  output      A (rows x reduction)          B (reduction x cols)
//   forward  y  [M, N]   h, K-major                    W [N, K], K-major
//            (FWD32: the same, y in f32)
//   dh       dh [M, K]   g, K-major                    W [N, K], MN-major
//   dW       dWᵀ [K, N]  act(h)ᵀ from h, MN-major      g [M, N], MN-major
//
// A block owns a 128 x 256 output tile: two warpgroups of 128 threads, 64
// rows each, every product a `wgmma.mma_async.m64n256k16` with f32
// accumulators in registers (128 a thread) and both operands read from
// shared memory through 128-byte-swizzled descriptors (the transpose bits
// for the MN-major ones). A ring of 4 stages, each a 128 x 64 A tile and a
// 64 x 256 B tile (48 KB, 1024-byte aligned), is filled by TMA
// (`cp.async.bulk.tensor`, one elected thread, an mbarrier per stage);
// TMA zero-fills every row and column past the matrix, so the ragged edges
// need masking only in the stores (act(0) = 0 for all three activations).
// One wgmma group stays in flight (`wgmma.wait_group 1`) while the next
// stage is made ready: where A is h (forward, dW), every thread applies act
// to its share of that stage in place, in f32 rounded to bf16 (elementwise,
// so the swizzle does not matter), then `fence.proxy.async` and a barrier,
// before any wgmma reads it. act is recomputed once per 256-wide output
// column tile: 3 times over the forward's N = 768 and over dW's N. The
// epilogues stage the output tile in shared memory as TMA's swizzled boxes
// and write it by TMA stores (4-byte stores from the accumulator layout,
// 8 rows a warp instruction, had cost dh 0.57 ms a call). dh's epilogue
// takes act'(h) from the block's [128 x 256] tile of h, which TMA brings in
// beside a 3-stage ring while the products run, in a second, rolled pass
// over the sums parked in the ring.
// dW sums over M without atomics: the reduction is cut into S contiguous
// chunks of whole 64-row steps (S from `ops/fused_mlp.py` `dw_splits`,
// enough blocks for several waves), each block writes its f32 partial tile
// to a workspace [S, K, N], and `xfm_act_matmul_dw_sum` sums the partials in
// the order s = 0 .. S-1 and writes dW [N, K] transposed, in W's dtype: the
// same bits every run.
//
// f32 keeps the first design: one 128 x 128 output tile per block of 8
// warps, a 32-deep reduction step staged through shared memory, CUDA-core
// FMAs (no TF32, so that f32 runs agree with the CPU); its dW blocks each
// walk all M rows in order.
#include "attention_tiles.cuh"
#include "tma_ring.cuh"

#include <cuda.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32;  // f32: output tile, reduction step
enum Mode { FWD = 0, DH = 1, DW = 2, FWD32 = 3 };  // FWD32: bf16 in, f32 y
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

// ---------------------------------------------------------------------------
// f32: the first design, CUDA-core FMA through shared tiles
//
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

// f32: the block's [BM x BN] sums, a 16 x 16 thread grid, 8 x 8 outputs a
// thread, each output summed over the reduction in the order of its steps.
template <typename T, bool A_KM, bool B_NK>
struct Acc;

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

// f32: one [BM x BN] tile of the output of MODE per block: blockIdx.x over
// its rows, blockIdx.y over its columns.
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
      uint4 bv = make_uint4(0, 0, 0, 0);  // no bias: + 0
      if (p.b) bv = *reinterpret_cast<const uint4*>(static_cast<const T*>(p.b) + gc);
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



// ---------------------------------------------------------------------------
// bf16: wgmma fed by a TMA ring

constexpr int WBM = 128, WBN = 256, WBK = 64;  // output tile, reduction step
constexpr int STAGES = 4;                       // the ring (dh: 3, see H_TILE)
constexpr int WG_THREADS = 256;                 // two warpgroups, 64 rows each
constexpr int A_STAGE = WBM * WBK * 2;          // 16 KB
constexpr int B_STAGE = WBN * WBK * 2;          // 32 KB
constexpr int STAGE_BYTES = A_STAGE + B_STAGE;
constexpr int BOX = 64 * 64 * 2;                // one 64 x 64 TMA box, 8 KB
constexpr int H_TILE = WBM * WBN * 2;           // dh: h under the output tile, 64 KB
constexpr int DH_LD = WBN + 4;                  // dh: the parked f32 sums' row, 1040 B
static_assert(WBM * DH_LD * 4 <= (STAGES - 1) * STAGE_BYTES, "dh's sums fit in its ring");
// the ring's stages, and the shared memory (+ room to align to 1024)
__host__ __device__ constexpr int ring_stages(int mode) {
  return mode == DH ? STAGES - 1 : STAGES;
}
constexpr size_t wg_smem(int mode) {
  return (size_t)ring_stages(mode) * STAGE_BYTES + (mode == DH ? H_TILE : 0) + 1024;
}

// one TMA box at (col c, row r) of `map` into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, unsigned bar,
                                         int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(r)
      : "memory");
}

// the box at (col c, row r[, split z]) of `map` from shared memory; then,
// by the issuing thread, wait until every store has read its box
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, unsigned src, int c, int r) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c), "r"(r)
               : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, unsigned src, int c, int r,
                                             int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c), "r"(r), "r"(z)
      : "memory");
}
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile at `addr`:
// K-major, `sbo` is the stride between 8-row groups (1024 B) and `lbo`
// unused; MN-major, `lbo` is the stride between 64-wide column blocks and
// `sbo` between groups of 8 reduction rows. Tiles are 1024-byte aligned, so
// the base-offset bits stay 0.
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 16] B[16 x 256], bf16 in, f32 accumulators; TA / TB
// 1 where the operand is MN-major. Thread t of the warpgroup holds, for
// n-block j (columns 8j .. 8j + 7), rows 16 (t / 32) + (t % 32) / 4 and 8
// below at columns 8j + 2 (t % 4) + {0, 1} in d[4j .. 4j + 3].
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// every thread applies act to its share of one landed A stage of h, in
// place, in f32 rounded to bf16; then makes its writes visible to wgmma
// (the outer loop stays rolled: act's inlined copies cost instruction cache)
__device__ __forceinline__ void act_stage(unsigned char* A, int act) {
  uint4* v = reinterpret_cast<uint4*>(A);
#pragma unroll 1
  for (int i = 0; i < A_STAGE / 16 / WG_THREADS; ++i) {
    uint4 x = v[threadIdx.x + i * WG_THREADS];
    unsigned* w = reinterpret_cast<unsigned*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
      __nv_bfloat162 r = __floats2bfloat162_rn(act_f(act, f.x), act_f(act, f.y));
      w[j] = *reinterpret_cast<unsigned*>(&r);
    }
    v[threadIdx.x + i * WG_THREADS] = x;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

struct WArgs {
  const bf16* b;  // [N] (forward; null: no bias)
  int M, K, N, act;
  int chunk;      // dW: rows of M a split sums (a multiple of WBK)
};

// One [WBM x WBN] tile of the output of MODE per block: blockIdx.x over its
// columns, blockIdx.y over its rows, blockIdx.z over dW's splits of M. ta
// and tb are the TMA maps of A's and B's source; th (dh) h's, whose tile
// under the output lands beside the ring while the products run, for the
// epilogue's act'(h); to the output's: y, dh, or dW's partials [S, K, N]
// (see `fwd_bf16`, `bwd_bf16`).
template <int MODE>
__global__ void __launch_bounds__(WG_THREADS, 1)
xfm_act_matmul_wgmma(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap th,
                     const __grid_constant__ CUtensorMap to, const WArgs p) {
  constexpr bool FW = MODE == FWD || MODE == FWD32;
  constexpr int TA = MODE == DW, TB = !FW, RING = ring_stages(MODE);
  __shared__ __align__(8) uint64_t full[STAGES + 1];  // the ring's; dh: h's last
  extern __shared__ __align__(1024) unsigned char dyn_smem[];
  const unsigned raw = smem_u32(dyn_smem);
  unsigned char* smem = dyn_smem + ((1024 - (raw & 1023)) & 1023);
  const unsigned sbase = smem_u32(smem);
  const CUtensorMap *pa = &ta, *pb = &tb, *ph = &th, *po = &to;  // in parameter space
  const int tid = threadIdx.x, wg = tid / 128;
  const int c0 = blockIdx.x * WBN, r0 = blockIdx.y * WBM;
  const int M = p.M, K = p.K, N = p.N;
  int l_begin = 0, l_end = FW ? K : N;  // the reduction's range
  if constexpr (MODE == DW) {
    l_begin = blockIdx.z * p.chunk;
    l_end = min(l_begin + p.chunk, M);
  }
  const int nk = l_end > l_begin ? (l_end - l_begin + WBK - 1) / WBK : 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < RING + (MODE == DH); ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned char* htile = smem + RING * STAGE_BYTES;  // dh: [WBM x WBN] of h, 4 boxes
  if constexpr (MODE == DH) {
    if (tid == 0) {
      const unsigned bar = smem_u32(&full[RING]);
      mbar_expect_tx(bar, H_TILE);
#pragma unroll
      for (int j = 0; j < WBN / 64; ++j)
        tma_load(smem_u32(htile) + j * (H_TILE / 4), ph, bar, c0 + 64 * j, r0);
    }
  }

  // reduction step kt into its stage (thread 0)
  auto issue = [&](int kt) {
    const int s = kt % RING, l0 = l_begin + kt * WBK;
    const unsigned A = sbase + s * STAGE_BYTES, B = A + A_STAGE, bar = smem_u32(&full[s]);
    mbar_expect_tx(bar, STAGE_BYTES);
    if constexpr (FW) {  // h rows r0.., W rows c0.., reduction cols l0..
      tma_load(A, pa, bar, l0, r0);
      tma_load(B, pb, bar, l0, c0);
    } else if constexpr (MODE == DH) {  // g rows r0.. cols l0..; W rows l0.. cols c0..
      tma_load(A, pa, bar, l0, r0);
#pragma unroll
      for (int j = 0; j < WBN / 64; ++j) tma_load(B + j * BOX, pb, bar, c0 + 64 * j, l0);
    } else {  // h rows l0.. cols r0..; g rows l0.. cols c0..
#pragma unroll
      for (int j = 0; j < WBM / 64; ++j) tma_load(A + j * BOX, pa, bar, r0 + 64 * j, l0);
#pragma unroll
      for (int j = 0; j < WBN / 64; ++j) tma_load(B + j * BOX, pb, bar, c0 + 64 * j, l0);
    }
  };
  // all threads: wait for step kt to land; apply act where A is h
  auto ready = [&](int kt) {
    const int s = kt % RING;
    mbar_wait(smem_u32(&full[s]), (kt / RING) & 1);
    if constexpr (MODE != DH) act_stage(smem + s * STAGE_BYTES, p.act);
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  if (tid == 0)
    for (int kt = 0; kt < RING && kt < nk; ++kt) issue(kt);
  if (nk > 0) ready(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const unsigned A = sbase + (kt % RING) * STAGE_BYTES, B = A + A_STAGE;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WBK / 16; ++kk) {
      // this warpgroup's 64 rows of A: K-major rows 128 B apart, a k-step
      // 32 B along them; MN-major its own 64-wide box, a k-step 16 rows on
      const uint64_t da = TA ? sw128_desc(A + wg * BOX + kk * 2048, BOX, 1024)
                             : sw128_desc(A + wg * BOX + kk * 32, 16, 1024);
      const uint64_t db = TB ? sw128_desc(B + kk * 2048, BOX, 1024)
                             : sw128_desc(B + kk * 32, 16, 1024);
      wgmma_m64n256k16<TA, TB>(acc, da, db);
    }
    wgmma_commit();
    fence_acc(acc);
    if (kt + 1 < nk) ready(kt + 1);  // while this step's products run
    wgmma_wait<1>();                 // step kt - 1's products are done
    __syncthreads();                 // in both warpgroups; step kt + 1 is ready
    if (tid == 0 && kt >= 1 && kt - 1 + RING < nk) issue(kt - 1 + RING);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // epilogue, out of the free ring (or, for dh, the h tile) by TMA stores,
  // which skip what lies past the output; the boxes are TMA's
  // 128-byte-swizzled ones of 128 rows (64 bf16 or 32 f32 columns a box).
  // Forward: + b, rounded (FWD32: + b, in f32); dW: the f32 partial. dh:
  // the f32 sums parked in
  // the ring, then act'(h) applied by a loop that is not unrolled (64
  // inlined copies of act' overflow the instruction cache), in place in
  // the h tile.
  __syncthreads();  // both warpgroups' products are done: the ring is free
  constexpr bool F32_OUT = MODE == DW || MODE == FWD32;
  constexpr int EB = F32_OUT ? 4 : 2, BOXC = 128 / EB, OBOX = WBM * 128;
  const int lane = tid % 32, lrow0 = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  // (lr, lc) in its box: 16-byte chunks swizzled by the row's low 3 bits
  auto boxed = [](unsigned char* base, int lr, int lc) {
    const int cb = (lc % BOXC) * EB;
    return base + (lc / BOXC) * OBOX + lr * 128 + ((((cb >> 4) ^ (lr & 7)) << 4) | (cb & 15));
  };
#pragma unroll
  for (int j = 0; j < WBN / 8; ++j) {
    const int lc = 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = lrow0 + 8 * half;
      float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if constexpr (FW) {
        if (p.b && c0 + lc < N) {
          const float2 bb =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.b + c0 + lc));
          v0 += bb.x;
          v1 += bb.y;
        }
        if constexpr (MODE == FWD)
          *reinterpret_cast<__nv_bfloat162*>(boxed(smem, lr, lc)) = __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(boxed(smem, lr, lc)) = make_float2(v0, v1);
      } else if constexpr (MODE == DW) {
        *reinterpret_cast<float2*>(boxed(smem, lr, lc)) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<float2*>(smem + (lr * DH_LD + lc) * 4) = make_float2(v0, v1);
      }
    }
  }
  unsigned char* out = smem;
  if constexpr (MODE == DH) {
    out = htile;
    __syncthreads();
    mbar_wait(smem_u32(&full[RING]), 0);
#pragma unroll 1
    for (int e = tid; e < WBM * WBN / 2; e += WG_THREADS) {
      const int lr = e / (WBN / 2), lc = 2 * (e % (WBN / 2));
      const float2 v = *reinterpret_cast<const float2*>(smem + (lr * DH_LD + lc) * 4);
      __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(boxed(htile, lr, lc));
      const float2 hh = __bfloat1622float2(*hp);
      *hp = __floats2bfloat162_rn(v.x * act_df(p.act, hh.x), v.y * act_df(p.act, hh.y));
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < WBN / BOXC; ++j) {
      const unsigned src = smem_u32(out) + j * OBOX;
      if constexpr (F32_OUT)  // FWD32: one split, z = 0
        tma_store_3d(po, src, c0 + j * BOXC, r0, blockIdx.z);
      else
        tma_store_2d(po, src, c0 + j * BOXC, r0);
    }
    tma_store_wait();
  }
}

// dW [N, K] = Σ_s ws[s] (each [K, N] f32), in the order s = 0 .. S-1, in
// bf16: 32 x 32 tiles, read along N and written along K through shared
// memory. grid (ceil(N/32), ceil(K/32)), 256 threads.
__global__ void __launch_bounds__(256)
xfm_act_matmul_dw_sum(const float* __restrict__ ws, bf16* __restrict__ dw, int S, int K, int N) {
  __shared__ float t[32][33];
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + tx;
    float a = 0.f;
    if (k < K && n < N)
      for (int s = 0; s < S; ++s) a += ws[((size_t)s * K + k) * N + n];
    t[i][tx] = a;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + tx;
    if (n < N && k < K) dw[(size_t)n * K + k] = __float2bfloat16(t[tx][i]);
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// the driver's cuTensorMapEncodeTiled, found once through the runtime (no
// link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a row-major bf16 matrix [rows, cols] (or f32 [splits][rows, cols], a 3-D
// map) as a TMA map of boxes of box_rows rows x 128 bytes (64 or 32
// columns) of one split, 128-byte swizzle; loads see zero outside the
// matrix, stores skip it
bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
              int splits = 0) {
  const bool f32 = splits > 0;
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t eb = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)(f32 ? splits : 1)};
  const cuuint64_t strides[2] = {cols * eb, (cuuint64_t)rows * cols * eb};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / eb), (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            f32 ? 3 : 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the output [rows, cols] of MODE in [WBM x WBN] tiles, `splits` of them
// along dW's M
template <int MODE>
cudaError_t launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& th,
                         const CUtensorMap& to, const WArgs& p, int rows, int cols, int splits,
                         cudaStream_t st) {
  auto kernel = xfm_act_matmul_wgmma<MODE>;
  constexpr size_t smem = wg_smem(MODE);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((cols + WBN - 1) / WBN, (rows + WBM - 1) / WBM, splits);
  kernel<<<grid, WG_THREADS, smem, st>>>(ta, tb, th, to, p);
  return cudaGetLastError();
}

// y bf16, or with out_f32 f32 (a 3-D map of one split)
int fwd_bf16(const bf16* h, const bf16* w, const bf16* b, void* y, int M, int K, int N, int act,
             bool out_f32, cudaStream_t st) {
  CUtensorMap ta, tb, to;
  if (!make_map(&ta, h, M, K, WBM) || !make_map(&tb, w, N, K, WBN) ||
      !make_map(&to, y, M, N, WBM, out_f32 ? 1 : 0))
    return (int)cudaErrorNotSupported;
  const WArgs p{b, M, K, N, act, 0};
  if (out_f32) return (int)launch_wgmma<FWD32>(ta, tb, ta, to, p, M, N, 1, st);
  return (int)launch_wgmma<FWD>(ta, tb, ta, to, p, M, N, 1, st);
}

// dW through the workspace ws [S, K, N] f32, then dh
int bwd_bf16(const bf16* h, const bf16* w, const bf16* g, bf16* dh, bf16* dw, float* ws, int M,
             int K, int N, int act, int S, cudaStream_t st) {
  CUtensorMap hm, hk, gm, gk, wm, wsm, dhm;
  if (!make_map(&hm, h, M, K, 64) || !make_map(&hk, h, M, K, WBM) ||
      !make_map(&gm, g, M, N, 64) || !make_map(&gk, g, M, N, WBM) ||
      !make_map(&wm, w, N, K, 64) || !make_map(&wsm, ws, K, N, WBM, S) ||
      !make_map(&dhm, dh, M, K, WBM))
    return (int)cudaErrorNotSupported;
  const int chunk = ((M + WBK - 1) / WBK + S - 1) / S * WBK;
  const WArgs pw{nullptr, M, K, N, act, chunk};
  cudaError_t e = launch_wgmma<DW>(hm, gm, hm, wsm, pw, K, N, S, st);
  if (e != cudaSuccess) return (int)e;
  xfm_act_matmul_dw_sum<<<dim3((N + 31) / 32, (K + 31) / 32), 256, 0, st>>>(ws, dw, S, K, N);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const WArgs ph{nullptr, M, K, N, act, 0};
  return (int)launch_wgmma<DH>(gk, wm, hk, dhm, ph, M, K, 1, st);
}

template <int MODE>
cudaError_t launch_f32(const Args& p, cudaStream_t st) {
  using L = Lay<float, MODE == DW, MODE == FWD>;
  auto kernel = xfm_act_matmul<float, MODE>;
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

// h [M, K], w [N, K], b [N] or null (no bias), y [M, N], one dtype (with
// out_f32, y f32 whatever h's); 16-byte aligned, contiguous; K, N
// multiples of 8.
extern "C" int xfm_act_matmul_fwd(const void* h, const void* w, const void* b,
                                  void* y, int M, int K, int N, int act,
                                  int is_bf16, int out_f32, void* stream) {
  if (!dims_ok(M, K, N, act)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return fwd_bf16(static_cast<const bf16*>(h), static_cast<const bf16*>(w),
                    static_cast<const bf16*>(b), y, M, K, N, act, out_f32 != 0, st);
  const Args p{h, w, b, nullptr, y, M, K, N, act};
  return (int)launch_f32<FWD>(p, st);
}

// g [M, N] → dh [M, K] and dw [N, K] (the dW kernel, then the dh kernel).
// bf16: ws f32 [splits, K, N], the dW partials, splits >= 1; f32: ws null,
// splits unused.
extern "C" int xfm_act_matmul_bwd(const void* h, const void* w, const void* g,
                                  void* dh, void* dw, void* ws, int M, int K, int N,
                                  int act, int splits, int is_bf16, void* stream) {
  if (!dims_ok(M, K, N, act)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (splits < 1 || !ws) return (int)cudaErrorInvalidValue;
    return bwd_bf16(static_cast<const bf16*>(h), static_cast<const bf16*>(w),
                    static_cast<const bf16*>(g), static_cast<bf16*>(dh), static_cast<bf16*>(dw),
                    static_cast<float*>(ws), M, K, N, act, splits, st);
  }
  const Args pw{h, w, nullptr, g, dw, M, K, N, act};
  const Args ph{h, w, nullptr, g, dh, M, K, N, act};
  cudaError_t e = launch_f32<DW>(pw, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_f32<DH>(ph, st);
}
