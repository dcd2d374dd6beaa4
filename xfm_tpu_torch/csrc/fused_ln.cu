// K4: the fused (residual-add +) LayerNorm, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of xfm_tpu/ops/fused_ln.py: `_fwd_kernel`
// (fused_ln.py:91, called from `_fwd_pallas` :169) and `_bwd_kernel` (:108,
// called from `_bwd_pallas` :188).
//
//   forward   xn = x + y (f32; y optional), h = (xn - mean)·rstd·γ + β
//             xn (rounded to x's dtype, written only with y) and h out
//   backward  from the saved, rounded xn: the row statistics again, then
//             dx = rstd·(g − mean(g) − x̂·mean(g·x̂)) [+ dxn], g = dh·γ;
//             dγ = Σ dh·x̂ and dβ = Σ dh over all rows, in f32
//
// What bounds it on an H100: bytes. At the BEiT site (R = 18,912 rows,
// C = 768, bf16) each direction moves four [R, C] tensors, 116.2 MB, so
// 0.035 ms at 3.35 TB/s; it does ~10 f32 operations per element, far under
// the CUDA cores' 67 TFLOP/s. The design reads and writes each element once:
// one warp (W warps for C > 1024) owns a row and keeps it in registers
// (C = 768: 24 values a lane, read as vectors of 4) across the two passes of
// the statistics and the output pass; no padding of the rows (the TPU's
// 512-row blocks are not carried over).
//
// dγ and dβ are sums over all rows. The TPU carried them across its
// sequential grid; here blocks run in any order, so without atomics: the
// backward has a fixed number of blocks, each walks a fixed set of rows (row
// groups blockIdx.x, blockIdx.x + gridDim.x, ...), each lane keeps its
// columns' sums in registers, the block's row groups are summed through
// shared memory in a fixed order, and the block writes one f32 partial row
// [2, blocks, C]; a second kernel sums the partials per column in block
// order. Two runs give the same bits.
#include "attention_tiles.cuh"

namespace {

constexpr int LN_THREADS = 256, LN_WARPS = LN_THREADS / 32;
constexpr int MAXV = 8;  // vectors of 4 values a lane holds: C <= 1024 · W

// 4 consecutive values as f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&a);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(e[j]);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float v[4]) {
  uint2 a;
  bf16* e = reinterpret_cast<bf16*>(&a);
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = __float2bfloat16(v[j]);
  *reinterpret_cast<uint2*>(p) = a;
}

// Sum of v over the W warps that share a row (warps grp·W ... grp·W + W − 1
// of the block), in a fixed order; every thread of the block calls it.
template <int W>
__device__ __forceinline__ float row_sum(float v, float* red) {
  v = warp_sum(v);
  if constexpr (W == 1) {
    return v;
  } else {
    const int warp = threadIdx.x / 32, grp = warp / W;
    if (threadIdx.x % 32 == 0) red[warp] = v;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) s += red[grp * W + i];
    __syncthreads();
    return s;
  }
}

// The lane's share of one row: vectors t, t + 32·W, ... of the row's C / 4
struct RowMap {
  int t, nv;
  __device__ bool ok(int k, int W) const { return t + k * 32 * W < nv; }
  __device__ int col(int k, int W) const { return (t + k * 32 * W) * 4; }
};

template <typename T, int W, bool HAS_Y>
__global__ void __launch_bounds__(LN_THREADS)
xfm_ln_fwd(const T* __restrict__ x, const T* __restrict__ y,
           const float* __restrict__ gamma, const float* __restrict__ beta,
           T* __restrict__ xn_out, T* __restrict__ h_out, int R, int C,
           float eps) {
  __shared__ float red[LN_WARPS];
  const int warp = threadIdx.x / 32;
  const int row = blockIdx.x * (LN_WARPS / W) + warp / W;
  const bool valid = row < R;
  const RowMap map{(warp % W) * 32 + (int)(threadIdx.x % 32), C / 4};
  const size_t base = (size_t)(valid ? row : 0) * C;
  float v[MAXV][4];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    if (valid && map.ok(k, W)) {
      load4(x + base + map.col(k, W), v[k]);
      if constexpr (HAS_Y) {
        float u[4];
        load4(y + base + map.col(k, W), u);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[k][j] += u[j];
        store4(xn_out + base + map.col(k, W), v[k]);  // the sum, rounded
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) s += v[k][j];
    }
  }
  const float mean = row_sum<W>(s, red) / C;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    if (valid && map.ok(k, W)) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[k][j] -= mean;
        q += v[k][j] * v[k][j];
      }
    }
  }
  const float rstd = rsqrtf(row_sum<W>(q, red) / C + eps);
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    if (valid && map.ok(k, W)) {
      const int c = map.col(k, W);
      float g[4], b[4], o[4];
      load4(gamma + c, g);
      load4(beta + c, b);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = v[k][j] * rstd * g[j] + b[j];
      store4(h_out + base + c, o);
    }
  }
}

template <typename T, int W, bool HAS_DXN>
__global__ void __launch_bounds__(LN_THREADS)
xfm_ln_bwd(const T* __restrict__ xn, const T* __restrict__ dh,
           const T* __restrict__ dxn, const float* __restrict__ gamma,
           T* __restrict__ dx, float* __restrict__ partial, int R, int C,
           float eps) {
  constexpr int RPB = LN_WARPS / W;  // rows a block takes at a time
  __shared__ float red[LN_WARPS];
  __shared__ float cols[LN_WARPS * 1024];  // RPB · C <= 8192 floats
  const int warp = threadIdx.x / 32, grp = warp / W;
  const RowMap map{(warp % W) * 32 + (int)(threadIdx.x % 32), C / 4};
  float pg[MAXV][4], pb[MAXV][4];
#pragma unroll
  for (int k = 0; k < MAXV; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) pg[k][j] = pb[k][j] = 0.f;

  for (int it = blockIdx.x; it * RPB < R; it += gridDim.x) {
    const int row = it * RPB + grp;
    const bool valid = row < R;
    const size_t base = (size_t)(valid ? row : 0) * C;
    float v[MAXV][4];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      if (valid && map.ok(k, W)) {
        load4(xn + base + map.col(k, W), v[k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) s += v[k][j];
      }
    }
    const float mean = row_sum<W>(s, red) / C;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      if (valid && map.ok(k, W)) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[k][j] -= mean;
          q += v[k][j] * v[k][j];
        }
      }
    }
    const float rstd = rsqrtf(row_sum<W>(q, red) / C + eps);
    // v ← x̂; d ← dh; g = dh·γ kept in d's place after the partial sums
    float d[MAXV][4];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      if (valid && map.ok(k, W)) {
        float gm[4];
        load4(dh + base + map.col(k, W), d[k]);
        load4(gamma + map.col(k, W), gm);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[k][j] *= rstd;
          pg[k][j] += d[k][j] * v[k][j];
          pb[k][j] += d[k][j];
          d[k][j] *= gm[j];
          m1 += d[k][j];
          m2 += d[k][j] * v[k][j];
        }
      }
    }
    m1 = row_sum<W>(m1, red) / C;
    m2 = row_sum<W>(m2, red) / C;
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      if (valid && map.ok(k, W)) {
        const int c = map.col(k, W);
        float o[4], e[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = rstd * (d[k][j] - m1 - v[k][j] * m2);
        if constexpr (HAS_DXN) {
          load4(dxn + base + c, e);
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] += e[j];
        }
        store4(dx + base + c, o);
      }
    }
  }

  // the block's row groups → one partial row each for dγ and dβ, summed in
  // group order
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      if (map.ok(k, W)) {
        const int c = map.col(k, W);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cols[grp * C + c + j] = which == 0 ? pg[k][j] : pb[k][j];
      }
    }
    __syncthreads();
    float* out = partial + ((size_t)which * gridDim.x + blockIdx.x) * C;
    for (int c = threadIdx.x; c < C; c += LN_THREADS) {
      float a = 0.f;
      for (int g2 = 0; g2 < RPB; ++g2) a += cols[g2 * C + c];
      out[c] = a;
    }
    __syncthreads();
  }
}

// dγ, dβ: the partial rows of all blocks summed per column in block order
__global__ void __launch_bounds__(LN_THREADS)
xfm_ln_bwd_reduce(const float* __restrict__ partial, int blocks, int C,
                  float* __restrict__ dg, float* __restrict__ db) {
  const int i = blockIdx.x * LN_THREADS + threadIdx.x;
  if (i >= 2 * C) return;
  const int which = i / C, c = i % C;
  const float* p = partial + (size_t)which * blocks * C + c;
  float a = 0.f;
  for (int b = 0; b < blocks; ++b) a += p[(size_t)b * C];
  (which == 0 ? dg : db)[c] = a;
}

// the warps a row needs so that a lane holds at most MAXV vectors
int warps_per_row(int C) {
  const int nv = C / 4;
  return nv <= 32 * MAXV ? 1 : nv <= 64 * MAXV ? 2 : nv <= 128 * MAXV ? 4 : 8;
}

template <typename T, int W>
cudaError_t launch_fwd_w(const void* x, const void* y, const float* gamma,
                         const float* beta, void* xn, void* h, int R, int C,
                         float eps, cudaStream_t st) {
  const dim3 grid((R + LN_WARPS / W - 1) / (LN_WARPS / W));
  if (y)
    xfm_ln_fwd<T, W, true><<<grid, LN_THREADS, 0, st>>>(
        (const T*)x, (const T*)y, gamma, beta, (T*)xn, (T*)h, R, C, eps);
  else
    xfm_ln_fwd<T, W, false><<<grid, LN_THREADS, 0, st>>>(
        (const T*)x, nullptr, gamma, beta, nullptr, (T*)h, R, C, eps);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t launch_bwd_w(const void* xn, const void* dh, const void* dxn,
                         const float* gamma, void* dx, float* dg, float* db,
                         float* partial, int R, int C, int blocks, float eps,
                         cudaStream_t st) {
  if (dxn)
    xfm_ln_bwd<T, W, true><<<blocks, LN_THREADS, 0, st>>>(
        (const T*)xn, (const T*)dh, (const T*)dxn, gamma, (T*)dx, partial, R,
        C, eps);
  else
    xfm_ln_bwd<T, W, false><<<blocks, LN_THREADS, 0, st>>>(
        (const T*)xn, (const T*)dh, nullptr, gamma, (T*)dx, partial, R, C,
        eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  xfm_ln_bwd_reduce<<<(2 * C + LN_THREADS - 1) / LN_THREADS, LN_THREADS, 0,
                      st>>>(partial, blocks, C, dg, db);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* y, const float* gamma,
                       const float* beta, void* xn, void* h, int R, int C,
                       float eps, cudaStream_t st) {
  switch (warps_per_row(C)) {
    case 1: return launch_fwd_w<T, 1>(x, y, gamma, beta, xn, h, R, C, eps, st);
    case 2: return launch_fwd_w<T, 2>(x, y, gamma, beta, xn, h, R, C, eps, st);
    case 4: return launch_fwd_w<T, 4>(x, y, gamma, beta, xn, h, R, C, eps, st);
    default: return launch_fwd_w<T, 8>(x, y, gamma, beta, xn, h, R, C, eps, st);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* xn, const void* dh, const void* dxn,
                       const float* gamma, void* dx, float* dg, float* db,
                       float* partial, int R, int C, int blocks, float eps,
                       cudaStream_t st) {
  switch (warps_per_row(C)) {
    case 1: return launch_bwd_w<T, 1>(xn, dh, dxn, gamma, dx, dg, db, partial,
                                      R, C, blocks, eps, st);
    case 2: return launch_bwd_w<T, 2>(xn, dh, dxn, gamma, dx, dg, db, partial,
                                      R, C, blocks, eps, st);
    case 4: return launch_bwd_w<T, 4>(xn, dh, dxn, gamma, dx, dg, db, partial,
                                      R, C, blocks, eps, st);
    default: return launch_bwd_w<T, 8>(xn, dh, dxn, gamma, dx, dg, db,
                                       partial, R, C, blocks, eps, st);
  }
}

bool shape_ok(int R, int C) { return R > 0 && C > 0 && C % 128 == 0 && C <= 8192; }

}  // namespace

// x, y (may be null), xn (null without y), h: [R, C] in one dtype; gamma,
// beta: f32 [C]. 16-byte aligned, contiguous.
extern "C" int xfm_fused_ln_fwd(const void* x, const void* y, const void* gamma,
                                const void* beta, void* xn, void* h, int R,
                                int C, float eps, int is_bf16, void* stream) {
  if (!shape_ok(R, C) || (y != nullptr) != (xn != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<bf16>(x, y, (const float*)gamma,
                                    (const float*)beta, xn, h, R, C, eps, st)
                 : launch_fwd<float>(x, y, (const float*)gamma,
                                     (const float*)beta, xn, h, R, C, eps, st);
}

// xn, dh, dxn (may be null), dx: [R, C] in one dtype; gamma, dg, db: f32 [C];
// partial: f32 [2, blocks, C] scratch.
extern "C" int xfm_fused_ln_bwd(const void* xn, const void* dh, const void* dxn,
                                const void* gamma, void* dx, void* dg, void* db,
                                void* partial, int R, int C, int blocks,
                                float eps, int is_bf16, void* stream) {
  if (!shape_ok(R, C) || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_bwd<bf16>(xn, dh, dxn, (const float*)gamma, dx,
                                (float*)dg, (float*)db, (float*)partial, R, C,
                                blocks, eps, st)
             : launch_bwd<float>(xn, dh, dxn, (const float*)gamma, dx,
                                 (float*)dg, (float*)db, (float*)partial, R, C,
                                 blocks, eps, st);
}
