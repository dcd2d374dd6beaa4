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
// What bounds it on an H100: bytes. The forward reads x (and y) and writes h
// (and xn); the backward reads xn, dh (and dxn, add variant) and γ, and
// writes dx, dγ and dβ: 3 or 4 tensors [R, C] plus 3·C·4 bytes. At the BEiT
// site (R = 18,912 rows, C = 768, bf16, add) each direction moves 116.2 MB,
// 0.035 ms at 3.35 TB/s; about 10 f32 operations an element (17 backward)
// are far under the CUDA cores' 67 TFLOP/s. Both read and write each
// element of device memory once.
//
// Forward: one warp (W warps for C > 1024) owns a row and keeps it in
// registers (C = 768: 24 values a lane, read as vectors of 4) across the
// two passes of the statistics and the output pass; no padding of the rows
// (the TPU's 512-row blocks are not carried over).
//
// Backward (`xfm_ln_bwd_ring`): a warp that loads its row's tensors one
// after another keeps too few bytes in flight to near the bound, so this
// design keeps each SM's memory pipe full, and runs in one launch:
//   - Persistent blocks, one an SM (the grid is the SM count, from the
//     wrapper's `bwd_plan`), each owning a contiguous range of row groups
//     fixed by R and the grid. A group is G = 8 / W rows, one a row slot of
//     the 8 consumer warps.
//   - A ring of S stages in dynamic shared memory (S from the plan: about
//     64 KB, at least 2 and at most 8 stages, within 227 KB), each holding
//     one group of xn, dh and (add) dxn, filled by 1-D TMA bulk copies
//     (`cp.async.bulk`, no tensor map: a group of rows of each [R, C]
//     tensor is one contiguous run; the last group copies its true byte
//     count, so nothing past R is read). One thread of a ninth, producer
//     warp keeps the ring S groups ahead through a full/empty mbarrier pair
//     a stage: at C = 768 bf16 (add) two 36.9 KB stages, ~74 KB in flight
//     an SM where Little's law asks ~25 KB; C = 8,192 in f32 fits 2.
//     γ comes once a block, by the same copy.
//   - Consumers read their row from the stage with 16-byte loads, compute
//     the statistics and dx in f32 from registers (x̂ stays in registers,
//     dh is read from the stage twice), store dx with 16-byte stores, and
//     release the stage.
//   - dγ and dβ in the same launch, without atomics on the data: each lane
//     sums its columns over the block's rows in registers, the row slots'
//     sums are added through shared memory in slot order, and the block
//     writes one f32 partial row for each into a scratch [2, blocks + fold
//     groups, C]. The fold across blocks takes two levels so that no block
//     reads more than ~√blocks rows: blocks form fold groups of
//     ⌈√blocks⌉ in index order; an atomic ticket a group tells the last
//     of its blocks to arrive, which sums the group's rows in block order;
//     a ticket over the groups tells the last of those, which sums the
//     group rows in group order into dγ and dβ. Each last block resets its
//     ticket to 0 after a __threadfence(), so the next call finds the
//     counters (an int32 vector the wrapper allocates once a device) at 0.
//     The bits do not depend on which block finishes last; they depend on
//     the grid, so on the SM count. The counters assume one stream at a
//     time: two backward calls running at once on two streams of one device
//     would share them.
#include "attention_tiles.cuh"
#include "tma_ring.cuh"

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

// ---- backward: persistent blocks over a TMA bulk-copy ring ----

constexpr int BWD_CWARPS = 8;                       // consumer warps a block
constexpr int BWD_THREADS = 32 * (BWD_CWARPS + 1);  // and the producer warp
constexpr int BWD_MAX_STAGES = 8;
constexpr int BWD_BAR_BYTES = 256;       // full[8], empty[8], γ's barrier
constexpr int BWD_SMEM_LIMIT = 231424;   // dynamic bytes (227 KB less 1 KB)
constexpr int MAXE = 4 * MAXV;           // values of a row a lane holds

template <typename T>
struct BwdArgs {
  const T* xn;
  const T* dh;
  const T* dxn;  // null: plain and post variants
  const float* gamma;
  T* dx;
  float* dg;
  float* db;
  float* scratch;  // f32 [2, blocks + fold_groups, C]
  int* counters;   // int32 [1 + fold_groups], all 0 between calls
  int R, C, groups, stages, fold_group, fold_groups;
  float eps;
};

// 16 bytes: 4 f32 or 8 bf16 values as f32
__device__ __forceinline__ void ld16(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void ld16(const bf16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void st16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st16(bf16* p, const float (&v)[8]) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = a;
}
template <int VEC>
__device__ __forceinline__ void ld_f32(const float* p, float (&v)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; j += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + j);
    v[j] = a.x; v[j + 1] = a.y; v[j + 2] = a.z; v[j + 3] = a.w;
  }
}

// v[i] ← its sum over the W consumer warps of one row, in warp order,
// through `buf` and a named barrier of the row's warps (the producer warp
// takes no part). A row's three sums use three buffers, so one barrier a
// sum is enough: a warp writes a buffer again only after every warp of its
// row has passed the two barriers between.
template <int W, int N>
__device__ __forceinline__ void row_sums(float (&v)[N], float (*buf)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = warp_sum(v[i]);
  if constexpr (W > 1) {
    const int warp = threadIdx.x / 32, grp = warp / W;
    if (threadIdx.x % 32 == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) buf[warp][i] = v[i];
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(32 * W) : "memory");
#pragma unroll
    for (int i = 0; i < N; ++i) {
      v[i] = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) v[i] += buf[grp * W + w][i];
    }
  }
}

// dst0[c], dst1[c] = the sums over rows r0 <= r < r1, in the order of r, of
// the scratch's first and second halves (rows `slots` apart); every thread
// of the block calls it. A thread takes vectors of 4 columns, t and
// t + BWD_THREADS, and loads FOLD_ROWS rows of each before it adds any, so
// that a fold group's rows (⌈√blocks⌉ <= FOLD_ROWS up to 144 blocks) take
// one round trip to L2, where the other blocks wrote them.
constexpr int FOLD_ROWS = 12;
__device__ __forceinline__ void fold_rows(const float* scratch, size_t slots, int C, int r0,
                                          int r1, float* dst0, float* dst1) {
  constexpr int U = 2;
  const int n4 = C / 2;  // vectors of 4 in the two halves' 2·C columns
  for (int base = threadIdx.x; base < n4; base += U * BWD_THREADS) {
    float4 a[U];
    const float4* q[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = min(base + u * BWD_THREADS, n4 - 1) * 4;
      a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      q[u] = reinterpret_cast<const float4*>(scratch + (size_t)(i / C) * slots * C + i % C);
    }
    for (int r = r0; r < r1; r += FOLD_ROWS) {
      float4 v[FOLD_ROWS][U];
#pragma unroll
      for (int k = 0; k < FOLD_ROWS; ++k)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (r + k < r1) v[k][u] = __ldcg(q[u] + (size_t)(r + k) * (C / 4));
#pragma unroll
      for (int k = 0; k < FOLD_ROWS; ++k) {
        if (r + k < r1) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            a[u].x += v[k][u].x;
            a[u].y += v[k][u].y;
            a[u].z += v[k][u].z;
            a[u].w += v[k][u].w;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = (base + u * BWD_THREADS) * 4;
      if (i < 2 * C) *reinterpret_cast<float4*>((i < C ? dst0 : dst1) + i % C) = a[u];
    }
  }
}

template <typename T, int W, bool HAS_DXN>
__global__ void __launch_bounds__(BWD_THREADS, 1) xfm_ln_bwd_ring(const BwdArgs<T> p) {
  constexpr int VEC = 16 / (int)sizeof(T), KV = MAXE / VEC, G = BWD_CWARPS / W;
  constexpr int NIN = HAS_DXN ? 3 : 2;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[3][BWD_CWARPS][2];
  __shared__ int last;
  const int C = p.C, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* gam = reinterpret_cast<float*>(smem);  // γ [C]
  const unsigned bars = smem_u32(smem + (size_t)C * 4);
  const unsigned gbar = bars + 8 * 2 * BWD_MAX_STAGES;
  unsigned char* ring = smem + (size_t)C * 4 + BWD_BAR_BYTES;
  const unsigned slab = (unsigned)(G * C * sizeof(T));  // one tensor's rows of a stage
  const unsigned stage_bytes = slab * NIN;
  const int S = p.stages;
  // this block's row groups g0 .. g0 + n - 1 (n >= 1: the grid <= groups)
  const int g0 = (int)((long long)blockIdx.x * p.groups / gridDim.x);
  const int n = (int)((long long)(blockIdx.x + 1) * p.groups / gridDim.x) - g0;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);                                 // full
      mbar_init(bars + 8 * (BWD_MAX_STAGES + s), BWD_CWARPS);     // empty
    }
    mbar_init(gbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // each lane's columns: vectors t, t + 32·W, ... of the row's C / VEC
  const int grp = warp / W, t = (warp % W) * 32 + lane, nvec = C / VEC;
  float pg[KV][VEC], pb[KV][VEC];  // Σ dh·x̂ and Σ dh over the block's rows
#pragma unroll
  for (int k = 0; k < KV; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) pg[k][j] = pb[k][j] = 0.f;

  if (warp == BWD_CWARPS) {
    if (lane == 0) {  // the producer: γ, then the block's groups, S stages ahead
      mbar_expect_tx(gbar, C * 4);
      bulk_load(smem_u32(gam), p.gamma, C * 4, gbar);
      for (int i = 0; i < n; ++i) {
        const int s = i % S, g = g0 + i;
        const unsigned full = bars + 8 * s;
        if (i >= S) mbar_wait(bars + 8 * (BWD_MAX_STAGES + s), ((i / S) - 1) & 1);
        const size_t off = (size_t)g * G * C;
        const unsigned bytes = (unsigned)(min(G, p.R - g * G) * C * (int)sizeof(T));
        const unsigned dst = smem_u32(ring) + s * stage_bytes;
        mbar_expect_tx(full, bytes * NIN);
        bulk_load(dst, p.xn + off, bytes, full);
        bulk_load(dst + slab, p.dh + off, bytes, full);
        if constexpr (HAS_DXN) bulk_load(dst + 2 * slab, p.dxn + off, bytes, full);
      }
    }
  } else {
    mbar_wait(gbar, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % S, row = (g0 + i) * G + grp;
      mbar_wait(bars + 8 * s, (i / S) & 1);
      if (row < p.R) {
        const unsigned char* st = ring + (size_t)s * stage_bytes;
        const T* xs = reinterpret_cast<const T*>(st) + grp * C;
        const T* ds = reinterpret_cast<const T*>(st + slab) + grp * C;
        float x[KV][VEC];
        float sum[1] = {0.f};
#pragma unroll
        for (int k = 0; k < KV; ++k) {
          if (t + k * 32 * W < nvec) {
            ld16(xs + (t + k * 32 * W) * VEC, x[k]);
#pragma unroll
            for (int j = 0; j < VEC; ++j) sum[0] += x[k][j];
          }
        }
        row_sums<W>(sum, red[0]);
        const float mean = sum[0] / C;
        float q[1] = {0.f};
#pragma unroll
        for (int k = 0; k < KV; ++k) {
          if (t + k * 32 * W < nvec) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              x[k][j] -= mean;
              q[0] += x[k][j] * x[k][j];
            }
          }
        }
        row_sums<W>(q, red[1]);
        const float rstd = rsqrtf(q[0] / C + p.eps);
        // x ← x̂; the column sums; g = dh·γ and its two row means
        float m[2] = {0.f, 0.f};
#pragma unroll
        for (int k = 0; k < KV; ++k) {
          if (t + k * 32 * W < nvec) {
            const int c = (t + k * 32 * W) * VEC;
            float d[VEC], gm[VEC];
            ld16(ds + c, d);
            ld_f32<VEC>(gam + c, gm);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              x[k][j] *= rstd;
              pg[k][j] += d[j] * x[k][j];
              pb[k][j] += d[j];
              const float g = d[j] * gm[j];
              m[0] += g;
              m[1] += g * x[k][j];
            }
          }
        }
        row_sums<W>(m, red[2]);
        const float m1 = m[0] / C, m2 = m[1] / C;
        T* out = p.dx + (size_t)row * C;
#pragma unroll
        for (int k = 0; k < KV; ++k) {
          if (t + k * 32 * W < nvec) {
            const int c = (t + k * 32 * W) * VEC;
            float d[VEC], gm[VEC], o[VEC];
            ld16(ds + c, d);
            ld_f32<VEC>(gam + c, gm);
#pragma unroll
            for (int j = 0; j < VEC; ++j) o[j] = rstd * (d[j] * gm[j] - m1 - x[k][j] * m2);
            if constexpr (HAS_DXN) {
              float e[VEC];
              ld16(reinterpret_cast<const T*>(st + 2 * slab) + grp * C + c, e);
#pragma unroll
              for (int j = 0; j < VEC; ++j) o[j] += e[j];
            }
            st16(out + c, o);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (BWD_MAX_STAGES + s));  // release the stage
    }
  }

  // The block's partial rows: the row slots' sums in slot order, through
  // the ring (every stage has been consumed, so it is free).
  __syncthreads();
  float* fold = reinterpret_cast<float*>(ring);  // [G, C]
  const size_t slots = (size_t)gridDim.x + p.fold_groups;
  for (int which = 0; which < 2; ++which) {
    if (warp < BWD_CWARPS) {
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        if (t + k * 32 * W < nvec) {
          const int c = (t + k * 32 * W) * VEC;
#pragma unroll
          for (int j = 0; j < VEC; ++j) fold[grp * C + c + j] = which == 0 ? pg[k][j] : pb[k][j];
        }
      }
    }
    __syncthreads();
    float* out = p.scratch + (which * slots + blockIdx.x) * C;
    for (int c = tid; c < C; c += BWD_THREADS) {
      float a = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) a += fold[g * C + c];
      out[c] = a;
    }
    __syncthreads();
  }

  // Across blocks: the last block of each fold group sums the group's rows
  // in block order; the last of those sums the group rows in group order.
  // Thread 0 takes the ticket after the block's barrier and a fence, so
  // that the block's rows are visible to whichever block is last.
  const int fg = blockIdx.x / p.fold_group, b0 = fg * p.fold_group;
  const int b1 = min(b0 + p.fold_group, (int)gridDim.x);
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(p.counters + 1 + fg, 1) == b1 - b0 - 1;
    if (last) {
      p.counters[1 + fg] = 0;
      __threadfence();
    }
  }
  __syncthreads();
  if (!last) return;
  fold_rows(p.scratch, slots, C, b0, b1, p.scratch + (gridDim.x + fg) * C,
            p.scratch + (slots + gridDim.x + fg) * C);
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(p.counters, 1) == p.fold_groups - 1;
    if (last) {
      p.counters[0] = 0;
      __threadfence();
    }
  }
  __syncthreads();
  if (!last) return;
  fold_rows(p.scratch, slots, C, gridDim.x, gridDim.x + p.fold_groups, p.dg, p.db);
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

// the dynamic shared bytes of the backward: γ, the barriers, the ring
size_t bwd_smem(int C, int esz, int nin, int stages) {
  const int G = BWD_CWARPS / warps_per_row(C);
  return (size_t)C * 4 + BWD_BAR_BYTES + (size_t)stages * G * C * esz * nin;
}

template <typename T, int W, bool HAS_DXN>
cudaError_t launch_bwd_wd(const BwdArgs<T>& a, int blocks, int smem, cudaStream_t st) {
  auto kernel = xfm_ln_bwd_ring<T, W, HAS_DXN>;
  static unsigned allowed = 0;  // devices whose shared-memory limit is raised, a bit each
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(allowed >> dev & 1u)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BWD_SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    allowed |= 1u << dev;
  }
  kernel<<<blocks, BWD_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t launch_bwd_w(const BwdArgs<T>& a, int blocks, int smem, cudaStream_t st) {
  return a.dxn ? launch_bwd_wd<T, W, true>(a, blocks, smem, st)
               : launch_bwd_wd<T, W, false>(a, blocks, smem, st);
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
cudaError_t launch_bwd(const void* xn, const void* dh, const void* dxn, const void* gamma,
                       void* dx, void* dg, void* db, void* scratch, void* counters, int R,
                       int C, int blocks, int stages, int fold_group, int smem, float eps,
                       cudaStream_t st) {
  const int W = warps_per_row(C), G = BWD_CWARPS / W;
  const BwdArgs<T> a{(const T*)xn, (const T*)dh, (const T*)dxn, (const float*)gamma,
                     (T*)dx, (float*)dg, (float*)db, (float*)scratch, (int*)counters,
                     R, C, (R + G - 1) / G, stages, fold_group,
                     (blocks + fold_group - 1) / fold_group, eps};
  switch (W) {
    case 1: return launch_bwd_w<T, 1>(a, blocks, smem, st);
    case 2: return launch_bwd_w<T, 2>(a, blocks, smem, st);
    case 4: return launch_bwd_w<T, 4>(a, blocks, smem, st);
    default: return launch_bwd_w<T, 8>(a, blocks, smem, st);
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
// scratch: f32 [2, blocks + ⌈blocks / fold_group⌉, C]; counters: int32
// [1 + ⌈blocks / fold_group⌉], all 0. The plan (`ops/fused_ln.py`
// `bwd_plan`): `blocks` persistent blocks (at most the row groups), `rows`
// a group (8 / warps a row), `stages` in the ring, blocks of a fold group,
// and the dynamic shared bytes, checked against this file's own count.
extern "C" int xfm_fused_ln_bwd(const void* xn, const void* dh, const void* dxn,
                                const void* gamma, void* dx, void* dg, void* db,
                                void* scratch, void* counters, int R, int C,
                                int blocks, int rows, int stages, int fold_group,
                                int smem, float eps, int is_bf16, void* stream) {
  if (!shape_ok(R, C)) return (int)cudaErrorInvalidValue;
  const int G = BWD_CWARPS / warps_per_row(C);
  const size_t want = bwd_smem(C, is_bf16 ? 2 : 4, dxn ? 3 : 2, stages);
  if (rows != G || blocks < 1 || blocks > (R + G - 1) / G || stages < 1 ||
      stages > BWD_MAX_STAGES || fold_group < 1 || (size_t)smem != want ||
      smem > BWD_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<bf16>(xn, dh, dxn, gamma, dx, dg, db, scratch, counters, R, C,
                                    blocks, stages, fold_group, smem, eps, st)
                 : launch_bwd<float>(xn, dh, dxn, gamma, dx, dg, db, scratch, counters, R,
                                     C, blocks, stages, fold_group, smem, eps, st);
}
