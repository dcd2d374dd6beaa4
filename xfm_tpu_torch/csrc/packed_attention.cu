// BEiT self-attention over the packed qkv projection, forward and backward,
// for Hopper (sm_90a). Plain C interface, loaded with ctypes by
// xfm_tpu_torch/ops/flash_attention.py.
//
// Replaces the TPU kernels xfm_tpu/ops/flash_attention.py
// `_packed_fwd_kernel` (:983, called at :1160) / `_packed_bwd_kernel` (:1007,
// called at :1210) (public entry `flash_attention_packed` :1226). Computes,
// per (row b, head h),
//     out = softmax((q*scale) k^T + bias) v
// with q, k, v read in place out of qkv [B, N, 3*H*D] (layout [q | k | v],
// heads contiguous inside each section), dq, dk, dv written in place into
// dqkv, and bias [1, H, N, N] f32 shared by the batch, N < 512, D = 64; db
// [1, H, N, N] f32 is ds summed over the batch.
//
// bf16 runs the kernels of attention_mma.cuh, shared with K2 and K3 (that
// header's note has the tile design: mma.sync tiles held in registers, fed
// by cp.async), instantiated with `PackedBias` (`Head::TILE_F32`): each call
// first copies the bias to [H, N, Npad] f32 with rows padded to 16 bytes
// (Npad = 200 at N = 197, 1.9 MB), and every kernel stages each 64 x 64 f32
// bias tile by cp.async beside its K/V or Q/dO tiles and reads it as f32
// pairs (read beside each score through L1 instead, the kernels took 0.28 /
// 1.18 ms at the pair pass):
//   fwd   one block per (q tile of 64, h, b): one pass over 64-key tiles with
//         an online softmax; the row max and sum saved [2, B*H*N].
//   bwd   four kernels on the current stream, each output written once: no
//         atomics and no [B, H, N, N] scratch, so the same bits every run:
//         dq    one block per (q tile, h, b): delta = rowsum(dO (.) O) from
//               the forward's output, saved [B*H*N]; S, dP, dS, dq += dS K;
//         dkdv  one block per (k tile, h, b) over the q tiles in order:
//               dv += P^T dO, dk += dS^T (q*scale);
//         db    one block per (k tile, q tile, h) loops over b = 0, 1, ...
//               in order (`xfm_attn_bwd_db_mma_kernel`, shared with K2),
//               recomputes S, P (the dq kernel's bits) and dP and sums
//               ds = P (dP - delta) in registers; db is written once.
// Rounding points are the TPU kernel's except two, which K2's and K3's
// bf16 kernels share (tests/test_torch_flash_attention.py emulates both and
// holds them to the card's bf16 gate, 2^-6 max|ref|, against the Pallas
// kernel): the forward rounds the unnormalized exp(S - m) of each key tile
// to bf16 for PV and divides the f32 sums by the row sum at the end, where
// the TPU kernel rounds the normalized P; delta = rowsum(dO (.) O) from the
// rounded output, where the TPU kernel sums P (.) dP. The rest: q scaled in
// f32 and rounded before QK^T; scores, bias and softmax in f32; ds rounded
// for dq and dk, P for dv; db sums the f32 ds.
//
// f32 runs the first design's kernels below (CUDA-core FMA, full f32
// products, the TPU kernel's rounding points): the forward keeps a [64,
// Npad] score block in shared memory; the backward's dq kernel writes the
// row statistics and every f32 ds row to a scratch [B, H, N, N] that the
// dk/dv kernel reads back and a db kernel sums over b in order.
//
// What bounds it: at the XFM-base pair pass (2B = 96 rows, N = 197, H = 12,
// bf16) the forward must move 118.1 MB and do 11.4 GFLOP (0.035 ms by bytes
// at 3.35 TB/s), the backward 207.1 MB and 28.6 GFLOP (0.062 ms by bytes).
// This design takes 0.18 / 0.67 ms there (NVIDIA H100 80GB HBM3, 700 W; the
// first design 0.49 / 1.47): the mma kernels pad 197 to 256 (4 key tiles,
// the last holding 5 keys), 69 % more products than the function needs, at
// the mma.sync rate, and the backward forms S and dP three times (dq,
// dk/dv, db; db alone is 0.22 ms, 192 blocks each summing 96 rows of b).
#include "attention_mma.cuh"

namespace {

// the f32 kernels' tiles (the key tile KT is attention_mma.cuh's 64)
constexpr int QT_FWD = 64;      // q tile of the forward
constexpr int QT_BWD = 32;      // q tile of the backward kernels

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
// f32 forward: grid (ceil(N/64), H, B)

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
// f32 backward 1/3: dq and row statistics. grid (ceil(N/32), H, B).
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
// f32 backward 2/3: dk and dv. grid (ceil(N/64), H, B). P is recomputed from S
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
// f32 backward 3/3: db[h] = sum over b of ds[b, h], in the order b = 0, 1, ...
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


// The shared f32 bias [1, H, N, N], as a bias source of attention_mma.cuh,
// from its copy `pad` [H, N, Npad] whose rows are padded to Npad =
// round_up(N, 4) floats (16 bytes): each 64 x 64 tile is staged by cp.async
// beside the K/V or Q/dO tiles it goes with and read as f32 pairs.
struct PackedBias {
  const float* pad;
  int Npad;

  struct Head {
    const float* base;  // (h, q = 0, key = 0) of the padded copy
    int N, Npad;
    using Row = int;    // nothing is kept per row
    static constexpr bool TILE = false, TILE_F32 = true;

    __device__ constexpr bool present() const { return true; }
    __device__ Row row(int) const { return 0; }
    __device__ float at(Row, int) const { return 0.f; }
    // rows q0 .. q0 + 63 at keys k0 .. k0 + 63 into tile [64 x LDB32]; rows
    // past N and keys past Npad zero-filled (keys in N .. Npad are the
    // copy's zeros; every key past N is masked)
    __device__ void tile_f32_async(float* tile, int q0, int k0) const {
#pragma unroll
      for (int j = 0; j < MT * KT / 4 / MMA_THREADS; ++j) {
        const int i = threadIdx.x + j * MMA_THREADS;
        const int r = i / (KT / 4), c = (i % (KT / 4)) * 4, q = q0 + r, k = k0 + c;
        const bool ok = q < N && k < Npad;
        cp_async16(tile + r * LDB32 + c, ok ? base + (size_t)q * Npad + k : base, ok);
      }
    }
  };

  __device__ Head head(const Dims& d, int, int h) const {
    return Head{pad + (size_t)h * d.Nq * Npad, (int)d.Nq, Npad};
  }
};

// pad [H, N, Npad] = bias [H, N, N] with each row's tail Npad - N zero
__global__ void __launch_bounds__(THREADS)
packed_pad_bias_kernel(const float* __restrict__ bias, float* __restrict__ pad, int H, int N,
                       int Npad) {
  const size_t total = (size_t)H * N * Npad;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * THREADS) {
    const size_t row = i / Npad;
    const int k = (int)(i - row * Npad);
    pad[i] = k < N ? bias[row * N + k] : 0.f;
  }
}

int pad_bias(const float* bias, float* pad, int H, int N, cudaStream_t st) {
  const int Npad = round_up(N, 4);
  const long long total = (long long)H * N * Npad;
  const int g = (int)((total + THREADS - 1) / THREADS < 132 * 8 ? (total + THREADS - 1) / THREADS
                                                                : 132 * 8);
  packed_pad_bias_kernel<<<g, THREADS, 0, st>>>(bias, pad, H, N, Npad);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// host side

size_t fwd_smem(int Npad) {
  return (size_t)(QT_FWD + KT + QT_FWD) * LDT * sizeof(float) +
         (size_t)(QT_FWD * (Npad + 4) + QT_FWD * LDF) * sizeof(float);
}
size_t dq_smem(int Npad) {
  return (size_t)(3 * QT_BWD + KT) * LDT * sizeof(float) +
         (size_t)(2 * QT_BWD * (Npad + 4) + QT_BWD * LDF) * sizeof(float);
}
size_t dkdv_smem() {
  return (size_t)(KT + 4 * QT_BWD) * LDT * sizeof(float) +
         (size_t)(QT_BWD + 2 * KT) * LDF * sizeof(float);
}

int launch_fwd_f32(const float* qkv, const float* bias, float* out, int B, int N, int H,
                   float scale, cudaStream_t st) {
  const int Npad = round_up(N, KT);
  const size_t smem = fwd_smem(Npad);
  cudaError_t e = allow_smem(packed_fwd_kernel<float>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + QT_FWD - 1) / QT_FWD, H, B);
  packed_fwd_kernel<float><<<grid, THREADS, smem, st>>>(qkv, bias, out, N, H, Npad, scale);
  return (int)cudaGetLastError();
}

int launch_bwd_f32(const float* qkv, const float* bias, const float* dout, float* dqkv,
                   float* db, float* stats, float* ds_rows, int B, int N, int H, float scale,
                   cudaStream_t st) {
  const int Npad = round_up(N, KT);
  cudaError_t e;
  size_t smem = dq_smem(Npad);
  if ((e = allow_smem(packed_bwd_dq_kernel<float>, smem)) != cudaSuccess) return (int)e;
  dim3 g1((N + QT_BWD - 1) / QT_BWD, H, B);
  packed_bwd_dq_kernel<float><<<g1, THREADS, smem, st>>>(qkv, bias, dout, dqkv, stats, ds_rows,
                                                         B, N, H, Npad, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  smem = dkdv_smem();
  if ((e = allow_smem(packed_bwd_dkdv_kernel<float>, smem)) != cudaSuccess) return (int)e;
  dim3 g2(Npad / KT, H, B);
  packed_bwd_dkdv_kernel<float><<<g2, THREADS, smem, st>>>(qkv, bias, dout, dqkv, stats, ds_rows,
                                                           B, N, H, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const size_t HNN = (size_t)H * N * N;
  const int g3 = (int)((HNN + THREADS - 1) / THREADS < 132 * 8
                           ? (HNN + THREADS - 1) / THREADS : 132 * 8);
  packed_bwd_db_kernel<<<g3, THREADS, 0, st>>>(ds_rows, db, B, HNN);
  return (int)cudaGetLastError();
}

int launch_fwd_bf16(const bf16* qkv, const float* bias, float* pad, bf16* out, float* stats,
                    int B, int N, int H, float scale, cudaStream_t st) {
  const int rc = pad_bias(bias, pad, H, N, st);
  if (rc != 0) return rc;
  const int C = H * D;
  return launch_fwd_mma(qkv, qkv + C, qkv + 2 * C, PackedBias{pad, round_up(N, 4)}, out, stats,
                        qkv_dims(B, N, H), scale, st);
}

int launch_bwd_bf16(const bf16* qkv, const float* bias, float* pad, const bf16* out,
                    const float* stats, const bf16* dout, bf16* dqkv, float* db, float* delta,
                    int B, int N, int H, float scale, cudaStream_t st) {
  int rc = pad_bias(bias, pad, H, N, st);
  if (rc != 0) return rc;
  const int C = H * D;
  const Dims d = qkv_dims(B, N, H);
  const PackedBias pb{pad, round_up(N, 4)};
  rc = launch_bwd_mma(qkv, qkv + C, qkv + 2 * C, pb, out, dout, stats, delta, dqkv,
                                dqkv + C, dqkv + 2 * C, d, scale, st);
  if (rc != 0) return rc;
  return launch_db_mma(qkv, qkv + C, qkv + 2 * C, pb, dout, stats, delta, db, d, scale, st);
}

}  // namespace

// is_bf16: 1 for bf16 qkv/out, 0 for f32. bias is f32 [1, H, N, N]; out
// [B, N, H*64]; stats f32 [2, B*H*N], the row max and sum, written by the
// bf16 forward (the f32 forward leaves it alone). bf16: pad f32 [H, N,
// round_up(N, 4)], the bias's padded copy, written here; f32: pad null.
// Returns a cudaError_t (0 on success).
extern "C" int xfm_packed_attention_fwd(const void* qkv, const void* bias, void* pad, void* out,
                                        void* stats, int B, int N, int H, float scale,
                                        int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bi = static_cast<const float*>(bias);
  if (is_bf16)
    return launch_fwd_bf16(static_cast<const bf16*>(qkv), bi, static_cast<float*>(pad),
                           static_cast<bf16*>(out), static_cast<float*>(stats), B, N, H, scale,
                           st);
  return launch_fwd_f32(static_cast<const float*>(qkv), bi, static_cast<float*>(out), B, N, H,
                        scale, st);
}

// out: the forward's output (bf16 takes delta = rowsum(dout (.) out) from
// it); dout [B, N, H*64]; dqkv like qkv; db f32 [1, H, N, N]. bf16: pad as
// for the forward, stats the forward's, scratch = delta f32 [B*H*N]. f32:
// pad null, stats a scratch [2, B*H*N] that the dq kernel fills, scratch =
// ds f32 [B, H, N, N]; out is not read.
extern "C" int xfm_packed_attention_bwd(const void* qkv, const void* bias, void* pad,
                                        const void* out, void* stats, const void* dout,
                                        void* dqkv, void* db, void* scratch, int B, int N, int H,
                                        float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bi = static_cast<const float*>(bias);
  float* sts = static_cast<float*>(stats);
  float* dbf = static_cast<float*>(db);
  float* scr = static_cast<float*>(scratch);
  if (is_bf16)
    return launch_bwd_bf16(static_cast<const bf16*>(qkv), bi, static_cast<float*>(pad),
                           static_cast<const bf16*>(out), sts, static_cast<const bf16*>(dout),
                           static_cast<bf16*>(dqkv), dbf, scr, B, N, H, scale, st);
  return launch_bwd_f32(static_cast<const float*>(qkv), bi, static_cast<const float*>(dout),
                        static_cast<float*>(dqkv), dbf, sts, scr, B, N, H, scale, st);
}
