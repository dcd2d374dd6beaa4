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
// with q, k, v read in place out of qkv [B, N, 3*H*D] (layout [q | k | v],
// heads contiguous inside each section), N = wh*ww + 1 for any window
// (wh, ww), D = 64, bf16 or f32; dq, dk and dv written in place into dqkv
// [B, N, 3*H*D]. The table has the dtype of qkv.
//
// The compact bias (xfm_tpu/ops/relpos.py `compact_rel_pos`): cr [H, ww, L],
// L = (2wh-1)*ww, with the row-delta axis reversed, and cls3 [H, 3] f32 =
// (cls->patch, patch->cls, cls->cls). The bias it stands for is
//     bias[0, 0] = cc, bias[0, 1:] = c2a, bias[1:, 0] = a2c,
//     bias[1 + a*ww + ci, 1 + j] = cr[h, ci, (wh-1-a)*ww + j],  j < wh*ww,
// so the bias row of query 1 + a*ww + ci is one contiguous slice of the
// table, at an offset of either parity. The f32 kernels read the bias element
// beside each score; the bf16 kernels stage each 64 x 64 bias tile in shared
// memory by cp.async, like K and V, from eight copies of the table shifted
// by 0 .. 7 elements (5.2 MB at 384 px, built by the call), so that every
// 16-byte chunk of a row's slice is aligned in one of them, and read it by
// ldmatrix straight into the score tile's layout. The [H, N, N] bias never
// exists.
//
// Rounding points are the TPU kernel's: q is scaled in f32 and rounded to the
// input dtype before QK^T; scores plus bias and the softmax in f32; keys past
// N are masked out; P is rounded to the input dtype before dV; ds = p * (dp -
// delta) in f32, rounded to the input dtype for dq and dk; dq is multiplied
// by the scale after its product; dk uses the rounded, scaled q; dk and dv
// accumulate in f32 and are rounded once; the table gradient sums the
// unrounded f32 ds. Two points move in the bf16 kernels, as they did in K3's
// (tests/test_torch_relpos_attention.py emulates both and holds them to the
// card's bf16 gate, 2^-6 max|ref|, against the Pallas kernel):
//   - the forward rounds the unnormalized exp(S - m) of each key tile to
//     bf16 for PV and divides the f32 sums by the row sum at the end, where
//     the TPU kernel rounds the normalized P;
//   - delta = rowsum(dO (.) O) from the rounded output the forward saved,
//     where the TPU kernel sums P (.) dP.
//
// Design. The TPU kernel holds a whole [Nq, Nk] score block and the expanded
// bias in VMEM and carries the ds batch sum in scratch across a sequential
// grid. A Hopper block has 227 KB of shared memory (a [64, 960] f32 score
// block at 480 px alone is 246 KB) and blocks run in parallel in no order.
// bf16 runs the kernels of attention_mma.cuh, shared with K3 and
// instantiated here with `RelposBias` (mma.sync tiles held in registers, fed
// by cp.async; that header's note has the tile design):
//   fwd   the shifted copies (`relpos_shift_kernel`), then one block per
//         (q tile of 64, h, b): one pass over 64-key tiles with an online
//         softmax, each key tile's bias tile landing with its K and V; the
//         row max and sum saved [2, B*H*N].
//   bwd   six kernels on the current stream, no atomics and no
//         [B, H, N, Npad] tensor, so the same bits every run:
//         shift the table's eight shifted copies;
//         dq    one block per (q tile, h, b): delta from (dO, O), saved
//               [B*H*N]; S, dP, dS, dq += dS K over the key tiles;
//         dkdv  one block per (k tile, h, b) over the q tiles in order, each
//               q tile's bias tile staged [q][key] and read transposed, its
//               rows' (m, l, delta) prefetched into registers: dv += P^T dO,
//               dk += dS^T (q*scale);
//         db    (attention_mma.cuh's `xfm_attn_bwd_db_mma_kernel`, shared
//               with K1) one block per (k tile, q tile, h) loops over b = 0, 1, ...
//               in order, the next b's Q, dO, K, V tiles (cp.async) and row
//               statistics (registers) landing while this one computes; the
//               block's bias tile, the same for every b, stays in registers;
//               it recomputes S, P (the dq kernel's expression on the same
//               tiles, bit for bit) and dP, forms ds = P (dP - delta) in f32
//               and sums it in registers; db [H, N, N] f32 is written once;
//         fold  dcr[h, ci, e] sums db over the stripes a = 0, 1, ... (the
//               TPU kernel's order: over b first, then over a); one block
//               per dcls entry sums its row or column of db in a fixed tree.
//         f32 runs the first design's kernels on the CUDA cores through
//         shared tiles shaped for WMMA: two passes in the forward; dq with a
//         pass for delta = sum(p * dp) and one writing ds to an f32 scratch
//         [B, H, N, Npad] that dkdv reads back and the fold sums over b and
//         then over the stripes.
//
// What bounds it. At the main shape (B = 32, N = 577, H = 12, bf16) the
// forward must move 114.1 MB and do 32.7 GFLOP: 0.034 ms by bytes at
// 3.35 TB/s; the backward 200.5 MB and 81.8 GFLOP: 0.083 ms by operations at
// 989 TFLOP/s. On an H100 (700 W) this design takes 0.25 / 1.19 ms, 7x / 14x
// those bounds (the first design: 1.54 / 4.14). Its products run at the
// mma.sync rate, below wgmma's, at 2 or 3 blocks of 4 warps an SM (166 to
// 255 registers a thread); the 64-row tiles pad 577 to 640 (23 % more
// products); the backward forms S and dP three times and dS^T once more:
// nine tile products where five would do, the price of owning every output
// without atomics (db alone is 0.36 ms); each score's bias costs a convert,
// a select and an add. Read beside each score through L1 instead, as an
// unaligned bf16 scalar (8 cache lines a warp instruction), the bias held
// the same kernels at 0.54 / 2.22 ms.
#include "attention_mma.cuh"

namespace {

constexpr int QT = 64;          // q tile of the f32 forward and dq kernel
constexpr int QT_DKV = 32;      // q tile of the f32 dk/dv kernel
constexpr int ROWS_PER_WARP = QT / WARPS;

// Row code of a query row: its offset into its head's table [ww, L] (the
// element of key column 1), or one of these.
constexpr int CLS_ROW = -1;     // row 0: the cls token's bias row
constexpr int PAD_ROW = -2;     // past N: never stored

// The compact table of every head, as a bias source of attention_mma.cuh:
// cr [H, ww, L] in T, cls3 [H, 3] f32. The f32 kernels read it beside each
// score (`at`); the bf16 kernels stage each 64 x 64 bias tile in shared
// memory by cp.async (`tile_async`) from `crs`, eight copies of each head's
// table shifted by 0 .. 7 elements ([H, 8, P] bf16, `relpos_shift_kernel`):
// a row's slice starts at any element, and in one of the copies it starts
// on a 16-byte boundary.
template <typename T>
struct RelposBias {
  const T* cr;
  const float* cls3;
  const bf16* crs;  // bf16 only
  int N, wh, ww, P;

  struct Head {
    const T* cr;      // this head's [ww, L]
    const bf16* crs;  // its eight shifted copies [8, P]
    float c2a, a2c, cc;
    int N, wh, ww, P;
    using Row = int;
    static constexpr bool TILE = true;  // the bf16 kernels stage it
    static constexpr bool TILE_F32 = false;

    __device__ constexpr bool present() const { return true; }
    __device__ Row row(int q) const {
      if (q >= N) return PAD_ROW;
      if (q == 0) return CLS_ROW;
      const int i = q - 1, a = i / ww, ci = i - a * ww;
      return ci * (2 * wh - 1) * ww + (wh - 1 - a) * ww;
    }
    // bias(row, key) for a key < N; a row past N reads the cls row's
    // values (finite; such rows are never stored)
    __device__ float at(Row rc, int k) const {
      if (rc < 0) return k == 0 ? cc : c2a;
      return k == 0 ? a2c : to_f(cr[rc + k - 1]);
    }
    // The table under q rows q0 .. q0 + 63 and keys k0 .. k0 + 63 into a
    // [64 x LDT] tile: column c of row rc is element rc + k0 + c - 1 of the
    // head's table, i.e. element x = rc + k0 + c + 7 - s of copy s =
    // (rc + k0 + 7) % 8 (copy s holds element p of the table at p + 8 - s).
    // Cls and padded rows are zero-filled; `patch` gives their bias.
    // `stage(q0)` keeps rc + 7 of the 4 rows this thread copies (-1 for
    // none), one division each, for every key tile of those rows.
    struct Stage {
      int x[MT * KT / 8 / MMA_THREADS];
    };
    __device__ Stage stage(int q0) const {
      Stage st;
#pragma unroll
      for (int j = 0; j < MT * KT / 8 / MMA_THREADS; ++j) {
        const int rc = row(q0 + (threadIdx.x + j * MMA_THREADS) / (KT / 8));
        st.x[j] = rc >= 0 ? rc + 7 : -1;
      }
      return st;
    }
    __device__ void tile_async(bf16* tile, const Stage& st, int k0) const {
#pragma unroll
      for (int j = 0; j < MT * KT / 8 / MMA_THREADS; ++j) {
        const int i = threadIdx.x + j * MMA_THREADS;
        const int r = i / (KT / 8), c = (i % (KT / 8)) * 8;
        const int x = st.x[j] + k0, s = x & 7;
        cp_async16(tile + r * LDT + c, st.x[j] >= 0 ? crs + (size_t)s * P + (x - s) + c : crs,
                   st.x[j] >= 0);
      }
    }
    // the bias at a staged value: the cls row (row0) holds c2a, key 0 a2c,
    // their crossing cc
    __device__ float patch(float staged, bool row0, bool key0) const {
      if (key0) return row0 ? cc : a2c;
      return row0 ? c2a : staged;
    }
  };

  __device__ Head head(int h) const {
    const int L = (2 * wh - 1) * ww;
    return Head{cr + (size_t)h * ww * L, crs + (size_t)h * 8 * P, cls3[h * 3],
                cls3[h * 3 + 1], cls3[h * 3 + 2], N, wh, ww, P};
  }
  __device__ Head head(const Dims&, int, int h) const { return head(h); }
};

// crs [H, 8, P]: copy s of head h holds element p - 8 + s of its table
// [ww * L] at p, 0 where that is outside the table.
__global__ void __launch_bounds__(THREADS)
relpos_shift_kernel(const bf16* __restrict__ cr, bf16* __restrict__ crs, int H, int n, int P) {
  const size_t total = (size_t)H * 8 * P;
  for (size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * THREADS) {
    const int hs = (int)(idx / P), p = (int)(idx - (size_t)hs * P);
    const int h = hs / 8, e = p - 8 + hs % 8;
    crs[idx] = e >= 0 && e < n ? cr[(size_t)h * n + e] : __float2bfloat16(0.f);
  }
}

// softmax probability from the score, its bias and the row's max and sum;
// the same expression in every f32 kernel
__device__ __forceinline__ float prob(float s, float bias, float m, float l) {
  const float v = s + bias;
  return expf(v - m) / l;
}

// ---------------------------------------------------------------------------
// forward, f32: grid (ceil(N/64), H, B). stats: [2][B*H*N] = row max, row sum.

template <typename T>
__global__ void __launch_bounds__(THREADS)
relpos_fwd_kernel(const T* __restrict__ qkv, RelposBias<T> bias,
                  T* __restrict__ out, float* __restrict__ stats, int B, int N,
                  int H, int Npad, float scale) {
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D, C3 = 3 * C;
  const size_t BHN = (size_t)B * H * N;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* KV = Qs + QT * LDT;
  T* Ps = KV + KT * LDT;
  float* S = reinterpret_cast<float*>(Ps + QT * LDT);
  float* O = S + QT * LDF;
  __shared__ float row_m[QT], row_l[QT];
  __shared__ int rcode[QT];

  const auto hb = bias.head(h);
  if (threadIdx.x < QT) rcode[threadIdx.x] = hb.row(q0 + threadIdx.x);
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
        v[t] = k < N ? S[r * LDF + c] + hb.at(rc, k) : -INFINITY;
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
        p = prob(S[r * LDF + c], hb.at(rc, k), row_m[r], row_l[r]);
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
// backward, f32, 1/2: dq and the ds scratch. grid (ceil(N/64), H, B).

template <typename T>
__global__ void __launch_bounds__(THREADS)
relpos_bwd_dq_kernel(const T* __restrict__ qkv, RelposBias<T> bias,
                     const float* __restrict__ stats, const T* __restrict__ dout,
                     T* __restrict__ dqkv, float* __restrict__ ds_rows, int B, int N,
                     int H, int Npad, float scale) {
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D, C3 = 3 * C;
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

  const auto hb = bias.head(h);
  if (threadIdx.x < QT) {
    const int q = q0 + threadIdx.x;
    rcode[threadIdx.x] = hb.row(q);
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
          delta[i] += prob(S[r * LDF + c], hb.at(rc, k), row_m[r], row_l[r]) *
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
          const float p = prob(S[r * LDF + c], hb.at(rc, k), row_m[r], row_l[r]);
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
// backward, f32, 2/2: dk and dv. grid (Npad/64, H, B). P is recomputed from S and
// the forward's row max and sum; ds is read back from the scratch.

template <typename T>
__global__ void __launch_bounds__(THREADS)
relpos_bwd_dkdv_kernel(const T* __restrict__ qkv, RelposBias<T> bias,
                       const float* __restrict__ stats, const T* __restrict__ dout,
                       T* __restrict__ dqkv, const float* __restrict__ ds_rows, int B,
                       int N, int H, int Npad, float scale) {
  constexpr int M = QT_DKV;
  const int k0 = blockIdx.x * KT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D, C3 = 3 * C;
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

  const auto hb = bias.head(h);
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
      rcode[threadIdx.x] = hb.row(q);
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
        p = prob(St[r * LDF + c], hb.at(rc, k), row_m[r], row_l[r]);
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
// backward, last: ds folded into the compact gradients, from the f32 path's
// scratch [B, H, N, Npad] or from bf16's db [H, N, N] (B = 1, Npad = N).
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
// The eight shifted copies of the bf16 table that the kernels stage from,
// crs [H, 8, P] (RelposBias); P must be a multiple of 8 and hold a tile's
// reach past the table's end: the last row's last key tile reads up to
// element rc + k0 + 70 <= ww*L + 70 of its copy.
int build_shifted(const bf16* cr, bf16* crs, int H, int wh, int ww, int P, cudaStream_t st) {
  const int n = ww * (2 * wh - 1) * ww;
  if (P % 8 || P < n + 71) return (int)cudaErrorInvalidValue;
  const long long total = (long long)H * 8 * P;
  const int g = (int)((total + THREADS - 1) / THREADS < 132 * 8 ? (total + THREADS - 1) / THREADS
                                                                : 132 * 8);
  relpos_shift_kernel<<<g, THREADS, 0, st>>>(cr, crs, H, n, P);
  return (int)cudaGetLastError();
}

int launch_fwd_bf16(const bf16* qkv, const bf16* cr, const float* cls3, bf16* crs, bf16* out,
                    float* stats, int B, int N, int H, int wh, int ww, int P, float scale,
                    cudaStream_t st) {
  const int rc = build_shifted(cr, crs, H, wh, ww, P, st);
  if (rc != 0) return rc;
  const int C = H * D;
  const RelposBias<bf16> bias{cr, cls3, crs, N, wh, ww, P};
  return launch_fwd_mma(qkv, qkv + C, qkv + 2 * C, bias, out, stats, qkv_dims(B, N, H),
                        scale, st);
}

int launch_fwd_f32(const float* qkv, const float* cr, const float* cls3, float* out,
                   float* stats, int B, int N, int H, int wh, int ww, float scale,
                   cudaStream_t st) {
  const size_t smem = fwd_smem<float>();
  cudaError_t e = allow_smem(relpos_fwd_kernel<float>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + QT - 1) / QT, H, B);
  const RelposBias<float> bias{cr, cls3, nullptr, N, wh, ww, 0};
  relpos_fwd_kernel<float><<<grid, THREADS, smem, st>>>(qkv, bias, out, stats, B, N, H,
                                                        round_up(N, KT), scale);
  return (int)cudaGetLastError();
}

// the fold of `ds` ([B, H, N, Npad] f32) into dcr and dcls
int launch_fold(const float* ds, float* dcr, float* dcls, int B, int N, int H, int wh, int ww,
                int Npad, cudaStream_t st) {
  const int total = H * ww * (2 * wh - 1) * ww;
  const int g = (total + THREADS - 1) / THREADS < 132 * 8 ? (total + THREADS - 1) / THREADS
                                                          : 132 * 8;
  relpos_fold_dcr_kernel<<<g, THREADS, 0, st>>>(ds, dcr, B, N, H, wh, ww, Npad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  relpos_fold_dcls_kernel<<<3 * H, THREADS, 0, st>>>(ds, dcls, B, N, H, Npad);
  return (int)cudaGetLastError();
}

int launch_bwd_bf16(const bf16* qkv, const bf16* cr, const float* cls3, bf16* crs,
                    const bf16* out, const float* stats, const bf16* dout, bf16* dqkv,
                    float* dcr, float* dcls, float* delta, float* db, int B, int N, int H,
                    int wh, int ww, int P, float scale, cudaStream_t st) {
  int rc = build_shifted(cr, crs, H, wh, ww, P, st);
  if (rc != 0) return rc;
  const int C = H * D;
  const Dims d = qkv_dims(B, N, H);
  const RelposBias<bf16> bias{cr, cls3, crs, N, wh, ww, P};
  rc = launch_bwd_mma(qkv, qkv + C, qkv + 2 * C, bias, out, dout, stats, delta, dqkv,
                      dqkv + C, dqkv + 2 * C, d, scale, st);
  if (rc != 0) return rc;
  rc = launch_db_mma(qkv, qkv + C, qkv + 2 * C, bias, dout, stats, delta, db, d, scale, st);
  if (rc != 0) return rc;
  return launch_fold(db, dcr, dcls, 1, N, H, wh, ww, N, st);
}

int launch_bwd_f32(const float* qkv, const float* cr, const float* cls3, const float* stats,
                   const float* dout, float* dqkv, float* dcr, float* dcls, float* ds_rows,
                   int B, int N, int H, int wh, int ww, float scale, cudaStream_t st) {
  const int Npad = round_up(N, KT);
  const RelposBias<float> bias{cr, cls3, nullptr, N, wh, ww, 0};
  cudaError_t e;
  size_t smem = dq_smem<float>();
  if ((e = allow_smem(relpos_bwd_dq_kernel<float>, smem)) != cudaSuccess) return (int)e;
  dim3 g1((N + QT - 1) / QT, H, B);
  relpos_bwd_dq_kernel<float><<<g1, THREADS, smem, st>>>(qkv, bias, stats, dout, dqkv, ds_rows,
                                                         B, N, H, Npad, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  smem = dkdv_smem<float>();
  if ((e = allow_smem(relpos_bwd_dkdv_kernel<float>, smem)) != cudaSuccess) return (int)e;
  dim3 g2(Npad / KT, H, B);
  relpos_bwd_dkdv_kernel<float><<<g2, THREADS, smem, st>>>(qkv, bias, stats, dout, dqkv,
                                                           ds_rows, B, N, H, Npad, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return launch_fold(ds_rows, dcr, dcls, B, N, H, wh, ww, Npad, st);
}

}  // namespace

// is_bf16: 1 for bf16 qkv/cr/out, 0 for f32. cr [H, ww, (2wh-1)*ww] in the
// dtype of qkv, cls3 f32 [H, 3], out [B, N, H*64], stats f32 [2, B*H*N].
// bf16: crs bf16 [H, 8, P], the table's shifted copies (written here; P a
// multiple of 8, at least ww*(2wh-1)*ww + 71); f32: crs null, P unused.
// Returns a cudaError_t (0 on success).
extern "C" int xfm_relpos_attention_fwd(const void* qkv, const void* cr, const void* cls3,
                                        void* crs, void* out, void* stats, int B, int N, int H,
                                        int wh, int ww, int P, float scale, int is_bf16,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cls = static_cast<const float*>(cls3);
  if (is_bf16)
    return launch_fwd_bf16(static_cast<const bf16*>(qkv), static_cast<const bf16*>(cr), cls,
                           static_cast<bf16*>(crs), static_cast<bf16*>(out),
                           static_cast<float*>(stats), B, N, H, wh, ww, P, scale, st);
  return launch_fwd_f32(static_cast<const float*>(qkv), static_cast<const float*>(cr), cls,
                        static_cast<float*>(out), static_cast<float*>(stats), B, N, H, wh, ww,
                        scale, st);
}

// out: the forward's output (the bf16 kernels take delta = rowsum(dout (.)
// out) from it; f32 does not read it); dout [B, N, H*64]; dqkv like qkv;
// dcr f32 [H, ww, (2wh-1)*ww]; dcls f32 [H, 3]. bf16: crs and P as for the
// forward, delta f32 [B*H*N] and scratch = db f32 [H, N, N]; f32: crs and
// delta null, scratch = ds f32 [B, H, N, round_up(N, 64)].
extern "C" int xfm_relpos_attention_bwd(const void* qkv, const void* cr, const void* cls3,
                                        void* crs, const void* out, const void* stats,
                                        const void* dout, void* dqkv, void* dcr, void* dcls,
                                        void* delta, void* scratch, int B, int N, int H, int wh,
                                        int ww, int P, float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cls = static_cast<const float*>(cls3);
  const float* sts = static_cast<const float*>(stats);
  if (is_bf16)
    return launch_bwd_bf16(static_cast<const bf16*>(qkv), static_cast<const bf16*>(cr), cls,
                           static_cast<bf16*>(crs), static_cast<const bf16*>(out), sts,
                           static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv),
                           static_cast<float*>(dcr), static_cast<float*>(dcls),
                           static_cast<float*>(delta), static_cast<float*>(scratch), B, N, H,
                           wh, ww, P, scale, st);
  return launch_bwd_f32(static_cast<const float*>(qkv), static_cast<const float*>(cr), cls, sts,
                        static_cast<const float*>(dout), static_cast<float*>(dqkv),
                        static_cast<float*>(dcr), static_cast<float*>(dcls),
                        static_cast<float*>(scratch), B, N, H, wh, ww, scale, st);
}
