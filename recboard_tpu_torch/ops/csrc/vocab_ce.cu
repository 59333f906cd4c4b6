// Full-vocabulary softmax cross-entropy per row for Hopper (sm_90a), float32.
//
// Replaces the TPU kernels of recboard_tpu/ops/vocab_ce.py:
//   * forward  _fwd_kernel (:48): loss[r] = logsumexp_v(h[r].W[:, v] + b[v])
//     - (h[r].W[:, y[r]] + b[y[r]]), with logz[r] kept for the backward;
//   * backward _bwd_kernel (:64): with dlog[r, v] = (softmax[r, v]
//     - [v == y[r]]) * g[r], dh = dlog W^T, dW = h^T dlog, db = sum_r dlog.
// Neither writes the (M, V) logits: they are recomputed tile by tile.
//
// W arrives in its (V, D) row-major storage (what fc.weight is), so a logit
// is the dot product of two contiguous D-vectors, and dW is written in that
// (V, D) layout too.
//
// What bounds it on an H100: operations. At BERT4Rec's training shape
// (M = 10,240 selected rows, D = 64, V = 12,103) the forward is 2*M*D*V =
// 15.9 GFLOP, 237 us at the 67 TFLOP/s float32 rate, against 5.7 MB of
// inputs (1.7 us at 3.35 TB/s); the backward counted as the TPU kernel's
// work (logits again, dh and dW) is 47.6 GFLOP, 710 us. So the design
// keeps the logits out of device memory and spends its effort on the
// products:
//   * one tile is 64 rows x 64 vocabulary entries; 256 threads each hold a
//     4 x 4 block of it in registers, fed by float4 loads from d-major
//     copies of the two operand tiles in shared memory (one broadcast and
//     one 256-byte read per 16 FMAs);
//   * the forward keeps an online logsumexp per row (running max, and a
//     sum rescaled when the max grows) and the label's logit, per thread,
//     merged across the 16 threads of a row at the end;
//   * the TPU's sequential grid carries the dW sum from one step to the
//     next; Hopper blocks run in no order, so the backward is two kernels
//     without atomics: a row-tile kernel (dh) and a vocabulary-tile kernel
//     (dW and db), each recomputing its logits from logz;
//   * to fill 132 SMs, each kernel splits its loop (over vocabulary tiles,
//     or row tiles) across blocks that write partial results; a second
//     pass adds the partials in a fixed order, so results do not depend on
//     the order blocks run in.
// The products are scalar FMAs: a first kernel that is right and simple.
// mma.sync or wgmma with split-precision float32, and TMA, are later work.

#include "tiles.cuh"

namespace {

// Forward: block (row tile, vocabulary split). Writes per split and row the
// running max, the sum of exp(logit - max) and the label's logit (0 when the
// label is in another split) into part[3][split][M].
__global__ void __launch_bounds__(kThreads)
vocab_ce_fwd_kernel(const float* __restrict__ h, const float* __restrict__ wt,
                    const float* __restrict__ bias, const int64_t* __restrict__ labels,
                    float* __restrict__ part, int M, int D, int V, int tiles_per_split) {
  extern __shared__ __align__(16) float smem[];
  float* h_t = smem;             // D x kLd
  float* w_t = h_t + D * kLd;    // D x kLd
  float* b_s = w_t + D * kLd;    // kTile
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t r0 = (int64_t)blockIdx.x * kTile;
  const int split = blockIdx.y;
  const int n_tiles = (V + kTile - 1) / kTile;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  load_dmajor(h_t, h, M, r0, D);
  int64_t y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = r0 + 4 * ty + i;
    y[i] = r < M ? labels[r] : -1;
  }
  float m[4], s[4], picked[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    s[i] = 0.f;
    picked[i] = 0.f;
  }

  float acc[4][4];
  for (int t = t_begin; t < t_end; ++t) {
    const int64_t v0 = (int64_t)t * kTile;
    __syncthreads();  // the previous tile is consumed
    load_dmajor(w_t, wt, V, v0, D);
    if (threadIdx.x < kTile) {
      const int64_t v = v0 + threadIdx.x;
      b_s[threadIdx.x] = v < V ? bias[v] : 0.f;
    }
    __syncthreads();
    tile_dot(h_t, w_t, D, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x[4], tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t v = v0 + 4 * tx + j;
        x[j] = v < V ? acc[i][j] + b_s[4 * tx + j] : -INFINITY;
        tile_max = fmaxf(tile_max, x[j]);
        if (v == y[i]) picked[i] = x[j];
      }
      if (tile_max == -INFINITY) continue;  // this thread's columns lie past V
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(x[j] - tile_max);  // exp(-inf) = 0
      lse_merge(m[i], s[i], tile_max, sum);
    }
  }

  // merge the 16 threads of each row (lanes tx = 0..15 of one half-warp)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(kFull, m[i], o);
      const float s2 = __shfl_xor_sync(kFull, s[i], o);
      picked[i] += __shfl_xor_sync(kFull, picked[i], o);
      lse_merge(m[i], s[i], m2, s2);
    }
    const int64_t r = r0 + 4 * ty + i;
    if (tx == 0 && r < M) {
      const int64_t splits = gridDim.y;
      part[(0 * splits + split) * M + r] = m[i];
      part[(1 * splits + split) * M + r] = s[i];
      part[(2 * splits + split) * M + r] = picked[i];
    }
  }
}

// logz and loss per row from the splits' partials
__global__ void vocab_ce_combine_kernel(const float* __restrict__ part,
                                        float* __restrict__ loss, float* __restrict__ logz,
                                        int M, int splits) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M) return;
  float m = -INFINITY, s = 0.f, picked = 0.f;
  for (int k = 0; k < splits; ++k) {
    lse_merge(m, s, part[(int64_t)k * M + r], part[((int64_t)splits + k) * M + r]);
    picked += part[((int64_t)2 * splits + k) * M + r];
  }
  const float z = m + logf(s);
  logz[r] = z;
  loss[r] = z - picked;
}

// dlog[i][j] for rows 4 ty + i of the row tile at r0 and vocabulary entries
// 4 tx + j of the tile at v0, from the logits' 4 x 4 block (bias not yet
// added); entries past M or V are 0
__device__ __forceinline__ void dlogits(float acc[4][4], const float* b_tile, int64_t r0,
                                        int64_t v0, int ty, int tx, int M, int V,
                                        const int64_t y[4], const float z[4],
                                        const float g[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool row_ok = r0 + 4 * ty + i < M;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t v = v0 + 4 * tx + j;
      float d = 0.f;
      if (row_ok && v < V) {
        const float p = expf(acc[i][j] + b_tile[4 * tx + j] - z[i]);
        d = (p - (v == y[i] ? 1.f : 0.f)) * g[i];
      }
      acc[i][j] = d;
    }
  }
}

// Backward, dh: block (row tile, vocabulary split); dh, or its split's
// partial, goes to dh_part[split][M][D].
__global__ void __launch_bounds__(kThreads)
vocab_ce_dh_kernel(const float* __restrict__ h, const float* __restrict__ wt,
                   const float* __restrict__ bias, const int64_t* __restrict__ labels,
                   const float* __restrict__ logz, const float* __restrict__ grad,
                   float* __restrict__ dh_part, int M, int D, int V, int tiles_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int D4 = round4(D);
  float* h_t = smem;                // D x kLd
  float* w_t = h_t + D * kLd;       // D x kLd
  float* w_r = w_t + D * kLd;       // kTile x D4
  float* dl_t = w_r + kTile * D4;   // kTile (vocabulary) x kLd (rows)
  float* b_s = dl_t + kTile * kLd;  // kTile
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t r0 = (int64_t)blockIdx.x * kTile;
  const int split = blockIdx.y;
  const int n_tiles = (V + kTile - 1) / kTile;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  load_dmajor(h_t, h, M, r0, D);
  int64_t y[4];
  float z[4], g[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = r0 + 4 * ty + i;
    const bool ok = r < M;
    y[i] = ok ? labels[r] : -1;
    z[i] = ok ? logz[r] : 0.f;
    g[i] = ok ? grad[r] : 0.f;
  }
  float out[4][kChunks][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][k][j] = 0.f;

  float acc[4][4];
  for (int t = t_begin; t < t_end; ++t) {
    const int64_t v0 = (int64_t)t * kTile;
    __syncthreads();  // the previous tile is consumed
    load_dmajor(w_t, wt, V, v0, D);
    load_rowmajor(w_r, wt, V, v0, D, D4);
    if (threadIdx.x < kTile) {
      const int64_t v = v0 + threadIdx.x;
      b_s[threadIdx.x] = v < V ? bias[v] : 0.f;
    }
    __syncthreads();
    tile_dot(h_t, w_t, D, ty, tx, acc);
    dlogits(acc, b_s, r0, v0, ty, tx, M, V, y, z, g);
#pragma unroll
    for (int j = 0; j < 4; ++j)  // dl_t[v][r]: the rows of one entry contiguous
      *reinterpret_cast<float4*>(dl_t + (4 * tx + j) * kLd + 4 * ty) =
          make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    __syncthreads();
    tile_accumulate(dl_t, w_r, D4, ty, tx, out);  // dh += dlog W
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = r0 + 4 * ty + i;
    if (r >= M) continue;
    float* dst = dh_part + ((int64_t)split * M + r) * D;
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = kTile * k + 4 * tx + j;
        if (c < D) dst[c] = out[i][k][j];
      }
  }
}

// Backward, dW and db: block (vocabulary tile, row split); dW (V, D) and db,
// or the split's partials, go to dw_part[split][V][D] and db_part[split][V].
__global__ void __launch_bounds__(kThreads)
vocab_ce_dw_kernel(const float* __restrict__ h, const float* __restrict__ wt,
                   const float* __restrict__ bias, const int64_t* __restrict__ labels,
                   const float* __restrict__ logz, const float* __restrict__ grad,
                   float* __restrict__ dw_part, float* __restrict__ db_part, int M, int D,
                   int V, int tiles_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int D4 = round4(D);
  float* w_t = smem;                // D x kLd
  float* h_t = w_t + D * kLd;       // D x kLd
  float* h_r = h_t + D * kLd;       // kTile x D4
  float* dl = h_r + kTile * D4;     // kTile (rows) x kLd (vocabulary)
  float* b_s = dl + kTile * kLd;    // kTile
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t v0 = (int64_t)blockIdx.x * kTile;
  const int split = blockIdx.y;
  const int n_tiles = (M + kTile - 1) / kTile;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  load_dmajor(w_t, wt, V, v0, D);
  if (threadIdx.x < kTile) {
    const int64_t v = v0 + threadIdx.x;
    b_s[threadIdx.x] = v < V ? bias[v] : 0.f;
  }
  float out[4][kChunks][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][k][j] = 0.f;
  float db_acc = 0.f;

  float acc[4][4];
  for (int t = t_begin; t < t_end; ++t) {
    const int64_t r0 = (int64_t)t * kTile;
    __syncthreads();  // the previous tile is consumed; on the first pass, W is staged
    load_dmajor(h_t, h, M, r0, D);
    load_rowmajor(h_r, h, M, r0, D, D4);
    int64_t y[4];
    float z[4], g[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t r = r0 + 4 * ty + i;
      const bool ok = r < M;
      y[i] = ok ? labels[r] : -1;
      z[i] = ok ? logz[r] : 0.f;
      g[i] = ok ? grad[r] : 0.f;
    }
    __syncthreads();
    tile_dot(h_t, w_t, D, ty, tx, acc);  // rows 4 ty + i, entries 4 tx + j
    dlogits(acc, b_s, r0, v0, ty, tx, M, V, y, z, g);
#pragma unroll
    for (int i = 0; i < 4; ++i)  // dl[r][v]: the entries of one row contiguous
      *reinterpret_cast<float4*>(dl + (4 * ty + i) * kLd + 4 * tx) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
    tile_accumulate(dl, h_r, D4, ty, tx, out);  // dW[v] += sum_r dlog[r][v] h[r]
    if (threadIdx.x < kTile)
      for (int r = 0; r < kTile; ++r) db_acc += dl[r * kLd + threadIdx.x];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t v = v0 + 4 * ty + i;
    if (v >= V) continue;
    float* dst = dw_part + ((int64_t)split * V + v) * D;
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = kTile * k + 4 * tx + j;
        if (c < D) dst[c] = out[i][k][j];
      }
  }
  if (threadIdx.x < kTile && v0 + threadIdx.x < V)
    db_part[(int64_t)split * V + v0 + threadIdx.x] = db_acc;
}

size_t fwd_smem(int D) { return sizeof(float) * ((size_t)2 * D * kLd + kTile); }

size_t bwd_smem(int D) {
  return sizeof(float) *
         ((size_t)2 * D * kLd + (size_t)kTile * round4(D) + (size_t)kTile * kLd + kTile);
}

bool bad_shape(int M, int D, int V, int split_a, int split_b) {
  return M < 0 || D < 1 || D > kMaxD || V < 1 || split_a < 1 || split_b < 1;
}

int tiles_per(int tiles, int splits) { return (tiles + splits - 1) / splits; }

}  // namespace

// h (M, D), wt (V, D), bias (V,): contiguous float32; labels (M,) int64.
// part: 3 * splits * M floats of scratch. Writes loss and logz (M,). The
// vocabulary tiles are cut into `splits` runs of equal length (the last may
// be shorter, none empty). Launches on `stream`; returns the first CUDA
// error (0 on success).
extern "C" int vocab_ce_fwd_f32(const float* h, const float* wt, const float* bias,
                                const int64_t* labels, float* part, float* loss,
                                float* logz, int M, int D, int V, int splits,
                                void* stream) {
  if (bad_shape(M, D, V, splits, 1)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int v_tiles = (V + kTile - 1) / kTile;
  const int per = tiles_per(v_tiles, splits);
  if ((splits - 1) * per >= v_tiles) return (int)cudaErrorInvalidValue;  // an empty split
  const size_t smem = fwd_smem(D);
  cudaError_t err = allow_smem(vocab_ce_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + kTile - 1) / kTile), (unsigned)splits);
  vocab_ce_fwd_kernel<<<grid, kThreads, smem, st>>>(h, wt, bias, labels, part, M, D, V, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  vocab_ce_combine_kernel<<<(unsigned)((M + 255) / 256), 256, 0, st>>>(part, loss, logz, M,
                                                                      splits);
  return (int)cudaGetLastError();
}

// The backward for the loss gradient g (M,): dh (M, D), dw (V, D) (the
// gradient of wt) and db (V,). dh_splits runs of vocabulary tiles for dh and
// dw_splits runs of row tiles for dw/db; with more than one, dh_part holds
// dh_splits * M * D floats, dw_part dw_splits * V * D and db_part
// dw_splits * V, else they are unused (may be null).
extern "C" int vocab_ce_bwd_f32(const float* h, const float* wt, const float* bias,
                                const int64_t* labels, const float* logz, const float* g,
                                float* dh_part, float* dw_part, float* db_part, float* dh,
                                float* dw, float* db, int M, int D, int V, int dh_splits,
                                int dw_splits, void* stream) {
  if (bad_shape(M, D, V, dh_splits, dw_splits)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int v_tiles = (V + kTile - 1) / kTile;
  const int m_tiles = (M + kTile - 1) / kTile;
  const int dh_per = tiles_per(v_tiles, dh_splits);
  const int dw_per = tiles_per(m_tiles > 0 ? m_tiles : 1, dw_splits);
  if ((dh_splits - 1) * dh_per >= v_tiles || (M > 0 && (dw_splits - 1) * dw_per >= m_tiles))
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(D);
  cudaError_t err;
  if ((err = allow_smem(vocab_ce_dh_kernel, smem)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(vocab_ce_dw_kernel, smem)) != cudaSuccess) return (int)err;

  if (M > 0) {
    float* dh_out = dh_splits > 1 ? dh_part : dh;
    const dim3 grid_dh((unsigned)m_tiles, (unsigned)dh_splits);
    vocab_ce_dh_kernel<<<grid_dh, kThreads, smem, st>>>(h, wt, bias, labels, logz, g, dh_out,
                                                        M, D, V, dh_per);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (dh_splits > 1 &&
        (err = sum_splits(dh_part, dh, (int64_t)M * D, dh_splits, st)) != cudaSuccess)
      return (int)err;
  }

  float* dw_out = dw_splits > 1 ? dw_part : dw;
  float* db_out = dw_splits > 1 ? db_part : db;
  const dim3 grid_dw((unsigned)v_tiles, (unsigned)dw_splits);
  vocab_ce_dw_kernel<<<grid_dw, kThreads, smem, st>>>(h, wt, bias, labels, logz, g, dw_out,
                                                      db_out, M, D, V, dw_per);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (dw_splits > 1) {
    if ((err = sum_splits(dw_part, dw, (int64_t)V * D, dw_splits, st)) != cudaSuccess)
      return (int)err;
    if ((err = sum_splits(db_part, db, (int64_t)V, dw_splits, st)) != cudaSuccess)
      return (int)err;
  }
  return 0;
}
