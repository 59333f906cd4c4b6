// Shared-negative sampled softmax for Hopper (sm_90a), float32.
//
// Replaces the TPU kernels of recboard_tpu/ops/losses.py
// (sampled_softmax_shared_fused, the custom VJP at :397):
//   * forward  _shared_fwd_kernel (:239): per row r of user u (M, D) with its
//     positive p (M, D) and the K shared negatives n (K, D),
//     pos_logit[r] = u[r].p[r] / tau and
//     logz[r] = logsumexp([pos_logit[r], u[r].n[k] / tau for every k]);
//   * backward _shared_bwd_kernel (:255): with row gradients s (M,) and
//     P[r, k] = s[r] exp(u[r].n[k] / tau - logz[r]),
//     coef[r] = s[r] (exp(pos_logit[r] - logz[r]) - 1):
//     du = (P n + coef p) / tau, dpos = coef u / tau, dneg = P^T u / tau.
// Neither writes the (M, K) logits: they are recomputed tile by tile.
//
// What bounds it on an H100: operations. At HSTU's training shape (M =
// 256 x 50 = 12,800 rows, K = 512, D = 64) the forward is 2*M*K*D = 0.84
// GFLOP, 12.5 us at the 67 TFLOP/s float32 rate, against 6.8 MB of inputs
// (2.0 us at 3.35 TB/s); the backward (logits again, du and dneg) is 2.52
// GFLOP, 37.6 us. So the logits stay out of device memory and the effort
// goes to the products, in the tiling vocab_ce.cu uses (tiles.cuh):
//   * a tile is 64 rows x 64 negatives; 256 threads each hold a 4 x 4 block
//     of it in registers, fed by float4 loads from d-major copies of the two
//     operand tiles in shared memory. The negatives are tiled: at K = 512,
//     D = 64 they are 128 KB, which the TPU kernel held whole in VMEM;
//   * the forward keeps an online logsumexp per thread, seeded by the
//     positive logit on one thread of each row, and merges the 16 threads
//     of a row at the end;
//   * the TPU grid runs in order and adds dneg across its steps; Hopper
//     blocks run in no order, so the backward is two kernels without
//     atomics: a row-tile kernel (du, dpos) and a negative-tile kernel
//     (dneg) whose loop over row tiles is split across blocks that write
//     partials, added in a fixed order by a second pass. Reruns give the
//     same bits.
// Rows with s = 0 get du and dpos exactly 0 (P and coef are products by 0).
// The products are scalar FMAs: a first kernel that is right and simple.

#include "tiles.cuh"

namespace {

__device__ __forceinline__ void zero_out(float out[4][kChunks][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][k][j] = 0.f;
}

// Forward: block = one row tile, looping over every negative tile.
__global__ void __launch_bounds__(kThreads)
shared_fwd_kernel(const float* __restrict__ user, const float* __restrict__ pos,
                  const float* __restrict__ neg, float* __restrict__ logz,
                  float* __restrict__ pos_logit, int M, int D, int K, float inv_tau) {
  extern __shared__ __align__(16) float smem[];
  float* u_t = smem;            // D x kLd
  float* n_t = u_t + D * kLd;   // D x kLd
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t r0 = (int64_t)blockIdx.x * kTile;

  load_dmajor(u_t, user, M, r0, D);
  __syncthreads();
  // the positive logit of each row: the 16 threads of a row split D
  float pl[4], m[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = r0 + 4 * ty + i;
    float p = 0.f;
    if (r < M)
      for (int d = tx; d < D; d += 16) p = fmaf(u_t[d * kLd + 4 * ty + i], pos[r * D + d], p);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) p += __shfl_xor_sync(kFull, p, o);
    pl[i] = p * inv_tau;
    m[i] = tx == 0 ? pl[i] : -INFINITY;  // one thread of the row holds it
    s[i] = tx == 0 ? 1.f : 0.f;
  }

  float acc[4][4];
  const int n_tiles = (K + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int64_t k0 = (int64_t)t * kTile;
    __syncthreads();  // the previous tile is consumed
    load_dmajor(n_t, neg, K, k0, D);
    __syncthreads();
    tile_dot(u_t, n_t, D, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x[4], tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = k0 + 4 * tx + j < K ? acc[i][j] * inv_tau : -INFINITY;
        tile_max = fmaxf(tile_max, x[j]);
      }
      if (tile_max == -INFINITY) continue;  // this thread's columns lie past K
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
      lse_merge(m[i], s[i], m2, s2);
    }
    const int64_t r = r0 + 4 * ty + i;
    if (tx == 0 && r < M) {
      logz[r] = m[i] + logf(s[i]);
      pos_logit[r] = pl[i];
    }
  }
}

// P[i][j] for rows 4 ty + i of the row tile at r0 and negatives 4 tx + j of
// the tile at k0, from the products' 4 x 4 block; 0 past M or K
__device__ __forceinline__ void probs(float acc[4][4], int64_t r0, int64_t k0, int ty, int tx,
                                      int M, int K, const float z[4], const float s[4],
                                      float inv_tau) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool row_ok = r0 + 4 * ty + i < M;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j] = (row_ok && k0 + 4 * tx + j < K) ? expf(acc[i][j] * inv_tau - z[i]) * s[i]
                                                  : 0.f;
  }
}

// Backward, du and dpos: block = one row tile, looping over every negative
// tile.
__global__ void __launch_bounds__(kThreads)
shared_du_kernel(const float* __restrict__ user, const float* __restrict__ pos,
                 const float* __restrict__ neg, const float* __restrict__ logz,
                 const float* __restrict__ pos_logit, const float* __restrict__ grad,
                 float* __restrict__ du, float* __restrict__ dpos, int M, int D, int K,
                 float inv_tau) {
  extern __shared__ __align__(16) float smem[];
  const int D4 = round4(D);
  float* u_t = smem;              // D x kLd
  float* n_t = u_t + D * kLd;     // D x kLd
  float* n_r = n_t + D * kLd;     // kTile x D4
  float* p_t = n_r + kTile * D4;  // kTile (negatives) x kLd (rows)
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t r0 = (int64_t)blockIdx.x * kTile;

  load_dmajor(u_t, user, M, r0, D);
  float z[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = r0 + 4 * ty + i;
    z[i] = r < M ? logz[r] : 0.f;
    s[i] = r < M ? grad[r] : 0.f;
  }
  float out[4][kChunks][4];
  zero_out(out);

  float acc[4][4];
  const int n_tiles = (K + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int64_t k0 = (int64_t)t * kTile;
    __syncthreads();  // the previous tile is consumed
    load_dmajor(n_t, neg, K, k0, D);
    load_rowmajor(n_r, neg, K, k0, D, D4);
    __syncthreads();
    tile_dot(u_t, n_t, D, ty, tx, acc);
    probs(acc, r0, k0, ty, tx, M, K, z, s, inv_tau);
#pragma unroll
    for (int j = 0; j < 4; ++j)  // p_t[k][r]: the rows of one negative contiguous
      *reinterpret_cast<float4*>(p_t + (4 * tx + j) * kLd + 4 * ty) =
          make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    __syncthreads();
    tile_accumulate(p_t, n_r, D4, ty, tx, out);  // du += P n
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = r0 + 4 * ty + i;
    if (r >= M) continue;
    const float coef = s[i] * (expf(pos_logit[r] - z[i]) - 1.f);
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = kTile * k + 4 * tx + j;
        if (c >= D) continue;
        du[r * D + c] = (out[i][k][j] + coef * pos[r * D + c]) * inv_tau;
        dpos[r * D + c] = coef * user[r * D + c] * inv_tau;
      }
  }
}

// Backward, dneg: block (negative tile, row split); dneg, or the split's
// partial, goes to dneg_part[split][K][D].
__global__ void __launch_bounds__(kThreads)
shared_dneg_kernel(const float* __restrict__ user, const float* __restrict__ neg,
                   const float* __restrict__ logz, const float* __restrict__ grad,
                   float* __restrict__ dneg_part, int M, int D, int K, float inv_tau,
                   int tiles_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int D4 = round4(D);
  float* n_t = smem;              // D x kLd
  float* u_t = n_t + D * kLd;     // D x kLd
  float* u_r = u_t + D * kLd;     // kTile x D4
  float* p_t = u_r + kTile * D4;  // kTile (rows) x kLd (negatives)
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t k0 = (int64_t)blockIdx.x * kTile;
  const int split = blockIdx.y;
  const int n_tiles = (M + kTile - 1) / kTile;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  load_dmajor(n_t, neg, K, k0, D);
  float out[4][kChunks][4];
  zero_out(out);

  float acc[4][4];
  for (int t = t_begin; t < t_end; ++t) {
    const int64_t r0 = (int64_t)t * kTile;
    __syncthreads();  // the previous tile is consumed; on the first pass, neg is staged
    load_dmajor(u_t, user, M, r0, D);
    load_rowmajor(u_r, user, M, r0, D, D4);
    float z[4], s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t r = r0 + 4 * ty + i;
      z[i] = r < M ? logz[r] : 0.f;
      s[i] = r < M ? grad[r] : 0.f;
    }
    __syncthreads();
    tile_dot(u_t, n_t, D, ty, tx, acc);  // rows 4 ty + i, negatives 4 tx + j
    probs(acc, r0, k0, ty, tx, M, K, z, s, inv_tau);
#pragma unroll
    for (int i = 0; i < 4; ++i)  // p_t[r][k]: the negatives of one row contiguous
      *reinterpret_cast<float4*>(p_t + (4 * ty + i) * kLd + 4 * tx) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
    tile_accumulate(p_t, u_r, D4, ty, tx, out);  // dneg[k] += sum_r P[r][k] u[r]
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t k = k0 + 4 * ty + i;
    if (k >= K) continue;
    float* dst = dneg_part + ((int64_t)split * K + k) * D;
#pragma unroll
    for (int c4 = 0; c4 < kChunks; ++c4)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = kTile * c4 + 4 * tx + j;
        if (c < D) dst[c] = out[i][c4][j] * inv_tau;
      }
  }
}

size_t fwd_smem(int D) { return sizeof(float) * (size_t)2 * D * kLd; }

size_t bwd_smem(int D) {
  return sizeof(float) * ((size_t)2 * D * kLd + (size_t)kTile * round4(D) + (size_t)kTile * kLd);
}

bool bad_shape(int M, int D, int K) { return M < 0 || D < 1 || D > kMaxD || K < 1; }

}  // namespace

// user, pos (M, D) and neg (K, D): contiguous float32. Writes logz and
// pos_logit (M,). Launches on `stream`; returns the first CUDA error (0 on
// success).
extern "C" int sampled_softmax_shared_fwd_f32(const float* user, const float* pos,
                                              const float* neg, float* logz,
                                              float* pos_logit, int M, int D, int K,
                                              float inv_tau, void* stream) {
  if (bad_shape(M, D, K)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const size_t smem = fwd_smem(D);
  cudaError_t err = allow_smem(shared_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  shared_fwd_kernel<<<(unsigned)((M + kTile - 1) / kTile), kThreads, smem,
                      (cudaStream_t)stream>>>(user, pos, neg, logz, pos_logit, M, D, K,
                                              inv_tau);
  return (int)cudaGetLastError();
}

// The backward for row gradients g (M,) of logz - pos_logit: du, dpos (M, D)
// and dneg (K, D). The row tiles of dneg's sum are cut into `splits` runs
// of equal length (the last may be shorter, none empty); with more than
// one, dneg_part holds splits * K * D floats of scratch, else it is unused
// (may be null).
extern "C" int sampled_softmax_shared_bwd_f32(const float* user, const float* pos,
                                              const float* neg, const float* logz,
                                              const float* pos_logit, const float* g,
                                              float* du, float* dpos, float* dneg,
                                              float* dneg_part, int M, int D, int K,
                                              float inv_tau, int splits, void* stream) {
  if (bad_shape(M, D, K) || splits < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t dneg_n = (int64_t)K * D;
  if (M == 0) return (int)cudaMemsetAsync(dneg, 0, sizeof(float) * dneg_n, st);
  const int m_tiles = (M + kTile - 1) / kTile;
  const int per = (m_tiles + splits - 1) / splits;
  if ((splits - 1) * per >= m_tiles) return (int)cudaErrorInvalidValue;  // an empty split
  const size_t smem = bwd_smem(D);
  cudaError_t err;
  if ((err = allow_smem(shared_du_kernel, smem)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(shared_dneg_kernel, smem)) != cudaSuccess) return (int)err;

  shared_du_kernel<<<(unsigned)m_tiles, kThreads, smem, st>>>(user, pos, neg, logz, pos_logit,
                                                              g, du, dpos, M, D, K, inv_tau);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const dim3 grid((unsigned)((K + kTile - 1) / kTile), (unsigned)splits);
  shared_dneg_kernel<<<grid, kThreads, smem, st>>>(user, neg, logz, g,
                                                   splits > 1 ? dneg_part : dneg, M, D, K,
                                                   inv_tau, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (splits > 1 && (err = sum_splits(dneg_part, dneg, dneg_n, splits, st)) != cudaSuccess)
    return (int)err;
  return 0;
}
