// Full-vocabulary softmax cross-entropy per row for Hopper (sm_90a), float32.
//
// Replaces the TPU kernels of recboard_tpu/ops/vocab_ce.py:
//   * forward  _fwd_kernel (:48): loss[r] = logsumexp_v(h[r].W[:, v] + b[v])
//     - (h[r].W[:, y[r]] + b[y[r]]), with logz[r] kept for the backward;
//   * backward _bwd_kernel (:64, pallas_call :140, reached through
//     fullvocab_ce_rows :190): with dlog[r, v] = (exp(h[r].W[:, v] + b[v]
//     - logz[r]) - [v == y[r]]) * g[r], dh = dlog W^T, dW = h^T dlog,
//     db = sum_r dlog.
// Neither writes the (M, V) logits: they are recomputed tile by tile. W
// arrives in its (V, D) row-major storage (what fc.weight is), and dW is
// written in that layout too.
//
// The forward. What bounds it on an H100: operations. Its work is 2*M*D*V
// = 15.9 GFLOP at BERT4Rec's training shape (M = 10,240 selected rows, D =
// 64, V = 12,103): 237 us at the 67 TFLOP/s float32 rate without tensor
// cores, 96 us as three TF32 products at the 495 TFLOP/s tensor-core rate;
// its inputs are 3.5 MB. So it runs on the tensor cores as the backward
// does, and shares its logits: the same tile_logits, in the same fragment
// order, so the backward's recomputed logits have the bits of those that
// made logz:
//   * a block takes a 64-row tile of h and a split of the 128-entry
//     vocabulary tiles; h's tile is split once into TF32 hi and lo tiles in
//     shared memory (its fragments are read by 4 warps each), and W's tiles
//     are double-buffered by cp.async in float32 and split as fragments
//     load (each read by 2 warps): splitting them once instead needs a third
//     tile, one block an SM at D 64, and measured slower;
//   * an online logsumexp on the accumulator fragments: each thread keeps
//     (max, sum, label's logit) for its 4 rows over its 8 entries of every
//     tile (bias added, -inf past V, exp2 of x - max), merged over the quad
//     and then the 4 warps of a row at the end, in a fixed order; the
//     logits never leave registers;
//   * two blocks an SM up to D 64 (96 KB of shared memory each, at most 128
//     registers a thread), one at D 128 (192 KB); the wrapper sizes the
//     vocabulary splits to the blocks that fit (FWD_BLOCKS_PER_SM in
//     ops/vocab_ce.py), and the splits' partials are merged in order by a
//     second kernel: reruns give the same bits, and no atomics.
//
// The backward. What bounds it on an H100: operations. The TPU kernel's
// work (the logits again, dh and dW) is 6*M*D*V = 47.6 GFLOP: 0.710 ms at
// the float32 rate without tensor cores, 0.288 ms as three TF32 products
// each at the 495 TFLOP/s tensor-core rate; its inputs are 5.7 MB (1.7 us
// at 3.35 TB/s). So the design puts the products on the tensor cores and
// keeps float32 accuracy (mma_tf32.cuh):
//   * every product is mma.sync m16n8k8 TF32 in split precision (3xTF32),
//     the float32 operands split in registers as fragments are loaded
//     (ldmatrix where a fragment lies along a tile's rows);
//   * two kernels, no atomics: dh by row tiles (64 rows, a loop over
//     128-entry vocabulary tiles) and dW and db by vocabulary tiles (128
//     entries, a loop over 64-row tiles), each recomputing its logits from
//     logz (8*M*D*V in all, 3x that issued to the tensor cores); loops are
//     split across blocks that write partials, added in a fixed order, so
//     every run gives the same bits;
//   * 8 warps a block, one block an SM; the logits of a 64 x 128 tile are
//     2 x 4 warps of 32 x 32; dlog is made from their accumulator fragments
//     in registers (bias, logz, exp2, the label's one-hot, g) and written
//     once to shared memory as the second product's A operand (row-major
//     for dh, transposed for dW);
//   * each tile's second product is summed in fresh registers and added to
//     the running dh or dW in float32: the tensor cores truncate as they
//     accumulate, and over a whole loop (up to 1,536 entries a split) that
//     drifted to 8.5e-6 relative where float32 products give 2.7e-6;
//   * one swizzled float32 copy of each operand tile in shared memory
//     serves both products; the streamed tile (W's in the dh kernel, h's
//     in the dW kernel) is double-buffered, the next one staged with
//     cp.async (zero-filled past V, M and D) while the current one is
//     multiplied;
//   * D is padded with zeros to 32, 64 or 128, one build of each kernel per
//     width.
// What holds it back: the splits. Each operand element is split again by
// every warp that loads it (2 to 4), four integer operations each, about as
// many instructions as the products issue (cvt.rna, a quarter-rate
// conversion, was slower still); and two blocks an SM spill at 128
// registers, so one block of 8 warps has to hide every latency. Left for
// the next step: wgmma from shared memory (the only way to the full
// tensor-core rate; mma.sync issues from registers, one warp at a time)
// with operands split once per tile, TMA loads into an mbarrier-paced
// ring, and a persistent grid in place of the split loops and their
// partials.

#include "mma_tf32.cuh"  // tile_logits, mma_accumulate, stage_rows
#include "tiles.cuh"  // kMaxD, kFull, lse_merge, allow_smem, sum_splits

namespace {

constexpr int kRows = 64;         // rows of h per tile
constexpr int kVocab = 128;       // vocabulary entries per tile
constexpr int kTcThreads = 256;   // 8 warps
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ int label_in(int64_t y, int V) {
  return y >= 0 && y < V ? (int)y : -1;
}

// Forward: block (64-row tile, vocabulary split), looping over the split's
// 128-entry tiles. Writes per split and row the max logit, the sum of
// exp(logit - max) and the label's logit (0 when the label is in another
// split) into part[3][split][M]. h's tile is split once into hi and lo
// tiles; W's tiles are double-buffered in float32 and split as fragments
// load. Two blocks an SM fit up to DP 64; at 128 the shared memory allows
// one, so its registers are not capped for two.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, DP <= 64 ? 2 : 1)
vocab_ce_fwd_kernel(const float* __restrict__ h, const float* __restrict__ wt,
                    const float* __restrict__ bias, const int64_t* __restrict__ labels,
                    float* __restrict__ part, int M, int D, int V, int tiles_per_split) {
  extern __shared__ __align__(16) float smem[];
  float* hh_s = smem;               // kRows x DP: h's hi (its float32 tile first)
  float* hl_s = hh_s + kRows * DP;  // kRows x DP: h's lo
  float* w_s = hl_s + kRows * DP;   // 2 x kVocab x DP: W's tiles
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int n_tiles = (V + kVocab - 1) / kVocab;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const SplitTile h_split{hh_s, hl_s};

  stage_rows<kRows, DP, kTcThreads>(hh_s, h, D, true, RowsFrom{r0, M});
  stage_rows<kVocab, DP, kTcThreads>(w_s, wt, D, true, RowsFrom{(int64_t)t_begin * kVocab, V});
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  split_tile<kRows * DP, kTcThreads>(hh_s, hh_s, hl_s);  // seen after the loop's first barrier

  // logits: warps 2 (rows) x 4 (entries) of 32 x 32; each thread holds rows
  // rw + 16 i + 8 hh + g, and of every tile the entries vw + 8 j + 2 t + e
  const int rw = 32 * (warp / 4), vw = 32 * (warp % 4);
  int y[2][2];
  float mx[2][2], sum[2][2], picked[2][2];  // over this thread's entries so far
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t r = r0 + rw + 16 * i + 8 * hh + g;
      y[i][hh] = r < M ? label_in(labels[r], V) : -1;
      mx[i][hh] = -INFINITY;
      sum[i][hh] = picked[i][hh] = 0.f;
    }

  float acc[2][4][4];
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int buf = (tile - t_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // this tile is staged; the previous one's products are done
    if (tile + 1 < t_end)
      stage_rows<kVocab, DP, kTcThreads>(w_s + (buf ^ 1) * kVocab * DP, wt, D, true,
                                         RowsFrom{(int64_t)(tile + 1) * kVocab, V});
    cp_async_commit();
    const int vb = tile * kVocab + vw + 2 * t;
    float bias_c[4][2];  // -inf past V: those entries add exp(-inf) = 0
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = vb + 8 * j + e;
        bias_c[j][e] = v < V ? __ldg(bias + v) : -INFINITY;
      }
    tile_logits<DP>(h_split, w_s + buf * kVocab * DP, rw, vw, acc);

    // online logsumexp of each row over this thread's 8 entries of the tile
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float x[4][2], tile_max = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            x[j][e] = acc[i][j][2 * hh + e] + bias_c[j][e];
            tile_max = fmaxf(tile_max, x[j][e]);
          }
        const int dy = y[i][hh] - vb;
        if ((unsigned)dy < 32u) {  // the label may be one of this thread's entries
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (dy == 8 * j + e) picked[i][hh] = x[j][e];
        }
        const float m = fmaxf(mx[i][hh], tile_max);
        if (m == -INFINITY) continue;  // no entry below V yet
        // exp(x - m) as exp2: x - m is exact near the max
        float s = sum[i][hh] * exp2f((mx[i][hh] - m) * kLog2e);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) s += exp2f((x[j][e] - m) * kLog2e);
        sum[i][hh] = s;
        mx[i][hh] = m;
      }
  }
  cp_async_wait_all();

  // merge each row over the quad's lanes (t), then over the 4 warps of its
  // entries (vw) through shared memory, in a fixed order
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float m2 = __shfl_xor_sync(kFull, mx[i][hh], o);
        const float s2 = __shfl_xor_sync(kFull, sum[i][hh], o);
        picked[i][hh] += __shfl_xor_sync(kFull, picked[i][hh], o);
        lse_merge(mx[i][hh], sum[i][hh], m2, s2);
      }
  __syncthreads();  // the tiles are consumed
  float* red = w_s;  // [3][4][kRows]: (max, sum, picked) x entry warp x row
  if (t == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k = (warp % 4) * kRows + rw + 16 * i + 8 * hh + g;
        red[k] = mx[i][hh];
        red[4 * kRows + k] = sum[i][hh];
        red[8 * kRows + k] = picked[i][hh];
      }
  __syncthreads();
  const int64_t r = r0 + threadIdx.x;
  if (threadIdx.x < kRows && r < M) {
    float m = -INFINITY, s = 0.f, p = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = c * kRows + threadIdx.x;
      lse_merge(m, s, red[k], red[4 * kRows + k]);
      p += red[8 * kRows + k];
    }
    const int64_t splits = gridDim.y;
    part[(0 * splits + split) * M + r] = m;
    part[(1 * splits + split) * M + r] = s;
    part[(2 * splits + split) * M + r] = p;
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

// ---- backward ----

// logits -> dlog in place: rows [i][h] (h = 0, 1: g and g + 8) with label
// y (-1 when out of range), zl = logz * log2(e) (+inf past M) and g;
// entries vb + 8 j + e with bias bias_c[j][e] (-inf past V). Both sentinels
// make exp2 exactly 0, so dlog is 0 past M and V, and on rows with g = 0.
__device__ __forceinline__ void to_dlog(float acc[2][4][4], const int y[2][2],
                                        const float zl[2][2], const float gr[2][2], int vb,
                                        const float bias_c[4][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int hh = q >> 1, e = q & 1;
        const float p = exp2f(fmaf(acc[i][j][q] + bias_c[j][e], kLog2e, -zl[i][hh]));
        acc[i][j][q] = (p - (vb + 8 * j + e == y[i][hh] ? 1.f : 0.f)) * gr[i][hh];
      }
}

// Backward, dh: block (64-row tile, vocabulary split), looping over the
// split's 128-entry tiles; dh, or its split's partial, goes to
// dh_part[split][M][D].
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
vocab_ce_dh_kernel(const float* __restrict__ h, const float* __restrict__ wt,
                   const float* __restrict__ bias, const int64_t* __restrict__ labels,
                   const float* __restrict__ logz, const float* __restrict__ grad,
                   float* __restrict__ dh_part, int M, int D, int V, int tiles_per_split) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                    // kRows x DP
  float* w_s = h_s + kRows * DP;        // 2 x kVocab x DP
  float* dl_s = w_s + 2 * kVocab * DP;  // kRows x kVocab
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int n_tiles = (V + kVocab - 1) / kVocab;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  stage_rows<kRows, DP, kTcThreads>(h_s, h, D, true, RowsFrom{r0, M});
  stage_rows<kVocab, DP, kTcThreads>(w_s, wt, D, true, RowsFrom{(int64_t)t_begin * kVocab, V});
  cp_async_commit();

  // logits: warps 2 (rows) x 4 (entries) of 32 x 32; dh: 4 (rows) x 2 (D)
  const int rw = 32 * (warp / 4), vw = 32 * (warp % 4);
  const int rd = 16 * (warp / 2), dd = (DP / 2) * (warp % 2);
  constexpr int NT = DP / 16;
  int y[2][2];
  float zl[2][2], gr[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t r = r0 + rw + 16 * i + 8 * hh + g;
      const bool ok = r < M;
      y[i][hh] = ok ? label_in(labels[r], V) : -1;
      zl[i][hh] = ok ? logz[r] * kLog2e : INFINITY;
      gr[i][hh] = ok ? grad[r] : 0.f;
    }
  float out[1][NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) out[0][j][q] = 0.f;

  float acc[2][4][4];
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int buf = (tile - t_begin) & 1;
    const float* w_cur = w_s + buf * kVocab * DP;
    cp_async_wait_all();
    __syncthreads();  // this tile is staged; the previous one's products are done
    if (tile + 1 < t_end)
      stage_rows<kVocab, DP, kTcThreads>(w_s + (buf ^ 1) * kVocab * DP, wt, D, true,
                                          RowsFrom{(int64_t)(tile + 1) * kVocab, V});
    cp_async_commit();
    const int vb = tile * kVocab + vw + 2 * t;
    float bias_c[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = vb + 8 * j + e;
        bias_c[j][e] = v < V ? __ldg(bias + v) : -INFINITY;
      }
    tile_logits<DP>(h_s, w_cur, rw, vw, acc);
    to_dlog(acc, y, zl, gr, vb, bias_c);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)  // dl_s[r][v]
          *reinterpret_cast<float2*>(dl_s + at(rw + 16 * i + 8 * hh + g, vw + 8 * j + 2 * t,
                                               kVocab)) =
              make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
    __syncthreads();
    mma_accumulate<1, NT, kVocab, kVocab, DP>(dl_s, rd, w_cur, dd, g, t, out);  // dh += dlog W
  }
  cp_async_wait_all();

#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t r = r0 + rd + 8 * hh + g;
      const int d = dd + 8 * j + 2 * t;  // D is a multiple of 4: d < D means d + 1 < D
      if (r < M && d < D)
        *reinterpret_cast<float2*>(dh_part + ((int64_t)split * M + r) * D + d) =
            make_float2(out[0][j][2 * hh], out[0][j][2 * hh + 1]);
    }
}

// Backward, dW and db: block (128-entry vocabulary tile, row split),
// looping over the split's 64-row tiles; dW (V, D) and db, or the split's
// partials, go to dw_part[split][V][D] and db_part[split][V].
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
vocab_ce_dw_kernel(const float* __restrict__ h, const float* __restrict__ wt,
                   const float* __restrict__ bias, const int64_t* __restrict__ labels,
                   const float* __restrict__ logz, const float* __restrict__ grad,
                   float* __restrict__ dw_part, float* __restrict__ db_part, int M, int D,
                   int V, int tiles_per_split) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                      // kVocab x DP
  float* h_s = w_s + kVocab * DP;         // 2 x kRows x DP
  float* dl_s = h_s + 2 * kRows * DP;     // kVocab x kRows: dlog transposed
  int64_t* y_s = reinterpret_cast<int64_t*>(dl_s + kVocab * kRows);  // 2 x kRows
  float* z_s = reinterpret_cast<float*>(y_s + 2 * kRows);            // 2 x kRows
  float* g_s = z_s + 2 * kRows;                                       // 2 x kRows
  float* b_s = g_s + 2 * kRows;                                       // kVocab
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int64_t v0 = (int64_t)blockIdx.x * kVocab;
  const int split = blockIdx.y;
  const int n_tiles = (M + kRows - 1) / kRows;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  // a row tile of h, and its rows' labels, logz and g, into buffer buf
  auto stage_tile = [&](int buf, int tile) {
    const int64_t r0 = (int64_t)tile * kRows;
    stage_rows<kRows, DP, kTcThreads>(h_s + buf * kRows * DP, h, D, true, RowsFrom{r0, M});
    if (threadIdx.x < kRows) {
      const int64_t r = r0 + threadIdx.x;
      const bool ok = r < M;
      const int k = buf * kRows + threadIdx.x;
      cp_async<8>(y_s + k, ok ? labels + r : labels, ok);
      cp_async<4>(z_s + k, ok ? logz + r : logz, ok);
      cp_async<4>(g_s + k, ok ? grad + r : grad, ok);
    }
  };
  stage_rows<kVocab, DP, kTcThreads>(w_s, wt, D, true, RowsFrom{v0, V});
  if (threadIdx.x < kVocab) {
    const bool ok = v0 + threadIdx.x < V;
    cp_async<4>(b_s + threadIdx.x, ok ? bias + v0 + threadIdx.x : bias, ok);
  }
  if (t_begin < t_end) stage_tile(0, t_begin);
  cp_async_commit();

  // logits: warps 2 (rows) x 4 (entries) of 32 x 32; dW: 4 (entries) x 2 (D)
  const int rw = 32 * (warp / 4), vw = 32 * (warp % 4);
  const int vd = 32 * (warp / 2), dd = (DP / 2) * (warp % 2);
  constexpr int NT = DP / 16;
  float out[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) out[i][j][q] = 0.f;
  float db_c[4][2];  // this thread's entries, summed over its rows in order
#pragma unroll
  for (int j = 0; j < 4; ++j) db_c[j][0] = db_c[j][1] = 0.f;
  const int vb = (int)v0 + vw + 2 * t;

  float acc[2][4][4];
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int buf = (tile - t_begin) & 1;
    const float* h_cur = h_s + buf * kRows * DP;
    cp_async_wait_all();
    __syncthreads();  // this tile is staged; the previous one's products are done
    if (tile + 1 < t_end) stage_tile(buf ^ 1, tile + 1);
    cp_async_commit();
    tile_logits<DP>(h_cur, w_s, rw, vw, acc);
    int y[2][2];
    float zl[2][2], gr[2][2], bias_c[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k = rw + 16 * i + 8 * hh + g;
        const bool ok = (int64_t)tile * kRows + k < M;
        y[i][hh] = ok ? label_in(y_s[buf * kRows + k], V) : -1;
        zl[i][hh] = ok ? z_s[buf * kRows + k] * kLog2e : INFINITY;
        gr[i][hh] = g_s[buf * kRows + k];  // 0 past M
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bias_c[j][e] = vb + 8 * j + e < V ? b_s[vw + 8 * j + 2 * t + e] : -INFINITY;
    to_dlog(acc, y, zl, gr, vb, bias_c);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // dl_s[v][r]
          const int hh = q >> 1, e = q & 1;
          dl_s[at(vw + 8 * j + 2 * t + e, rw + 16 * i + 8 * hh + g, kRows)] = acc[i][j][q];
          db_c[j][e] += acc[i][j][q];
        }
    __syncthreads();
    mma_accumulate<2, NT, kRows, kRows, DP>(dl_s, vd, h_cur, dd, g, t, out);  // dW += dlog^T h
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t v = v0 + vd + 16 * i + 8 * hh + g;
        const int d = dd + 8 * j + 2 * t;  // D is a multiple of 4
        if (v < V && d < D)
          *reinterpret_cast<float2*>(dw_part + ((int64_t)split * V + v) * D + d) =
              make_float2(out[i][j][2 * hh], out[i][j][2 * hh + 1]);
      }

  // db: over the 8 row groups of a warp (lanes g), then the two warps of
  // each 32-entry column (rows 0-31, 32-63), in a fixed order
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) db_c[j][e] += __shfl_xor_sync(kFull, db_c[j][e], o);
  __syncthreads();  // dl_s is free
  float* red = dl_s;  // 2 x kVocab
  if (g == 0)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) red[(warp / 4) * kVocab + vw + 8 * j + 2 * t + e] = db_c[j][e];
  __syncthreads();
  if (threadIdx.x < kVocab && v0 + threadIdx.x < V)
    db_part[(int64_t)split * V + v0 + threadIdx.x] = red[threadIdx.x] + red[kVocab + threadIdx.x];
}

template <int DP>
size_t dh_smem() {
  return sizeof(float) * ((size_t)kRows * DP + 2 * kVocab * DP + kRows * kVocab);
}

template <int DP>
size_t dw_smem() {  // + labels (int64), logz and g of two row tiles, and the bias
  return sizeof(float) * ((size_t)kVocab * DP + 2 * kRows * DP + kVocab * kRows + 8 * kRows +
                          kVocab);
}

// the width the kernels pad D to: one build of each kernel per width
int padded_width(int D) { return D <= 32 ? 32 : D <= 64 ? 64 : 128; }

template <int DP>
cudaError_t bwd_run(const float* h, const float* wt, const float* bias, const int64_t* labels,
                    const float* logz, const float* g, float* dh_part, float* dw_part,
                    float* db_part, float* dh, float* dw, float* db, int M, int D, int V,
                    int dh_splits, int dw_splits, cudaStream_t st) {
  const int v_tiles = (V + kVocab - 1) / kVocab;
  const int m_tiles = (M + kRows - 1) / kRows;
  const int dh_per = (v_tiles + dh_splits - 1) / dh_splits;
  const int dw_per = m_tiles > 0 ? (m_tiles + dw_splits - 1) / dw_splits : 1;
  if ((dh_splits - 1) * dh_per >= v_tiles || (M > 0 && (dw_splits - 1) * dw_per >= m_tiles))
    return cudaErrorInvalidValue;  // an empty split
  cudaError_t err;
  if ((err = allow_smem(vocab_ce_dh_kernel<DP>, dh_smem<DP>())) != cudaSuccess) return err;
  if ((err = allow_smem(vocab_ce_dw_kernel<DP>, dw_smem<DP>())) != cudaSuccess) return err;

  if (M > 0) {
    float* dh_out = dh_splits > 1 ? dh_part : dh;
    const dim3 grid((unsigned)m_tiles, (unsigned)dh_splits);
    vocab_ce_dh_kernel<DP><<<grid, kTcThreads, dh_smem<DP>(), st>>>(
        h, wt, bias, labels, logz, g, dh_out, M, D, V, dh_per);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (dh_splits > 1 &&
        (err = sum_splits(dh_part, dh, (int64_t)M * D, dh_splits, st)) != cudaSuccess)
      return err;
  }

  float* dw_out = dw_splits > 1 ? dw_part : dw;
  float* db_out = dw_splits > 1 ? db_part : db;
  const dim3 grid((unsigned)v_tiles, (unsigned)dw_splits);
  vocab_ce_dw_kernel<DP><<<grid, kTcThreads, dw_smem<DP>(), st>>>(
      h, wt, bias, labels, logz, g, dw_out, db_out, M, D, V, dw_per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (dw_splits > 1) {
    if ((err = sum_splits(dw_part, dw, (int64_t)V * D, dw_splits, st)) != cudaSuccess)
      return err;
    if ((err = sum_splits(db_part, db, (int64_t)V, dw_splits, st)) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int DP>
size_t fwd_smem() {
  return sizeof(float) * ((size_t)2 * kRows * DP + 2 * kVocab * DP);
}

struct FwdArgs {
  const float *h, *wt, *bias;
  const int64_t* labels;
  float *part, *loss, *logz;
  int M, D, V, splits;
  cudaStream_t stream;
};

// The forward at one width
template <int DP>
cudaError_t fwd_run(const FwdArgs& a) {
  const auto kernel = vocab_ce_fwd_kernel<DP>;
  const size_t smem = fwd_smem<DP>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int v_tiles = (a.V + kVocab - 1) / kVocab;
  const int per = (v_tiles + a.splits - 1) / a.splits;
  if ((a.splits - 1) * per >= v_tiles) return cudaErrorInvalidValue;  // an empty split
  if (a.M == 0) return cudaSuccess;
  const dim3 grid((unsigned)((a.M + kRows - 1) / kRows), (unsigned)a.splits);
  kernel<<<grid, kTcThreads, smem, a.stream>>>(a.h, a.wt, a.bias, a.labels, a.part, a.M, a.D,
                                               a.V, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  vocab_ce_combine_kernel<<<(unsigned)((a.M + 255) / 256), 256, 0, a.stream>>>(
      a.part, a.loss, a.logz, a.M, a.splits);
  return cudaGetLastError();
}

bool bad_shape(int M, int D, int V, int split_a, int split_b) {
  return M < 0 || D < 1 || D > kMaxD || D % 4 != 0 || V < 1 || split_a < 1 || split_b < 1;
}

}  // namespace

// h (M, D), wt (V, D), bias (V,): contiguous float32, D a multiple of 4 and
// h and wt 16-byte aligned; labels (M,) int64. part: 3 * splits * M floats
// of scratch. Writes loss and logz (M,). The 128-entry vocabulary tiles are
// cut into `splits` runs of equal length (the last may be shorter, none
// empty). Launches on `stream`; returns the first CUDA error (0 on
// success).
extern "C" int vocab_ce_fwd_f32(const float* h, const float* wt, const float* bias,
                                const int64_t* labels, float* part, float* loss,
                                float* logz, int M, int D, int V, int splits, void* stream) {
  if (bad_shape(M, D, V, splits, 1)) return (int)cudaErrorInvalidValue;
  const FwdArgs a{h, wt, bias, labels, part, loss, logz, M, D, V, splits,
                  (cudaStream_t)stream};
  switch (padded_width(D)) {
    case 32:
      return (int)fwd_run<32>(a);
    case 64:
      return (int)fwd_run<64>(a);
    default:
      return (int)fwd_run<128>(a);
  }
}

// The backward for the loss gradient g (M,): dh (M, D), dw (V, D) (the
// gradient of wt) and db (V,); D a multiple of 4 and h and wt 16-byte
// aligned. dh_splits runs of 128-entry vocabulary tiles for dh and
// dw_splits runs of 64-row tiles for dw/db; with more than one, dh_part
// holds dh_splits * M * D floats, dw_part dw_splits * V * D and db_part
// dw_splits * V, else they are unused (may be null).
extern "C" int vocab_ce_bwd_f32(const float* h, const float* wt, const float* bias,
                                const int64_t* labels, const float* logz, const float* g,
                                float* dh_part, float* dw_part, float* db_part, float* dh,
                                float* dw, float* db, int M, int D, int V, int dh_splits,
                                int dw_splits, void* stream) {
  if (bad_shape(M, D, V, dh_splits, dw_splits)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (padded_width(D)) {
    case 32:
      return (int)bwd_run<32>(h, wt, bias, labels, logz, g, dh_part, dw_part, db_part, dh, dw,
                              db, M, D, V, dh_splits, dw_splits, st);
    case 64:
      return (int)bwd_run<64>(h, wt, bias, labels, logz, g, dh_part, dw_part, db_part, dh, dw,
                              db, M, D, V, dh_splits, dw_splits, st);
    default:
      return (int)bwd_run<128>(h, wt, bias, labels, logz, g, dh_part, dw_part, db_part, dh, dw,
                               db, M, D, V, dh_splits, dw_splits, st);
  }
}
