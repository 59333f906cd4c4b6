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
// The forward. A row of weight 0 adds nothing to the loss (its logz and
// pos_logit are multiplied by 0), and the backward reads them only on rows
// of s != 0, which have w != 0; at HSTU's training shape (M = 256 x 50 =
// 12,800 rows, K = 512, D = 64) 87.9 % of the rows are pads of weight 0.
// So it computes the rows of w != 0 alone: 1,553 of 12,800, 2*1,553*K*D =
// 0.102 GFLOP (0.62 us as three TF32 products at the 495 TFLOP/s
// tensor-core rate, 1.52 us at the 67 TFLOP/s float32 rate), against 1.08
// MB of w, the weighted rows of u and p, n, and logz and pos_logit written
// for every row (0.32 us at 3.35 TB/s). The design, three kernels behind
// one call, with no host synchronisation, no atomics and no library call:
//   1. cand_live_kernel (live_rows.cuh, K4's) lists the rows of w != 0 in
//      order, and their count, in device memory;
//   2. shared_fwd_tile_kernel<DP>: block (128-negative tile, split) stages
//      its negatives once and walks its split's tiles of 64 listed rows,
//      gathered through the list by stage_rows, the next one staged by
//      cp.async while the current one is multiplied. Per tile, tile_logits
//      gives the 64 x 128 logits in the backward's warp layout and DP, so
//      the backward recomputes them bit for bit; an online logsumexp on the
//      accumulator fragments gives each row's (max, sum of exp) over the
//      block's negatives: each thread over its 8 entries (-inf past K, exp2
//      of (x - max) log2 e), then the quad's lanes, then the row's 4 warps
//      in order, written at the row's list position. Before that, while its
//      tiles load, every block writes its share of logz = pos_logit = 0 on
//      the rows of weight 0 (a thread a row, the blocks without tiles
//      first), so no torch.empty contents reach the loss;
//   3. shared_fwd_merge_kernel, a programmatic dependent launch: a warp a
//      listed row makes pos_logit = u.p / tau (lane sums, then a fixed
//      shuffle tree) while the tile kernel runs, waits for that kernel's
//      end, and merges (pos_logit, 1) with the negative tiles' partials in
//      order: logz = max + log(sum).
// Reruns give the same bits; with no weighted row, logz and pos_logit are
// exactly 0. The grid is the backward's (below): at the training shape 4
// negative tiles x 50 splits, 100 blocks taking one tile each.
//
// The backward. A row of s = 0 adds exactly nothing to du, dpos or dneg
// (P and coef are products by 0), and at that shape 87.9 % of the rows are
// pads of weight 0. So it computes the rows of s != 0 alone: 1,553 of
// 12,800, 6*1,553*K*D = 0.305 GFLOP (1.85 us as three TF32 products at the
// 495 TFLOP/s tensor-core rate, 4.6 us at the float32 rate). What bounds it
// is then bytes: du and dpos are written for all M rows (6.55 MB), and s,
// n, dneg and the live rows of u, p, logz and pos_logit add 1.1 MB, 2.3 us
// at 3.35 TB/s. The design, three kernels behind one call, with no host
// synchronisation, no float atomics and no library call:
//   1. cand_live_kernel (live_rows.cuh, K4's) lists the rows of s != 0 in
//      order, and their count, in device memory;
//   2. shared_bwd_tile_kernel<DP>: block (128-negative tile, split) stages its
//      negatives once and walks its split's tiles of 64 listed rows, gathered
//      through the list by mma_tf32.cuh's stage_rows (cp.async; zeros past the
//      list, past K and past D). Per tile, K3's tile_logits gives the 64 x 128
//      logits (mma.sync TF32 in split precision, 3xTF32, mma_tf32.cuh: float32
//      accuracy); P is made in registers from the fragments (exp2 of the logit
//      - logz, times s) and written once to shared memory, where that one copy
//      feeds both second products: mma_accumulate gives du's partial P n over
//      this block's negatives, written to du_part at the rows' list positions,
//      and mma_accumulate with A_COLS (the same copy read down its columns)
//      adds P^T u to the block's running dneg, written to dneg_part once its
//      split is done. Before that, while its tiles load, every block writes its
//      share of du = dpos = 0 on the rows of s = 0 (a warp a row over the whole
//      grid), so no torch.empty contents reach autograd. D is padded with zeros
//      to 32, 64 or 128, one build per width; a D that is not a multiple of 4
//      (or a row that is not 16-byte aligned) is staged by 4-byte copies;
//   3. shared_bwd_finish_kernel adds the partials in a fixed order: du over
//      the ceil(K / 128) negative tiles, then + coef p, times 1 / tau, and
//      dpos = coef u / tau, a warp a listed row; dneg over the splits that
//      took tiles (their number from the count in device memory), times 1 /
//      tau. Reruns give the same bits; with no row of s != 0, du, dpos and
//      dneg are exactly 0.
// At the training shape the grid is 4 negative tiles x 50 splits; the 25
// tiles of listed rows give one tile to each of 25 splits, so 100 blocks
// take tiles and 100 only write zeros.
// Its logits are the forward's, bit for bit (the same tile_logits call,
// warp layout and DP), so P is formed from the logz they made.
// What holds it back: latency. At the training shape 100 blocks, one an
// SM, each make one pass of logits and two products from mma.sync
// fragments that are split again at every load (about as many integer
// operations as the products issue), after a chain of dependent loads
// (the count, the list, the rows); the listing and the finishing pass are
// launches of their own. Left for later: operands split once per tile,
// wgmma, and the finishing sums in the tile kernel's last blocks.
// Their scratch is sized on the host, which does not know the live count:
// the backward's du_part holds ceil(K / 128) partials for every row, 4
// ceil(K / 128) M D bytes (13.1 MB at the training shape), and so grows
// with K; the forward's partials take 8 ceil(K / 128) M bytes (410 KB).

#include <algorithm>

#include "live_rows.cuh"  // cand_live_kernel, kListThreads
#include "mma_tf32.cuh"   // tile_logits, mma_accumulate, stage_rows, cp_async
#include "tiles.cuh"      // kMaxD, kFull, lse_merge, allow_smem

namespace {

constexpr int kRows = 64;         // listed rows per tile
constexpr int kNegs = 128;        // negatives per tile
constexpr int kTcThreads = 256;   // 8 warps
constexpr int kFinishThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// The ceil(n / kRows) tiles of the n listed rows are cut into runs of
// `per` tiles (the last may be shorter), one a split; the first `used`
// splits take tiles, the others none
__device__ __forceinline__ void tile_runs(int n, int splits, int& tiles, int& per, int& used) {
  tiles = (n + kRows - 1) / kRows;
  per = (tiles + splits - 1) / splits;
  used = per > 0 ? (tiles + per - 1) / per : 0;
}

// ---- forward ----

// Forward, 2: block (negative tile, split) takes its split's tiles of
// listed rows, one after another, the next one staged while the current
// one is multiplied: each tile's 64 x 128 logits (tile_logits, 3xTF32, as
// the backward recomputes them), then each row's (max, sum of exp) over
// this block's negatives, to part[0 or 1][negative tile][list position].
// First every block writes its share of the zeros of logz and pos_logit
// on the rows of weight 0, while its first tiles load.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, DP <= 64 ? 2 : 1)
shared_fwd_tile_kernel(const float* __restrict__ user, const float* __restrict__ neg,
                       const float* __restrict__ weights, const int* __restrict__ live,
                       const int* __restrict__ n_live, float* __restrict__ logz,
                       float* __restrict__ pos_logit, float* __restrict__ part, int M, int D,
                       int K, float inv_tau, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* n_s = smem;                  // kNegs x DP: this block's negatives
  float* u_s = n_s + kNegs * DP;      // 2 x kRows x DP: tiles of listed rows
  float* red = u_s + 2 * kRows * DP;  // 2 x 4 x kRows: (max, sum) x warp x row
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int64_t k0 = (int64_t)blockIdx.x * kNegs;
  const int n = *n_live;
  int tiles, per, used;
  tile_runs(n, gridDim.y, tiles, per, used);
  const int t_begin = min(tiles, (int)blockIdx.y * per), t_end = min(tiles, t_begin + per);

  auto stage_u = [&](int tile, float* dst) {
    const int64_t b0 = (int64_t)tile * kRows;
    stage_rows<kRows, DP, kTcThreads>(dst, user, D, vec, [&](int r, int64_t& m) {
      m = b0 + r < n ? (int64_t)live[b0 + r] : -1;
      return m >= 0;
    });
  };
  if (t_begin < t_end) {
    stage_rows<kNegs, DP, kTcThreads>(n_s, neg, D, vec, RowsFrom{k0, K});
    stage_u(t_begin, u_s);
  }
  cp_async_commit();
  // the merging kernel may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;");

  // logz = pos_logit = 0 on the rows cand_live_kernel left out: a thread a
  // row over the whole grid, the last blocks, those of the splits that take
  // no tile, first
  const int64_t threads = (int64_t)gridDim.x * gridDim.y * kTcThreads;
  const int64_t from_last =
      threads - 1 - (((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * kTcThreads + threadIdx.x);
  for (int64_t r = from_last; r < M; r += threads)
    if (weights[r] == 0.f) logz[r] = pos_logit[r] = 0.f;

  // logits: warps 2 (rows) x 4 (negatives) of 32 x 32; each thread holds
  // rows rw + 16 i + 8 hh + g and negatives vw + 8 j + 2 t + e
  const int rw = 32 * (warp / 4), vw = 32 * (warp % 4);
  bool col_ok[4][2];  // negatives past K take no part
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) col_ok[j][e] = k0 + vw + 8 * j + 2 * t + e < K;

  float acc[2][4][4];
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int buf = (tile - t_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // this tile is staged; the previous one's partials are read
    if (tile + 1 < t_end) stage_u(tile + 1, u_s + (buf ^ 1) * kRows * DP);
    cp_async_commit();

    tile_logits<DP>(u_s + buf * kRows * DP, n_s, rw, vw, acc);
    // each row's (max, sum of exp2((x - max) log2 e)) over this thread's 8
    // entries, then over the quad's lanes
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float x[4][2], m = -INFINITY, s = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            x[j][e] = col_ok[j][e] ? acc[i][j][2 * hh + e] * inv_tau : -INFINITY;
            m = fmaxf(m, x[j][e]);
          }
        if (m != -INFINITY) {  // else this thread's negatives all lie past K
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) s += exp2f((x[j][e] - m) * kLog2e);
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float m2 = __shfl_xor_sync(kFull, m, o);
          const float s2 = __shfl_xor_sync(kFull, s, o);
          lse_merge(m, s, m2, s2);
        }
        if (t == 0) {
          const int r = rw + 16 * i + 8 * hh + g;
          red[(warp % 4) * kRows + r] = m;
          red[(4 + warp % 4) * kRows + r] = s;
        }
      }
    __syncthreads();
    // the row's 4 warps in order: this negative tile's partial
    const int64_t b = (int64_t)tile * kRows + threadIdx.x;
    if (threadIdx.x < kRows && b < n) {
      float m = -INFINITY, s = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        lse_merge(m, s, red[c * kRows + threadIdx.x], red[(4 + c) * kRows + threadIdx.x]);
      part[(int64_t)blockIdx.x * M + b] = m;
      part[((int64_t)gridDim.x + blockIdx.x) * M + b] = s;
    }
  }
}

// Forward, 3: a warp a listed row b, m = live[b]: pos_logit[m] = u[m].p[m]
// / tau (lane l adds d = l, l + 32, ..., then a fixed shuffle tree), made
// while the tile kernel runs; then, once that kernel has ended, logz[m]
// from (pos_logit, 1) merged with each negative tile's partial in order.
// A programmatic dependent launch of the tile kernel, which ran after the
// listing: the list may be read at once, the partials after the wait.
__global__ void __launch_bounds__(kFinishThreads)
shared_fwd_merge_kernel(const float* __restrict__ user, const float* __restrict__ pos,
                        const int* __restrict__ live, const int* __restrict__ n_live,
                        const float* __restrict__ part, float* __restrict__ logz,
                        float* __restrict__ pos_logit, int M, int D, int neg_tiles,
                        float inv_tau) {
  const int64_t b = (int64_t)blockIdx.x * (kFinishThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (b >= *n_live) return;  // whole warps
  const int64_t m = live[b];
  float dot = 0.f;
  for (int d = lane; d < D; d += 32) dot = fmaf(user[m * D + d], pos[m * D + d], dot);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (lane != 0) return;
  const float pl = dot * inv_tau;
  float mx = pl, s = 1.f;
  for (int k = 0; k < neg_tiles; ++k)
    lse_merge(mx, s, part[(int64_t)k * M + b], part[((int64_t)neg_tiles + k) * M + b]);
  logz[m] = mx + logf(s);
  pos_logit[m] = pl;
}

template <int DP>
size_t fwd_tile_smem() {
  return sizeof(float) * ((size_t)kNegs * DP + (size_t)2 * kRows * DP + (size_t)8 * kRows);
}

template <int DP>
cudaError_t launch_fwd_tiles(dim3 grid, cudaStream_t st, const float* user, const float* neg,
                             const float* w, const int* live, const int* n_live, float* logz,
                             float* pos_logit, float* part, int M, int D, int K, float inv_tau,
                             bool vec) {
  const cudaError_t err = allow_smem(shared_fwd_tile_kernel<DP>, fwd_tile_smem<DP>());
  if (err != cudaSuccess) return err;
  shared_fwd_tile_kernel<DP><<<grid, kTcThreads, fwd_tile_smem<DP>(), st>>>(
      user, neg, w, live, n_live, logz, pos_logit, part, M, D, K, inv_tau, vec);
  return cudaGetLastError();
}

// ---- backward ----

// Backward, 2: block (negative tile, split) takes its split's tiles of
// listed rows, one after another: each tile's 64 x 128 logits (tile_logits,
// 3xTF32), P in registers, P once to shared memory, then du's partial over
// this block's negatives, P n, to du_part[negative tile][list position],
// and dneg's, P^T u, added to the block's running dneg; that goes to
// dneg_part[split] at the end. First every block writes its share of the
// zeros of du and dpos on the rows with s = 0, while its first tiles load.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, DP <= 64 ? 2 : 1)
shared_bwd_tile_kernel(const float* __restrict__ user, const float* __restrict__ neg,
                       const float* __restrict__ logz, const float* __restrict__ grad,
                       const int* __restrict__ live, const int* __restrict__ n_live,
                       float* __restrict__ du, float* __restrict__ dpos,
                       float* __restrict__ du_part, float* __restrict__ dneg_part, int M, int D,
                       int K, float inv_tau, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* n_s = smem;              // kNegs x DP: this block's negatives
  float* u_s = n_s + kNegs * DP;  // kRows x DP: a tile of listed rows
  float* p_s = u_s + kRows * DP;  // kRows x kNegs: P
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t k0 = (int64_t)blockIdx.x * kNegs;
  const int n = *n_live;
  int tiles, per, used;
  tile_runs(n, gridDim.y, tiles, per, used);
  const int t_begin = min(tiles, (int)blockIdx.y * per), t_end = min(tiles, t_begin + per);

  auto stage_u = [&](int tile) {
    const int64_t b0 = (int64_t)tile * kRows;
    // a row index or -1, tested after: as an early return this spilled
    // 48 more bytes at DP 64, and the tiles took 1 us more
    stage_rows<kRows, DP, kTcThreads>(u_s, user, D, vec, [&](int r, int64_t& m) {
      m = b0 + r < n ? (int64_t)live[b0 + r] : -1;
      return m >= 0;
    });
  };
  // logz and s of this thread's rows of a tile: rows rw + 16 i + 8 hh + g
  // of the logits (below); 0 past the list
  const int rw = 32 * (warp / 4), vw = 32 * (warp % 4);
  float zr[2][2], sr[2][2];
  auto row_consts = [&](int tile) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t b = (int64_t)tile * kRows + rw + 16 * i + 8 * hh + g;
        const int64_t m = b < n ? live[b] : -1;
        zr[i][hh] = m >= 0 ? logz[m] : 0.f;
        sr[i][hh] = m >= 0 ? grad[m] : 0.f;
      }
  };
  if (t_begin < t_end) {
    stage_rows<kNegs, DP, kTcThreads>(n_s, neg, D, vec, RowsFrom{k0, K});
    stage_u(t_begin);
    row_consts(t_begin);
  }
  cp_async_commit();

  // du and dpos exactly 0 on the rows cand_live_kernel left out: a warp
  // takes 32 rows at a time over the whole grid, a lane reading one row's
  // s; the last blocks, those of the splits that take no tile, first
  const int64_t warps = (int64_t)gridDim.x * gridDim.y * (kTcThreads / 32);
  const int64_t from_last =
      warps - 1 - (((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * (kTcThreads / 32) + warp);
  for (int64_t r0 = 32 * from_last; r0 < M; r0 += 32 * warps) {
    const bool zero = r0 + lane < M && grad[r0 + lane] == 0.f;
    for (unsigned rows = __ballot_sync(kFull, zero); rows; rows &= rows - 1) {
      const int64_t r = r0 + __ffs(rows) - 1;
      for (int d = lane; d < D; d += 32) du[r * D + d] = dpos[r * D + d] = 0.f;
    }
  }

  // warps: the logits 2 (rows) x 4 (negatives) of 32 x 32; du 4 (rows) x 2
  // (D); dneg 4 (negatives) x 2 (D)
  const int rd = 16 * (warp / 2), vd = 32 * (warp / 2), dd = (DP / 2) * (warp % 2);
  constexpr int NT = DP / 16;
  float dn[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) dn[i][j][q] = 0.f;
  bool col_ok[4][2];  // negatives past K take no probability
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) col_ok[j][e] = k0 + vw + 8 * j + 2 * t + e < K;

  float acc[2][4][4];
  for (int tile = t_begin; tile < t_end; ++tile) {
    if (tile > t_begin) {
      __syncthreads();  // the previous tile's products are done
      stage_u(tile);
      cp_async_commit();
      row_consts(tile);
    }
    const int64_t b0 = (int64_t)tile * kRows;
    cp_async_wait_all();
    __syncthreads();  // the tiles are staged

    tile_logits<DP>(u_s, n_s, rw, vw, acc);
    // P = s exp(logit - logz): a row past the list has u = 0 and s = 0
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int hh = q >> 1, e = q & 1;
          const float x = acc[i][j][q] * inv_tau;
          acc[i][j][q] = col_ok[j][e] ? exp2f((x - zr[i][hh]) * kLog2e) * sr[i][hh] : 0.f;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)  // p_s[r][k]
          *reinterpret_cast<float2*>(p_s + at(rw + 16 * i + 8 * hh + g, vw + 8 * j + 2 * t,
                                              kNegs)) =
              make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
    __syncthreads();

    float du_o[1][NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) du_o[0][j][q] = 0.f;
    mma_accumulate<1, NT, kNegs, kNegs, DP>(p_s, rd, n_s, dd, g, t, du_o);  // P n
    float* dst = du_part + (int64_t)blockIdx.x * M * D;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t b = b0 + rd + 8 * hh + g;
        const int d = dd + 8 * j + 2 * t;
        if (b >= n) continue;
        if (d < D) dst[b * D + d] = du_o[0][j][2 * hh];
        if (d + 1 < D) dst[b * D + d + 1] = du_o[0][j][2 * hh + 1];
      }
    mma_accumulate<2, NT, kRows, kNegs, DP, true>(p_s, vd, u_s, dd, g, t, dn);  // dneg += P^T u
  }

  if (t_begin >= t_end) return;  // this split wrote no partial
  float* dst = dneg_part + (int64_t)blockIdx.y * K * D;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t k = k0 + vd + 16 * i + 8 * hh + g;
        const int d = dd + 8 * j + 2 * t;
        if (k >= K) continue;
        if (d < D) dst[k * D + d] = dn[i][j][2 * hh];
        if (d + 1 < D) dst[k * D + d + 1] = dn[i][j][2 * hh + 1];
      }
}

// Backward, 3: the partials added in a fixed order. A warp a listed row b,
// m = live[b]: du[m] = (the du_part of each negative tile in order + coef
// p[m]) / tau and dpos[m] = coef u[m] / tau, with coef = s (exp(pos_logit
// - logz) - 1); then dneg = the dneg_part of each split that took tiles,
// in order, / tau (exactly 0 with no listed row).
__global__ void __launch_bounds__(kFinishThreads)
shared_bwd_finish_kernel(const float* __restrict__ user, const float* __restrict__ pos,
                         const float* __restrict__ logz, const float* __restrict__ pos_logit,
                         const float* __restrict__ grad, const int* __restrict__ live,
                         const int* __restrict__ n_live, const float* __restrict__ du_part,
                         const float* __restrict__ dneg_part, float* __restrict__ du,
                         float* __restrict__ dpos, float* __restrict__ dneg, int M, int D, int K,
                         int neg_tiles, int splits, float inv_tau) {
  const int n = *n_live;
  int tiles, per, used;
  tile_runs(n, splits, tiles, per, used);
  const int lane = threadIdx.x % 32;
  const int64_t warps = (int64_t)gridDim.x * (kFinishThreads / 32);
  for (int64_t b = (int64_t)blockIdx.x * (kFinishThreads / 32) + threadIdx.x / 32; b < n;
       b += warps) {
    const int64_t m = live[b];
    const float s = grad[m], z = logz[m];
    const float coef = s * (expf(pos_logit[m] - z) - 1.f);
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int k = 0; k < neg_tiles; ++k) acc += du_part[((int64_t)k * M + b) * D + d];
      du[m * D + d] = (acc + coef * pos[m * D + d]) * inv_tau;
      dpos[m * D + d] = coef * user[m * D + d] * inv_tau;
    }
  }
  const int64_t kd = (int64_t)K * D;
  for (int64_t i = (int64_t)blockIdx.x * kFinishThreads + threadIdx.x; i < kd;
       i += (int64_t)gridDim.x * kFinishThreads) {
    float acc = 0.f;
    for (int k = 0; k < used; ++k) acc += dneg_part[k * kd + i];
    dneg[i] = acc * inv_tau;
  }
}

template <int DP>
size_t tile_smem() {
  return sizeof(float) * ((size_t)kNegs * DP + (size_t)kRows * DP + (size_t)kRows * kNegs);
}

template <int DP>
cudaError_t launch_tiles(dim3 grid, cudaStream_t st, const float* user, const float* neg,
                         const float* logz, const float* g, const int* live, const int* n_live,
                         float* du, float* dpos, float* du_part, float* dneg_part, int M, int D,
                         int K, float inv_tau, bool vec) {
  const cudaError_t err = allow_smem(shared_bwd_tile_kernel<DP>, tile_smem<DP>());
  if (err != cudaSuccess) return err;
  shared_bwd_tile_kernel<DP><<<grid, kTcThreads, tile_smem<DP>(), st>>>(
      user, neg, logz, g, live, n_live, du, dpos, du_part, dneg_part, M, D, K, inv_tau, vec);
  return cudaGetLastError();
}

// the finishing kernel's grid: a warp for each row and a thread for each
// element of dneg, up to four blocks an SM
unsigned finish_grid(int M, int K, int D, int sms) {
  const int64_t want = std::max<int64_t>((M + 7) / 8, ((int64_t)K * D + 255) / 256);
  return (unsigned)std::max<int64_t>(1, std::min<int64_t>(want, (int64_t)4 * sms));
}

bool bad_shape(int M, int D, int K) { return M < 0 || D < 1 || D > kMaxD || K < 1; }

}  // namespace

// user, pos (M, D) and neg (K, D), weights (M,): contiguous float32.
// Writes logz and pos_logit (M,) on the rows of weight != 0, and exactly 0
// on the others, through one scratch buffer the caller allocates, of 2 *
// ceil(K / 128) * M + M + 1 words: the partials (float32), then live (M,)
// and n_live (1,) (int32). The tiles of listed rows are cut into `splits`
// runs of equal length (splits <= 65535). Launches its three kernels on
// `stream`; the count of weighted rows stays in device memory. Returns the
// first CUDA error (0 on success).
extern "C" int sampled_softmax_shared_fwd_f32(const float* user, const float* pos,
                                              const float* neg, const float* weights,
                                              float* logz, float* pos_logit, float* scratch,
                                              int M, int D, int K, float inv_tau, int splits,
                                              void* stream) {
  if (bad_shape(M, D, K) || splits < 1 || splits > 65535) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int neg_tiles = (K + kNegs - 1) / kNegs;
  float* part = scratch;
  int* live = reinterpret_cast<int*>(part + (int64_t)2 * neg_tiles * M);
  int* n_live = live + M;
  cand_live_kernel<<<1, kListThreads, 0, st>>>(weights, live, n_live, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool vec = D % 4 == 0 && ((uintptr_t)user | (uintptr_t)neg) % 16 == 0;
  const dim3 grid((unsigned)neg_tiles, (unsigned)splits);
  auto go = [&](auto launch) {
    return launch(grid, st, user, neg, weights, live, n_live, logz, pos_logit, part, M, D, K,
                  inv_tau, vec);
  };
  err = D <= 32 ? go(launch_fwd_tiles<32>)
                : D <= 64 ? go(launch_fwd_tiles<64>) : go(launch_fwd_tiles<128>);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(((int64_t)M + 7) / 8));  // a warp a row
  config.blockDim = dim3(kFinishThreads);
  config.stream = st;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &early;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, shared_fwd_merge_kernel, user, pos, (const int*)live,
                                 (const int*)n_live, (const float*)part, logz, pos_logit, M, D,
                                 neg_tiles, inv_tau);
}

// The backward for row gradients g (M,) of logz - pos_logit: du, dpos (M, D)
// and dneg (K, D), through one scratch buffer the caller allocates, of
// ceil(K / 128) * M * D + splits * K * D + M + 1 words: du_part and
// dneg_part (float32), then live (M,) and n_live (1,) (int32). The tiles of
// listed rows are cut into `splits` runs of equal length (splits <= 65535);
// `sms` is the card's SM count. Launches its three kernels on `stream`; the
// count of rows with g != 0 stays in device memory. Returns the first CUDA
// error (0 on success).
extern "C" int sampled_softmax_shared_bwd_f32(const float* user, const float* pos,
                                              const float* neg, const float* logz,
                                              const float* pos_logit, const float* g,
                                              float* du, float* dpos, float* dneg,
                                              float* scratch, int M, int D, int K, float inv_tau,
                                              int splits, int sms, void* stream) {
  if (bad_shape(M, D, K) || splits < 1 || splits > 65535 || sms < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int neg_tiles = (K + kNegs - 1) / kNegs;
  float* du_part = scratch;
  float* dneg_part = du_part + (int64_t)neg_tiles * M * D;
  int* live = reinterpret_cast<int*>(dneg_part + (int64_t)splits * K * D);
  int* n_live = live + M;
  cand_live_kernel<<<1, kListThreads, 0, st>>>(g, live, n_live, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (M > 0) {
    const bool vec = D % 4 == 0 && ((uintptr_t)user | (uintptr_t)neg) % 16 == 0;
    const dim3 grid((unsigned)neg_tiles, (unsigned)splits);
    auto go = [&](auto launch) {
      return launch(grid, st, user, neg, logz, g, live, n_live, du, dpos, du_part, dneg_part, M,
                    D, K, inv_tau, vec);
    };
    err = D <= 32 ? go(launch_tiles<32>) : D <= 64 ? go(launch_tiles<64>) : go(launch_tiles<128>);
    if (err != cudaSuccess) return (int)err;
  }
  shared_bwd_finish_kernel<<<finish_grid(M, K, D, sms), kFinishThreads, 0, st>>>(
      user, pos, logz, pos_logit, g, live, n_live, du_part, dneg_part, du, dpos, dneg, M, D, K,
      neg_tiles, splits, inv_tau);
  return (int)cudaGetLastError();
}
