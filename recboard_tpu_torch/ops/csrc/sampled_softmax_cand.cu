// Per-position sampled softmax for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel _fwd_kernel of recboard_tpu/ops/losses.py (:170,
// called by sampled_softmax_loss_pallas at :186), and adds the backward that
// the JAX package gets by autodiff of its chunked scan (sampled_softmax_loss,
// :133). Row m of the encodings u (M, D) has its own C candidate ids
// ids (M, C) into the table e (N, D), the positive in column 0:
//   logit[m, c] = u[m] . e[ids[m, c]] / tau;
//   forward, for row weights w (M,): logz[m] = logsumexp over c of
//             logit[m, c] and pos_logit[m] = logit[m, 0] where w[m] != 0,
//             both 0 where w[m] = 0;
//   backward, for row gradients s (M,) of logz - pos_logit, with
//   coef[m, c] = s[m] (exp(logit[m, c] - logz[m]) - [c = 0]):
//             du[m]     = sum over c of coef[m, c] e[ids[m, c]] / tau,
//             dtable[n] = sum over (m, c) with ids[m, c] = n of coef[m, c] u[m] / tau.
// Ids are taken as JAX's gather takes them: a negative id counts from the
// end of the table, and the result is clamped into [0, N). No kernel reads
// outside the table. An id outside [-N, N) still enters the logits and du,
// but adds nothing to dtable: JAX's gradient, a scatter, drops it.
//
// What bounds it on an H100: at HSTU's training shape (M = 256 x 50 = 12,800
// rows, C = 513, D = 64, N = 12,101) 87.9 % of rows are pads of weight 0,
// and a pad row's logz only ever meets a 0 (its loss term is multiplied by
// its weight, its row gradient is 0). The forward takes the weights, as the
// TPU kernel does, and computes the 1,553 weighted rows only: 0.10 GFLOP
// (1.5 us at the 67 TFLOP/s float32 rate) against 6.8 MB of inputs and
// outputs (2.0 us at 3.35 TB/s). But the candidate rows it gathers are
// 1,553 * C * D * 4 = 0.204 GB: the 3.1 MB table stays in L2, and that
// gather's L2 traffic and latency are what a kernel of this shape waits
// on. Both passes load a candidate's table row the same way: a group of
// G lanes (G the power of two that covers D in float4s), each lane a
// float4 of the row, so a group's loads are one contiguous row. A logit is
// the sum of the G lanes' float4 dots in the order of group_sum's
// shuffles, times 1 / tau rounded on its own (cand_logit): the forward
// forms the same sum in one lane, so the backward's exp(logit - logz) is
// taken on the logits that made logz. The design:
//   * the forward, in two kernels:
//     1. cand_live_kernel (one block, live_rows.cuh, shared with K5's
//        backward) lists the rows with w != 0 in order, and their count,
//        in device memory: the host never waits on it;
//     2. cand_fwd_kernel: a block of kFwdWarps warps per listed row, its
//        C candidates cut into tiles of 32 and the tiles dealt to the
//        warps (a slice each). A warp stages a tile's 32 table rows
//        through shared memory with cp.async (16 bytes a lane), into a
//        ring of two tiles, so 32 rows are in flight while it takes the
//        dots of the 32 before; then each lane takes one candidate of the
//        tile, its whole dot and an online (max, sum) on its own, with no
//        shuffle and no exp repeated across lanes. The lanes are merged by
//        shuffles and the slices in warp order. It writes logz and
//        pos_logit, never the (M, C) logits, and exactly 0 in both on rows
//        of weight 0;
//   * the backward recomputes the logits, in four kernels and no library
//     call, over the rows with s != 0 (797 K (m, c) entries at the
//     training shape):
//     1. cand_live_kernel lists them;
//     2. cand_rows_kernel: a block of 8 warps per listed row, each warp a
//        slice of its C candidates, so enough table rows are in flight;
//        du is merged across the slices in warp order through shared
//        memory, and each live entry's coef and clamped id go to compact
//        arrays at (list position) * C + c, which is flat (m, c) order.
//        Rows with s = 0 get du exactly 0;
//     3. cand_chunk_kernel: the TPU grid would add dtable across its
//        sequential steps; Hopper blocks run in no order. So the compact
//        entries are cut into chunks of kChunk, and a block sorts its
//        chunk by id with CUB's block radix sort (stable, so the entries
//        of one id keep their flat order) and writes the sorted entry
//        indices and, for every table row, the (start, count) of its run
//        in the chunk (0 where the id is absent);
//     4. cand_segment_kernel: the entries of table row n are its runs in
//        chunk order, which is flat order: the order a stable sort of all
//        ids gives. S warps walk them (S from the mean entries per table
//        row, so a heavy row is split), each over a range of chunks, and
//        the S partial sums are added in warp order.
//     No float atomics and no order taken from atomics: reruns give the
//     same bits.
// The products are scalar FMAs.

#include <climits>

#include <cub/block/block_radix_sort.cuh>

#include "live_rows.cuh"  // cand_live_kernel, kListThreads
#include "mma_tf32.cuh"    // cp_async, cp_async_commit, cp_async_wait
#include "tiles.cuh"      // kThreads, kMaxD, kFull, lse_merge

namespace {

constexpr int kWarps = kThreads / 32;  // backward: a block's warps (row kernel: a slice each)
constexpr int kFwdWarps = 4;           // forward: a row block, one slice of the row per warp
constexpr int kFwdStages = 2;          // forward: tiles of 32 table rows a warp stages
constexpr int kSortThreads = 512;      // cand_chunk_kernel: a chunk of
constexpr int kSortItems = 16;         //   512 x 16 entries a block
constexpr int kChunk = kSortThreads * kSortItems;
// compact entries are indexed in int32: M * C at most this
constexpr int64_t kMaxEntries = 2147483647LL - kChunk;
constexpr int kUnroll = 4;             // backward: steps whose table rows load together
constexpr int kRunBatches = 4;         // segment kernel: runs of 4 x 32 chunks a warp holds

// JAX's gather: a negative id counts from the end, then clamp into [0, N)
__device__ __forceinline__ int clamp_id(int id, int N) {
  if (id < 0) id += N;
  return id < 0 ? 0 : (id >= N ? N - 1 : id);
}

// the float4 of a row that starts at element 4 q; zeros past D. Rows are
// 16-byte aligned and D % 4 == 0 (the wrapper checks both)
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int q, int D) {
  return 4 * q < D ? __ldg(reinterpret_cast<const float4*>(row) + q)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

// the dot summed over the G lanes of each group
__device__ __forceinline__ float group_sum(float x, int G) {
  for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// a candidate's logit from this lane's float4s of u and of its table row,
// the same in every lane of the group. Rounded on its own (no FMA with
// what follows), so that forward and backward take the same value
__device__ __forceinline__ float cand_logit(float4 uv, float4 e, int G, float inv_tau) {
  return __fmul_rn(group_sum(dot4(uv, e), G), inv_tau);
}

// x[0] + ... + x[n - 1] added as group_sum adds the n lanes' values (lane
// j takes lane j + n / 2's, then j + n / 4's, ...), which gives every lane
// the same bits; x is overwritten
template <int n>
__device__ __forceinline__ float shuffle_order_sum(float* x) {
  if constexpr (n == 1) {
    return x[0];
  } else {
#pragma unroll
    for (int j = 0; j < n / 2; ++j) x[j] += x[j + n / 2];
    return shuffle_order_sum<n / 2>(x);
  }
}

// Walks the C candidates of row `m` group by group: for every candidate c of
// this lane's group, in increasing order, calls visit(c, id, in_table, e,
// logit) with its clamped id, whether its raw id lay in [-N, N), this lane's
// float4 e of the table row, and the logit. Every lane of the warp runs the
// same steps (the shuffles need them all).
template <typename Visit>
__device__ __forceinline__ void for_candidates(const float4 uv, const int* __restrict__ row_ids,
                                               const float* __restrict__ table, int C, int D,
                                               int N, float inv_tau, int G, Visit visit) {
  const int lane = threadIdx.x % 32;
  const int g = lane / G, q = lane % G, P = 32 / G;
  for (int c0 = 0; c0 < C; c0 += 32) {
    // the clamped id, with bit 31 set when the raw id lay outside [-N, N)
    int own = 0;
    if (c0 + lane < C) {
      const int raw = row_ids[c0 + lane];
      own = clamp_id(raw, N) | (raw >= -N && raw < N ? 0 : INT_MIN);
    }
    for (int k0 = 0; k0 < 32 && c0 + k0 < C; k0 += kUnroll * P) {
      float4 e[kUnroll];
      int id[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int k = k0 + j * P + g;
        id[j] = __shfl_sync(kFull, own, k & 31);
        e[j] = load4(table + (int64_t)(id[j] & INT_MAX) * D, q, D);
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int k = k0 + j * P + g;
        const float x = cand_logit(uv, e[j], G, inv_tau);
        if (k < 32 && c0 + k < C) visit(c0 + k, id[j] & INT_MAX, id[j] >= 0, e[j], x);
      }
    }
  }
}

// Forward, 2: the blocks write logz = pos_logit = 0 on the rows with
// w = 0, and block b takes the listed rows b, b + gridDim.x, ...: the C
// candidates of row m = live[b] are cut into tiles of 32, and warp v takes
// tiles v, v + kFwdWarps, ... (its slice). A tile's table rows are copied
// by cp.async into a ring of kFwdStages tiles in shared memory, 16 bytes a
// lane, one row per group of G lanes (float4 q of row r at r G + (q ^
// (r mod min(G, 8))), so that lanes reading whole rows share no bank), while
// the warp takes the dots of the tile before; the next tile's ids are read
// as a tile is issued. Lane l then takes candidate l of the tile: its dot
// with u (in registers) summed over the G float4s in the order of
// group_sum's shuffles, so the logit has cand_logit's bits, and an online
// (max, sum). The lanes are merged by shuffles, the warps in warp order.
template <int G>
__global__ void __launch_bounds__(kFwdWarps * 32, G < 32 ? 3 : 1)
cand_fwd_kernel(const float* __restrict__ user, const int* __restrict__ ids,
                const float* __restrict__ table, const float* __restrict__ w,
                const int* __restrict__ live, const int* __restrict__ n_live,
                float* __restrict__ logz, float* __restrict__ pos_logit, int M, int C, int D,
                int N, float inv_tau) {
  constexpr int P = 32 / G, SW = (G < 8 ? G : 8) - 1;
  for (int64_t i = (int64_t)blockIdx.x * kFwdWarps * 32 + threadIdx.x; i < M;
       i += (int64_t)gridDim.x * kFwdWarps * 32)
    if (w[i] == 0.f) logz[i] = pos_logit[i] = 0.f;  // the rows cand_live_kernel left out
  const int rows = *n_live;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / G, q = lane % G;
  extern __shared__ float4 staged[];
  float4* ring = staged + warp * kFwdStages * 32 * G;
  __shared__ float part_m[kFwdWarps], part_s[kFwdWarps];
  const int tiles = (C + 31) / 32;
  const int own_tiles = warp < tiles ? (tiles - warp + kFwdWarps - 1) / kFwdWarps : 0;
  for (int64_t b = blockIdx.x; b < rows; b += gridDim.x) {
    const int64_t m = live[b];
    const int* __restrict__ row_ids = ids + m * C;
    float4 uv[G];
#pragma unroll
    for (int j = 0; j < G; ++j) uv[j] = load4(user + m * D, j, D);
    auto tile_ids = [&](int i) {  // lane l: the clamped id of candidate l of tile i
      const int c = 32 * (warp + i * kFwdWarps) + lane;
      return i < own_tiles && c < C ? clamp_id(row_ids[c], N) : 0;
    };
    int next = tile_ids(0);
    auto issue = [&](int i) {  // the table rows of this warp's tile i into its slot
      if (i >= own_tiles) return;  // the whole warp
      const int own = next;
      next = tile_ids(i + 1);
      const int c0 = 32 * (warp + i * kFwdWarps);
      float4* slot = ring + (i % kFwdStages) * 32 * G;
#pragma unroll
      for (int r0 = 0; r0 < 32; r0 += P) {
        const int r = r0 + g, id = __shfl_sync(kFull, own, r);
        const bool ok = c0 + r < C && 4 * q < D;
        cp_async<16>(slot + r * G + (q ^ (r & SW)),
                     ok ? table + (int64_t)id * D + 4 * q : table, ok);
      }
    };
    float mx = -INFINITY, sum = 0.f, pl = 0.f;
#pragma unroll
    for (int i = 0; i < kFwdStages - 1; ++i) {
      issue(i);
      cp_async_commit();
    }
    for (int i = 0; i < own_tiles; ++i) {
      __syncwarp();  // every lane has read the slot that is filled next
      issue(i + kFwdStages - 1);
      cp_async_commit();
      cp_async_wait<kFwdStages - 1>();
      __syncwarp();  // tile i has landed, from every lane's copies
      const float4* row = ring + (i % kFwdStages) * 32 * G + lane * G;
      float x[G];
#pragma unroll
      for (int j = 0; j < G; ++j) x[j] = dot4(uv[j], row[j ^ (lane & SW)]);
      const float x0 = __fmul_rn(shuffle_order_sum<G>(x), inv_tau);  // cand_logit
      const int c = 32 * (warp + i * kFwdWarps) + lane;
      if (c == 0) pl = x0;
      if (c < C) {
        if (x0 > mx) {
          sum = sum * expf(mx - x0) + 1.f;  // exp(-inf) = 0 on the first
          mx = x0;
        } else {
          sum += expf(x0 - mx);
        }
      }
    }
    for (int o = 1; o < 32; o <<= 1) {  // merge the lanes
      const float m2 = __shfl_xor_sync(kFull, mx, o);
      const float s2 = __shfl_xor_sync(kFull, sum, o);
      lse_merge(mx, sum, m2, s2);
    }
    if (lane == 0) {
      part_m[warp] = mx;
      part_s[warp] = sum;
    }
    __syncthreads();
    if (threadIdx.x == 0) {  // merge the slices in warp order; column 0 was warp 0's
      for (int v = 1; v < kFwdWarps; ++v) lse_merge(mx, sum, part_m[v], part_s[v]);
      logz[m] = mx + logf(sum);
      pos_logit[m] = pl;
    }
    __syncthreads();  // part_m and part_s are taken again by the next row
  }
}

// Backward, 2: the blocks zero du of the rows with s = 0, and block b
// takes the listed rows b, b + gridDim.x, ...: for m = live[b], du[m] and
// the coef (0 for an id outside [-N, N)) and clamped id of its C entries
// at b * C + c. Warp w walks candidates [w * slice, (w + 1) * slice); the
// warps' du are added in warp order.
__global__ void __launch_bounds__(kThreads)
cand_rows_kernel(const float* __restrict__ user, const int* __restrict__ ids,
                 const float* __restrict__ table, const float* __restrict__ logz,
                 const float* __restrict__ grad, const int* __restrict__ live,
                 const int* __restrict__ n_live, float* __restrict__ du,
                 float* __restrict__ coef, int* __restrict__ keys, int M, int C, int D, int N,
                 float inv_tau, int G) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < (int64_t)M * D;
       i += (int64_t)gridDim.x * kThreads)
    if (grad[i / D] == 0.f) du[i] = 0.f;  // nothing flows back from this row
  const int rows = *n_live;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, q = lane % G;
  const int slice = (C + kWarps - 1) / kWarps;
  const int c_lo = min(C, warp * slice), n_c = min(C, c_lo + slice) - c_lo;
  __shared__ float4 part[kWarps][kMaxD / 4];
  for (int64_t b = blockIdx.x; b < rows; b += gridDim.x) {
    const int64_t m = live[b];
    const float s = grad[m], z = logz[m];
    float* __restrict__ coef_row = coef + b * C + c_lo;
    int* __restrict__ key_row = keys + b * C + c_lo;
    const float4 uv = load4(user + m * D, q, D);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n_c > 0)
      for_candidates(
          uv, ids + m * C + c_lo, table, n_c, D, N, inv_tau, G,
          [&](int c, int id, bool in_table, float4 e, float x) {
            const float cf = s * (expf(x - z) - (c_lo + c == 0 ? 1.f : 0.f));
            acc.x = fmaf(cf, e.x, acc.x);
            acc.y = fmaf(cf, e.y, acc.y);
            acc.z = fmaf(cf, e.z, acc.z);
            acc.w = fmaf(cf, e.w, acc.w);
            if (q == 0) {  // an id outside [-N, N) adds nothing to dtable, as in JAX
              coef_row[c] = in_table ? cf : 0.f;
              key_row[c] = id;
            }
          });
    for (int o = G; o < 32; o <<= 1) {
      acc.x += __shfl_xor_sync(kFull, acc.x, o);
      acc.y += __shfl_xor_sync(kFull, acc.y, o);
      acc.z += __shfl_xor_sync(kFull, acc.z, o);
      acc.w += __shfl_xor_sync(kFull, acc.w, o);
    }
    if (lane < G) part[warp][lane] = acc;
    __syncthreads();
    const float* parts = reinterpret_cast<const float*>(part);
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += parts[w * kMaxD + d];
      du[m * D + d] = t * inv_tau;
    }
    __syncthreads();  // part is taken again by the next row
  }
}

// the first position in [lo, hi) of the ascending `sorted` whose key is > key
__device__ __forceinline__ int upper_bound(const unsigned* sorted, int lo, int hi,
                                           unsigned key) {
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (sorted[mid] <= key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Backward, 3: block k sorts the compact entries [k * kChunk, ...) by id,
// stably, and writes order[k * kChunk + i], the compact index of its i-th
// entry in that order, and runs[k * N + n] = start | count << 16 of id n's
// run in it (0 where n is absent). Ids lie in [0, N); the pad key N of a
// short last chunk sorts after them and is never written.
__global__ void __launch_bounds__(kSortThreads)
cand_chunk_kernel(const unsigned* __restrict__ keys, const int* __restrict__ n_live,
                  int* __restrict__ order, unsigned* __restrict__ runs, int C, int N,
                  int end_bit) {
  using Sort = cub::BlockRadixSort<unsigned, kSortThreads, kSortItems, int>;
  __shared__ union {
    typename Sort::TempStorage sort;
    unsigned sorted[kChunk];
  } smem;
  const int64_t entries = (int64_t)*n_live * C, base = (int64_t)blockIdx.x * kChunk;
  if (base >= entries) return;  // the whole block
  const int len = (int)min((int64_t)kChunk, entries - base);
  unsigned* __restrict__ col = runs + (int64_t)blockIdx.x * N;
  for (int n = threadIdx.x; n < N; n += kSortThreads) col[n] = 0u;
  unsigned key[kSortItems];
  int idx[kSortItems];
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {  // blocked: thread t holds 16 t + j
    idx[j] = threadIdx.x * kSortItems + j;
    key[j] = idx[j] < len ? keys[base + idx[j]] : (unsigned)N;
  }
  Sort(smem.sort).SortBlockedToStriped(key, idx, 0, end_bit);
  __syncthreads();  // the sort's storage becomes the sorted keys
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {  // striped: thread t holds 512 j + t
    const int i = j * kSortThreads + threadIdx.x;
    smem.sorted[i] = key[j];
    if (i < len) order[base + i] = (int)(base + idx[j]);
  }
  __syncthreads();  // also orders the zeroes of col before the runs
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const int i = j * kSortThreads + threadIdx.x;
    if (i < len && (i == 0 || smem.sorted[i - 1] != key[j])) {
      const int end = upper_bound(smem.sorted, i + 1, len, key[j]);
      col[key[j]] = (unsigned)i | (unsigned)(end - i) << 16;
    }
  }
}

// Backward, 4: dtable[n] = the sum of coef u[row] / tau over table row n's
// entries. A block takes kWarps / S table rows with S warps each; warp
// `sub` of a row walks chunks [chunks * sub / S, chunks * (sub + 1) / S),
// 128 at a time: each lane reads the runs of four chunks, warp scans
// place the runs' entries in slots, and 32 slots at a time are gathered
// (their user rows by groups of G lanes, kUnroll steps loaded ahead). The
// S partials are added in warp order.
__global__ void __launch_bounds__(kThreads)
cand_segment_kernel(const float* __restrict__ user, const float* __restrict__ coef,
                    const int* __restrict__ live, const int* __restrict__ order,
                    const unsigned* __restrict__ runs, const int* __restrict__ n_live,
                    float* __restrict__ dtable, int C, int D, int N, float inv_tau, int G) {
  const int64_t entries = (int64_t)*n_live * C;
  const int chunks = (int)((entries + kChunk - 1) / kChunk);
  // warps per table row: one per 256 entries of a mean row, at most kWarps
  const int64_t mean = entries / N;
  const int S = mean < 512 ? 1 : mean < 1024 ? 2 : mean < 2048 ? 4 : kWarps;
  const int per_block = kWarps / S;
  const int64_t n0 = (int64_t)blockIdx.x * per_block;
  if (n0 >= N) return;  // the whole block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / G, q = lane % G, P = 32 / G, sub = warp % S;
  const int64_t n = n0 + warp / S;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int k_lo = (int)((int64_t)chunks * sub / S);
  const int k_hi = n < N ? (int)((int64_t)chunks * (sub + 1) / S) : k_lo;
  for (int kb = k_lo; kb < k_hi; kb += 32 * kRunBatches) {
    // lane l of batch r holds chunk kb + 32 r + l's run: its start in the
    // chunk and its slots [first, last) in this pass
    unsigned run[kRunBatches];
#pragma unroll
    for (int r = 0; r < kRunBatches; ++r) {
      const int k = kb + 32 * r + lane;
      run[r] = k < k_hi ? runs[(int64_t)k * N + n] : 0u;
    }
    int start[kRunBatches], first[kRunBatches], last[kRunBatches], total = 0;
#pragma unroll
    for (int r = 0; r < kRunBatches; ++r) {
      const int count = run[r] >> 16;
      int incl = count;  // inclusive scan of the counts over lanes
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      start[r] = run[r] & 0xffffu;
      last[r] = total + incl;
      first[r] = last[r] - count;
      total = __shfl_sync(kFull, last[r], 31);
    }
    for (int j0 = 0; j0 < total; j0 += 32) {
      const int j = j0 + lane;
      int64_t at = -1;  // slot j's place in order
#pragma unroll
      for (int r = 0; r < kRunBatches; ++r) {
        int src = 0;  // the lanes of batch r whose runs end at or before slot j
        for (int step = 16; step > 0; step >>= 1)
          if (__shfl_sync(kFull, last[r], src + step - 1) <= j) src += step;
        const int f = __shfl_sync(kFull, first[r], src & 31);
        const int l = __shfl_sync(kFull, last[r], src & 31);
        const int st = __shfl_sync(kFull, start[r], src & 31);
        if (f <= j && j < l) at = (int64_t)(kb + 32 * r + src) * kChunk + st + (j - f);
      }
      int row = 0;
      float cf = 0.f;
      if (at >= 0) {
        const int e = order[at];
        cf = coef[e];
        row = live[e / C];
      }
      const int here = min(32, total - j0);
      for (int t0 = 0; t0 < here; t0 += kUnroll * P) {
        float4 e4[kUnroll];
        float c4[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = t0 + u * P + g;
          const int r = __shfl_sync(kFull, row, t & 31);
          c4[u] = __shfl_sync(kFull, cf, t & 31);
          e4[u] = t < here ? load4(user + (int64_t)r * D, q, D)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t0 + u * P + g >= here) continue;
          acc.x = fmaf(c4[u], e4[u].x, acc.x);
          acc.y = fmaf(c4[u], e4[u].y, acc.y);
          acc.z = fmaf(c4[u], e4[u].z, acc.z);
          acc.w = fmaf(c4[u], e4[u].w, acc.w);
        }
      }
    }
  }
  for (int o = G; o < 32; o <<= 1) {
    acc.x += __shfl_xor_sync(kFull, acc.x, o);
    acc.y += __shfl_xor_sync(kFull, acc.y, o);
    acc.z += __shfl_xor_sync(kFull, acc.z, o);
    acc.w += __shfl_xor_sync(kFull, acc.w, o);
  }
  __shared__ float4 part[kWarps][kMaxD / 4];
  if (lane < G) part[warp][lane] = acc;
  __syncthreads();
  const float* parts = reinterpret_cast<const float*>(part);
  for (int i = threadIdx.x; i < per_block * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    if (n0 + r >= N) break;
    float t = 0.f;
    for (int w = r * S; w < (r + 1) * S; ++w) t += parts[w * kMaxD + d];
    dtable[(n0 + r) * D + d] = t * inv_tau;
  }
}

// lanes per candidate: the power of two that covers D in float4s
int group_lanes(int D) {
  int G = 1;
  while (4 * G < D) G *= 2;
  return G;
}

// the rows are read as float4s
bool bad_shape(int M, int C, int D, int N) {
  return M < 0 || C < 1 || D < 4 || D > kMaxD || D % 4 != 0 || N < 1;
}

// the grid of a row kernel, whose count of listed rows stays on the card:
// a few waves of the SMs, enough for the listed rows at HSTU's pad share,
// and at most one block a row
unsigned row_grid(int M) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (unsigned)min((int64_t)M, (int64_t)16 * sms);
}

// the forward's row kernel for G lanes a candidate: its dynamic shared
// memory is kFwdWarps x kFwdStages tiles of 32 rows of G float4s
template <int G>
int launch_fwd(cudaStream_t st, const float* user, const int* ids, const float* table,
               const float* w, const int* live, const int* n_live, float* logz, float* pos_logit,
               int M, int C, int D, int N, float inv_tau) {
  const size_t smem = (size_t)kFwdWarps * kFwdStages * 32 * G * sizeof(float4);
  const cudaError_t err = allow_smem(cand_fwd_kernel<G>, smem);
  if (err != cudaSuccess) return (int)err;
  cand_fwd_kernel<G><<<row_grid(M), kFwdWarps * 32, smem, st>>>(
      user, ids, table, w, live, n_live, logz, pos_logit, M, C, D, N, inv_tau);
  return (int)cudaGetLastError();
}

}  // namespace

// user (M, D) and table (N, D) contiguous float32 with 16-byte aligned
// rows (D a multiple of 4, at most kMaxD), ids (M, C) contiguous int32,
// weights w (M,) float32. Writes logz and pos_logit (M,), through the
// scratch the caller allocates: live (M,) and n_live (1,) int32. Launches
// its two kernels on `stream`; the count of rows with w != 0 stays in
// device memory. Returns the first CUDA error (0 on success).
extern "C" int sampled_softmax_cand_fwd_f32(const float* user, const int* ids,
                                            const float* table, const float* w, float* logz,
                                            float* pos_logit, int* live, int* n_live, int M,
                                            int C, int D, int N, float inv_tau, void* stream) {
  if (bad_shape(M, C, D, N)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cand_live_kernel<<<1, kListThreads, 0, st>>>(w, live, n_live, M);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  auto go = [&](auto launch) {
    return launch(st, user, ids, table, w, live, n_live, logz, pos_logit, M, C, D, N, inv_tau);
  };
  switch (group_lanes(D)) {
    case 1: return go(launch_fwd<1>);
    case 2: return go(launch_fwd<2>);
    case 4: return go(launch_fwd<4>);
    case 8: return go(launch_fwd<8>);
    case 16: return go(launch_fwd<16>);
    default: return go(launch_fwd<32>);
  }
}

// The backward for row gradients g (M,) of logz - pos_logit: du (M, D)
// and dtable (N, D), through the scratch the caller allocates: live (M,)
// and n_live (1,) int32; coef (M * C) float32, keys and order (M * C)
// int32; runs (ceil(M * C / kChunk) * N) uint32. M * C must stay below
// 2^31. Launches its four kernels on `stream`; the count of rows with
// g != 0 stays in device memory.
extern "C" int sampled_softmax_cand_bwd_f32(const float* user, const int* ids, const float* table,
                                            const float* logz, const float* g, float* du,
                                            float* dtable, int* live, int* n_live, float* coef,
                                            int* keys, int* order, unsigned* runs, int M, int C,
                                            int D, int N, float inv_tau, void* stream) {
  if (bad_shape(M, C, D, N) || (int64_t)M * C > kMaxEntries)
    return (int)cudaErrorInvalidValue;
  const int G = group_lanes(D);
  const cudaStream_t st = (cudaStream_t)stream;
  int end_bit = 1;  // the bits of the pad key N
  while (end_bit < 31 && (N >> end_bit) != 0) ++end_bit;
  cand_live_kernel<<<1, kListThreads, 0, st>>>(g, live, n_live, M);
  if (M > 0) {
    cand_rows_kernel<<<row_grid(M), kThreads, 0, st>>>(user, ids, table, logz, g, live, n_live,
                                                       du, coef, keys, M, C, D, N, inv_tau, G);
    const int64_t chunks = ((int64_t)M * C + kChunk - 1) / kChunk;
    cand_chunk_kernel<<<(unsigned)chunks, kSortThreads, 0, st>>>(
        reinterpret_cast<const unsigned*>(keys), n_live, order, runs, C, N, end_bit);
  }
  cand_segment_kernel<<<N, kThreads, 0, st>>>(user, coef, live, order, runs, n_live, dtable, C,
                                              D, N, inv_tau, G);
  return (int)cudaGetLastError();
}
