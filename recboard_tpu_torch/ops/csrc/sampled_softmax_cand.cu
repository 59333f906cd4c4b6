// Per-position sampled softmax for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel _fwd_kernel of recboard_tpu/ops/losses.py (:170,
// called by sampled_softmax_loss_pallas at :186), and adds the backward that
// the JAX package gets by autodiff of its chunked scan (sampled_softmax_loss,
// :133). Row m of the encodings u (M, D) has its own C candidate ids
// ids (M, C) into the table e (N, D), the positive in column 0:
//   logit[m, c] = u[m] . e[ids[m, c]] / tau;
//   forward:  logz[m] = logsumexp over c of logit[m, c], pos_logit[m] =
//             logit[m, 0];
//   backward, for row gradients s (M,) of logz - pos_logit, with
//   coef[m, c] = s[m] (exp(logit[m, c] - logz[m]) - [c = 0]):
//             du[m]     = sum over c of coef[m, c] e[ids[m, c]] / tau,
//             dtable[n] = sum over (m, c) with ids[m, c] = n of coef[m, c] u[m] / tau.
// Ids are taken as JAX's gather takes them: a negative id counts from the
// end of the table, and the result is clamped into [0, N). No kernel reads
// outside the table.
//
// What bounds it on an H100: operations. At HSTU's training shape (M = 256 x
// 50 = 12,800 rows, C = 513, D = 64, N = 12,101) the forward is 2*M*C*D =
// 0.84 GFLOP, 12.5 us at the 67 TFLOP/s float32 rate, against 32.8 MB of
// inputs (9.8 us at 3.35 TB/s). But the rows it gathers are M*C*D*4 = 1.68
// GB per pass: the 3.1 MB table stays in L2, and the gather's L2 traffic is
// what a kernel of this shape waits on. The design:
//   * one warp per row. The warp splits into groups of G lanes (G the power
//     of two that covers D in float4s); a group takes one candidate, each of
//     its lanes a float4 of the row, so a group's loads are one contiguous
//     row and 32 / G candidates are in flight per step. The dot is reduced
//     inside the group with shuffles;
//   * the row's ids are read 32 at a time, one per lane, and handed to the
//     groups by shuffles; the table rows of a few steps are loaded before
//     their dots are taken;
//   * the forward keeps an online logsumexp per group and merges the groups
//     at the end; it writes logz and pos_logit, never the (M, C) logits;
//   * the backward recomputes the logits. A row kernel writes du, coef (M, C)
//     and each entry's id as a sort key (the sentinel N on rows with s = 0,
//     which it skips: du is exactly 0 there). The TPU grid would add
//     dtable across its sequential steps; Hopper blocks run in no order. So
//     the wrapper sorts the keys (stable, so entries of one id keep their
//     flat order), and a segment kernel sums each table row's entries in that
//     order, one warp per row. No atomics: reruns give the same bits.
// The products are scalar FMAs: a first kernel that is right and simple.

#include "tiles.cuh"  // kThreads, kMaxD, kFull, lse_merge

namespace {

constexpr int kWarps = kThreads / 32;  // one row (or table row) per warp
constexpr int kUnroll = 4;             // steps whose table rows load together

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

// Walks the C candidates of row `m` group by group: for every candidate c of
// this lane's group, in increasing order, calls visit(c, id, e, logit) with
// its clamped id, this lane's float4 e of the table row, and the logit.
// Every lane of the warp runs the same steps (the shuffles need them all).
template <typename Visit>
__device__ __forceinline__ void for_candidates(const float4 uv, const int* __restrict__ row_ids,
                                               const float* __restrict__ table, int C, int D,
                                               int N, float inv_tau, int G, Visit visit) {
  const int lane = threadIdx.x % 32;
  const int g = lane / G, q = lane % G, P = 32 / G;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int own = c0 + lane < C ? clamp_id(row_ids[c0 + lane], N) : 0;
    for (int k0 = 0; k0 < 32 && c0 + k0 < C; k0 += kUnroll * P) {
      float4 e[kUnroll];
      int id[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int k = k0 + j * P + g;
        id[j] = __shfl_sync(kFull, own, k & 31);
        e[j] = load4(table + (int64_t)id[j] * D, q, D);
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int k = k0 + j * P + g;
        const float x = group_sum(dot4(uv, e[j]), G) * inv_tau;
        if (k < 32 && c0 + k < C) visit(c0 + k, id[j], e[j], x);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
cand_fwd_kernel(const float* __restrict__ user, const int* __restrict__ ids,
                const float* __restrict__ table, float* __restrict__ logz,
                float* __restrict__ pos_logit, int M, int C, int D, int N, float inv_tau,
                int G) {
  const int64_t m = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (m >= M) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const float4 uv = load4(user + m * D, lane % G, D);
  float mx = -INFINITY, sum = 0.f, pl = 0.f;
  for_candidates(uv, ids + m * C, table, C, D, N, inv_tau, G,
                       [&](int c, int, float4, float x) {
                         if (c == 0) pl = x;
                         if (x > mx) {
                           sum = sum * expf(mx - x) + 1.f;  // exp(-inf) = 0 on the first
                           mx = x;
                         } else {
                           sum += expf(x - mx);
                         }
                       });
  // merge the groups; column 0 was group 0's first candidate
  for (int o = G; o < 32; o <<= 1) {
    const float m2 = __shfl_xor_sync(kFull, mx, o);
    const float s2 = __shfl_xor_sync(kFull, sum, o);
    lse_merge(mx, sum, m2, s2);
  }
  if (lane == 0) {
    logz[m] = mx + logf(sum);
    pos_logit[m] = pl;
  }
}

// Backward, rows: du (M, D), coef (M, C) and the sort keys (M, C).
__global__ void __launch_bounds__(kThreads)
cand_rows_kernel(const float* __restrict__ user, const int* __restrict__ ids,
                 const float* __restrict__ table, const float* __restrict__ logz,
                 const float* __restrict__ grad, float* __restrict__ du,
                 float* __restrict__ coef, int* __restrict__ keys, int M, int C, int D, int N,
                 float inv_tau, int G) {
  const int64_t m = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (m >= M) return;
  const int lane = threadIdx.x % 32;
  const float s = grad[m];
  if (s == 0.f) {  // nothing flows back from this row
    for (int d = lane; d < D; d += 32) du[m * D + d] = 0.f;
    for (int c = lane; c < C; c += 32) keys[m * C + c] = N;
    return;
  }
  const int q = lane % G;
  const float4 uv = load4(user + m * D, q, D);
  const float z = logz[m];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for_candidates(uv, ids + m * C, table, C, D, N, inv_tau, G,
                       [&](int c, int id, float4 e, float x) {
                         const float cf = s * (expf(x - z) - (c == 0 ? 1.f : 0.f));
                         acc.x = fmaf(cf, e.x, acc.x);
                         acc.y = fmaf(cf, e.y, acc.y);
                         acc.z = fmaf(cf, e.z, acc.z);
                         acc.w = fmaf(cf, e.w, acc.w);
                         if (q == 0) {
                           coef[m * C + c] = cf;
                           keys[m * C + c] = id;
                         }
                       });
  for (int o = G; o < 32; o <<= 1) {
    acc.x += __shfl_xor_sync(kFull, acc.x, o);
    acc.y += __shfl_xor_sync(kFull, acc.y, o);
    acc.z += __shfl_xor_sync(kFull, acc.z, o);
    acc.w += __shfl_xor_sync(kFull, acc.w, o);
  }
  if (lane < G) {
    const float out[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * q + j < D) du[m * D + 4 * q + j] = out[j] * inv_tau;
  }
}

// the first position of `sorted` (T keys, ascending) whose key is >= n
__device__ __forceinline__ int64_t lower_bound(const int* __restrict__ sorted, int64_t T, int n) {
  int64_t lo = 0, hi = T;
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (sorted[mid] < n) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Backward, table: dtable[n] from the entries with key n, in sorted order.
// `perm` holds each sorted entry's flat index m * C + c.
__global__ void __launch_bounds__(kThreads)
cand_dtable_kernel(const float* __restrict__ user, const float* __restrict__ coef,
                   const int* __restrict__ sorted, const int64_t* __restrict__ perm,
                   float* __restrict__ dtable, int C, int D, int N, int64_t T, float inv_tau) {
  const int n = blockIdx.x * kWarps + threadIdx.x / 32;
  if (n >= N) return;
  const int lane = threadIdx.x % 32;
  const int64_t bound = lane < 2 ? lower_bound(sorted, T, n + lane) : 0;
  const int64_t lo = __shfl_sync(kFull, bound, 0), hi = __shfl_sync(kFull, bound, 1);
  float acc[kMaxD / 32] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t j0 = lo; j0 < hi; j0 += 32) {
    const int64_t j = j0 + lane;
    const int64_t idx = j < hi ? perm[j] : 0;
    const int row = (int)(idx / C);
    const float cf = j < hi ? coef[idx] : 0.f;
    const int count = hi - j0 < 32 ? (int)(hi - j0) : 32;
    for (int t = 0; t < count; ++t) {
      const int64_t r = __shfl_sync(kFull, row, t);
      const float c = __shfl_sync(kFull, cf, t);
#pragma unroll
      for (int k = 0; k < kMaxD / 32; ++k) {
        const int d = lane + 32 * k;
        if (d < D) acc[k] = fmaf(c, user[r * D + d], acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxD / 32; ++k) {
    const int d = lane + 32 * k;
    if (d < D) dtable[(int64_t)n * D + d] = acc[k] * inv_tau;
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

unsigned row_blocks(int64_t rows) { return (unsigned)((rows + kWarps - 1) / kWarps); }

}  // namespace

// user (M, D) and table (N, D) contiguous float32 with 16-byte aligned
// rows (D a multiple of 4, at most kMaxD), ids (M, C) contiguous int32.
// Writes logz and pos_logit (M,). Launches on `stream`; returns the
// first CUDA error (0 on success).
extern "C" int sampled_softmax_cand_fwd_f32(const float* user, const int* ids,
                                            const float* table, float* logz, float* pos_logit,
                                            int M, int C, int D, int N, float inv_tau,
                                            void* stream) {
  if (bad_shape(M, C, D, N)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const int G = group_lanes(D);
  const cudaStream_t st = (cudaStream_t)stream;
  cand_fwd_kernel<<<row_blocks(M), kThreads, 0, st>>>(user, ids, table, logz, pos_logit, M, C,
                                                      D, N, inv_tau, G);
  return (int)cudaGetLastError();
}

// The backward's row kernel for row gradients g (M,) of logz - pos_logit:
// du (M, D), and coef and keys (M, C): each entry's coefficient and its
// clamped id, or the key N on rows with g = 0 (whose coef is left unwritten).
extern "C" int sampled_softmax_cand_rows_f32(const float* user, const int* ids,
                                             const float* table, const float* logz,
                                             const float* g, float* du, float* coef, int* keys,
                                             int M, int C, int D, int N, float inv_tau,
                                             void* stream) {
  if (bad_shape(M, C, D, N)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const int G = group_lanes(D);
  const cudaStream_t st = (cudaStream_t)stream;
  cand_rows_kernel<<<row_blocks(M), kThreads, 0, st>>>(user, ids, table, logz, g, du, coef,
                                                       keys, M, C, D, N, inv_tau, G);
  return (int)cudaGetLastError();
}

// The backward's table kernel: dtable (N, D) from coef (M, C), the keys
// sorted ascending (sorted, M * C) and each sorted entry's flat index
// (perm). Keys equal to N are never read.
extern "C" int sampled_softmax_cand_dtable_f32(const float* user, const float* coef,
                                               const int* sorted, const int64_t* perm,
                                               float* dtable, int M, int C, int D, int N,
                                               float inv_tau, void* stream) {
  if (bad_shape(M, C, D, N)) return (int)cudaErrorInvalidValue;
  cand_dtable_kernel<<<row_blocks(N), kThreads, 0, (cudaStream_t)stream>>>(
      user, coef, sorted, perm, dtable, C, D, N, (int64_t)M * C, inv_tau);
  return (int)cudaGetLastError();
}
