// Backward of HSTU's stacked relative time and position bias for Hopper
// (sm_90a), float32.
//
// Replaces the TPU kernel _bwd_kernel of recboard_tpu/ops/rel_bias.py (:69,
// called through stacked_rel_bias(kernel_bwd=True) at :176). The forward is
//   bias[nb, b, m, n] = pos_w[nb, n - m + L - 1] + ts_w[nb, bucket[b, m, n]],
// so from the cotangent g (NB, B, L, L) the weights' gradients are two
// histograms of g per bias block nb:
//   dts[nb, k]  = sum of g[nb, b, m, n] over the entries with bucket k,
//   dpos[nb, r] = sum of g[nb, b, m, n] over the entries with n - m + L - 1 = r.
//
// What bounds it on an H100: bytes. At HSTU's training shape (NB = 4, B =
// 256, L = 50) it reads a 10.24 MB cotangent and 2.56 MB of int32 buckets,
// 3.8 us at 3.35 TB/s, for one add per entry and histogram. The TPU kernel
// turned the histograms into (NB, X) @ (X, K) products on its matrix unit;
// here a block reads each bucket id once for a group of up to 4 bias
// blocks, and neither histogram needs a shuffle or an atomic:
//   * a block owns a chunk of the (m, n) positions of the L x L tile (one
//     slot of VEC consecutive positions a thread, read by VEC-wide loads)
//     over a run of batch rows b; it loads kRowsAhead rows at once (the
//     first before it clears its histogram, the next while it bins the
//     last), adds their entries into a histogram of its own in shared
//     memory (bins x threads, a column a thread: no two lanes write one
//     word or share a bank) and sums its positions' values over the rows
//     in registers;
//   * dpos needs no binning: an entry's diagonal depends on its (m, n)
//     alone, so the block folds its per-position sums along the diagonals
//     n - m, m ascending into two sums by the parity of m;
//   * the block adds its threads' histograms, a thread a bin, each
//     starting at the column of its bin mod 32, so that a warp's 32 reads
//     hit 32 banks, and writes its dts and dpos bins as one partial; about
//     one block an SM in all;
//   * rel_bias_sum_kernel adds the blocks' partials, a warp an output, in
//     block order and a fixed shuffle tree; dts is zero from column K on.
//     It is a programmatic dependent launch: its blocks are scheduled
//     once every binning block has binned its rows, and wait
//     (griddepcontrol.wait) until that pass has ended and its partials
//     are visible.
// The order of every addition is fixed, so reruns give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxGroup = 4;  // bias blocks a block bins at once
constexpr int kRowsAhead = 3;  // batch rows a thread has in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // what a block may ask for on sm_90

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&out)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
    out[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void load(const int* p, int (&out)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
    out[0] = *p;
  }
}

// the ids and the group's cotangent values of rows b .. b + kRowsAhead - 1
// (those below b1) at one slot; ids and g point at row b
template <int VEC>
struct Rows {
  int id[kRowsAhead][VEC];
  float v[kRowsAhead][kMaxGroup][VEC];

  __device__ __forceinline__ void load(const int* ids, const float* g, size_t X, int LL, int ng,
                                       int b, int b1) {
#pragma unroll
    for (int a = 0; a < kRowsAhead; ++a)
      if (b + a < b1) {
        ::load<VEC>(ids + a * LL, id[a]);
#pragma unroll
        for (int j = 0; j < kMaxGroup; ++j)
          if (j < ng) ::load<VEC>(g + a * LL + j * X, v[a][j]);
      }
  }
};

// lane 0 gets the sum of every lane's `s`, in a fixed tree
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(kFull, s, off);
  return s;
}

// Block (chunk c of the tile's slots, run r of batch rows; group z of
// bias blocks), blockIdx.x = r * chunks + c. Its partial goes to
// part[nb][bin][blockIdx.x] for the group's nb, the K bucket bins first,
// then the 2L - 1 diagonals.
template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rel_bias_hist_kernel(const float* __restrict__ g, const int* __restrict__ bucket,
                     float* __restrict__ part, int NB, int B, int L, int K, int group,
                     int chunk, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x, t = threadIdx.x;
  const int LL = L * L, R = 2 * L - 1, bins = K + R;
  const int chunks = (LL / VEC + chunk - 1) / chunk;
  const int p = blockIdx.x, P = gridDim.x;
  const int c = p % chunks, r = p / chunks;
  const int nb0 = blockIdx.y * group, ng = min(group, NB - nb0);
  const int s0 = c * chunk, s1 = min(LL / VEC, s0 + chunk);
  const int b0 = r * rows, b1 = min(B, b0 + rows);
  float* hist = smem;                        // [group * K][T]: a column a thread
  float* colsum = smem + (size_t)group * K * T;  // [group][chunk * VEC]

  const int s = s0 + t;
  const bool live = s < s1;
  const size_t X = (size_t)B * LL;
  const int* ids = bucket + (size_t)b0 * LL + (size_t)s * VEC;
  const float* gs = g + nb0 * X + (size_t)b0 * LL + (size_t)s * VEC;
  Rows<VEC> cur;
  if (live) cur.load(ids, gs, X, LL, ng, b0, b1);
  for (int i = t; i < ng * K * T / 4; i += T)
    reinterpret_cast<float4*>(hist)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  float acc[kMaxGroup][VEC];
#pragma unroll
  for (int j = 0; j < kMaxGroup; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;
  if (live) {
    float* own = hist + t;
    for (int b = b0; b < b1; b += kRowsAhead) {
      ids += kRowsAhead * LL, gs += kRowsAhead * LL;
      Rows<VEC> next;
      if (b + kRowsAhead < b1) next.load(ids, gs, X, LL, ng, b + kRowsAhead, b1);
#pragma unroll
      for (int a = 0; a < kRowsAhead; ++a)
        if (b + a < b1)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
#pragma unroll
            for (int j = 0; j < kMaxGroup; ++j)
              if (j < ng) acc[j][e] += cur.v[a][j][e];
            // the wrapper's ids lie in [0, K); others take no bucket bin.
            // The group's words are read before any is written: one wait
            const int k = cur.id[a][e];
            if ((unsigned)k < (unsigned)K) {
              float h[kMaxGroup];
#pragma unroll
              for (int j = 0; j < kMaxGroup; ++j)
                if (j < ng) h[j] = own[(j * K + k) * T];
#pragma unroll
              for (int j = 0; j < kMaxGroup; ++j)
                if (j < ng) own[(j * K + k) * T] = h[j] + cur.v[a][j][e];
            }
          }
      cur = next;
    }
#pragma unroll
    for (int j = 0; j < kMaxGroup; ++j)
      if (j < ng)
#pragma unroll
        for (int e = 0; e < VEC; ++e) colsum[j * chunk * VEC + t * VEC + e] = acc[j][e];
  }
  __syncthreads();
  // the finishing kernel may be scheduled now, its launch overlapping the
  // sums below; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;");

  // bucket bins: thread t the bins t, t + T, ...; bin i's columns from
  // i mod 32 on, wrapping at T, into four sums by their place mod 4, then
  // (a0 + a1) + (a2 + a3)
  for (int i = t; i < ng * K; i += T) {
    const float* row = hist + (size_t)i * T;
    const int first = i & 31;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int u = first; u < T + first; u += 4) {
      a0 += row[u < T ? u : u - T];
      a1 += row[u + 1 < T ? u + 1 : u + 1 - T];
      a2 += row[u + 2 < T ? u + 2 : u + 2 - T];
      a3 += row[u + 3 < T ? u + 3 : u + 3 - T];
    }
    const int j = i / K, k = i - j * K;
    part[((size_t)(nb0 + j) * bins + k) * P + p] = (a0 + a1) + (a2 + a3);
  }
  // diagonals: the chunk's positions q0 <= q < q1 on n - m = d - (L - 1),
  // q = m (L + 1) + n - m, m ascending, into two sums by the parity of m,
  // then added; a diagonal that misses the chunk gets 0. The last threads
  // take the first diagonals: the first ones sum bins
  const int q0 = s0 * VEC, q1 = s1 * VEC;
  for (int i = T - 1 - t; i < ng * R; i += T) {
    const int j = i / R, d = i - j * R, delta = d - (L - 1);
    const float* cs = colsum + (size_t)j * chunk * VEC;  // position q at cs[q - q0]
    // m with 0 <= n < L and q0 <= q < q1
    const int first = max(max(0, -delta), q0 - delta > 0 ? (q0 - delta + L) / (L + 1) : 0);
    const int last = q1 - 1 - delta < 0 ? -1 : min(L - 1 - max(0, delta), (q1 - 1 - delta) / (L + 1));
    float even = 0.f, odd = 0.f;
    for (int m = first & ~1; m <= last; m += 2) {
      const int at = m * (L + 1) + delta - q0;
      if (m >= first) even += cs[at];
      if (m + 1 <= last) odd += cs[at + L + 1];
    }
    part[((size_t)(nb0 + j) * bins + K + d) * P + p] = even + odd;
  }
}

// dts (NB, ts_columns) and dpos (NB, 2L - 1) from the blocks' partials, a
// warp an output: lane l adds partials l, l + 32, ... in order, then a
// fixed tree; dts is zero from column K on.
__global__ void rel_bias_sum_kernel(const float* __restrict__ part, float* __restrict__ dts,
                                    float* __restrict__ dpos, int NB, int L, int K,
                                    int ts_columns, int P) {
  const int R = 2 * L - 1, bins = K + R, cols = ts_columns + R;
  const int64_t o = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  // launched while rel_bias_hist_kernel runs: wait for its partials
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (o >= (int64_t)NB * cols) return;  // whole warps
  const int nb = (int)(o / cols), col = (int)(o % cols);
  const bool is_ts = col < ts_columns;
  float sum = 0.f;
  if (!is_ts || col < K) {
    const float* src = part + ((size_t)nb * bins + (is_ts ? col : K + col - ts_columns)) * P;
#pragma unroll 4
    for (int i = lane; i < P; i += 32) sum += src[i];
    sum = warp_sum(sum);
  }
  if (lane == 0) {
    if (is_ts)
      dts[(int64_t)nb * ts_columns + col] = sum;
    else
      dpos[(int64_t)nb * R + (col - ts_columns)] = sum;
  }
}

template <int VEC>
cudaError_t launch_hist(const float* g, const int* bucket, float* part, int NB, int B, int L,
                        int K, int threads, int group, int chunk, int rows, unsigned blocks,
                        size_t smem, cudaStream_t st) {
  // raised once to the most any call asks, so that a call captured in a
  // CUDA graph after a first eager call makes no attribute call
  static size_t allowed = 48 * 1024;
  cudaError_t err;
  if (smem > allowed) {
    if ((err = cudaFuncSetAttribute(rel_bias_hist_kernel<VEC>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem)) !=
        cudaSuccess)
      return err;
    allowed = kMaxSmem;
  }
  const unsigned passes = (unsigned)((NB + group - 1) / group);
  rel_bias_hist_kernel<VEC><<<dim3(blocks, passes), threads, smem, st>>>(
      g, bucket, part, NB, B, L, K, group, chunk, rows);
  return cudaGetLastError();
}

}  // namespace

// g (NB, B, L, L) float32 and bucket (B, L, L) int32 with ids in [0, K),
// contiguous; with vec 4, L * L a multiple of 4 and both 16-byte aligned.
// The grid: `threads` (a multiple of 32) a block, each taking `vec`
// positions; chunks of `chunk` (<= threads) slots of the tile, runs of
// `rows` batch rows, groups of `group` (<= 4) bias blocks. part: NB *
// (K + 2L - 1) * blocks floats of scratch, blocks = chunks * runs. Writes
// dts (NB, ts_columns) and dpos (NB, 2L - 1). Launches on `stream`;
// returns the first CUDA error (0 on success).
extern "C" int stacked_rel_bias_bwd_f32(const float* g, const int* bucket, float* part,
                                        float* dts, float* dpos, int NB, int B, int L, int K,
                                        int ts_columns, int threads, int group, int vec,
                                        int chunk, int rows, void* stream) {
  if (NB < 1 || B < 0 || L < 1 || K < 1 || K > ts_columns || threads < 32 ||
      threads > kMaxThreads || threads % 32 || group < 1 || group > kMaxGroup ||
      (vec != 1 && vec != 4) || (L * L) % vec || chunk < 1 || chunk > threads || rows < 1)
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && ((uintptr_t)g % 16 || (uintptr_t)bucket % 16))
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = sizeof(float) * ((size_t)group * K * threads + (size_t)group * chunk * vec);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int chunks = (L * L / vec + chunk - 1) / chunk;
  const int blocks = chunks * ((B + rows - 1) / rows);
  cudaError_t err = cudaSuccess;
  if (blocks > 0)
    err = vec == 4 ? launch_hist<4>(g, bucket, part, NB, B, L, K, threads, group, chunk, rows,
                                    (unsigned)blocks, smem, st)
                   : launch_hist<1>(g, bucket, part, NB, B, L, K, threads, group, chunk, rows,
                                    (unsigned)blocks, smem, st);
  if (err != cudaSuccess) return (int)err;
  const int64_t warps = (int64_t)NB * (ts_columns + 2 * L - 1);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)((warps * 32 + 255) / 256));
  config.blockDim = dim3(256);
  config.stream = st;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &early;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, rel_bias_sum_kernel, (const float*)part, dts, dpos, NB,
                                 L, K, ts_columns, blocks);
}
