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
// The Toeplitz index comes from the entry's own (m, n); the TPU kernel read
// it from an array of its own, a layout device of the TPU.
//
// What bounds it on an H100: bytes. At HSTU's training shape (NB = 4, B =
// 256, L = 50) it reads a 10.24 MB cotangent and 2.56 MB of int32 buckets,
// 3.8 us at 3.35 TB/s, for one add per entry and histogram. The TPU kernel
// turned the histograms into (NB, X) @ (X, K) products on its matrix unit;
// here they are sums into a few hundred bins in shared memory:
//   * the grid is (blocks, NB): a block takes one bias block's cotangent
//     over a contiguous run of the B*L*L entries, and each of its 8 warps
//     walks groups of 32 consecutive entries in a fixed order into a
//     histogram of its own (K + 2L - 1 floats);
//   * within a group, lanes that share a bin (__match_any_sync) add their
//     values in lane order, and the lowest of them adds the sum to the
//     warp's histogram: no atomics, so the order of every addition is
//     fixed;
//   * the block adds its 8 histograms in warp order into its row of a
//     partial array, and a second pass adds the blocks' rows in block order
//     into dts (zero beyond the K active buckets) and dpos. Reruns give the
//     same bits.
// Global atomics per entry onto about 130 bins would serialise on
// contention. Entries above the diagonal (n > m) are read like the others.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// adds `val` of every lane into hist[bin], lanes with one bin in lane order;
// a bin below 0 takes nothing
__device__ __forceinline__ void add_binned(float* hist, int bin, float val, int lane) {
  const unsigned peers = __match_any_sync(kFull, bin);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float v = __shfl_sync(kFull, val, j);
    if ((peers >> j) & 1u) sum += v;
  }
  if (bin >= 0 && lane == __ffs(peers) - 1) hist[bin] += sum;
  __syncwarp();
}

// Block (run of entries, bias block nb): its histograms go to
// part[nb][blockIdx.x][K + 2L - 1], the K bucket bins first.
__global__ void __launch_bounds__(kThreads)
rel_bias_hist_kernel(const float* __restrict__ g, const int* __restrict__ bucket,
                     float* __restrict__ part, int B, int L, int K) {
  extern __shared__ float hist[];  // kWarps x bins
  const int bins = K + 2 * L - 1;
  const int nb = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t X = (int64_t)B * L * L;
  const int64_t chunk = (X + gridDim.x - 1) / gridDim.x;
  const int64_t x0 = (int64_t)blockIdx.x * chunk;
  const int64_t x1 = x0 + chunk < X ? x0 + chunk : X;
  const float* gnb = g + (int64_t)nb * X;

  for (int i = threadIdx.x; i < kWarps * bins; i += kThreads) hist[i] = 0.f;
  __syncthreads();
  float* own = hist + warp * bins;
  for (int64_t base = x0 + 32 * warp; base < x1; base += 32 * kWarps) {
    const int64_t x = base + lane;
    const bool ok = x < x1;
    const float val = ok ? gnb[x] : 0.f;
    int kb = ok ? bucket[x] : -1;
    if (kb >= K) kb = -1;  // the wrapper's ids lie in [0, K); others take no bin
    const int mn = (int)(x % ((int64_t)L * L));
    const int m = mn / L, n = mn - m * L;
    add_binned(own, kb, val, lane);
    add_binned(own, ok ? K + n - m + L - 1 : -1, val, lane);
  }
  __syncthreads();
  float* dst = part + ((int64_t)nb * gridDim.x + blockIdx.x) * bins;
  for (int i = threadIdx.x; i < bins; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += hist[w * bins + i];
    dst[i] = s;
  }
}

// dts (NB, ts_columns) and dpos (NB, 2L - 1) from the blocks' rows, added in
// block order; dts is zero from column K on.
__global__ void rel_bias_sum_kernel(const float* __restrict__ part, float* __restrict__ dts,
                                    float* __restrict__ dpos, int NB, int L, int K,
                                    int ts_columns, int blocks) {
  const int R = 2 * L - 1, bins = K + R, cols = ts_columns + R;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)NB * cols) return;
  const int nb = (int)(i / cols), col = (int)(i % cols);
  const bool is_ts = col < ts_columns;
  const int bin = is_ts ? col : K + (col - ts_columns);
  float s = 0.f;
  if (!is_ts || col < K)
    for (int b = 0; b < blocks; ++b) s += part[((int64_t)nb * blocks + b) * bins + bin];
  if (is_ts)
    dts[(int64_t)nb * ts_columns + col] = s;
  else
    dpos[(int64_t)nb * R + (col - ts_columns)] = s;
}

}  // namespace

// g (NB, B, L, L) float32 and bucket (B, L, L) int32 with ids in [0, K),
// contiguous. part: NB * blocks * (K + 2L - 1) floats of scratch. Writes
// dts (NB, ts_columns) and dpos (NB, 2L - 1). `blocks` runs of entries per
// bias block. Launches on `stream`; returns the first CUDA error (0 on
// success).
extern "C" int stacked_rel_bias_bwd_f32(const float* g, const int* bucket, float* part,
                                        float* dts, float* dpos, int NB, int B, int L, int K,
                                        int ts_columns, int blocks, void* stream) {
  if (NB < 1 || B < 0 || L < 1 || K < 1 || K > ts_columns || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = sizeof(float) * (size_t)kWarps * (K + 2 * L - 1);
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(rel_bias_hist_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
    return (int)err;
  rel_bias_hist_kernel<<<dim3((unsigned)blocks, (unsigned)NB), kThreads, smem, st>>>(
      g, bucket, part, B, L, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)NB * (ts_columns + 2 * L - 1);
  rel_bias_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, dts, dpos, NB, L, K,
                                                                   ts_columns, blocks);
  return (int)cudaGetLastError();
}
