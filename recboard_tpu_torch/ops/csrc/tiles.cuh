// What the port's float32 kernels share: the block size and widest D of
// K4's kernels (sampled_softmax_cand.cu), an online logsumexp merge (the
// forwards of K3, K4 and K5), partials of a split loop added in a fixed
// order (K3's backward), and the opt-in to more than 48 KB of shared
// memory.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a block of K4's kernels
constexpr int kMaxD = 128;     // the wrappers refuse a wider D
constexpr unsigned kFull = 0xffffffffu;

// merges (max, sum) pairs of a logsumexp; a max of -inf holds nothing
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float n = fmaxf(m, m2);
  s = s * expf(m - n) + s2 * expf(m2 - n);
  m = n;
}

// out[i] = sum over k of part[k * n + i], k in order
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int64_t n, int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(int64_t)k * n + i];
  out[i] = s;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

cudaError_t sum_splits(const float* part, float* out, int64_t n, int splits,
                       cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, out, n, splits);
  return cudaGetLastError();
}

}  // namespace
