// Float32 tiles of 64 rows x 64 columns for K5's forward
// (sampled_softmax.cu): 256 threads each hold a 4 x 4 block of a tile
// product in registers, fed by float4 loads from d-major copies of the two
// operand tiles in shared memory. And what the other kernels share: an
// online logsumexp merge, partials of a split loop added in a fixed order,
// the opt-in to more than 48 KB of shared memory.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;               // rows, and columns, per tile
constexpr int kThreads = 256;           // 16 x 16 threads, a 4 x 4 block each
constexpr int kLd = kTile + 4;          // leading dim of d-major tiles (float4-aligned)
constexpr int kMaxD = 128;              // the wrapper refuses a wider D
constexpr unsigned kFull = 0xffffffffu;

// a row-major (n, D) tile [r0, r0 + 64) into a d-major shared tile
// dst[d * kLd + r]; rows past n are zeros
__device__ __forceinline__ void load_dmajor(float* dst, const float* __restrict__ src,
                                            int64_t n, int64_t r0, int D) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int64_t g = r0 + r;
    dst[d * kLd + r] = g < n ? src[g * D + d] : 0.f;
  }
}

// acc[i][j] = sum_d a_t[d][4 ty + i] * b_t[d][4 tx + j]: the 4 x 4 block of
// a 64 x 64 product of two d-major tiles
__device__ __forceinline__ void tile_dot(const float* a_t, const float* b_t, int D,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(a_t + d * kLd + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(b_t + d * kLd + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

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
