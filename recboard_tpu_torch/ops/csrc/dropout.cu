// Inverted-dropout mask for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel _mask_kernel of recboard_tpu/ops/dropout.py (:37,
// called by dropout_mask at :52): out[i] = scale where the 32 random bits of
// element i are >= threshold, else 0, with threshold = min(round(rate *
// 2^32), 2^32 - 1) and scale = 1 / (1 - rate). The TPU kernel draws its bits
// from the core's hardware generator; here they are a counter-based hash of
// (seed, i), which the plain version in ops/dropout.py evaluates bit for bit:
//   k = mix(seed ^ 0x9E3779B9), x = mix(lo(i) + k),
//   bits = mix(x ^ (k * 0x85EBCA6B + hi(i))),
// with mix the two-round xor-shift-multiply hash of ops/attention.py's keep
// mask. The second round keys the counter again after a nonlinear step, so
// two seeds do not give shifted copies of one stream.
//
// What bounds it on an H100: bytes. A (1024, 50, 64) mask is a 13.1 MB write,
// 3.9 us at 3.35 TB/s, for a dozen integer operations per element. Each
// thread writes four consecutive elements with one 16-byte store; the seed is
// read on the device, so drawing it does not wait for the device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ float mask_value(uint64_t i, uint32_t key, uint32_t threshold,
                                            float scale) {
  const uint32_t x = mix((uint32_t)i + key);
  const uint32_t bits = mix(x ^ (key * 0x85EBCA6Bu + (uint32_t)(i >> 32)));
  return bits >= threshold ? scale : 0.f;
}

__global__ void __launch_bounds__(kThreads)
mask_kernel(const int* __restrict__ seed, float* __restrict__ out, int64_t n,
            uint32_t threshold, float scale) {
  const uint32_t key = mix((uint32_t)seed[0] ^ 0x9E3779B9u);
  const int64_t i0 = 4 * ((int64_t)blockIdx.x * kThreads + threadIdx.x);
  if (i0 + 4 <= n) {
    *reinterpret_cast<float4*>(out + i0) = make_float4(
        mask_value(i0, key, threshold, scale), mask_value(i0 + 1, key, threshold, scale),
        mask_value(i0 + 2, key, threshold, scale), mask_value(i0 + 3, key, threshold, scale));
  } else {
    for (int64_t i = i0; i < n; ++i) out[i] = mask_value(i, key, threshold, scale);
  }
}

}  // namespace

// out: n contiguous float32, 16-byte aligned; seed: one int32 on the device.
// Launches on `stream`; returns the first CUDA error (0 on success).
extern "C" int dropout_mask_f32(const int* seed, float* out, long long n, unsigned threshold,
                                float scale, void* stream) {
  if (n < 0 || (uintptr_t)out % 16 != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t threads = (n + 3) / 4;
  mask_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                (cudaStream_t)stream>>>(seed, out, n, threshold, scale);
  return (int)cudaGetLastError();
}
