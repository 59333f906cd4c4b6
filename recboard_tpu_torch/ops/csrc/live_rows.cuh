// The rows a sampled-softmax kernel has to compute, listed on the card:
// those whose flag (a row weight, or a row gradient) is not 0. Shared by
// K4 (sampled_softmax_cand.cu, forward and backward) and K5's backward
// (sampled_softmax.cu). The list and its count stay in device memory, so
// the host never waits on them and a CUDA graph captures the call.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

namespace {

constexpr int kListThreads = 1024;  // cand_live_kernel's one block

// The rows with flag[m] != 0 in increasing order (live) and their count
// (n_live). Each thread takes a contiguous run of rows, whose flags it
// loads 32 at a time.
__global__ void __launch_bounds__(kListThreads)
cand_live_kernel(const float* __restrict__ flag, int* __restrict__ live,
                 int* __restrict__ n_live, int M) {
  using Scan = cub::BlockScan<int, kListThreads>;
  __shared__ typename Scan::TempStorage scan;
  const int per = (M + kListThreads - 1) / kListThreads;
  const int lo = (int)min((int64_t)M, (int64_t)threadIdx.x * per);
  const int hi = min(M, lo + per);
  auto flags = [&](int g0) {  // bit j: row g0 + j has flag != 0
    unsigned bits = 0u;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (g0 + j < hi && flag[g0 + j] != 0.f) bits |= 1u << j;
    return bits;
  };
  const unsigned first = lo < hi ? flags(lo) : 0u;  // the usual run: 32 rows or fewer
  int count = __popc(first);
  for (int g0 = lo + 32; g0 < hi; g0 += 32) count += __popc(flags(g0));
  int at, total;
  Scan(scan).ExclusiveSum(count, at, total);
  for (int g0 = lo; g0 < hi; g0 += 32)
    for (unsigned bits = g0 == lo ? first : flags(g0); bits; bits &= bits - 1)
      live[at++] = g0 + __ffs(bits) - 1;
  if (threadIdx.x == 0) *n_live = total;
}

}  // namespace
