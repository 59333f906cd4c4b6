// Multi-head attention forward for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel recboard_tpu/ops/attention.py:mha_pallas
// (_mha_kernel): per (batch, head), softmax(Q K^T * scale + mask + bias) V,
// where an entry counts as masked when its additive score is <= NEG_INF / 2
// and a query row with no unmasked entry gives zeros.
//
// What bounds it on an H100: bytes. At SASRec's serving shape (B=512,
// L=S=50, H=1, hd=64) q, k, v and out are 6.5 MB each in float32, 26 MB in
// all, which takes 7.8 us at 3.35 TB/s; the causal products are about
// 0.17 GFLOP, 2.5 us at the 67 TFLOP/s float32 rate. So the design reads
// each input once and writes the output once, and keeps every intermediate
// on the chip:
//   * no (B*H, L, S) mask in device memory (the Pallas wrapper builds one):
//     the causal mask comes from indices (key s is visible to query row l
//     iff s <= l + S - L), the key-pad mask from a (B, S) byte row;
//   * the bias is read through its strides, with stride 0 on broadcast
//     dimensions, so a (1, H, L, S) bias is never expanded or copied;
//   * heads are addressed in place in the (B, L, H*hd) layout: no transposes;
//   * one block per (batch*head, tile of 32 query rows) stages its query
//     tile and 32-key tiles of K and V in shared memory and runs an online
//     softmax in float32 (running max and sum per row), so the scores and
//     probabilities never reach device memory;
//   * with causal masking and no bias, the key loop ends at the last key
//     the block's rows can see.
// The products are scalar FMAs: a first kernel that is right and simple.
// wgmma tiles fed by TMA are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kTileQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTileS = 32;                     // keys per tile: one per lane
constexpr int kMaxHd = 128;
constexpr int kAccPerLane = kMaxHd / 32;       // output columns per lane
constexpr float kNegInf = -1e30f;              // NEG_INF of the reference
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

size_t smem_bytes(int hd) {
  // q tile, K tile (one pad column per key row), V tile
  return sizeof(float) *
         ((size_t)kTileQ * hd + (size_t)kTileS * (hd + 1) + (size_t)kTileS * hd);
}

__global__ void __launch_bounds__(kWarps * 32)
mha_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const uint8_t* __restrict__ key_pad,
               const float* __restrict__ bias, int64_t bias_sb, int64_t bias_sh,
               int64_t bias_sl, int64_t bias_ss, float* __restrict__ out,
               int L, int S, int H, int hd, float scale, int causal) {
  extern __shared__ float smem[];
  float* q_sh = smem;                      // kTileQ x hd
  float* k_sh = q_sh + kTileQ * hd;        // kTileS x (hd + 1): the pad column
                                           // puts a lane's key on its own bank
  float* v_sh = k_sh + kTileS * (hd + 1);  // kTileS x hd

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int q0 = blockIdx.y * kTileQ;
  const int64_t D = (int64_t)H * hd;
  const int64_t head = (int64_t)h * hd;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int offset = S - L;  // causal: key s visible to row l iff s <= l + offset
  const bool skip_hidden = causal && bias == nullptr;

  for (int i = threadIdx.x; i < kTileQ * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd, l = q0 + r;
    q_sh[i] = l < L ? q[((int64_t)b * L + l) * D + head + d] : 0.f;
  }

  float row_max[kRowsPerWarp], row_sum[kRowsPerWarp];
  float acc[kRowsPerWarp][kAccPerLane];
  // whether a row has met an unmasked entry yet: a flag rather than -inf
  // arithmetic, so a row whose first key tiles are all masked stays finite
  bool seen[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    row_max[i] = 0.f;
    row_sum[i] = 0.f;
    seen[i] = false;
#pragma unroll
    for (int j = 0; j < kAccPerLane; ++j) acc[i][j] = 0.f;
  }

  int s_end = S;
  if (skip_hidden) {
    const int last_row = min(q0 + kTileQ, L) - 1;
    s_end = max(0, min(S, last_row + offset + 1));
  }
  for (int s0 = 0; s0 < s_end; s0 += kTileS) {
    __syncthreads();  // the previous tile is consumed; on the first pass, q is staged
    for (int i = threadIdx.x; i < kTileS * hd; i += blockDim.x) {
      const int j = i / hd, d = i - j * hd, s = s0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        const int64_t g = ((int64_t)b * S + s) * D + head + d;
        kv = k[g];
        vv = v[g];
      }
      k_sh[j * (hd + 1) + d] = kv;
      v_sh[j * hd + d] = vv;
    }
    __syncthreads();

    const int s = s0 + lane;  // this lane's key
    const bool in_range = s < S;
    const bool pad_masked =
        in_range && key_pad != nullptr && key_pad[(int64_t)b * S + s] != 0;
    const int n_keys = min(kTileS, S - s0);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      // rows interleave across warps, which balances the causal triangle
      const int r = warp + kWarps * i;
      const int l = q0 + r;
      if (l >= L) continue;                          // uniform over the warp
      if (skip_hidden && s0 > l + offset) continue;  // tile hidden from row l
      float x = 0.f;
      bool ok = false;
      if (in_range) {
        const float* qr = q_sh + r * hd;
        const float* kr = k_sh + lane * (hd + 1);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        // the reference's additive score: scaled product + (causal + pad) + bias
        float add = 0.f;
        if (causal && s > l + offset) add = kNegInf;
        if (pad_masked) add += kNegInf;
        x = dot * scale + add;
        if (bias != nullptr)
          x += bias[b * bias_sb + h * bias_sh + l * bias_sl + s * bias_ss];
        ok = x > 0.5f * kNegInf;
      }
      if (!__any_sync(kFull, ok)) continue;
      const float tile_max = warp_max(ok ? x : -INFINITY);
      const float new_max = seen[i] ? fmaxf(row_max[i], tile_max) : tile_max;
      const float corr = seen[i] ? expf(row_max[i] - new_max) : 0.f;
      const float p = ok ? expf(x - new_max) : 0.f;
      row_sum[i] = row_sum[i] * corr + warp_sum(p);
      row_max[i] = new_max;
      seen[i] = true;
#pragma unroll
      for (int j = 0; j < kAccPerLane; ++j) acc[i][j] *= corr;
      for (int t = 0; t < n_keys; ++t) {
        const float pt = __shfl_sync(kFull, p, t);
#pragma unroll
        for (int j = 0; j < kAccPerLane; ++j) {
          const int d = lane + 32 * j;
          if (d < hd) acc[i][j] = fmaf(pt, v_sh[t * hd + d], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int l = q0 + warp + kWarps * i;
    if (l >= L) continue;
    float* o = out + ((int64_t)b * L + l) * D + head;
#pragma unroll
    for (int j = 0; j < kAccPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) o[d] = seen[i] ? acc[i][j] / row_sum[i] : 0.f;
    }
  }
}

}  // namespace

// q (B, L, H*hd), k and v (B, S, H*hd), out (B, L, H*hd): contiguous float32.
// key_pad: (B, S) bytes, nonzero = masked, or null. bias: null, or a float32
// tensor read at b*sb + h*sh + l*sl + s*ss (strides in elements). Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mha_fwd_f32(const float* q, const float* k, const float* v,
                           const uint8_t* key_pad, const float* bias,
                           long long bias_sb, long long bias_sh,
                           long long bias_sl, long long bias_ss, float* out,
                           int B, int L, int S, int H, int hd, float scale,
                           int causal, void* stream) {
  if (B < 0 || L < 0 || S < 0 || H < 1 || hd < 1 || hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0) return 0;
  const size_t smem = smem_bytes(hd);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mha_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)B * (unsigned)H, (unsigned)((L + kTileQ - 1) / kTileQ));
  mha_fwd_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      q, k, v, key_pad, bias, bias_sb, bias_sh, bias_sl, bias_ss, out, L, S, H,
      hd, scale, causal);
  return (int)cudaGetLastError();
}
