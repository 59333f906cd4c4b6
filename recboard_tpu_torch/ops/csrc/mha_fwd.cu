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
// 0.17 GFLOP. The kernel is attn_fwd_tc.cuh's, without dropout: both
// products on the tensor cores in split-precision TF32, the online softmax
// in registers, scores and probabilities never in device memory, the bias
// read through its strides (stride 0 on broadcast dimensions, so a
// (1, H, L, S) bias is never expanded), heads addressed in place.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_fwd_tc.cuh"

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
  const Scores sc{key_pad, bias, bias_sh, bias_sl, bias_ss, scale, causal, S - L, bias_sb};
  return (int)attn_fwd_tc<false>(q, k, v, sc, nullptr, out, nullptr, B, L, S, H, hd, 0u, 1.f,
                                 (cudaStream_t)stream);
}
