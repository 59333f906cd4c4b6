// Multi-head attention with dropout on the probabilities, forward and
// backward, for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel recboard_tpu/ops/attention.py:mha_dropout_pallas:
// _mha_drop_fwd_kernel and _mha_drop_bwd_kernel behind the custom VJP of
// _mha_dropout_fused. Per (batch row b, head h):
//   x    = Q K^T * scale + causal/key-pad mask + bias[h]   (masked: x <= NEG_INF/2)
//   P    = softmax(x) over the unmasked keys (a row with none gives zeros)
//   out  = (P * keep / (1 - rate)) V
// with keep(l, s) = bits(seed, b*H + h, l*S + s) >= threshold, a counter-based
// hash evaluated where it is used and never stored. The hash is the one the
// JAX kernel uses in interpret mode (_keep_mask), keyed by the batch ROW, so
// at B = 1 the masks agree bit for bit and at B > 1 every row draws its own.
// The backward returns dq, dk, dv and, when asked, dbias summed over the batch.
//
// What bounds it on an H100: bytes. At SASRec's training shape (B=512,
// L=S=50, H=1, hd=64) the forward moves q, k, v and out (26 MB, 7.8 us at
// 3.35 TB/s) and the backward q, k, v, out, dO, dq, dk, dv (52 MB, 15.6 us);
// their products are 0.17 and 0.42 GFLOP, 2.5 and 6.3 us at the 67 TFLOP/s
// float32 rate. So neither pass writes a (B*H, L, S) tensor:
//   * the forward is attn_fwd_tc.cuh's kernel with dropout: both products on
//     the tensor cores in split-precision TF32, an online softmax in
//     registers, the keep mask applied to P before the PV product, and one
//     float per row beside the output: lse = max + log(sum), +inf for a row
//     with no visible key;
//   * the backward runs one block per batch*head. It reads lse and computes
//     delta = rowsum(dO * O) (equal to the JAX kernel's sum(dP_dropped * P))
//     once per row, then walks 32-key tiles; for each tile it walks 32-row
//     chunks of queries, rebuilds P and the keep mask from q, k, lse and the
//     seed, and forms dS = P * (keep * dO V^T / (1 - rate) - delta) in shared
//     memory. dK and dV of the tile sum over the chunks in registers and are
//     written once; dQ adds each tile's share to its rows in device memory
//     (the block owns those rows, so no atomics); dbias, shared by the whole
//     batch, takes atomicAdd.
//   * with causal masking and no bias both passes skip the (query, key) tiles
//     that the mask hides.
// The backward's products are scalar FMAs: a first kernel that is right and
// simple.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_fwd_tc.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kTileQ = kWarps * kRowsPerWarp;  // query rows per block / chunk
constexpr int kTileS = 32;                     // keys per tile: one per lane
constexpr int kMaxHd = 128;
constexpr int kAccPerThread = kTileS * kMaxHd / kThreads;  // backward dk/dv entries
constexpr size_t kMaxSmem = 232448;  // the most a block may ask for on an H100

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

size_t bwd_smem_bytes(int hd, int L) {
  // K and V tiles (padded), q and dO chunks, dS and dropped-P tiles, lse and delta
  return sizeof(float) * (2 * (size_t)kTileS * (hd + 1) + 2 * (size_t)kTileQ * hd +
                          2 * (size_t)kTileQ * kTileS + 2 * (size_t)L);
}

__global__ void __launch_bounds__(kThreads)
mha_drop_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ out,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    Scores sc, const int* __restrict__ seed, float* __restrict__ dq,
                    float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ dbias, int L, int S, int H, int hd,
                    uint32_t threshold, float inv_keep) {
  extern __shared__ float smem[];
  const int hp = hd + 1;                    // pad column: a lane's key on its own bank
  float* k_sh = smem;                       // kTileS x hp
  float* v_sh = k_sh + kTileS * hp;         // kTileS x hp
  float* q_sh = v_sh + kTileS * hp;         // kTileQ x hd
  float* do_sh = q_sh + kTileQ * hd;        // kTileQ x hd
  float* ds_sh = do_sh + kTileQ * hd;       // kTileQ x kTileS: dS
  float* pd_sh = ds_sh + kTileQ * kTileS;   // kTileQ x kTileS: P * keep / (1 - rate)
  float* lse_sh = pd_sh + kTileQ * kTileS;  // L
  float* delta_sh = lse_sh + L;             // L

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int64_t D = (int64_t)H * hd;
  const int64_t head = (int64_t)h * hd;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool skip_hidden = sc.causal && sc.bias == nullptr;
  const uint32_t base = hash_base(seed, blockIdx.x);

  // per-row statistics: the forward's lse, and delta = rowsum(dO * O)
  for (int l = warp; l < L; l += kWarps) {
    const int64_t row = ((int64_t)b * L + l) * D + head;
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32) acc = fmaf(out[row + d], dout[row + d], acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      delta_sh[l] = acc;
      lse_sh[l] = lse[(int64_t)blockIdx.x * L + l];
    }
  }

  for (int s0 = 0; s0 < S; s0 += kTileS) {
    // the first row that can see a key of this tile
    const int l_begin = skip_hidden ? max(0, s0 - sc.offset) : 0;
    const int n_keys = min(kTileS, S - s0);
    __syncthreads();  // the previous tile is consumed; on the first pass, stats are ready
    for (int i = threadIdx.x; i < kTileS * hd; i += blockDim.x) {
      const int j = i / hd, d = i - j * hd, s = s0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        const int64_t g = ((int64_t)b * S + s) * D + head + d;
        kv = k[g];
        vv = v[g];
      }
      k_sh[j * hp + d] = kv;
      v_sh[j * hp + d] = vv;
    }

    float dk_acc[kAccPerThread], dv_acc[kAccPerThread];
#pragma unroll
    for (int t = 0; t < kAccPerThread; ++t) dk_acc[t] = dv_acc[t] = 0.f;

    const int s = s0 + lane;  // this lane's key in phase 1
    const bool in_range = s < S;
    const bool pad_masked =
        in_range && sc.key_pad != nullptr && sc.key_pad[(int64_t)b * S + s] != 0;

    for (int q0 = l_begin; q0 < L; q0 += kTileQ) {
      __syncthreads();  // K/V are staged; the previous chunk is consumed
      for (int i = threadIdx.x; i < kTileQ * hd; i += blockDim.x) {
        const int r = i / hd, d = i - r * hd, l = q0 + r;
        const int64_t g = ((int64_t)b * L + l) * D + head + d;
        q_sh[i] = l < L ? q[g] : 0.f;
        do_sh[i] = l < L ? dout[g] : 0.f;
      }
      __syncthreads();

      // phase 1: one (row, key) pair per lane -> dS and the dropped P
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + kWarps * i;
        const int l = q0 + r;
        float ds = 0.f, pd = 0.f;
        if (l < L && in_range) {
          const float* qr = q_sh + r * hd;
          const float* kr = k_sh + lane * hp;
          float dot = 0.f;
          for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
          const float x = sc(dot, h, l, s, pad_masked);
          if (x > 0.5f * kNegInf) {
            const float p = expf(x - lse_sh[l]);
            const float* gr = do_sh + r * hd;
            const float* vr = v_sh + lane * hp;
            float dpv = 0.f;
            for (int d = 0; d < hd; ++d) dpv = fmaf(gr[d], vr[d], dpv);
            const bool keep = kept(base, l, S, s, threshold);
            ds = p * ((keep ? dpv * inv_keep : 0.f) - delta_sh[l]);
            pd = keep ? p * inv_keep : 0.f;
            if (dbias != nullptr) atomicAdd(dbias + ((int64_t)h * L + l) * S + s, ds);
          }
        }
        ds_sh[r * kTileS + lane] = ds;
        pd_sh[r * kTileS + lane] = pd;
      }
      __syncthreads();

      // phase 2: dK += dS^T Q and dV += P_dropped^T dO, one (key, column) per entry
      const int rows = min(kTileQ, L - q0);
#pragma unroll
      for (int t = 0; t < kAccPerThread; ++t) {
        const int e = threadIdx.x + kThreads * t;
        if (e < kTileS * hd) {
          const int j = e / hd, d = e - j * hd;
          float a = dk_acc[t], c = dv_acc[t];
          for (int r = 0; r < rows; ++r) {
            a = fmaf(ds_sh[r * kTileS + j], q_sh[r * hd + d], a);
            c = fmaf(pd_sh[r * kTileS + j], do_sh[r * hd + d], c);
          }
          dk_acc[t] = a;
          dv_acc[t] = c;
        }
      }
      // phase 3: dQ += dS K * scale for the chunk's rows
      for (int e = threadIdx.x; e < rows * hd; e += kThreads) {
        const int r = e / hd, d = e - r * hd;
        float a = 0.f;
        for (int j = 0; j < n_keys; ++j) a = fmaf(ds_sh[r * kTileS + j], k_sh[j * hp + d], a);
        dq[((int64_t)b * L + q0 + r) * D + head + d] += a * sc.scale;
      }
    }

#pragma unroll
    for (int t = 0; t < kAccPerThread; ++t) {
      const int e = threadIdx.x + kThreads * t;
      if (e < kTileS * hd) {
        const int j = e / hd, d = e - j * hd;
        if (j < n_keys) {
          const int64_t g = ((int64_t)b * S + s0 + j) * D + head + d;
          dk[g] = dk_acc[t] * sc.scale;
          dv[g] = dv_acc[t];
        }
      }
    }
  }
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

bool bad_shape(int B, int L, int S, int H, int hd) {
  return B < 0 || L < 0 || S < 0 || H < 1 || hd < 1 || hd > kMaxHd;
}

}  // namespace

// q (B, L, H*hd), k and v (B, S, H*hd), out (B, L, H*hd): contiguous float32.
// key_pad: (B, S) bytes, nonzero = masked, or null. bias: null, or a float32
// (H, L, S) tensor read at h*sh + l*sl + s*ss (strides in elements, 0 on a
// broadcast dimension). seed: one int32 in device memory. lse: (B, H, L)
// float32, written. Keeps a probability where its hash is >= threshold and
// scales the kept ones by inv_keep. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int mha_dropout_fwd_f32(const float* q, const float* k, const float* v,
                                   const uint8_t* key_pad, const float* bias,
                                   long long bias_sh, long long bias_sl,
                                   long long bias_ss, const int* seed, float* out,
                                   float* lse, int B, int L, int S, int H, int hd,
                                   float scale, int causal, unsigned threshold,
                                   float inv_keep, void* stream) {
  const Scores sc{key_pad, bias, bias_sh, bias_sl, bias_ss, scale, causal, S - L};
  return (int)attn_fwd_tc<true>(q, k, v, sc, seed, out, lse, B, L, S, H, hd, threshold,
                                inv_keep, (cudaStream_t)stream);
}

// The backward of mha_dropout_fwd_f32 for the same inputs, its out and lse,
// and dout (B, L, H*hd). dq must hold zeros on entry (the kernel adds to it);
// dk and dv are written. dbias: null, or an (H, L, S) float32 tensor holding
// zeros, to which dS summed over the batch is added.
extern "C" int mha_dropout_bwd_f32(const float* q, const float* k, const float* v,
                                   const float* out, const float* dout, const float* lse,
                                   const uint8_t* key_pad, const float* bias,
                                   long long bias_sh, long long bias_sl,
                                   long long bias_ss, const int* seed, float* dq,
                                   float* dk, float* dv, float* dbias, int B, int L,
                                   int S, int H, int hd, float scale, int causal,
                                   unsigned threshold, float inv_keep, void* stream) {
  if (bad_shape(B, L, S, H, hd)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const size_t smem = bwd_smem_bytes(hd, L);
  const cudaError_t err = allow_smem((const void*)mha_drop_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const Scores sc{key_pad, bias, bias_sh, bias_sl, bias_ss, scale, causal, S - L};
  mha_drop_bwd_kernel<<<(unsigned)B * (unsigned)H, kThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, out, dout, lse, sc, seed, dq, dk, dv, dbias, L, S, H, hd, threshold,
      inv_keep);
  return (int)cudaGetLastError();
}
