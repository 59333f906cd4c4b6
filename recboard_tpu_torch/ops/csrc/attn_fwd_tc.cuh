// The attention forward on Hopper's tensor cores, float32 in split precision:
// one kernel body for mha_fwd.cu (K1, inference) and mha_dropout.cu (K2's
// forward, which adds the dropout keep mask and writes one logsumexp per
// row).
//
// Replaces the TPU kernels recboard_tpu/ops/attention.py:_mha_kernel (behind
// mha_pallas) and :_mha_drop_fwd_kernel (behind mha_dropout_pallas). Per
// (batch row b, head h):
//   x    = Q K^T * scale + causal/key-pad mask + bias   (masked: x <= NEG_INF/2)
//   P    = softmax(x) over the unmasked keys (a row with none gives zeros)
//   out  = (P * keep / (1 - rate)) V       (keep = 1, rate = 0 without dropout)
//   lse  = max + log(sum), +inf for a row with no visible key (dropout only)
//
// What bounds it on an H100: bytes. At SASRec's and BERT4Rec's shapes
// (B = 512, L = S = 50, D = H*hd = 64) q, k, v and out are 26 MB, 7.8 us at
// 3.35 TB/s, against 0.17 GFLOP of products. The design therefore reads each
// input once, keeps scores and probabilities on the chip, and spends as few
// instructions per (row, key) as it can:
//   * a block of 4 warps owns one (b, h) and 64 query rows, each warp 16
//     rows (the m of mma.sync m16n8k8); keys go by tiles of 64;
//   * Q, K and V tiles are staged by cp.async, in place from the
//     (B, L, H*hd) layout (row stride H*hd, column offset h*hd), into
//     mma_tf32.cuh's swizzled layout, hd padded with zeros to a multiple
//     of 8; 16-byte copies where hd is a multiple of 4 and the pointers
//     are 16-byte aligned, 4-byte copies otherwise;
//   * Q K^T and P V run on the tensor cores as 3xTF32 (mma_tf32.cuh), so
//     they keep float32's accuracy; each key tile's P V goes to fresh
//     registers and is added to the output in float32, since the tensor
//     cores truncate as they accumulate;
//   * the online softmax lives in the C fragments: a row is held by one quad
//     of lanes, so its max and sum take two shuffles;
//   * P moves from the C layout to the A layout by shuffles within each
//     quad, in registers;
//   * no (B*H, L, S) mask in device memory: causal by index (key s visible
//     to row l iff s <= l + S - L), key padding from (B, S) bytes, the bias
//     read through its strides (0 on broadcast dimensions);
//   * with causal masking and no bias, the key tiles that the block's rows
//     cannot see are not loaded, and a warp's products stop at the last
//     key its rows can see;
//   * 4 blocks an SM at hd <= 64 (registers capped at 128), so SASRec's
//     512 (b, h) pairs run in one wave;
//   * no atomics: a rerun gives the same bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the reference
constexpr unsigned kFull = 0xffffffffu;

// The per-(batch row, head) part of the dropout hash:
// 0x9E3779B9 * (seed + pid * 747796405), pid = b*H + h.
__device__ __forceinline__ uint32_t hash_base(const int* seed, int pid) {
  return 0x9E3779B9u * ((uint32_t)seed[0] + (uint32_t)pid * 747796405u);
}

__device__ __forceinline__ bool kept(uint32_t base, int l, int S, int s, uint32_t threshold) {
  uint32_t x = (uint32_t)l * (uint32_t)S + (uint32_t)s + base;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x ^= x >> 16;
  return x >= threshold;
}

// Where the additive mask and the bias live, and how to read them.
struct Scores {
  const uint8_t* key_pad;  // (B, S), nonzero = masked, or null
  const float* bias;       // read at b*sb + h*sh + l*sl + s*ss, or null
  int64_t sh, sl, ss;
  float scale;
  int causal, offset;      // causal: key s visible to row l iff s <= l + offset
  int64_t sb;              // 0 where the bias is shared across the batch

  // the reference's score: scaled product + (causal + pad) + bias, with
  // `bias` already at batch row b
  __device__ __forceinline__ float operator()(float dot, int h, int l, int s,
                                              bool pad_masked) const {
    float add = 0.f;
    if (causal && s > l + offset) add = kNegInf;
    if (pad_masked) add += kNegInf;
    float x = dot * scale + add;
    if (bias != nullptr) x += bias[h * sh + l * sl + s * ss];
    return x;
  }
};

constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kFwdRows = 16 * kFwdWarps;  // query rows per block
constexpr int kFwdKeys = 64;              // keys per tile
constexpr int kFwdMaxHd = 128;

// rows [r0, r0 + ROWS) of one head of a (n, row_stride) float32 array (its
// columns [col, col + hd)) into a swizzled tile of LD floats a row, columns
// [0, kd) with kd = hd rounded up to 8; rows past n and columns past hd are
// zeros. `vec`: hd is a multiple of 4 and the array 16-byte aligned, so
// each 16-byte chunk is wholly inside or outside the head.
template <int ROWS, int LD>
__device__ __forceinline__ void stage_head(float* dst, const float* __restrict__ src, int64_t n,
                                           int64_t r0, int64_t row_stride, int64_t col, int hd,
                                           int kd, bool vec) {
  if (vec) {
    const int chunks = kd / 4;
    for (int i = threadIdx.x; i < ROWS * chunks; i += kFwdThreads) {
      const int r = i / chunks, c = 4 * (i - r * chunks);
      const bool ok = r0 + r < n && c < hd;
      cp_async<16>(dst + at(r, c, LD), ok ? src + (r0 + r) * row_stride + col + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * kd; i += kFwdThreads) {
      const int r = i / kd, c = i - r * kd;
      const bool ok = r0 + r < n && c < hd;
      cp_async<4>(dst + at(r, c, LD), ok ? src + (r0 + r) * row_stride + col + c : src, ok);
    }
  }
}

template <int LD>
constexpr size_t attn_fwd_smem() {
  return sizeof(float) * 3 * (size_t)kFwdKeys * LD;  // Q, K and V tiles
}

// The A fragment of P for 8 keys from the C fragment c that holds them:
// c0, c1 (g, 2t and 2t + 1), c2, c3 (g + 8, ...). A wants (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4): column t lies in lane 4g + t/2 and column
// t + 4 in lane 4g + 2 + t/2, each as element t % 2 of its pair.
__device__ __forceinline__ void p_fragment(FragA& a, const float c[4], int g, int t) {
  const int src[2] = {4 * g + (t >> 1), 4 * g + 2 + (t >> 1)};
  const bool odd = t & 1;
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // q: (row half q & 1, column half q >> 1)
    const int e = 2 * (q & 1);
    const float x0 = __shfl_sync(kFull, c[e], src[q >> 1]);
    const float x1 = __shfl_sync(kFull, c[e + 1], src[q >> 1]);
    split_tf32(odd ? x1 : x0, a.hi[q], a.lo[q]);
  }
}

// Blocks an SM should hold: at LD 64 (SASRec's hd) 4 blocks of 48 KB, so
// that 512 (b, h) pairs run in one wave of 132 SMs; at LD 32 (BERT4Rec's)
// 4 too, where the compiler would otherwise take registers for only 3.
// That caps registers at 128 a thread.
constexpr int fwd_min_blocks(int LD) { return LD <= 64 ? 4 : 1; }

// grid (B*H, ceil(L / 64)), kFwdThreads threads. LD: hd rounded up to 32
// (the swizzle's row length). Without kDrop, seed and lse are not read.
template <bool kDrop, int LD>
__global__ void __launch_bounds__(kFwdThreads, fwd_min_blocks(LD))
attn_fwd_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, Scores sc, const int* __restrict__ seed,
                   float* __restrict__ out, float* __restrict__ lse, int L, int S, int H,
                   int hd, int vec, uint32_t threshold, float inv_keep) {
  static_assert(LD % 32 == 0 && LD <= kFwdMaxHd, "LD: a multiple of 32 up to 128");
  constexpr int NT = LD / 8;  // 8-wide column tiles of the output
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                      // kFwdRows x LD (kFwdRows == kFwdKeys)
  float* k_s = q_s + kFwdRows * LD;       // kFwdKeys x LD
  float* v_s = k_s + kFwdKeys * LD;       // kFwdKeys x LD

  const int pid = blockIdx.x;  // b*H + h: keys the dropout hash and lse's rows
  const int b = pid / H, h = pid - b * H;
  const int q0 = blockIdx.y * kFwdRows;
  const int64_t D = (int64_t)H * hd, head = (int64_t)h * hd;
  const int kd = (hd + 7) & ~7;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rw = 16 * warp;  // the warp's first row in the tile
  const bool skip_hidden = sc.causal && sc.bias == nullptr;
  if (sc.bias != nullptr) sc.bias += b * sc.sb;
  uint32_t base = 0;
  if constexpr (kDrop) base = hash_base(seed, pid);
  const float* qb = q + (int64_t)b * L * D;
  const float* kb = k + (int64_t)b * S * D;
  const float* vb = v + (int64_t)b * S * D;
  const uint8_t* pad = sc.key_pad == nullptr ? nullptr : sc.key_pad + (int64_t)b * S;

  int s_end = S;
  if (skip_hidden) s_end = max(0, min(S, min(q0 + kFwdRows, L) - 1 + sc.offset + 1));
  // the last key the warp's rows can see, under causal masking without bias
  const int warp_last = skip_hidden ? min(q0 + rw + 15, L - 1) + sc.offset : INT32_MAX;
  const bool warp_live = q0 + rw < L;

  stage_head<kFwdRows, LD>(q_s, qb, L, q0, D, head, hd, kd, vec);
  if (s_end > 0) stage_head<kFwdKeys, LD>(k_s, kb, S, 0, D, head, hd, kd, vec);
  cp_async_commit();
  if (s_end > 0) stage_head<kFwdKeys, LD>(v_s, vb, S, 0, D, head, hd, kd, vec);
  cp_async_commit();

  // rows rw + g (hh = 0) and rw + g + 8 (hh = 1) of this lane's quad
  float row_max[2] = {0.f, 0.f}, row_sum[2] = {0.f, 0.f};
  bool seen[2] = {false, false};  // whether the row has met an unmasked entry yet
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int s0 = 0; s0 < s_end; s0 += kFwdKeys) {
    cp_async_wait<1>();
    __syncthreads();  // Q and this K tile have landed
    const bool active = warp_live && s0 <= warp_last;
    // keys of this tile the warp computes: those in range and, under causal
    // masking without bias, those its rows can see (P is 0 past them)
    const int kt = skip_hidden ? min(S - s0, warp_last + 1 - s0) : S - s0;
    float corr[2] = {1.f, 1.f};
    // scores, then P: x[j][e] for rows (e < 2 ? g : g + 8), key s0 + 8 j + 2 t + (e & 1)
    float x[8][4];
    if (active) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < LD; k0 += 8) {
        if (k0 >= kd) break;
        FragA a;
        load_a(a, q_s, rw, k0, LD);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          if (8 * j >= kt) break;
          FragB bk[2];
          load_b_rows2(bk, k_s, 8 * j, k0, LD);
          mma_3xtf32(x[j], a, bk[0]);
          mma_3xtf32(x[j + 1], a, bk[1]);
        }
      }
      // masked entries become -inf, whose exp is 0
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1, l = q0 + rw + g + 8 * hh, s = s0 + 8 * j + 2 * t + (e & 1);
          float xs = -INFINITY;
          if (l < L && s < S) {
            xs = sc(x[j][e], h, l, s, pad != nullptr && pad[s] != 0);
            if (!(xs > 0.5f * kNegInf)) xs = -INFINITY;
          }
          x[j][e] = xs;
          tile_max[hh] = fmaxf(tile_max[hh], xs);
        }
      float new_max[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        tile_max[hh] = fmaxf(tile_max[hh], __shfl_xor_sync(kFull, tile_max[hh], 1));
        tile_max[hh] = fmaxf(tile_max[hh], __shfl_xor_sync(kFull, tile_max[hh], 2));
        new_max[hh] = row_max[hh];
        if (tile_max[hh] != -INFINITY) {  // the row sees a key of this tile
          new_max[hh] = seen[hh] ? fmaxf(row_max[hh], tile_max[hh]) : tile_max[hh];
          corr[hh] = seen[hh] ? expf(row_max[hh] - new_max[hh]) : 0.f;
        }
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const float p = expf(x[j][e] - new_max[hh]);
          psum[hh] += p;  // the softmax sums every visible key
          x[j][e] = p;
          if constexpr (kDrop) {
            const int l = q0 + rw + g + 8 * hh, s = s0 + 8 * j + 2 * t + (e & 1);
            if (p != 0.f && !kept(base, l, S, s, threshold)) x[j][e] = 0.f;
          }
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        psum[hh] += __shfl_xor_sync(kFull, psum[hh], 1);
        psum[hh] += __shfl_xor_sync(kFull, psum[hh], 2);
        if (tile_max[hh] != -INFINITY) {
          row_sum[hh] = row_sum[hh] * corr[hh] + psum[hh];
          row_max[hh] = new_max[hh];
          seen[hh] = true;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // this V tile has landed
    if (active) {
      // o = o * corr + P V, 64 output columns at a time, each tile's product
      // in fresh registers
#pragma unroll
      for (int c0 = 0; c0 < NT; c0 += 8) {
        if (8 * c0 >= kd) break;
        float part[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
        for (int k0 = 0; k0 < kFwdKeys; k0 += 8) {
          if (k0 >= kt) break;
          FragA a;
          p_fragment(a, x[k0 / 8], g, t);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (c0 + j >= NT || 8 * (c0 + j) >= kd) break;
            FragB bv;
            load_b_cols(bv, v_s, k0, 8 * (c0 + j), LD, g, t);
            mma_3xtf32(part[j], a, bv);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (c0 + j >= NT) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) o[c0 + j][e] = o[c0 + j][e] * corr[e >> 1] + part[j][e];
        }
      }
    }
    if (s0 + kFwdKeys < s_end) {
      __syncthreads();  // every warp is done with this K and V tile
      stage_head<kFwdKeys, LD>(k_s, kb, S, s0 + kFwdKeys, D, head, hd, kd, vec);
      cp_async_commit();
      stage_head<kFwdKeys, LD>(v_s, vb, S, s0 + kFwdKeys, D, head, hd, kd, vec);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int l = q0 + rw + g + 8 * hh;
    if (l >= L) continue;
    float* orow = out + ((int64_t)b * L + l) * D + head;
    float norm = 0.f;
    if (seen[hh]) norm = kDrop ? inv_keep / row_sum[hh] : 1.f / row_sum[hh];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int d = 8 * j + 2 * t;
      if (d >= hd) break;
      const float a = o[j][2 * hh] * norm, c = o[j][2 * hh + 1] * norm;
      if (vec) {  // hd a multiple of 4: d < hd means d + 1 < hd
        *reinterpret_cast<float2*>(orow + d) = make_float2(a, c);
      } else {
        orow[d] = a;
        if (d + 1 < hd) orow[d + 1] = c;
      }
    }
    if constexpr (kDrop)
      if (t == 0)
        lse[(int64_t)pid * L + l] = seen[hh] ? row_max[hh] + logf(row_sum[hh]) : INFINITY;
  }
}

template <bool kDrop, int LD>
cudaError_t attn_fwd_tc_launch(const float* q, const float* k, const float* v, const Scores& sc,
                               const int* seed, float* out, float* lse, int B, int L, int S,
                               int H, int hd, int vec, uint32_t threshold, float inv_keep,
                               cudaStream_t stream) {
  constexpr size_t smem = attn_fwd_smem<LD>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_tc_kernel<kDrop, LD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)B * (unsigned)H, (unsigned)((L + kFwdRows - 1) / kFwdRows));
  attn_fwd_tc_kernel<kDrop, LD><<<grid, kFwdThreads, smem, stream>>>(
      q, k, v, sc, seed, out, lse, L, S, H, hd, vec, threshold, inv_keep);
  return cudaGetLastError();
}

// The forward for q (B, L, H*hd), k and v (B, S, H*hd) and out (B, L, H*hd),
// contiguous float32, hd in 1..128; with kDrop, the keep mask of `seed` and
// `threshold`, kept probabilities scaled by inv_keep, and lse (B, H, L).
template <bool kDrop>
cudaError_t attn_fwd_tc(const float* q, const float* k, const float* v, const Scores& sc,
                        const int* seed, float* out, float* lse, int B, int L, int S, int H,
                        int hd, uint32_t threshold, float inv_keep, cudaStream_t stream) {
  if (B < 0 || L < 0 || S < 0 || H < 1 || hd < 1 || hd > kFwdMaxHd) return cudaErrorInvalidValue;
  if (B == 0 || L == 0) return cudaSuccess;
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec = hd % 4 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(out);
  switch ((hd + 31) / 32) {
    case 1:
      return attn_fwd_tc_launch<kDrop, 32>(q, k, v, sc, seed, out, lse, B, L, S, H, hd, vec,
                                           threshold, inv_keep, stream);
    case 2:
      return attn_fwd_tc_launch<kDrop, 64>(q, k, v, sc, seed, out, lse, B, L, S, H, hd, vec,
                                           threshold, inv_keep, stream);
    case 3:
      return attn_fwd_tc_launch<kDrop, 96>(q, k, v, sc, seed, out, lse, B, L, S, H, hd, vec,
                                           threshold, inv_keep, stream);
    default:
      return attn_fwd_tc_launch<kDrop, 128>(q, k, v, sc, seed, out, lse, B, L, S, H, hd, vec,
                                            threshold, inv_keep, stream);
  }
}

}  // namespace
