// Multi-head attention with dropout on the probabilities, forward and
// backward, for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel recboard_tpu/ops/attention.py:mha_dropout_pallas:
// _mha_drop_fwd_kernel and _mha_drop_bwd_kernel behind the custom VJP of
// _mha_dropout_fused. Per (batch row b, head h):
//   x    = Q K^T * scale + causal/key-pad mask + bias[b, h]   (masked: x <= NEG_INF/2)
//   P    = softmax(x) over the unmasked keys (a row with none gives zeros)
//   out  = (P * keep / (1 - rate)) V
// with keep(l, s) = bits(seed, b*H + h, l*S + s) >= threshold, a counter-based
// hash evaluated where it is used and never stored. The hash is the one the
// JAX kernel uses in interpret mode (_keep_mask), keyed by the batch ROW, so
// at B = 1 the masks agree bit for bit and at B > 1 every row draws its own.
// The bias is shared across the batch or given per batch row (BSARec's and
// UniSRec's additive -1e4 mask, (B, 1, L, S)), read through its strides. The
// backward returns dq, dk, dv and, when asked, dbias summed over the batch
// (for a shared bias only):
//   Pd    = keep ? P / (1 - rate) : 0
//   dS    = P * ((keep ? dO V^T / (1 - rate) : 0) - delta),  delta = rowsum(dO * O)
//   dV    = Pd^T dO,  dK = dS^T Q * scale,  dQ = dS K * scale
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
//   * the backward (attn_bwd_tc_kernel, FlashAttention-2's backward walked
//     key-major) runs one block of 4 warps per batch*head. It reads lse and
//     computes delta (equal to the JAX kernel's sum(dP_dropped * P), since
//     out used the same keep mask) once per row into shared memory, then
//     walks 64-key tiles, each warp owning 16 keys (the m of mma.sync
//     m16n8k8), and for each key tile the query tiles (16 rows where
//     hd > 32, 32 at hd <= 32). K, V, Q and dO are staged by cp.async, in
//     place from the (B, L, H*hd) layout, into mma_tf32.cuh's swizzled
//     tiles. S^T = K Q^T and dP^T = V dO^T run on the tensor cores as
//     3xTF32, so the C fragments hold keys by rows and queries by columns;
//     P and the keep mask (one bit an entry) are made in those registers,
//     dV += Pd^T dO is taken before dP^T is formed, then dS^T and
//     dK += dS^T Q. Both take their A operand from the C fragments by quad
//     shuffles (p_fragment); dK and dV stay in registers across the query
//     tiles and are written once. dQ needs dS with queries by rows: it goes
//     once to a swizzled shared tile (over Q and dO, which are consumed by
//     then), read by ldmatrix, and each warp adds 16 rows by a share of the
//     columns of dS K to dq. The block owns every row of its (b, h), so dq
//     takes no atomics: the first key tile writes, later ones add, and rows
//     that no key tile visits are zeroed. Each product's share of a tile
//     goes to fresh registers and is added in float32 (the tensor cores
//     truncate as they accumulate). dq, dk and dv rerun to the same bits;
//     dbias, shared by the whole batch and on no model path, takes
//     atomicAdd from the dS^T fragments, so its bits may change from run to
//     run;
//   * with causal masking and no bias both passes skip the (query, key) tiles
//     that the mask hides, and a warp's products start at the first query
//     its keys are visible to;
//   * 4 backward blocks an SM at hd <= 64 (registers capped at 128, 41 KB
//     of shared memory a block at hd 64), so SASRec's 512 (b, h) pairs run
//     in one wave.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_fwd_tc.cuh"

namespace {

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kBwdKeys = 16 * kBwdWarps;  // keys per tile, 16 a warp
constexpr size_t kMaxSmem = 232448;       // the most a block may ask for on an H100
static_assert(kBwdThreads == kFwdThreads, "stage_head strides by kFwdThreads");

// Query rows per tile: 16 where hd > 32 (SASRec's 64: S^T and dP^T in 16
// registers, no spills at the 128-register cap), 32 at hd <= 32
// (BERT4Rec's 16: half the barriers and tile loads per row)
__host__ __device__ constexpr int bwd_rows(int LD) { return LD <= 32 ? 32 : 16; }

// K, V, Q and dO tiles (dS lies over Q and dO), then lse and delta
size_t bwd_smem_bytes(int LD, int L) {
  const size_t rows = bwd_rows(LD);
  return sizeof(float) * ((2 * (size_t)kBwdKeys + 2 * rows) * LD + 2 * (size_t)L);
}

constexpr int bwd_min_blocks(int LD) { return LD <= 64 ? 4 : 1; }

// acc += A B for a 16-key strip: A from the C fragments `a_c` (keys by
// rows, the query tile's 8-wide tiles [jb, je) by columns; with kKeep,
// entry (j, e) kept where bit 4j + e of `keep` is set, then scaled by
// inv_keep, else 0), B the rows of `tile` (queries by rows, d by columns).
// Each 8-query step's product goes to fresh registers, added in float32.
template <int LD, int QT, bool kKeep>
__device__ __forceinline__ void strip_accumulate(float (&acc)[LD / 8][4], float (&a_c)[QT][4],
                                                 uint32_t keep, float inv_keep,
                                                 const float* tile, int jb, int je, int kd,
                                                 int g, int t) {
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    if (j < jb || j >= je) continue;
    float c[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[e] = !kKeep ? a_c[j][e] : (keep >> (4 * j + e) & 1u) ? a_c[j][e] * inv_keep : 0.f;
    FragA a;
    p_fragment(a, c, g, t);
#pragma unroll
    for (int i = 0; i < LD / 8; ++i) {
      if (8 * i >= kd) break;
      FragB bf;
      load_b_cols(bf, tile, 8 * j, 8 * i, LD, g, t);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32(part, a, bf);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += part[e];
    }
  }
}

// two adjacent entries of a row (d even), as one 8-byte store where `vec`
// (hd a multiple of 4: d < hd means d + 1 < hd); added to what is there
// unless `write`
__device__ __forceinline__ void put2(float* row, int d, int hd, float a, float c, bool vec,
                                     bool write) {
  if (vec) {
    float2* p = reinterpret_cast<float2*>(row + d);
    if (!write) {
      const float2 o = *p;
      a += o.x;
      c += o.y;
    }
    *p = make_float2(a, c);
  } else {
    row[d] = write ? a : row[d] + a;
    if (d + 1 < hd) row[d + 1] = write ? c : row[d + 1] + c;
  }
}

// grid (B*H), kBwdThreads threads. LD: hd rounded up to 32.
template <int LD>
__global__ void __launch_bounds__(kBwdThreads, bwd_min_blocks(LD))
attn_bwd_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ out,
                   const float* __restrict__ dout, const float* __restrict__ lse, Scores sc,
                   const int* __restrict__ seed, float* __restrict__ dq,
                   float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dbias,
                   int L, int S, int H, int hd, int vec, uint32_t threshold, float inv_keep) {
  static_assert(LD % 32 == 0 && LD <= kFwdMaxHd, "LD: a multiple of 32 up to 128");
  constexpr int NT = LD / 8;         // 8-wide column tiles of dK, dV and dQ
  constexpr int kBwdRows = bwd_rows(LD);  // query rows per tile
  constexpr int kQT = kBwdRows / 8;       // 8-wide query tiles of S^T and dP^T
  constexpr int kMT = kBwdRows / 16;      // 16-row tiles of dQ
  constexpr int kDqSplit = kBwdWarps / kMT;  // warps sharing a 16-row tile of dQ
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                    // kBwdKeys x LD
  float* v_s = k_s + kBwdKeys * LD;     // kBwdKeys x LD
  float* q_s = v_s + kBwdKeys * LD;     // kBwdRows x LD
  float* do_s = q_s + kBwdRows * LD;    // kBwdRows x LD
  float* ds_s = q_s;                    // kBwdRows x kBwdKeys, once Q and dO are consumed
  float* lse_s = do_s + kBwdRows * LD;  // L
  float* delta_s = lse_s + L;           // L

  const int pid = blockIdx.x;  // b*H + h: keys the dropout hash and lse's rows
  const int b = pid / H, h = pid - b * H;
  if (sc.bias != nullptr) sc.bias += b * sc.sb;  // the batch row's bias (sb 0 if shared)
  const int64_t D = (int64_t)H * hd, head = (int64_t)h * hd;
  const int kd = (hd + 7) & ~7;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int kw = 16 * warp;  // the warp's first key in the tile
  const bool skip_hidden = sc.causal && sc.bias == nullptr;
  const uint32_t base = hash_base(seed, pid);
  const int64_t qoff = (int64_t)b * L * D, koff = (int64_t)b * S * D;
  const uint8_t* pad = sc.key_pad == nullptr ? nullptr : sc.key_pad + (int64_t)b * S;
  // the first query tile that can see a key of the tile at s0
  const auto first_row = [&](int s0) {
    return skip_hidden ? max(0, s0 - sc.offset) / kBwdRows * kBwdRows : 0;
  };

  for (int s0 = 0; s0 < S; s0 += kBwdKeys) {
    __syncthreads();  // every warp is done with the previous K and V tiles
    stage_head<kBwdKeys, LD>(k_s, k + koff, S, s0, D, head, hd, kd, vec);
    stage_head<kBwdKeys, LD>(v_s, v + koff, S, s0, D, head, hd, kd, vec);
    int q0 = first_row(s0);
    if (q0 < L) {
      stage_head<kBwdRows, LD>(q_s, q + qoff, L, q0, D, head, hd, kd, vec);
      stage_head<kBwdRows, LD>(do_s, dout + qoff, L, q0, D, head, hd, kd, vec);
    }
    cp_async_commit();
    if (s0 == 0) {
      // per-row statistics while the tiles land: the forward's lse, and
      // delta = rowsum(dO * O) by a quad of lanes a row; dq rows that no key
      // tile visits (causal, L > S) are zeros
      for (int l = threadIdx.x; l < L; l += kBwdThreads) lse_s[l] = lse[(int64_t)pid * L + l];
      const int zero_rows = q0;
      for (int l0 = 0; l0 < L; l0 += kBwdThreads / 4) {
        const int l = l0 + threadIdx.x / 4;
        float acc = 0.f;
        if (l < L) {
          const int64_t row = qoff + l * D + head;
#pragma unroll 4
          for (int d = t; d < hd; d += 4) acc = fmaf(out[row + d], dout[row + d], acc);
          if (l < zero_rows)
            for (int d = t; d < hd; d += 4) dq[row + d] = 0.f;
        }
        acc += __shfl_xor_sync(kFull, acc, 1);
        acc += __shfl_xor_sync(kFull, acc, 2);
        if (l < L && t == 0) delta_s[l] = acc;
      }
    }

    const bool warp_live = s0 + kw < S;
    // the first row that sees the warp's first key, under causal masking
    // without bias
    const int wfirst = s0 + kw - sc.offset;
    bool pad_masked[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s = s0 + kw + g + 8 * hh;
      pad_masked[hh] = pad != nullptr && s < S && pad[s] != 0;
    }
    // dK and dV of the warp's 16 keys: C fragments, keys by rows, d by columns
    float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

    for (; q0 < L; q0 += kBwdRows) {
      cp_async_wait<0>();
      __syncthreads();  // K, V, Q and dO have landed; the statistics are ready

      // the warp's 8-wide query tiles [jb, je): rows in range that can see
      // one of its keys
      const int je = (min(kBwdRows, L - q0) + 7) / 8;
      const int jb = skip_hidden ? min(je, max(0, wfirst - q0) / 8) : 0;
      const bool active = warp_live && jb < je;
      // S^T, then P (x), and dP^T, then dS^T (dp): keys s0 + kw + g (+8) by
      // rows, queries q0 + 8j + 2t (+1) by columns; bit 4j + e of `keep`
      // holds the keep mask of entry (j, e)
      float x[kQT][4], dp[kQT][4];
      uint32_t keep = 0;
#pragma unroll
      for (int j = 0; j < kQT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] = dp[j][e] = 0.f;
      if (active) {
#pragma unroll
        for (int k0 = 0; k0 < LD; k0 += 8) {
          if (k0 >= kd) break;
          FragA a;
          load_a(a, k_s, kw, k0, LD);
#pragma unroll
          for (int j = 0; j < kQT; j += 2) {
            if (j >= je) break;
            if (j + 2 <= jb) continue;
            FragB bq[2];
            load_b_rows2(bq, q_s, 8 * j, k0, LD);
            mma_3xtf32(x[j], a, bq[0]);
            mma_3xtf32(x[j + 1], a, bq[1]);
          }
        }
#pragma unroll
        for (int j = 0; j < kQT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e >> 1, s = s0 + kw + g + 8 * hh, l = q0 + 8 * j + 2 * t + (e & 1);
            float p = 0.f;
            if (j >= jb && j < je && l < L && s < S) {
              const float xs = sc(x[j][e], h, l, s, pad_masked[hh]);
              if (xs > 0.5f * kNegInf) {
                p = expf(xs - lse_s[l]);  // 0 where lse is +inf
                if (kept(base, l, S, s, threshold)) keep |= 1u << (4 * j + e);
              }
            }
            x[j][e] = p;
          }
        // dV += Pd^T dO, with Pd = keep ? P * inv_keep : 0
        strip_accumulate<LD, kQT, true>(dv_acc, x, keep, inv_keep, do_s, jb, je, kd, g, t);
#pragma unroll
        for (int k0 = 0; k0 < LD; k0 += 8) {
          if (k0 >= kd) break;
          FragA a;
          load_a(a, v_s, kw, k0, LD);
#pragma unroll
          for (int j = 0; j < kQT; j += 2) {
            if (j >= je) break;
            if (j + 2 <= jb) continue;
            FragB bd[2];
            load_b_rows2(bd, do_s, 8 * j, k0, LD);
            mma_3xtf32(dp[j], a, bd[0]);
            mma_3xtf32(dp[j + 1], a, bd[1]);
          }
        }
        // dS = P * ((keep ? dP * inv_keep : 0) - delta): 0 wherever P is
#pragma unroll
        for (int j = 0; j < kQT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int l = q0 + 8 * j + 2 * t + (e & 1);
            float ds = 0.f;
            if (x[j][e] != 0.f) {
              const float dpk = (keep >> (4 * j + e) & 1u) ? dp[j][e] * inv_keep : 0.f;
              ds = x[j][e] * (dpk - delta_s[l]);
              if (dbias != nullptr)
                atomicAdd(dbias + ((int64_t)h * L + l) * S + s0 + kw + g + 8 * (e >> 1), ds);
            }
            dp[j][e] = ds;
          }
        // dK += dS^T Q (scaled when written)
        strip_accumulate<LD, kQT, false>(dk_acc, dp, 0u, 1.f, q_s, jb, je, kd, g, t);
      }
      __syncthreads();  // every warp is done with Q and dO: dS goes over them
      // dS with queries by rows, keys by columns: the A operand of dQ
#pragma unroll
      for (int j = 0; j < kQT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds_s[at(8 * j + 2 * t + (e & 1), kw + g + 8 * (e >> 1), kBwdKeys)] = dp[j][e];
      __syncthreads();  // dS is whole

      // dQ += dS K * scale: the warp's 16 rows (mt) by every kDqSplit-th
      // column tile from `col`, the key tile's share in fresh registers
      {
        const int mt = warp % kMT, col = warp / kMT, r0 = q0 + 16 * mt;
        if (r0 < L) {
          int kend = min(kBwdKeys, S - s0);
          if (skip_hidden) kend = min(kend, min(r0 + 15, L - 1) + sc.offset - s0 + 1);
          float part[NT / kDqSplit][4];
#pragma unroll
          for (int i = 0; i < NT / kDqSplit; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
          for (int k0 = 0; k0 < kBwdKeys; k0 += 8) {
            if (k0 >= kend) break;
            FragA a;
            load_a(a, ds_s, 16 * mt, k0, kBwdKeys);
#pragma unroll
            for (int i = 0; i < NT / kDqSplit; ++i) {
              if (8 * (col + kDqSplit * i) >= kd) break;
              FragB bk;
              load_b_cols(bk, k_s, k0, 8 * (col + kDqSplit * i), LD, g, t);
              mma_3xtf32(part[i], a, bk);
            }
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int l = r0 + g + 8 * hh;
            if (l >= L) continue;
            float* row = dq + qoff + l * D + head;
#pragma unroll
            for (int i = 0; i < NT / kDqSplit; ++i) {
              const int d = 8 * (col + kDqSplit * i) + 2 * t;
              if (d >= hd) break;
              put2(row, d, hd, part[i][2 * hh] * sc.scale, part[i][2 * hh + 1] * sc.scale,
                   vec, s0 == 0);
            }
          }
        }
      }
      __syncthreads();  // dS is consumed: the next Q and dO go over it
      if (q0 + kBwdRows < L) {
        stage_head<kBwdRows, LD>(q_s, q + qoff, L, q0 + kBwdRows, D, head, hd, kd, vec);
        stage_head<kBwdRows, LD>(do_s, dout + qoff, L, q0 + kBwdRows, D, head, hd, kd, vec);
        cp_async_commit();
      }
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s = s0 + kw + g + 8 * hh;
      if (s >= S) continue;
      float* krow = dk + koff + s * D + head;
      float* vrow = dv + koff + s * D + head;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int d = 8 * i + 2 * t;
        if (d >= hd) break;
        put2(krow, d, hd, dk_acc[i][2 * hh] * sc.scale, dk_acc[i][2 * hh + 1] * sc.scale,
             vec, true);
        put2(vrow, d, hd, dv_acc[i][2 * hh], dv_acc[i][2 * hh + 1], vec, true);
      }
    }
  }
}

template <int LD>
cudaError_t attn_bwd_tc_launch(const float* q, const float* k, const float* v, const float* out,
                               const float* dout, const float* lse, const Scores& sc,
                               const int* seed, float* dq, float* dk, float* dv, float* dbias,
                               int B, int L, int S, int H, int hd, int vec, uint32_t threshold,
                               float inv_keep, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(LD, L);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_tc_kernel<LD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  attn_bwd_tc_kernel<LD><<<(unsigned)B * (unsigned)H, kBwdThreads, smem, stream>>>(
      q, k, v, out, dout, lse, sc, seed, dq, dk, dv, dbias, L, S, H, hd, vec, threshold,
      inv_keep);
  return cudaGetLastError();
}

bool bad_shape(int B, int L, int S, int H, int hd) {
  return B < 0 || L < 0 || S < 0 || H < 1 || hd < 1 || hd > kFwdMaxHd;
}

}  // namespace

// q (B, L, H*hd), k and v (B, S, H*hd), out (B, L, H*hd): contiguous float32.
// key_pad: (B, S) bytes, nonzero = masked, or null. bias: null, or a float32
// tensor read at b*sb + h*sh + l*sl + s*ss (strides in elements, 0 on a
// broadcast dimension; sb 0 where the bias is shared across the batch). seed: one int32 in device memory. lse: (B, H, L)
// float32, written. Keeps a probability where its hash is >= threshold and
// scales the kept ones by inv_keep. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int mha_dropout_fwd_f32(const float* q, const float* k, const float* v,
                                   const uint8_t* key_pad, const float* bias,
                                   long long bias_sb, long long bias_sh, long long bias_sl,
                                   long long bias_ss, const int* seed, float* out,
                                   float* lse, int B, int L, int S, int H, int hd,
                                   float scale, int causal, unsigned threshold,
                                   float inv_keep, void* stream) {
  const Scores sc{key_pad, bias, bias_sh, bias_sl, bias_ss, scale, causal, S - L, bias_sb};
  return (int)attn_fwd_tc<true>(q, k, v, sc, seed, out, lse, B, L, S, H, hd, threshold,
                                inv_keep, (cudaStream_t)stream);
}

// The backward of mha_dropout_fwd_f32 for the same inputs, its out and lse,
// and dout (B, L, H*hd). dq, dk and dv are written, every entry (nothing is
// written when B or S is 0). dbias: null, or an (H, L, S) float32 tensor
// holding zeros, to which dS summed over the batch is added; only for a bias
// shared across the batch (bias_sb 0).
extern "C" int mha_dropout_bwd_f32(const float* q, const float* k, const float* v,
                                   const float* out, const float* dout, const float* lse,
                                   const uint8_t* key_pad, const float* bias,
                                   long long bias_sb, long long bias_sh, long long bias_sl,
                                   long long bias_ss, const int* seed, float* dq,
                                   float* dk, float* dv, float* dbias, int B, int L,
                                   int S, int H, int hd, float scale, int causal,
                                   unsigned threshold, float inv_keep, void* stream) {
  if (bad_shape(B, L, S, H, hd)) return (int)cudaErrorInvalidValue;
  if (dbias != nullptr && bias_sb != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const Scores sc{key_pad, bias, bias_sh, bias_sl, bias_ss, scale, causal, S - L, bias_sb};
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec = hd % 4 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(dout) &&
                  aligned(dq) && aligned(dk) && aligned(dv);
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((hd + 31) / 32) {
    case 1:
      return (int)attn_bwd_tc_launch<32>(q, k, v, out, dout, lse, sc, seed, dq, dk, dv, dbias,
                                         B, L, S, H, hd, vec, threshold, inv_keep, st);
    case 2:
      return (int)attn_bwd_tc_launch<64>(q, k, v, out, dout, lse, sc, seed, dq, dk, dv, dbias,
                                         B, L, S, H, hd, vec, threshold, inv_keep, st);
    case 3:
      return (int)attn_bwd_tc_launch<96>(q, k, v, out, dout, lse, sc, seed, dq, dk, dv, dbias,
                                         B, L, S, H, hd, vec, threshold, inv_keep, st);
    default:
      return (int)attn_bwd_tc_launch<128>(q, k, v, out, dout, lse, sc, seed, dq, dk, dv,
                                          dbias, B, L, S, H, hd, vec, threshold, inv_keep, st);
  }
}
