// Float32-accurate tile products on Hopper's tensor cores (sm_90a) through
// mma.sync m16n8k8 TF32, for the kernels of vocab_ce.cu, K5's backward
// (sampled_softmax.cu) and the attention kernels (attn_fwd_tc.cuh,
// mha_dropout.cu's backward).
//
// Split precision ("3xTF32"): each float32 operand x is cut into
// hi = tf32(x) and lo = tf32(x - hi), both rounded as cvt.rna rounds (done
// with integer operations, which give the same bits faster), and a product
// is lo*hi + hi*lo + hi*hi accumulated in float32 (the two small terms
// first, as CUTLASS's 3xTF32 does). A TF32 product of two such operands is
// exact in float32, so the result keeps float32 accuracy at three
// tensor-core products where one alone keeps about three digits. The split
// is done in registers as fragments are loaded, so shared memory holds the
// float32 tiles only; or once per tile (split_tile, SplitTile), where many
// warps read one tile.
//
// Shared tiles are row-major with `ld` floats a row (a multiple of 32), the
// 16-byte chunks of each row permuted by an XOR of the row's low three bits:
// element (r, c) lies at r * ld + (c ^ swz(r)). Both fragment patterns of
// m16n8k8 then hit 32 distinct banks: 8 rows x 4 columns (an A fragment, or
// a B fragment read along the tile's rows) and 4 rows x 8 columns (a B
// fragment read down its columns). One copy of a tile thus serves as the
// B operand of C = A B^T (n = tile row) and of C = A B (k = tile row).
//
// Fragments (g = lane / 4, t = lane % 4): A a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, n g), b1 (k t + 4, n g);
// C c0, c1 (g, 2t and 2t + 1), c2, c3 (g + 8, 2t and 2t + 1).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }

__device__ __forceinline__ int at(int r, int c, int ld) { return r * ld + (c ^ swz(r)); }

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

// the bits of x rounded to TF32 (10 mantissa bits), to nearest with ties
// away from zero: for finite x what cvt.rna.tf32.f32 gives, in two integer
// operations where the conversion runs at a quarter of the float32 rate
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, each a TF32 value rounded as cvt.rna rounds
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));  // x - hi is exact in float32
}

// c += a b for one 16 x 8 x 8 tile: TF32 operands, float32 accumulator
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b at float32 accuracy: the small products first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float c[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// ldmatrix reads 8 x 4 blocks of 32-bit words (8 x 8 of 16 bits), lane l
// giving the address of row l % 8 of block l / 8; word (g, t) of each block
// lands in lane 4g + t, which is the A fragment's and the B fragment's
// layout. (Its .trans form moves 16-bit halves, so a B fragment read down a
// tile's columns is loaded word by word.)
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const float* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// this lane's ldmatrix address in a tile for the A fragment of rows m0..
// and columns k0..
__device__ __forceinline__ int a_offset(int m0, int k0, int ld) {
  const int l = threadIdx.x % 32, blk = l / 8;
  return at(m0 + l % 8 + 8 * (blk & 1), k0 + 4 * (blk >> 1), ld);
}

// the A fragment of rows m0.. and columns k0.. of a tile (ld floats a row)
__device__ __forceinline__ void load_a(FragA& a, const float* s, int m0, int k0, int ld) {
  uint32_t r[4];
  ldmatrix_x4(r, s + a_offset(m0, k0, ld));
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(__uint_as_float(r[q]), a.hi[q], a.lo[q]);
}

// the B fragments (k0.., n0..) and (k0.., n0 + 8..) of B = tile^T: tile
// rows are n, columns k
__device__ __forceinline__ void load_b_rows2(FragB b[2], const float* s, int n0, int k0,
                                             int ld) {
  const int l = threadIdx.x % 32, blk = l / 8;
  uint32_t r[4];
  ldmatrix_x4(r, s + at(n0 + l % 8 + 8 * (blk >> 1), k0 + 4 * (blk & 1), ld));
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    split_tf32(__uint_as_float(r[2 * j]), b[j].hi[0], b[j].lo[0]);
    split_tf32(__uint_as_float(r[2 * j + 1]), b[j].hi[1], b[j].lo[1]);
  }
}

// A tile split once into its TF32 hi and lo parts (split_tile), held as two
// tiles of one layout: its A fragments load with no split
struct SplitTile {
  const float* hi;
  const float* lo;
};

__device__ __forceinline__ void load_a(FragA& a, SplitTile s, int m0, int k0, int ld) {
  const int o = a_offset(m0, k0, ld);
  ldmatrix_x4(a.hi, s.hi + o);
  ldmatrix_x4(a.lo, s.lo + o);
}

// the N floats of a staged tile (src) split into hi and lo tiles of the
// same layout, as split_tf32 splits them; src may be hi (split in place)
template <int N, int THREADS>
__device__ __forceinline__ void split_tile(const float* src, float* hi, float* lo) {
#pragma unroll
  for (int i = threadIdx.x; i < N / 4; i += THREADS) {
    const float4 x = reinterpret_cast<const float4*>(src)[i];
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    reinterpret_cast<uint4*>(hi)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

// the B fragment (k0.., n0..) of B = tile: tile rows are k, columns n
__device__ __forceinline__ void load_b_cols(FragB& b, const float* s, int k0, int n0, int ld,
                                            int g, int t) {
  split_tf32(s[at(k0 + t, n0 + g, ld)], b.hi[0], b.lo[0]);
  split_tf32(s[at(k0 + t + 4, n0 + g, ld)], b.hi[1], b.lo[1]);
}

// cp.async of `bytes` (4, 8 or 16) from global to shared memory; zeros when
// !valid (source size 0: nothing is read). 16-byte copies bypass L1.
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? bytes : 0;
  if constexpr (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(s), "l"(src),
                 "n"(bytes), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// waits until at most N of this thread's newest cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows m of a row-major (., D) float32 array into a swizzled tile of DP
// floats a row, tile row r taking array row m where row(r, m) is true and
// zeros where it is false; columns past D are zeros. 16-byte copies when
// vec (D a multiple of 4 and the array 16-byte aligned, so each 16-byte
// chunk is wholly inside or outside it), else 4-byte ones.
template <int ROWS, int DP, int THREADS, typename Row>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int D,
                                           bool vec, Row row) {
  if (vec) {
    constexpr int kChunks = DP / 4;
#pragma unroll
    for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
      const int r = i / kChunks, c = 4 * (i % kChunks);
      int64_t m;
      const bool ok = row(r, m) && c < D;
      cp_async<16>(dst + at(r, c, DP), ok ? src + m * D + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, c = i % DP;
      int64_t m;
      const bool ok = row(r, m) && c < D;
      cp_async<4>(dst + at(r, c, DP), ok ? src + m * D + c : src, ok);
    }
  }
}

// stage_rows' row map of rows [r0, r0 + ROWS) of an array of n rows
struct RowsFrom {
  int64_t r0, n;
  __device__ __forceinline__ bool operator()(int r, int64_t& m) const {
    m = r0 + r;
    return m < n;
  }
};

// ---- tile products shared by the kernels (K3's, and K5's backward)

// acc[i][j] = the logits (no bias) of tile rows rw + 16 i + (g, g + 8) and
// entries vw + 8 j + (2t, 2t + 1): rows of h_s times rows of w_s, over DP.
// h's tile is a float32 tile (split as fragments load) or a SplitTile;
// either way the products, and so the logits, have the same bits.
template <int DP, typename TileH>
__device__ __forceinline__ void tile_logits(TileH h_s, const float* w_s, int rw, int vw,
                                            float acc[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < DP; k0 += 8) {
    FragA a[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) load_a(a[i], h_s, rw + 16 * i, k0, DP);
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      FragB b[2];
      load_b_rows2(b, w_s, vw + 8 * j, k0, DP);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_3xtf32(acc[i][j + jj], a[i], b[jj]);
    }
  }
}

// the A fragment (m0.., k0..) of A = tile^T: tile rows are k, columns m.
// Each of its four words is a 4 x 8 read down the tile's columns, as
// load_b_cols reads, so the lanes hit 32 distinct banks
__device__ __forceinline__ void load_a_cols(FragA& a, const float* s, int m0, int k0, int ld,
                                            int g, int t) {
  split_tf32(s[at(k0 + t, m0 + g, ld)], a.hi[0], a.lo[0]);
  split_tf32(s[at(k0 + t, m0 + g + 8, ld)], a.hi[1], a.lo[1]);
  split_tf32(s[at(k0 + t + 4, m0 + g, ld)], a.hi[2], a.lo[2]);
  split_tf32(s[at(k0 + t + 4, m0 + g + 8, ld)], a.hi[3], a.lo[3]);
}

// out[i][j] += (A B) of A rows m0 + 16 i.. and B columns n0 + 8 j.. (b_s:
// rows k, LDB floats a row), over K. A is a_s (rows m, LDA floats a row),
// or with A_COLS a_s^T (a_s rows k, columns m): so one copy of a tile is
// the A operand of both A B and A^T B. The tensor cores truncate as they
// accumulate, which over a long sum drifts: so the tile's product is
// summed apart and added to out in float32 (rounded to nearest), once per
// tile.
template <int MT, int NT, int K, int LDA, int LDB, bool A_COLS = false>
__device__ __forceinline__ void mma_accumulate(const float* a_s, int m0, const float* b_s, int n0,
                                               int g, int t, float out[MT][NT][4]) {
  float part[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    FragA a[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if constexpr (A_COLS)
        load_a_cols(a[i], a_s, m0 + 16 * i, k0, LDA, g, t);
      else
        load_a(a[i], a_s, m0 + 16 * i, k0, LDA);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragB b;
      load_b_cols(b, b_s, k0, n0 + 8 * j, LDB, g, t);
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_3xtf32(part[i][j], a[i], b);
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) out[i][j][q] += part[i][j][q];
}

}  // namespace
