// recboard_tpu_torch native — host-side negative sampling in C++.
//
// A copy of the sampler in recboard_tpu's native/recboard_native.cpp: the
// same xorshift128+ stream seeded through splitmix64, the same draw and
// rejection order, so the same seed gives the same negatives in both
// packages. Exposed through a C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC -o librecboard_native.so recboard_native.cpp
extern "C" {

#include <cstdint>

// xorshift128+ PRNG — deterministic per (seed, stream)
struct Rng {
  uint64_t s0, s1;
};

static inline uint64_t splitmix64(uint64_t& x) {
  x += 0x9E3779B97f4A7C15ULL;
  uint64_t z = x;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

static inline void rng_seed(Rng* r, uint64_t seed) {
  uint64_t x = seed;
  r->s0 = splitmix64(x);
  r->s1 = splitmix64(x);
}

static inline uint64_t rng_next(Rng* r) {
  uint64_t x = r->s0, y = r->s1;
  r->s0 = y;
  x ^= x << 23;
  r->s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
  return r->s1 + y;
}

static inline int64_t rng_below(Rng* r, int64_t n) {
  return (int64_t)(rng_next(r) % (uint64_t)n);
}

// binary search membership in a sorted int64 array
static inline bool contains(const int64_t* arr, int64_t n, int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    if (arr[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo < n && arr[lo] == v;
}

// Sample `num_negs` uniform negatives per row, rejecting the row's
// user's seen items (CSR: seen_indptr over users, sorted seen_items).
// out: (n_rows * num_negs) int64.
void sample_negatives(
    const int64_t* users, int64_t n_rows, int64_t num_negs,
    const int64_t* seen_indptr, const int64_t* seen_items,
    int64_t n_items, uint64_t seed, int64_t* out) {
  Rng rng;
  rng_seed(&rng, seed);
  for (int64_t i = 0; i < n_rows; ++i) {
    const int64_t u = users[i];
    const int64_t* seen = seen_items + seen_indptr[u];
    const int64_t n_seen = seen_indptr[u + 1] - seen_indptr[u];
    for (int64_t k = 0; k < num_negs; ++k) {
      int64_t cand = rng_below(&rng, n_items);
      int tries = 0;
      while (contains(seen, n_seen, cand) && tries < 128) {
        cand = rng_below(&rng, n_items);
        ++tries;
      }
      out[i * num_negs + k] = cand;
    }
  }
}

}  // extern "C"
