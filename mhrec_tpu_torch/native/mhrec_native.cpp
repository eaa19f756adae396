// Native host-side data ops for mhrec_tpu_torch (a copy of the JAX
// package's mhrec_tpu/native/mhrec_native.cpp).
//
// The training input pipeline's irregular hot path is negative sampling:
// per-sample without-replacement draws excluding a per-row blacklist
// (reference trainset.py:70-108 runs this in Python DataLoader workers).
// These OpenMP kernels draw whole batches in parallel; exposed through
// ctypes with a numpy fallback (mhrec_tpu_torch/native/__init__.py).
//
// Hot-loop engineering (the prior protocol draws 8 category pools x
// B x K/B negatives per batch, and the host has few cores to hide it):
//   * splitmix64 RNG (one multiply-mix per draw; mt19937_64's large state
//     and init cost dominated the old per-row profile),
//   * Lemire multiply-shift bounded draw (no modulo, no rejection),
//   * open-addressing linear-probe taboo set in a per-row flat buffer
//     (std::unordered_set spent the time in node allocation + hashing).
//
// Built at first use by mhrec_tpu_torch/native/__init__.py:
//   g++ -O3 -fopenmp -shared -fPIC mhrec_native.cpp -o <mhrec_tpu_torch/_build>/libmhrec_native-<digest>.so

#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline uint64_t mix64(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

inline uint64_t mix_seed(uint64_t seed, uint64_t row) {
  return mix64(seed + 0x9E3779B97F4A7C15ULL * (row + 1));
}

struct Rng {  // splitmix64 stream
  uint64_t s;
  inline uint64_t next() {
    return mix64(s += 0x9E3779B97F4A7C15ULL);
  }
  inline uint64_t bounded(uint64_t n) {  // Lemire multiply-shift
    return (uint64_t)(((__uint128_t)next() * n) >> 64);
  }
  inline double uniform01() {  // [0, 1) with 53 random bits
    return (double)(next() >> 11) * 0x1.0p-53;
  }
};

// Open-addressing linear-probe set over non-negative int64 keys.
// Capacity is a power of two >= 2x the maximum load; EMPTY = -1.
struct TabooSet {
  int64_t* slots;
  uint64_t mask;

  static uint64_t cap_for(uint64_t n) {
    uint64_t c = 16;
    while (c < 2 * n + 8) c <<= 1;
    return c;
  }

  void init(std::vector<int64_t>& buf, uint64_t cap) {
    buf.assign(cap, -1);
    slots = buf.data();
    mask = cap - 1;
  }

  inline uint64_t slot(int64_t v) const {
    return (mix64((uint64_t)v) * 0x9E3779B97F4A7C15ULL) >> 1 & mask;
  }

  // true if newly inserted, false if already present
  inline bool insert(int64_t v) {
    uint64_t i = slot(v);
    while (true) {
      int64_t s = slots[i];
      if (s == v) return false;
      if (s < 0) { slots[i] = v; return true; }
      i = (i + 1) & mask;
    }
  }

  inline bool contains(int64_t v) const {
    uint64_t i = slot(v);
    while (true) {
      int64_t s = slots[i];
      if (s == v) return true;
      if (s < 0) return false;
      i = (i + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

// Uniform negatives without replacement from items [1, item_num), excluding
// a per-row blacklist (0 entries ignored). out: [B, K]; blacklist: [B, Lb].
void sample_negatives_uniform(int64_t* out, int64_t B, int64_t K,
                              const int64_t* blacklist, int64_t Lb,
                              int64_t item_num, uint64_t seed) {
#pragma omp parallel
  {
    std::vector<int64_t> buf;
#pragma omp for schedule(static)
    for (int64_t b = 0; b < B; ++b) {
      Rng rng{mix_seed(seed, (uint64_t)b)};
      TabooSet taboo;
      taboo.init(buf, TabooSet::cap_for((uint64_t)(Lb + K)));
      for (int64_t j = 0; j < Lb; ++j) {
        int64_t v = blacklist[b * Lb + j];
        if (v > 0) taboo.insert(v);
      }
      int64_t n = 0;
      int64_t guard = 0;
      const int64_t max_tries = 64 * K + 1024;
      while (n < K && guard < max_tries) {
        ++guard;
        int64_t cand = 1 + (int64_t)rng.bounded((uint64_t)(item_num - 1));
        if (taboo.insert(cand)) out[b * K + n++] = cand;
      }
      // degenerate corpora: fill remaining with-replacement
      while (n < K) {
        out[b * K + n++] = 1 + (int64_t)rng.bounded((uint64_t)(item_num - 1));
      }
    }
  }
}

// Pool-based variant: candidates drawn uniformly from pool[0..pool_n).
void sample_negatives_pool(int64_t* out, int64_t B, int64_t K,
                           const int64_t* blacklist, int64_t Lb,
                           const int64_t* pool, int64_t pool_n,
                           uint64_t seed) {
#pragma omp parallel
  {
    std::vector<int64_t> buf;
#pragma omp for schedule(static)
    for (int64_t b = 0; b < B; ++b) {
      Rng rng{mix_seed(seed, (uint64_t)b)};
      TabooSet taboo;
      taboo.init(buf, TabooSet::cap_for((uint64_t)(Lb + K)));
      for (int64_t j = 0; j < Lb; ++j) {
        int64_t v = blacklist[b * Lb + j];
        if (v > 0) taboo.insert(v);
      }
      int64_t n = 0;
      int64_t guard = 0;
      const int64_t max_tries = 64 * K + 1024;
      while (n < K && guard < max_tries) {
        ++guard;
        int64_t cand = pool[rng.bounded((uint64_t)pool_n)];
        if (taboo.insert(cand)) out[b * K + n++] = cand;
      }
      // pool nearly exhausted: accept repeats of (possibly blacklisted)
      // items rather than spin forever — same terminal behavior as before
      while (n < K) {
        out[b * K + n++] = pool[rng.bounded((uint64_t)pool_n)];
      }
    }
  }
}

// Weighted (popularity CDF) variant: with replacement, blacklist-rejected.
// cdf: [pool_n] nondecreasing in (0, 1].
void sample_negatives_weighted(int64_t* out, int64_t B, int64_t K,
                               const int64_t* blacklist, int64_t Lb,
                               const int64_t* pool, const double* cdf,
                               int64_t pool_n, uint64_t seed) {
#pragma omp parallel
  {
    std::vector<int64_t> buf;
#pragma omp for schedule(static)
    for (int64_t b = 0; b < B; ++b) {
      Rng rng{mix_seed(seed, (uint64_t)b)};
      TabooSet taboo;
      taboo.init(buf, TabooSet::cap_for((uint64_t)Lb));
      for (int64_t j = 0; j < Lb; ++j) {
        int64_t v = blacklist[b * Lb + j];
        if (v > 0) taboo.insert(v);
      }
      int64_t n = 0;
      int64_t guard = 0;
      const int64_t max_tries = 64 * K + 1024;
      while (n < K) {
        double u = rng.uniform01();
        int64_t lo = 0, hi = pool_n - 1;
        while (lo < hi) {
          int64_t mid = (lo + hi) / 2;
          if (cdf[mid] < u) lo = mid + 1; else hi = mid;
        }
        int64_t cand = pool[lo];
        ++guard;
        if (guard < max_tries && taboo.contains(cand)) continue;
        out[b * K + n++] = cand;
      }
    }
  }
}

}  // extern "C"
