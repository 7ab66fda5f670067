// Count Sketch hash family for the CUDA kernels.
//
// Bit-identical to repro_torch/core/hashing.py (and to the JAX reference's
// repro/core/hashing.py): murmur3 fmix32 over the two 32-bit words of a
// 64-bit global element id, with per-row seeds computed on the host by
// hashing.bucket_seed / hashing.sign_seed and passed by value.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fs {

constexpr int kMaxRows = 10;   // len(hashing.ROW_SEEDS)

struct RowSeeds {
  uint32_t bucket[kMaxRows];
  uint32_t sign[kMaxRows];
};

inline RowSeeds make_seeds(const uint32_t* bucket, const uint32_t* sign,
                           int rows) {
  RowSeeds s{};
  for (int j = 0; j < rows; ++j) {
    s.bucket[j] = bucket[j];
    s.sign[j] = sign[j];
  }
  return s;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash64(uint32_t lo, uint32_t hi,
                                           uint32_t seed) {
  const uint32_t h = fmix32(lo ^ seed);
  return fmix32(h ^ hi ^ (seed * 0x9E3779B9u + 1u));
}

// h % d without a division (Lemire's fastmod for 32-bit operands), exact
// for every 32-bit h and every d in 1..2^31-1.  The host computes
// m = floor((2^64 - 1) / d) + 1 (mod 2^64; 0 for d = 1, which gives 0);
// count_sketch.fastmod_multiplier in the wrappers.  The product
// (m * h mod 2^64) * d >> 64 is __umul64hi(m * h, d), written out for a
// 32-bit d: two wide multiplies instead of a 64 x 64 high product.
__device__ __forceinline__ uint32_t fastmod(uint32_t h, uint64_t m,
                                            uint32_t d) {
  const uint64_t low = m * h;
  const uint64_t mid = static_cast<uint64_t>(static_cast<uint32_t>(
                           low >> 32)) * d +
                       __umulhi(static_cast<uint32_t>(low), d);
  return static_cast<uint32_t>(mid >> 32);
}

// The column of an id in one row: hash64 % cols, taken by fastmod with
// m = fastmod_multiplier(cols).
__device__ __forceinline__ uint32_t bucket(uint32_t lo, uint32_t hi,
                                           uint32_t seed, uint32_t cols,
                                           uint64_t m) {
  return fastmod(hash64(lo, hi, seed), m, cols);
}

__device__ __forceinline__ float sign(uint32_t lo, uint32_t hi,
                                      uint32_t seed) {
  return (hash64(lo, hi, seed) >> 31) == 0u ? 1.0f : -1.0f;
}

// Blocks for a grid-stride loop over n items: enough to fill 132 SMs many
// times over, never more than the items need.
inline unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  const long long cap = 132LL * 16;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace fs

// Instantiate a kernel template on the row count, so that each row loop
// unrolls and per-row values stay in registers.  Returns
// cudaErrorInvalidValue from the enclosing function for rows outside
// 1..kMaxRows.
#define FS_CASE_ROWS(n, R, ...) \
  case n: {                     \
    constexpr int R = n;        \
    __VA_ARGS__;                \
    break;                      \
  }
#define FS_DISPATCH_ROWS(rows, R, ...)                          \
  switch (rows) {                                               \
    FS_CASE_ROWS(1, R, __VA_ARGS__)                             \
    FS_CASE_ROWS(2, R, __VA_ARGS__)                             \
    FS_CASE_ROWS(3, R, __VA_ARGS__)                             \
    FS_CASE_ROWS(4, R, __VA_ARGS__)                             \
    FS_CASE_ROWS(5, R, __VA_ARGS__)                             \
    FS_CASE_ROWS(6, R, __VA_ARGS__)                             \
    FS_CASE_ROWS(7, R, __VA_ARGS__)                             \
    FS_CASE_ROWS(8, R, __VA_ARGS__)                             \
    FS_CASE_ROWS(9, R, __VA_ARGS__)                             \
    FS_CASE_ROWS(10, R, __VA_ARGS__)                            \
    default:                                                    \
      return static_cast<int>(cudaErrorInvalidValue);           \
  }
