// One id's Count Sketch estimate, shared by the estimate kernel
// (estimate.cu) and the fused estimate + selection (estimate_select.cu), so
// that both give the same bits.
//
// The median over the R sketch rows of s_j(id) * T[j, h_j(id)], with
// jnp.median's semantics: the mean of the two middle values for an even row
// count, and the canonical NaN (0x7fc00000) if any value is NaN.  The <= 10
// values are sorted in registers by an odd-even transposition network
// unrolled on the row count; the midpoint is rounded as jnp.median rounds
// it, so the result equals the plain twin's bit for bit.
#pragma once

#include "hash.cuh"

namespace fs {

template <int R>
__device__ __forceinline__ float estimate_id(const float* __restrict__ table,
                                             uint32_t cols, uint64_t m,
                                             unsigned long long id,
                                             const RowSeeds& seeds) {
  const uint32_t lo = static_cast<uint32_t>(id);
  const uint32_t hi = static_cast<uint32_t>(id >> 32);
  float v[R];
  bool any_nan = false;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const uint32_t b = bucket(lo, hi, seeds.bucket[j], cols, m);
    v[j] = sign(lo, hi, seeds.sign[j]) *
           __ldcg(table + static_cast<size_t>(j) * cols + b);
    any_nan |= (v[j] != v[j]);
  }
#pragma unroll
  for (int pass = 0; pass < R; ++pass) {
#pragma unroll
    for (int a = pass & 1; a + 1 < R; a += 2) {
      const float x = v[a];
      const float y = v[a + 1];
      v[a] = fminf(x, y);
      v[a + 1] = fmaxf(x, y);
    }
  }
  const float mid = __fmul_rn(__fadd_rn(v[(R - 1) / 2], v[R / 2]), 0.5f);
  return any_nan ? __int_as_float(0x7fc00000) : mid;
}

}  // namespace fs
