// FetchSGD post-extraction sketch update on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/server_step.py::_topk_mask_kernel
// (called through topk_mask).
//
// Given the k extracted global ids and their values, for each id and each
// sketch row j, with cell = (j, h_j(id)):
//     error_mode zero:      se[cell] = 0
//     error_mode subtract:  se[cell] -= s_j(id) * value      (se - S(Delta))
//     momentum masking:     su[cell] = 0
// in place on su and se.  With k = 0 nothing is launched.
//
// The TPU kernel accumulated a hit-count table and S(Delta) in VMEM across a
// sequential grid over padded id blocks, then swept both tables.  Here one
// thread takes one id: zeroing is an idempotent store, so racing threads
// that hit one cell are harmless, and the subtraction is an f32 atomicAdd.
// Only the k ids launch threads, so no padded slot ever hashes, and the
// tables are touched only at the k * rows hit cells.
//
// Bound on the H100: the ids and values read once (12 B per id) and one
// 4 B store per (id, row) into each table the mode writes, at 3.35 TB/s.
#include "hash.cuh"

namespace {

template <int R>
__global__ void topk_mask_kernel(const long long* __restrict__ ids,
                                 const float* __restrict__ values,
                                 long long k, float* __restrict__ su,
                                 float* __restrict__ se, uint32_t cols,
                                 uint64_t m, fs::RowSeeds seeds, int subtract,
                                 int mask_momentum) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < k; i += stride) {
    const unsigned long long id = static_cast<unsigned long long>(ids[i]);
    const uint32_t lo = static_cast<uint32_t>(id);
    const uint32_t hi = static_cast<uint32_t>(id >> 32);
    const float v = subtract ? values[i] : 0.0f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const size_t cell = static_cast<size_t>(j) * cols +
                          fs::bucket(lo, hi, seeds.bucket[j], cols, m);
      if (subtract) {
        atomicAdd(se + cell, -(fs::sign(lo, hi, seeds.sign[j]) * v));
      } else {
        se[cell] = 0.0f;
      }
      if (mask_momentum) su[cell] = 0.0f;
    }
  }
}

}  // namespace

extern "C" int fs_topk_mask(const long long* ids, const float* values,
                            long long k, float* su, float* se, int rows,
                            int cols, const uint32_t* bucket_seeds,
                            const uint32_t* sign_seeds,
                            unsigned long long fastmod_m, int subtract,
                            int mask_momentum, void* stream) {
  if (rows < 1 || rows > fs::kMaxRows || cols < 1 || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k == 0) return 0;
  const fs::RowSeeds seeds = fs::make_seeds(bucket_seeds, sign_seeds, rows);
  constexpr int kThreads = 256;
  const unsigned grid = fs::grid_for(k, kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FS_DISPATCH_ROWS(rows, R,
                   topk_mask_kernel<R><<<grid, kThreads, 0, s>>>(
                       ids, values, k, su, se, static_cast<uint32_t>(cols),
                       fastmod_m, seeds, subtract, mask_momentum))
  return static_cast<int>(cudaGetLastError());
}
