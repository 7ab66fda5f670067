// Count Sketch estimate (unsketch) on Hopper.
//
// Replaces the Pallas TPU kernel
// repro/kernels/count_sketch.py::_estimate_kernel (called through
// sketch_estimate_words / sketch_estimate).
//
// Computes, for each global id base..base+n-1, the median over the sketch
// rows of s_j(id) * T[j, h_j(id)], with jnp.median's semantics: the mean of
// the two middle values for an even row count, NaN if any value is NaN.
//
// The TPU kernel gathered through a one-hot MXU contraction.  Here each
// thread hashes its id, gathers one cell per row from the table (21 MB on
// the main path, resident in the 50 MB L2) and sorts the <= 10 values in
// registers (estimate.cuh, shared with the fused estimate + selection of
// estimate_select.cu); jnp.median's midpoint and NaN rules make it equal
// its plain twin bit for bit.
//
// What bounds it on the H100: the random 4-byte reads, rows per id.  The
// byte bound (the estimates written once plus the table read once) is out
// of reach: this kernel with the bucket taken by `%` took 0.64 ms for 2^24
// ids from the 5 x 2^20 table with or without its hashing, and 0.60 ms
// from a table 16x smaller, about 131 G random reads a second
// (python -m repro_torch.launch.probe_sketch_bounds).  Taking the bucket
// by fastmod (hash.cuh) or reading through ld.global.cg does not move it
// (the same probe), and several ids a thread with all their gathers in
// flight gained no more than the spread between runs, so the kernel stays
// one id a thread.
#include "estimate.cuh"

namespace {

template <int R>
__global__ void estimate_kernel(const float* __restrict__ table, uint32_t cols,
                                uint64_t m, unsigned long long base,
                                long long n, float* __restrict__ out,
                                fs::RowSeeds seeds) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = fs::estimate_id<R>(table, cols, m,
                                base + static_cast<unsigned long long>(i),
                                seeds);
  }
}

}  // namespace

extern "C" int fs_estimate(const float* table, int rows, int cols,
                           unsigned long long base, long long n, float* out,
                           const uint32_t* bucket_seeds,
                           const uint32_t* sign_seeds,
                           unsigned long long fastmod_m, void* stream) {
  if (rows < 1 || rows > fs::kMaxRows || cols < 1 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const fs::RowSeeds seeds = fs::make_seeds(bucket_seeds, sign_seeds, rows);
  constexpr int kThreads = 256;
  const unsigned grid = fs::grid_for(n, kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FS_DISPATCH_ROWS(rows, R,
                   estimate_kernel<R><<<grid, kThreads, 0, s>>>(
                       table, static_cast<uint32_t>(cols), fastmod_m, base,
                       n, out, seeds))
  return static_cast<int>(cudaGetLastError());
}
