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
// sequential grid over padded id blocks, then swept both tables.  Here the
// work is spread over (row, id) pairs, one thread each: the grid's y index is
// the sketch row and its x blocks run over the ids, so k = 25,000 ids of a
// 5-row sketch give 125,000 threads (490 blocks over 132 SMs) and no thread
// waits on another row's stores.  A warp holds 32 consecutive ids of one
// row, so its id and value reads coalesce and its row seeds are uniform;
// each thread does one hash and its stores.  Zeroing is an idempotent store,
// so threads that hit one cell race harmlessly; the subtraction is an f32
// atomicAdd, exact on integer values.  Only the k * rows pairs launch
// threads, so no padded slot ever hashes, and the tables are touched only at
// the hit cells.
//
// Bound on the H100: the ids and values read once (12 B per id) and one
// 4 B store per (id, row) into each table the mode writes, at 3.35 TB/s.
// The stores are random, so the card's random-access rate (about 131 G
// 4-byte accesses/s, python -m repro_torch.launch.probe_sketch_bounds) and
// the launch itself are what it meets in practice.
#include "hash.cuh"

namespace {

__global__ void topk_mask_kernel(const long long* __restrict__ ids,
                                 const float* __restrict__ values,
                                 long long k, float* __restrict__ su,
                                 float* __restrict__ se, uint32_t cols,
                                 uint64_t m, fs::RowSeeds seeds, int subtract,
                                 int mask_momentum) {
  const int j = blockIdx.y;
  const uint32_t bseed = seeds.bucket[j];
  const uint32_t sseed = seeds.sign[j];
  float* const se_row = se + static_cast<size_t>(j) * cols;
  float* const su_row = su + static_cast<size_t>(j) * cols;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < k; i += stride) {
    const unsigned long long id = static_cast<unsigned long long>(ids[i]);
    const uint32_t lo = static_cast<uint32_t>(id);
    const uint32_t hi = static_cast<uint32_t>(id >> 32);
    const uint32_t c = fs::bucket(lo, hi, bseed, cols, m);
    if (subtract) {
      atomicAdd(se_row + c, -(fs::sign(lo, hi, sseed) * values[i]));
    } else {
      se_row[c] = 0.0f;
    }
    if (mask_momentum) su_row[c] = 0.0f;
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
  const dim3 grid(fs::grid_for(k, kThreads), static_cast<unsigned>(rows));
  topk_mask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ids, values, k, su, se, static_cast<uint32_t>(cols), fastmod_m, seeds,
      subtract, mask_momentum);
  return static_cast<int>(cudaGetLastError());
}
