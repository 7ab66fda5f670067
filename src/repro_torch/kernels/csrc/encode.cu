// Count Sketch encode on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/count_sketch.py::_encode_kernel
// (called through sketch_encode_words / sketch_encode).
//
// Computes, for each element i of a chunk whose global ids start at `base`
// (64-bit) and each sketch row j:  T[j, h_j(base+i)] += s_j(base+i) * v_i,
// with v in f32 or bf16 and the table in f32.
//
// The TPU kernel wrote this scatter as a one-hot MXU contraction into an
// output block that a sequential grid revisits, because the TPU has no
// atomics.  Blocks run in parallel here, so that accumulation would race.
// Each thread instead hashes its elements on the fly (no index tables) and
// adds into the table with global f32 atomicAdd, whose result is unused and
// so compiles to a fire-and-forget reduction.  The main path's 5 x 2^20 f32
// table is 21 MB and stays in the 50 MB L2, where the reductions resolve.
// Zero values add nothing and are skipped (embedding rows of unseen tokens).
//
// Bound on the H100: the bytes are the values read once (4 B each) plus the
// table written once, at 3.35 TB/s; the rows * n L2 reductions and the ~40
// integer operations of each hash make the kernel slower than that.
#include <cuda_bf16.h>

#include "hash.cuh"

namespace {

__device__ __forceinline__ float load_value(const float* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float load_value(const __nv_bfloat16* p,
                                            long long i) {
  return __bfloat162float(p[i]);
}

template <int R, typename T>
__global__ void encode_kernel(const T* __restrict__ values, long long n,
                              unsigned long long base,
                              float* __restrict__ table, uint32_t cols,
                              fs::RowSeeds seeds) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float v = load_value(values, i);
    if (v == 0.0f) continue;
    const unsigned long long id = base + static_cast<unsigned long long>(i);
    const uint32_t lo = static_cast<uint32_t>(id);
    const uint32_t hi = static_cast<uint32_t>(id >> 32);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const uint32_t b = fs::bucket(lo, hi, seeds.bucket[j], cols);
      atomicAdd(table + static_cast<size_t>(j) * cols + b,
                fs::sign(lo, hi, seeds.sign[j]) * v);
    }
  }
}

template <typename T>
int launch(const T* values, long long n, unsigned long long base,
           float* table, int rows, int cols, const fs::RowSeeds& seeds,
           cudaStream_t stream) {
  constexpr int kThreads = 256;
  const unsigned grid = fs::grid_for(n, kThreads);
  FS_DISPATCH_ROWS(rows, R,
                   encode_kernel<R, T><<<grid, kThreads, 0, stream>>>(
                       values, n, base, table, static_cast<uint32_t>(cols),
                       seeds))
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fs_encode(const void* values, int values_bf16, long long n,
                         unsigned long long base, float* table, int rows,
                         int cols, const uint32_t* bucket_seeds,
                         const uint32_t* sign_seeds, void* stream) {
  if (rows < 1 || rows > fs::kMaxRows || cols < 1 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const fs::RowSeeds seeds = fs::make_seeds(bucket_seeds, sign_seeds, rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (values_bf16) {
    return launch(static_cast<const __nv_bfloat16*>(values), n, base, table,
                  rows, cols, seeds, s);
  }
  return launch(static_cast<const float*>(values), n, base, table, rows, cols,
                seeds, s);
}

extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
