// FetchSGD momentum and error accumulation on Hopper.
//
// Replaces the Pallas TPU kernel
// repro/kernels/server_step.py::_momentum_error_kernel (called through
// momentum_error).
//
// Computes, over the (rows, cols) f32 sketches,
//     su' = momentum * su + agg
//     se' = lr * su' + se
// with lr a 0-d f32 device tensor read by pointer, so no host sync.
//
// The TPU kernel held all five tables in VMEM.  Here it is one vectorised
// elementwise pass: 16-byte loads and stores, a grid-stride loop, and the
// products and sums rounded separately (__fmul_rn / __fadd_rn) so that nvcc
// does not contract them into an FMA and the result matches the plain
// PyTorch version bit for bit.
//
// Bound on the H100: 5 table streams (3 read, 2 written) at 3.35 TB/s.
#include "hash.cuh"

namespace {

__device__ __forceinline__ void update(float momentum, float lr, float a,
                                       float u, float e, float* u_out,
                                       float* e_out) {
  const float u2 = __fadd_rn(__fmul_rn(momentum, u), a);
  *u_out = u2;
  *e_out = __fadd_rn(__fmul_rn(lr, u2), e);
}

__global__ void momentum_error_kernel(const float* __restrict__ agg,
                                      const float* __restrict__ su,
                                      const float* __restrict__ se,
                                      const float* __restrict__ lr_ptr,
                                      float momentum,
                                      float* __restrict__ su_out,
                                      float* __restrict__ se_out,
                                      long long n) {
  const float lr = *lr_ptr;
  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4* a4 = reinterpret_cast<const float4*>(agg);
  const float4* u4 = reinterpret_cast<const float4*>(su);
  const float4* e4 = reinterpret_cast<const float4*>(se);
  float4* uo4 = reinterpret_cast<float4*>(su_out);
  float4* eo4 = reinterpret_cast<float4*>(se_out);
  for (long long i = tid; i < n4; i += stride) {
    const float4 a = a4[i];
    const float4 u = u4[i];
    const float4 e = e4[i];
    float4 u2, e2;
    update(momentum, lr, a.x, u.x, e.x, &u2.x, &e2.x);
    update(momentum, lr, a.y, u.y, e.y, &u2.y, &e2.y);
    update(momentum, lr, a.z, u.z, e.z, &u2.z, &e2.z);
    update(momentum, lr, a.w, u.w, e.w, &u2.w, &e2.w);
    uo4[i] = u2;
    eo4[i] = e2;
  }
  // the n % 4 tail, one element per thread of the first threads
  const long long i = n4 * 4 + tid;
  if (i < n) {
    update(momentum, lr, agg[i], su[i], se[i], su_out + i, se_out + i);
  }
}

}  // namespace

// All five table pointers must be 16-byte aligned (checked by the wrapper).
extern "C" int fs_momentum_error(const float* agg, const float* su,
                                 const float* se, const float* lr,
                                 float momentum, float* su_out, float* se_out,
                                 long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  constexpr int kThreads = 256;
  const unsigned grid = fs::grid_for((n + 3) / 4, kThreads);
  momentum_error_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      agg, su, se, lr, momentum, su_out, se_out, n);
  return static_cast<int>(cudaGetLastError());
}
