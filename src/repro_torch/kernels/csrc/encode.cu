// Count Sketch encode on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/count_sketch.py::_encode_kernel
// (called through sketch_encode_words / sketch_encode).
//
// Computes, for each element i of a chunk whose global ids start at `base`
// (64-bit) and each sketch row j:  T[j, h_j(base+i)] += s_j(base+i) * v_i,
// with v in f32 or bf16 and the table in f32.  Zero values add nothing and
// are skipped (embedding rows of unseen tokens).
//
// The TPU kernel wrote this scatter as a one-hot MXU contraction into an
// output block that a sequential grid revisits, because the TPU has no
// atomics.  Blocks run in parallel here, so that accumulation would race.
//
// What bounds it on the H100: not the bytes (the values read once and the
// table written once) and not the hashing, but the random accesses.  The
// one-pass kernel below, a global f32 atomicAdd per (element, row), takes
// 0.95 ms for a 2^24-element chunk into the 5 x 2^20 table with or without
// its hashing: about 88 G random L2 reductions a second, whatever the
// table's size (python -m repro_torch.launch.probe_sketch_bounds).  The
// binned path takes those reductions off the table, in two kernels:
//
//   partition  Each block reads a tile of 2048 values (16 bytes a thread),
//              hashes each nonzero one per row and counting-sorts the
//              tile's records (signed value, column within its bin) in
//              shared memory by bin = (row, bucket / 2^15).  One global
//              atomicAdd per (tile, bin) reserves the run in that bin's
//              scratch, and the runs are written out contiguously, values
//              and 16-bit columns as two arrays (6 bytes a record).  A
//              record whose bin is full is added into the table at once
//              with a global atomicAdd: rare, and always correct.
//   accumulate Up to 4 blocks a bin add its records into a 128 KB slice of
//              f32 in shared memory (an f32 shared atomicAdd is a
//              compare-and-swap loop on sm_90a) and then add the slice into
//              the table, which is read and written once.
//
// Its costs are the records' round trip through device memory (0.5 GB at
// the 2^24 chunk), the hashing (10 murmur finalizer pairs an element), and
// a fixed cost per (tile, bin) run, which is why the bins are 2^15 columns
// wide (runs of about 64 records) rather than narrower.  The accumulate
// pass sweeps the whole table whatever the chunk's size, so short chunks
// keep the one-pass kernel; the wrapper (count_sketch.Bins.use) chooses.
// The buckets come from fastmod (hash.cuh).  The order of summation
// differs from the plain twin's, so reals agree to rounding; integer-valued
// inputs agree exactly.
#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>

#include "hash.cuh"

namespace {

constexpr int kBinShift = 15;                    // columns per bin: 2^15
constexpr uint32_t kBinCols = 1u << kBinShift;
constexpr int kMaxBins = 1024;                   // bins of a table, at most
constexpr int kPartThreads = 512;
constexpr int kPartBlocks = 2;                   // partition blocks an SM
constexpr int kPerThread = 4;                    // values per thread
constexpr int kTile = kPartThreads * kPerThread; // values per block
constexpr int kAccThreads = 1024;
constexpr int kAccSplit = 4;                     // accumulate blocks a bin,
constexpr long long kPartRecords = 1 << 17;      // ... one per this many
constexpr int kOnePassThreads = 256;
static_assert(kMaxBins <= 2 * kPartThreads, "the scan takes two bins a thread");
static_assert(kBinShift <= 16, "a column within a bin is 16 bits");

// kPerThread values from i on (zeros past n), as f32: 16 bytes (f32) or 8
// bytes (bf16) a load when `vec` says the pointer is aligned.
__device__ __forceinline__ void load_values(const float* p, long long i,
                                            long long n, bool vec,
                                            float (&x)[kPerThread]) {
  if (kPerThread % 4 == 0 && vec && i + kPerThread <= n) {
#pragma unroll
    for (int q = 0; q < kPerThread / 4; ++q) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(p + i) + q);
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      x[e] = i + e < n ? __ldcs(p + i + e) : 0.0f;
    }
  }
}

__device__ __forceinline__ void load_values(const __nv_bfloat16* p,
                                            long long i, long long n,
                                            bool vec, float (&x)[kPerThread]) {
  if (kPerThread % 4 == 0 && vec && i + kPerThread <= n) {
#pragma unroll
    for (int q = 0; q < kPerThread / 4; ++q) {
      const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p + i) + q);
      x[4 * q] = __uint_as_float(v.x << 16);
      x[4 * q + 1] = __uint_as_float(v.x & 0xFFFF0000u);
      x[4 * q + 2] = __uint_as_float(v.y << 16);
      x[4 * q + 3] = __uint_as_float(v.y & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      x[e] = i + e < n ? __bfloat162float(p[i + e]) : 0.0f;
    }
  }
}

__device__ __forceinline__ float load_value(const float* p, long long i) {
  return __ldcs(p + i);
}

__device__ __forceinline__ float load_value(const __nv_bfloat16* p,
                                            long long i) {
  return __bfloat162float(p[i]);
}

// ---- one-pass path: a global f32 atomicAdd per (element, row) ----------

template <int R, typename T>
__global__ void one_pass_kernel(const T* __restrict__ values, long long n,
                                unsigned long long base,
                                float* __restrict__ table, uint32_t cols,
                                uint64_t m, fs::RowSeeds seeds) {
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
      const uint32_t b = fs::bucket(lo, hi, seeds.bucket[j], cols, m);
      atomicAdd(table + static_cast<size_t>(j) * cols + b,
                fs::sign(lo, hi, seeds.sign[j]) * v);
    }
  }
}

// ---- binned path, kernel 1: partition a tile's records by bin -----------

// A record's key in registers: bit 31 the sign (1 = negative), the bits
// from kBinShift up the bin, the bits below the column within the bin.
constexpr uint32_t kColMask = kBinCols - 1;

template <int R, typename T>
__global__ void __launch_bounds__(kPartThreads, R <= 5 ? kPartBlocks : 1)
    partition_kernel(const T* __restrict__ values, long long n,
                     unsigned long long base, bool vec,
                     float* __restrict__ table, uint32_t cols, uint64_t m,
                     fs::RowSeeds seeds, int bins_per_row,
                     float* __restrict__ rec_val,
                     uint16_t* __restrict__ rec_col,
                     unsigned* __restrict__ cursor, long long cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nbins = R * bins_per_row;
  uint2* staged = reinterpret_cast<uint2*>(smem);    // kTile * R records
  unsigned* fill = reinterpret_cast<unsigned*>(staged + kTile * R);
  unsigned* off = fill + nbins;          // nbins: run starts in the tile
  unsigned* gpos = off + nbins;          // nbins: run starts in the scratch
  __shared__ unsigned warp_total[kPartThreads / 32];
  __shared__ unsigned tile_records;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int b = tid; b < nbins; b += kPartThreads) fill[b] = 0;
  __syncthreads();

  // 1. hash each nonzero value per row and count the records of each bin
  const long long i0 =
      static_cast<long long>(blockIdx.x) * kTile + tid * kPerThread;
  float x[kPerThread];
  load_values(values, i0, n, vec, x);
  uint32_t key[kPerThread][R];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    if (x[e] == 0.0f) continue;
    const unsigned long long id = base + static_cast<unsigned long long>(i0 + e);
    const uint32_t lo = static_cast<uint32_t>(id);
    const uint32_t hi = static_cast<uint32_t>(id >> 32);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const uint32_t b = fs::bucket(lo, hi, seeds.bucket[j], cols, m);
      const uint32_t neg = fs::hash64(lo, hi, seeds.sign[j]) >> 31;
      const uint32_t bin = j * bins_per_row + (b >> kBinShift);
      key[e][j] = (neg << 31) | (bin << kBinShift) | (b & kColMask);
      atomicAdd(fill + bin, 1u);
    }
  }
  __syncthreads();

  // 2. exclusive scan of the counts (two bins a thread), and one global
  //    atomicAdd per nonempty bin to reserve its run in the scratch; the
  //    reservations are awaited only after step 3
  const int b0 = 2 * tid;
  const unsigned c0 = b0 < nbins ? fill[b0] : 0u;
  const unsigned c1 = b0 + 1 < nbins ? fill[b0 + 1] : 0u;
  unsigned incl = c0 + c1;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < kPartThreads / 32 ? warp_total[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned up = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += up;
    }
    if (lane < kPartThreads / 32) warp_total[lane] = w;
    if (lane == kPartThreads / 32 - 1) tile_records = w;
  }
  __syncthreads();
  const unsigned excl =
      (warp > 0 ? warp_total[warp - 1] : 0u) + incl - (c0 + c1);
  unsigned g0 = 0, g1 = 0;
  if (b0 < nbins) {
    off[b0] = excl;
    fill[b0] = excl;
    if (c0) g0 = atomicAdd(cursor + b0, c0);
  }
  if (b0 + 1 < nbins) {
    off[b0 + 1] = excl + c0;
    fill[b0 + 1] = excl + c0;
    if (c1) g1 = atomicAdd(cursor + b0 + 1, c1);
  }
  __syncthreads();

  // 3. place each record (signed value, key without the sign) in its bin's
  //    run of the staging area
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    if (x[e] == 0.0f) continue;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const uint32_t k = key[e][j];
      const uint32_t bin = (k >> kBinShift) & (kMaxBins - 1);
      const unsigned pos = atomicAdd(fill + bin, 1u);
      staged[pos] = make_uint2(__float_as_uint((k >> 31) ? -x[e] : x[e]),
                               k & 0x7FFFFFFFu);
    }
  }
  if (b0 < nbins) gpos[b0] = g0;
  if (b0 + 1 < nbins) gpos[b0 + 1] = g1;
  __syncthreads();

  // 4. write the runs out, bin after bin; a full bin's records go to the
  //    table directly
  const unsigned total = tile_records;
  for (unsigned s = tid; s < total; s += kPartThreads) {
    const uint2 r = staged[s];
    const float v = __uint_as_float(r.x);
    const uint32_t bin = r.y >> kBinShift;
    const uint32_t col = r.y & kColMask;
    const unsigned long long g =
        static_cast<unsigned long long>(gpos[bin]) + (s - off[bin]);
    if (g < static_cast<unsigned long long>(cap)) {
      const size_t idx = static_cast<size_t>(bin) * cap + g;
      rec_val[idx] = v;
      rec_col[idx] = static_cast<uint16_t>(col);
    } else {
      const uint32_t row = bin / bins_per_row;
      const uint32_t q = bin - row * bins_per_row;
      atomicAdd(table + static_cast<size_t>(row) * cols + (q << kBinShift) +
                    col,
                v);
    }
  }
}

// ---- binned path, kernel 2: the blocks of a bin add its records ---------

// Up to kAccSplit blocks share a bin, one for each kPartRecords of its
// records (the rest leave at once): each adds its share of the records into
// a shared-memory slice of the bin's columns, then adds the slice into the
// table, with plain stores if it is the bin's only block and with global
// atomics (coalesced, and few against the records) if not.  A bin without
// records is skipped, so a short or sparse chunk pays little for the sweep.
__global__ void __launch_bounds__(kAccThreads)
    accumulate_kernel(float* __restrict__ table, uint32_t cols,
                      int bins_per_row, const float* __restrict__ rec_val,
                      const uint16_t* __restrict__ rec_col,
                      const unsigned* __restrict__ cursor, long long cap) {
  extern __shared__ __align__(16) float slice[];
  const int bin = blockIdx.x / kAccSplit;
  const int part = blockIdx.x - bin * kAccSplit;
  const long long count = min(static_cast<long long>(cursor[bin]), cap);
  const long long wanted = (count + kPartRecords - 1) / kPartRecords;
  const int parts = static_cast<int>(wanted < kAccSplit ? wanted : kAccSplit);
  if (part >= parts) return;
  const int row = bin / bins_per_row;
  const uint32_t c0 = static_cast<uint32_t>(bin - row * bins_per_row)
                      << kBinShift;
  const int width = static_cast<int>(min(kBinCols, cols - c0));
  const int tid = threadIdx.x;
  for (int c = tid; c < width; c += kAccThreads) slice[c] = 0.0f;
  __syncthreads();

  // this block's share of the bin's records, in groups of 4; the next
  // group is loaded before the current one is added
  const long long n4 = count / 4;
  const long long lo4 = n4 * part / parts;
  const long long hi4 = n4 * (part + 1) / parts;
  const float* v = rec_val + static_cast<size_t>(bin) * cap;
  const uint16_t* col = rec_col + static_cast<size_t>(bin) * cap;
  // cap is a multiple of 8, so each bin's arrays start 16-byte aligned
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const uint2* c4 = reinterpret_cast<const uint2*>(col);
  long long i = lo4 + tid;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  uint2 c = make_uint2(0u, 0u);
  if (i < hi4) {
    a = __ldcs(v4 + i);
    c = __ldcs(c4 + i);
  }
  for (; i < hi4; i += kAccThreads) {
    float4 an = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    uint2 cn = make_uint2(0u, 0u);
    if (i + kAccThreads < hi4) {
      an = __ldcs(v4 + i + kAccThreads);
      cn = __ldcs(c4 + i + kAccThreads);
    }
    atomicAdd(slice + (c.x & 0xFFFFu), a.x);
    atomicAdd(slice + (c.x >> 16), a.y);
    atomicAdd(slice + (c.y & 0xFFFFu), a.z);
    atomicAdd(slice + (c.y >> 16), a.w);
    a = an;
    c = cn;
  }
  if (part == parts - 1) {
    for (long long k = 4 * n4 + tid; k < count; k += kAccThreads) {
      atomicAdd(slice + col[k], v[k]);
    }
  }
  __syncthreads();

  float* out = table + static_cast<size_t>(row) * cols + c0;
  for (int k = tid; k < width; k += kAccThreads) {
    if (parts == 1) {
      out[k] += slice[k];
    } else {
      atomicAdd(out + k, slice[k]);
    }
  }
}

template <typename T>
int launch(const T* values, long long n, unsigned long long base,
           float* table, int rows, int cols, uint64_t m,
           const fs::RowSeeds& seeds, float* rec_val, uint16_t* rec_col,
           unsigned* cursor, long long cap, cudaStream_t stream) {
  const uint32_t ucols = static_cast<uint32_t>(cols);
  if (rec_val == nullptr) {
    const unsigned grid = fs::grid_for(n, kOnePassThreads);
    FS_DISPATCH_ROWS(rows, R,
                     one_pass_kernel<R, T>
                     <<<grid, kOnePassThreads, 0, stream>>>(
                         values, n, base, table, ucols, m, seeds))
    return static_cast<int>(cudaGetLastError());
  }
  const int bins_per_row = static_cast<int>((ucols + kBinCols - 1) >>
                                            kBinShift);
  const int nbins = rows * bins_per_row;
  if (nbins > kMaxBins || cap < 8 || cap % 8 != 0 || n >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(cursor, 0, nbins * sizeof(unsigned),
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = (reinterpret_cast<uintptr_t>(values) %
                    (4 * sizeof(T))) == 0;   // 4 values a vector load
  const unsigned tiles = static_cast<unsigned>((n + kTile - 1) / kTile);
  const size_t part_smem = static_cast<size_t>(kTile) * rows * 8 +
                           static_cast<size_t>(nbins) * 3 * sizeof(unsigned);
  FS_DISPATCH_ROWS(
      rows, R, {
        auto kernel = partition_kernel<R, T>;
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(part_smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        kernel<<<tiles, kPartThreads, part_smem, stream>>>(
            values, n, base, vec, table, ucols, m, seeds, bins_per_row,
            rec_val, rec_col, cursor, cap);
      })
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t acc_smem = std::min(kBinCols, ucols) * sizeof(float);
  err = cudaFuncSetAttribute(accumulate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(acc_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  accumulate_kernel<<<nbins * kAccSplit, kAccThreads, acc_smem, stream>>>(
      table, ucols, bins_per_row, rec_val, rec_col, cursor, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The binned path's geometry, which the wrapper sizes its scratch by
// (count_sketch.bins): columns per bin, and the most bins a table may have.
extern "C" int fs_encode_bin_cols() { return static_cast<int>(kBinCols); }
extern "C" int fs_encode_max_bins() { return kMaxBins; }

// rec_val == nullptr takes the one-pass path; otherwise rec_val / rec_col
// hold rows * ceil(cols / kBinCols) bins of `bin_capacity` records each and
// `cursor` one word per bin (cleared here).
extern "C" int fs_encode(const void* values, int values_bf16, long long n,
                         unsigned long long base, float* table, int rows,
                         int cols, const uint32_t* bucket_seeds,
                         const uint32_t* sign_seeds,
                         unsigned long long fastmod_m, float* rec_val,
                         uint16_t* rec_col, unsigned* cursor,
                         long long bin_capacity, void* stream) {
  if (rows < 1 || rows > fs::kMaxRows || cols < 1 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const fs::RowSeeds seeds = fs::make_seeds(bucket_seeds, sign_seeds, rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (values_bf16) {
    return launch(static_cast<const __nv_bfloat16*>(values), n, base, table,
                  rows, cols, fastmod_m, seeds, rec_val, rec_col, cursor,
                  bin_capacity, s);
  }
  return launch(static_cast<const float*>(values), n, base, table, rows,
                cols, fastmod_m, seeds, rec_val, rec_col, cursor,
                bin_capacity, s);
}

extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
