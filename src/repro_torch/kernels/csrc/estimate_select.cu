// Count Sketch estimate fused with the per-chunk candidate selection, on
// Hopper.
//
// Replaces, for one chunk of the server's top-k, the Pallas TPU kernel
// repro/kernels/count_sketch.py::_estimate_kernel and the lax.top_k(|est|,
// kk) that repro/core/topk.py::topk_from_sketch runs on its output in XLA.
//
// Given the ids base..base+n-1 of a chunk, it returns the kk of them with
// the largest |estimate| (the estimate of estimate.cuh, bit for bit that of
// estimate.cu) and their signed estimates: every id whose |estimate| is
// above the kk-th largest, then, among the ids whose |estimate| equals it,
// the lowest local indices.  The candidates come out in ascending local
// index, so two calls on one table give the same arrays.  |estimate| is
// ordered through its key: the float's bits with the sign cleared, an
// unsigned integer in which +0 = -0 < positive floats < +inf < NaN (every
// NaN one key), as torch.topk orders the magnitudes.
//
// What bounds it on the H100: the estimate's random reads (pass 1, about
// 131 G 4-byte reads a second; estimate.cu).  The byte bound, the table
// read once and kk * 12 bytes written, is out of reach for the same reason.
// What the fusion saves is what used to follow the estimate: its n floats
// read again by |.|, by torch.topk's multi-pass radix select and its sort
// of the winners, and the host operations around them.  Here, with no host
// sync, on the caller's stream:
//
//   estimate_hist  Pass 1: each thread estimates one id at a time (a grid
//                  of one wave of blocks strides over the chunk), stores
//                  the estimate into the n-float scratch and adds its key's
//                  top 12 bits to a 4096-bin histogram in shared memory.
//                  Keys crowd into a few exponent bins (all into one for an
//                  all-zero table), so a warp first groups its lanes by bin
//                  (__match_any_sync) and one lane a bin adds the group's
//                  count.  Each block adds its nonzero bins into the
//                  chunk's global histogram; the last block to finish finds
//                  the bin that holds the kk-th largest key.
//   refine x 2     Read the scratch and histogram, among the keys in the
//                  chosen bin, their next 11 and then last 8 bits (12 + 11
//                  + 8 = the key's 31 bits); the last block of each narrows
//                  the bin again.  The threshold key T is then exact.  A
//                  level whose bin is taken whole (every id of it is among
//                  the kk, as when kk = n) ends the selection early, and
//                  the later refine kernels return at once.
//   tile_count     Tiles of 4096 ids count their candidates, the ids above
//                  the selection's bin and in it, and add the counts into
//                  their group of 256 tiles (a 64-bit atomic a tile).  A
//                  tile of at most 256 candidates also lists them (index
//                  and estimate) in a compact list, in a run that one
//                  atomic reserves; about 6 a tile on the main path.
//   tile_write     Each tile sums the counts of the tiles before it in its
//                  group and of the groups before its own (no pass of one
//                  block over every tile), then places its selected ids:
//                  an id goes to (ids above before it) + min(ids tied
//                  before it, the ties still needed).  A listed tile ranks
//                  its run's candidates by index among themselves; any
//                  other (many ties, or a full list) reads its 4096
//                  estimates again and scans its threads.
//
// Three passes over the scratch (two refine, one count) read 64 MB each at
// a 2^24 chunk, at the HBM rate; the write reads it again only for tiles
// with many candidates.  On an H100 80GB HBM3 at 700 W, 2^24 ids of the
// 5 x 2^20 sketch of a normal chunk, kk = 25,000, the whole took 0.720 ms:
// pass 1 0.635 (the estimate alone 0.640), refine 2 0.029, refine 3 0.001
// (level 2 took its bin whole), count 0.031, write 0.014
// (python -m repro_torch.launch.probe_sketch_bounds).  Before the list,
// the write read every tile again (0.033-0.044 ms), and before the group
// counts, the count's last block scanned every tile's counts alone (count
// 0.046 ms).
#include "estimate.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoBin = 0xffffffffu;
constexpr int kThreads = 512;                   // estimate and refine blocks
constexpr int kBlocksPerSm = 2048 / kThreads;   // refine: one full wave
constexpr int kTileThreads = 256;               // count and write blocks
constexpr int kTile = 4096;                     // ids a tile
constexpr int kLoads = kTile / 4 / kTileThreads;  // float4s a thread: 4
constexpr int kGroupTiles = kTileThreads;       // tiles a group: 256
constexpr unsigned kCompact = 256;    // candidates a tile lists, at most
constexpr unsigned kNoStart = 0xffffffffu;      // a tile that lists none

// The radix select's three levels: key bits 30..19, 18..8 and 7..0.
constexpr int kBits1 = 12, kShift1 = 19;
constexpr int kBits2 = 11, kShift2 = 8;
constexpr int kBits3 = 8, kShift3 = 0;

// Zeroed by the caller before each call, with the groups' counts after it.
struct SelectState {
  unsigned hist1[1 << kBits1];
  unsigned hist2[1 << kBits2];
  unsigned hist3[1 << kBits3];
  unsigned arrived[3];   // blocks done: pass 1, refine 2, refine 3
  // The selection: every id with key >> shift > prefix, then the first
  // `need` ids (lowest index) with key >> shift == prefix.
  unsigned shift;
  unsigned prefix;
  unsigned need;
  unsigned resolved;     // 1 once shift, prefix and need are final
  unsigned cursor;       // entries of the compact list taken so far
  // the groups' 64-bit counts follow
};
static_assert(sizeof(SelectState) % sizeof(unsigned long long) == 0,
              "the groups' counts must be 8-byte aligned");

__device__ __forceinline__ unsigned key_of(float x) {
  const unsigned k = __float_as_uint(x) & 0x7fffffffu;
  return k > 0x7f800000u ? 0x7fc00000u : k;
}

// Adds one to hist[bin] for every lane whose bin is not kNoBin: one shared
// atomic for each distinct bin of the warp.  Every lane must call it.
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned bin) {
  const unsigned peers = __match_any_sync(kFull, bin);
  const int lane = threadIdx.x & 31;
  if (bin != kNoBin && lane == __ffs(peers) - 1) {
    atomicAdd(hist + bin, static_cast<unsigned>(__popc(peers)));
  }
}

// Exclusive prefix sum of x over the block (blockDim a multiple of 32);
// the block's total in *total when given.  Every thread must call it.
template <typename T>
__device__ T block_exclusive_scan(T x, T* total) {
  __shared__ T warp_incl[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  T incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T w = lane < warps ? warp_incl[lane] : T(0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < warps) warp_incl[lane] = w;
  }
  __syncthreads();
  const T excl = incl - x + (warp > 0 ? warp_incl[warp - 1] : T(0));
  if (total != nullptr) *total = warp_incl[warps - 1];
  __syncthreads();
  return excl;
}

// Whether this block is the last of the grid to get here.  What every
// block wrote before is visible to the last one.
__device__ __forceinline__ bool arrive_last(unsigned* arrived) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrived, 1u) == gridDim.x - 1;
  __syncthreads();
  return last;
}

__device__ __forceinline__ void flush(const unsigned* shist, unsigned* ghist,
                                      int bins) {
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    const unsigned c = shist[b];
    if (c != 0) atomicAdd(ghist + b, c);
  }
}

// In the last block of a level (kThreads threads): finds, counting from the
// top bin down, the bin of the global histogram that holds the need-th
// largest key of the level, and narrows the selection to it.
template <int kBits, int kShift, bool kLastLevel>
__device__ void select_level(SelectState* st, const unsigned* ghist,
                             unsigned need) {
  constexpr int kBins = 1 << kBits;
  constexpr int kPer = (kBins + kThreads - 1) / kThreads;
  unsigned h[kPer];
  unsigned sum = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int r = static_cast<int>(threadIdx.x) * kPer + q;   // from the top
    h[q] = r < kBins ? __ldcg(ghist + (kBins - 1 - r)) : 0u;
    sum += h[q];
  }
  unsigned above = block_exclusive_scan(sum, static_cast<unsigned*>(nullptr));
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (above < need && above + h[q] >= need) {
      const unsigned bin = kBins - 1 - (threadIdx.x * kPer + q);
      const unsigned rest = need - above;
      st->prefix = (st->prefix << kBits) | bin;
      st->shift = kShift;
      st->need = rest;
      st->resolved = (kLastLevel || h[q] == rest) ? 1u : 0u;
    }
    above += h[q];
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    estimate_hist_kernel(const float* __restrict__ table, uint32_t cols,
                         uint64_t m, unsigned long long base, long long n,
                         unsigned kk, float* __restrict__ est,
                         fs::RowSeeds seeds, SelectState* st) {
  __shared__ unsigned hist[1 << kBits1];
  for (int b = threadIdx.x; b < (1 << kBits1); b += kThreads) hist[b] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // i0 is uniform over the block, so every lane reaches hist_add
  for (long long i0 = static_cast<long long>(blockIdx.x) * kThreads; i0 < n;
       i0 += stride) {
    const long long i = i0 + threadIdx.x;
    unsigned bin = kNoBin;
    if (i < n) {
      const float e = fs::estimate_id<R>(
          table, cols, m, base + static_cast<unsigned long long>(i), seeds);
      est[i] = e;
      bin = key_of(e) >> kShift1;
    }
    hist_add(hist, bin);
  }
  __syncthreads();
  flush(hist, st->hist1, 1 << kBits1);
  if (arrive_last(&st->arrived[0])) {
    select_level<kBits1, kShift1, false>(st, st->hist1, kk);
  }
}

template <int kBits, int kShift>
__device__ __forceinline__ void refine_add(unsigned* hist, float x, bool ok,
                                           unsigned shift_prev,
                                           unsigned prefix_prev) {
  const unsigned k = key_of(x);
  const bool hit = ok && (k >> shift_prev) == prefix_prev;
  if (__any_sync(kFull, hit)) {
    hist_add(hist, hit ? (k >> kShift) & ((1u << kBits) - 1) : kNoBin);
  }
}

template <int kBits, int kShift, int kLevel>
__global__ void __launch_bounds__(kThreads)
    refine_kernel(const float* __restrict__ est, long long n,
                  SelectState* st) {
  if (st->resolved) return;   // the same for every thread of the grid
  const unsigned shift_prev = st->shift;
  const unsigned prefix_prev = st->prefix;
  const unsigned need = st->need;
  unsigned* ghist = kLevel == 2 ? &st->hist2[0] : &st->hist3[0];
  __shared__ unsigned hist[1 << kBits];
  for (int b = threadIdx.x; b < (1 << kBits); b += kThreads) hist[b] = 0;
  __syncthreads();
  const float4* est4 = reinterpret_cast<const float4*>(est);
  const long long n4 = n >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g0 = static_cast<long long>(blockIdx.x) * kThreads; g0 < n4;
       g0 += stride) {
    const long long g = g0 + threadIdx.x;
    const bool ok = g < n4;
    const float4 x = ok ? est4[g] : make_float4(0.f, 0.f, 0.f, 0.f);
    refine_add<kBits, kShift>(hist, x.x, ok, shift_prev, prefix_prev);
    refine_add<kBits, kShift>(hist, x.y, ok, shift_prev, prefix_prev);
    refine_add<kBits, kShift>(hist, x.z, ok, shift_prev, prefix_prev);
    refine_add<kBits, kShift>(hist, x.w, ok, shift_prev, prefix_prev);
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {   // the last n % 4 ids
    const long long i = (n4 << 2) + threadIdx.x;
    const bool ok = i < n;
    refine_add<kBits, kShift>(hist, ok ? est[i] : 0.f, ok, shift_prev,
                              prefix_prev);
  }
  __syncthreads();
  flush(hist, ghist, 1 << kBits);
  if (arrive_last(&st->arrived[kLevel - 1])) {
    select_level<kBits, kShift, kLevel == 3>(st, ghist, need);
  }
}

// The estimates of ids 4v..4v+3, zeros past the chunk's end.
__device__ __forceinline__ float4 load4(const float* __restrict__ est,
                                        long long n, long long v) {
  if (4 * v + 3 < n) return reinterpret_cast<const float4*>(est)[v];
  float e[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = 4 * v + j < n ? est[4 * v + j] : 0.f;
  return make_float4(e[0], e[1], e[2], e[3]);
}

// How many of ids first..first+count-1 the chunk holds.
__device__ __forceinline__ int held(long long n, long long first, int count) {
  const long long left = n - first;
  return left <= 0 ? 0 : (left < count ? static_cast<int>(left) : count);
}

// 2 for an id above the selection's bin, 1 for one in it, 0 below.
__device__ __forceinline__ int classify(float x, unsigned shift,
                                        unsigned prefix) {
  const unsigned s = key_of(x) >> shift;
  return s > prefix ? 2 : (s == prefix ? 1 : 0);
}

// An id's count, (above << 16) + tied: a tile holds at most 4096 ids.
__device__ __forceinline__ unsigned count_of(int c) {
  return c == 2 ? 0x10000u : static_cast<unsigned>(c);
}

// A tile's or a group's counts as one 64-bit word, (above << 32) + tied:
// sums of them stay exact, as no chunk holds 2^32 ids.
__device__ __forceinline__ unsigned long long widen(unsigned packed) {
  return (static_cast<unsigned long long>(packed >> 16) << 32) |
         (packed & 0xffffu);
}

// A candidate of the compact list: its local index and its estimate.
__device__ __forceinline__ unsigned long long candidate(long long i,
                                                        float x) {
  return (static_cast<unsigned long long>(i) << 32) | __float_as_uint(x);
}

__global__ void __launch_bounds__(kTileThreads)
    tile_count_kernel(const float* __restrict__ est, long long n,
                      SelectState* st,
                      unsigned long long* __restrict__ tile_counts,
                      unsigned long long* __restrict__ groups,
                      unsigned* __restrict__ tile_start,
                      unsigned long long* __restrict__ cand,
                      unsigned capacity) {
  const unsigned shift = st->shift;
  const unsigned prefix = st->prefix;
  // the tile's 1024 float4s, a warp's loads contiguous (order is free here)
  float4 x[kLoads];
  int c[kLoads][4];
  unsigned packed = 0;
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const long long v = static_cast<long long>(blockIdx.x) * (kTile / 4) +
                        q * kTileThreads + threadIdx.x;
    x[q] = load4(est, n, v);
    const float xs[4] = {x[q].x, x[q].y, x[q].z, x[q].w};
    const int cnt = held(n, 4 * v, 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      c[q][e] = e < cnt ? classify(xs[e], shift, prefix) : 0;
      packed += count_of(c[q][e]);
    }
  }
  unsigned total = 0;
  const unsigned excl = block_exclusive_scan(packed, &total);
  // A tile of at most kCompact candidates (ids above or in the bin) lists
  // them, in any order, in its run of the compact list; the write pass
  // then reads that run instead of the tile.
  const unsigned count = (total >> 16) + (total & 0xffffu);
  __shared__ unsigned start;
  if (threadIdx.x == 0) {
    tile_counts[blockIdx.x] = widen(total);
    atomicAdd(groups + blockIdx.x / kGroupTiles, widen(total));
    start = kNoStart;
    if (count <= kCompact) {
      const unsigned at = atomicAdd(&st->cursor, count);
      if (at + count <= capacity) start = at;
    }
    tile_start[blockIdx.x] = start;
  }
  __syncthreads();
  if (start == kNoStart || count == 0) return;
  unsigned long long at = start + (excl >> 16) + (excl & 0xffffu);
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const long long v = static_cast<long long>(blockIdx.x) * (kTile / 4) +
                        q * kTileThreads + threadIdx.x;
    const float xs[4] = {x[q].x, x[q].y, x[q].z, x[q].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c[q][e] != 0) cand[at++] = candidate(4 * v + e, xs[e]);
    }
  }
}

// Places one selected id: (ids above before it) + min(ids tied before it,
// the ties still needed); `tied` counts the ties before it.
__device__ __forceinline__ void place(int c, float x, long long i,
                                      unsigned long long above,
                                      unsigned long long tied,
                                      unsigned long long need,
                                      float* __restrict__ values,
                                      long long* __restrict__ idx) {
  if (c == 2 || (c == 1 && tied < need)) {
    const unsigned long long pos = above + (tied < need ? tied : need);
    values[pos] = x;
    idx[pos] = i;
  }
}

__global__ void __launch_bounds__(kTileThreads)
    tile_write_kernel(const float* __restrict__ est, long long n,
                      const SelectState* st,
                      const unsigned long long* __restrict__ tile_counts,
                      const unsigned long long* __restrict__ groups,
                      const unsigned* __restrict__ tile_start,
                      const unsigned long long* __restrict__ cand,
                      float* __restrict__ values,
                      long long* __restrict__ idx) {
  const long long tile = blockIdx.x;
  const unsigned long long mine = tile_counts[tile];
  if (mine == 0) return;   // no candidate in the tile
  const unsigned shift = st->shift;
  const unsigned prefix = st->prefix;
  const unsigned long long need = st->need;
  const unsigned start = tile_start[tile];
  // the counts of every id before the tile: the tiles before it in its
  // group (one a thread), then the groups before its own
  const long long group = tile / kGroupTiles;
  const long long mate = group * kGroupTiles + threadIdx.x;
  unsigned long long part = mate < tile ? tile_counts[mate] : 0ull;
  for (long long g = threadIdx.x; g < group; g += kTileThreads) {
    part += groups[g];
  }
  unsigned long long before = 0;
  block_exclusive_scan(part, &before);
  const unsigned long long above0 = before >> 32;
  const unsigned long long tied0 = before & 0xffffffffull;
  if (start != kNoStart) {
    // the compact run: each candidate ranks itself by index among them
    const unsigned count = static_cast<unsigned>(mine >> 32) +
                           static_cast<unsigned>(mine & 0xffffffffull);
    __shared__ unsigned long long run[kCompact];
    for (unsigned j = threadIdx.x; j < count; j += kTileThreads) {
      run[j] = cand[start + j];
    }
    __syncthreads();
    for (unsigned j = threadIdx.x; j < count; j += kTileThreads) {
      const unsigned long long me = run[j];
      const float x = __uint_as_float(static_cast<unsigned>(me));
      unsigned above = 0, tied = 0;
      for (unsigned k = 0; k < count; ++k) {
        const unsigned long long other = run[k];
        if ((other >> 32) < (me >> 32)) {
          const int c = classify(
              __uint_as_float(static_cast<unsigned>(other)), shift, prefix);
          above += c == 2;
          tied += c == 1;
        }
      }
      place(classify(x, shift, prefix), x, static_cast<long long>(me >> 32),
            above0 + above, tied0 + tied, need, values, idx);
    }
    return;
  }
  // the whole tile from the scratch: each thread takes 16 consecutive ids
  const long long first = tile * kTile + threadIdx.x * 16;
  float x[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = load4(est, n, first / 4 + q);
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
  const int cnt = held(n, first, 16);
  unsigned packed = 0;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    if (q < cnt) packed += count_of(classify(x[q], shift, prefix));
  }
  const unsigned excl =
      block_exclusive_scan(packed, static_cast<unsigned*>(nullptr));
  unsigned long long above = above0 + (excl >> 16);
  unsigned long long tied = tied0 + (excl & 0xffffu);
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    if (q < cnt) {
      const int c = classify(x[q], shift, prefix);
      place(c, x[q], first + q, above, tied, need, values, idx);
      above += c == 2;
      tied += c == 1;
    }
  }
}

template <int R>
int launch_estimate_hist(const float* table, uint32_t cols, uint64_t m,
                         unsigned long long base, long long n, unsigned kk,
                         float* est, const fs::RowSeeds& seeds,
                         SelectState* st, int sms, cudaStream_t s) {
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, estimate_hist_kernel<R>, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long wave =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > wave) blocks = wave;
  estimate_hist_kernel<R><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      table, cols, m, base, n, kk, est, seeds, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fs_select_tile() { return kTile; }
extern "C" int fs_select_group_tiles() { return kGroupTiles; }
extern "C" int fs_select_state_words() {
  return static_cast<int>(sizeof(SelectState) / sizeof(unsigned));
}

// est: n floats of scratch; work: fs_select_state_words() words and then
// 2 * ngroups more, all zeroed; tile_counts (64-bit) and tile_start: one
// word a tile of scratch; cand: `capacity` 64-bit words of scratch;
// ntiles = ceil(n / fs_select_tile()), ngroups = ceil(ntiles /
// fs_select_group_tiles()); values, idx: kk each.
extern "C" int fs_estimate_select(const float* table, int rows, int cols,
                                  unsigned long long base, long long n,
                                  long long kk, float* est, unsigned* work,
                                  unsigned long long* tile_counts,
                                  unsigned* tile_start,
                                  unsigned long long* cand,
                                  unsigned capacity, float* values,
                                  long long* idx,
                                  const uint32_t* bucket_seeds,
                                  const uint32_t* sign_seeds,
                                  unsigned long long fastmod_m, void* stream) {
  if (rows < 1 || rows > fs::kMaxRows || cols < 1 || n < 1 ||
      n >= (1LL << 31) || kk < 1 || kk > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const fs::RowSeeds seeds = fs::make_seeds(bucket_seeds, sign_seeds, rows);
  SelectState* st = reinterpret_cast<SelectState*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  int rc = 0;
  FS_DISPATCH_ROWS(rows, R,
                   rc = launch_estimate_hist<R>(
                       table, static_cast<uint32_t>(cols), fastmod_m, base, n,
                       static_cast<unsigned>(kk), est, seeds, st, sms, s))
  if (rc != 0) return rc;
  long long blocks = ((n >> 2) + kThreads - 1) / kThreads;
  if (blocks > static_cast<long long>(sms) * kBlocksPerSm) {
    blocks = static_cast<long long>(sms) * kBlocksPerSm;
  }
  const unsigned grid = static_cast<unsigned>(blocks < 1 ? 1 : blocks);
  refine_kernel<kBits2, kShift2, 2><<<grid, kThreads, 0, s>>>(est, n, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  refine_kernel<kBits3, kShift3, 3><<<grid, kThreads, 0, s>>>(est, n, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const long long ntiles = (n + kTile - 1) / kTile;
  unsigned long long* groups =
      reinterpret_cast<unsigned long long*>(work) +
      sizeof(SelectState) / sizeof(unsigned long long);
  tile_count_kernel<<<static_cast<unsigned>(ntiles), kTileThreads, 0, s>>>(
      est, n, st, tile_counts, groups, tile_start, cand, capacity);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  tile_write_kernel<<<static_cast<unsigned>(ntiles), kTileThreads, 0, s>>>(
      est, n, st, tile_counts, groups, tile_start, cand, values, idx);
  return static_cast<int>(cudaGetLastError());
}
