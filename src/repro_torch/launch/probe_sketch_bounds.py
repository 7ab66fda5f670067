"""What bounds the Count Sketch encode and estimate, and where the binned
encode starts to pay.

    PYTHONPATH=src python -m repro_torch.launch.probe_sketch_bounds \\
        [--out chiprun_out/probe_sketch_bounds.json]

Needs an NVIDIA Hopper card and nvcc.  First it builds, from the source
below and ``kernels/csrc/hash.cuh``, the port's first encode and estimate
kernels (one thread per element, a global f32 ``atomicAdd`` or a gather
per row, the bucket taken with ``%``) and variants of each that keep one
part of the work and drop the other, and times each at the main path's
shapes: a 2**24-element chunk at offset 2**32 + 12345 and a 5 x 2**20 f32
table.

  encode/as_is            the kernel as it was
  encode/fastmod          the same with the bucket taken by fastmod
  encode/hash_only        both hashes, no atomics (one store per thread)
  encode/hash_only_fastmod  the same with fastmod
  encode/atomic_rand      atomics to a bucket from one multiply (no hashing)
  encode/atomic_seq       atomics to consecutive buckets (coalesced)
  encode/atomic_rand_cs   atomic_rand, the values read with ld.global.cs
  encode/atomic_rand_last atomic_rand_cs with an L2 evict_last hint
  encode/atomic_rand@2^16 atomic_rand into a 5 x 2**16 table
  estimate/as_is          the kernel as it was
  estimate/fastmod        the same with fastmod
  estimate/hash_only      both hashes and the median, no gathers
  estimate/hash_only_fastmod  the same with fastmod
  estimate/gather_rand    gathers from a bucket from one multiply
  estimate/gather_rand_cg gather_rand through ld.global.cg, st.global.cs
  estimate/gather_rand_last gather_rand_cg with an L2 evict_last hint
  estimate/gather_rand@2^16 gather_rand from a 5 x 2**16 table

Then it times the kernels in ``kernels/csrc`` through their wrappers: the
encode's one-pass and binned paths (forced with ``_bin_capacity``) for
chunks of 2**12..2**24 elements into the 5 x 2**20 table, dense and 90%
zeros; the binned path's two kernels at 2**24 apart (``torch.profiler``);
the estimate at 2**24 ids; and the fused estimate + selection of 25,000
candidates from 2**24 ids of the table of the 2**24 dense chunk, whole and
by kernel (``torch.profiler``: pass 1, the two refine passes, the tile
count and write, and the zeroing of its histograms), beside the estimate
alone on that table.

Prints one line per variant (mean ms over 20 launches, CUDA events behind
a queued device sleep), the card's name and power limit, and the results
as one JSON object, which it also writes to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

SOURCE = r"""
#include "hash.cuh"

namespace {
constexpr int R = 5;

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

// The bucket of one row: `%` for MODE 0 and 2, fastmod for 1 and 7;
// hashing without the memory accesses for MODE 2 and 7.
template <int MODE>
__device__ __forceinline__ uint32_t hashed_bucket(uint32_t lo, uint32_t hi,
                                                  uint32_t seed,
                                                  uint32_t cols, uint64_t m) {
  const uint32_t h = fs::hash64(lo, hi, seed);
  return MODE == 0 || MODE == 2 ? h % cols : fs::fastmod(h, m, cols);
}

// MODE 0: % ; 1: fastmod ; 2: hash only (%) ; 3: cheap random ;
// 4: sequential ; 5: cheap random, values read with ld.cs ; 6: 5 with an
// L2 evict_last hint on the reductions ; 7: hash only (fastmod)
template <int MODE>
__global__ void encode(const float* __restrict__ v, long long n,
                       unsigned long long base, float* __restrict__ t,
                       uint32_t cols, uint64_t m, fs::RowSeeds sd,
                       float* __restrict__ sink) {
  constexpr bool kHash = MODE <= 2 || MODE == 7;
  constexpr bool kHashOnly = MODE == 2 || MODE == 7;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float acc = 0.0f;
  uint32_t accb = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float x = MODE == 5 || MODE == 6 ? __ldcs(v + i) : v[i];
    if (x == 0.0f) continue;
    const unsigned long long id = base + (unsigned long long)i;
    const uint32_t lo = (uint32_t)id, hi = (uint32_t)(id >> 32);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (kHash) {
        const uint32_t b = hashed_bucket<MODE>(lo, hi, sd.bucket[j], cols, m);
        const float s = fs::sign(lo, hi, sd.sign[j]);
        if (kHashOnly) { acc += s * x; accb ^= b; }
        else atomicAdd(t + (size_t)j * cols + b, s * x);
      } else {
        const uint32_t b = MODE == 4 ? (lo + j * 977u) & (cols - 1)
                                     : ((lo + j) * 0x9E3779B1u) & (cols - 1);
        if (MODE == 6) {
          asm volatile("red.global.add.L2::cache_hint.f32 [%0], %1, %2;"
                       :: "l"(t + (size_t)j * cols + b), "f"(x),
                          "l"(evict_last_policy()) : "memory");
        } else {
          atomicAdd(t + (size_t)j * cols + b, x);
        }
      }
    }
  }
  if (kHashOnly) {
    sink[(long long)blockIdx.x * blockDim.x + threadIdx.x] =
        acc + __uint_as_float(accb & 0x007FFFFFu);
  }
}

// MODE 0: % ; 1: fastmod ; 2: hash only (%) ; 3: cheap random gathers
// (ld.nc) ; 4: 3 through ld.cg, stores st.cs ; 5: 4 with an L2 evict_last
// hint on the gathers ; 7: hash only (fastmod)
template <int MODE>
__global__ void estimate(const float* __restrict__ t, uint32_t cols,
                         unsigned long long base, long long n,
                         float* __restrict__ out, uint64_t m,
                         fs::RowSeeds sd) {
  constexpr bool kHash = MODE <= 2 || MODE == 7;
  constexpr bool kHashOnly = MODE == 2 || MODE == 7;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const unsigned long long id = base + (unsigned long long)i;
    const uint32_t lo = (uint32_t)id, hi = (uint32_t)(id >> 32);
    float v[R];
    bool nan = false;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (kHash) {
        const uint32_t b = hashed_bucket<MODE>(lo, hi, sd.bucket[j], cols, m);
        const float s = fs::sign(lo, hi, sd.sign[j]);
        v[j] = kHashOnly ? s * (float)b
                         : s * __ldg(t + (size_t)j * cols + b);
      } else {
        const uint32_t b = ((lo + j) * 0x9E3779B1u) & (cols - 1);
        const float* a = t + (size_t)j * cols + b;
        if (MODE == 3) {
          v[j] = __ldg(a);
        } else if (MODE == 4) {
          v[j] = __ldcg(a);
        } else {
          asm volatile("ld.global.L2::cache_hint.f32 %0, [%1], %2;"
                       : "=f"(v[j]) : "l"(a), "l"(evict_last_policy()));
        }
      }
      nan |= v[j] != v[j];
    }
#pragma unroll
    for (int p = 0; p < R; ++p)
#pragma unroll
      for (int a = p & 1; a + 1 < R; a += 2) {
        const float x = v[a], y = v[a + 1];
        v[a] = fminf(x, y); v[a + 1] = fmaxf(x, y);
      }
    const float mid = __fmul_rn(__fadd_rn(v[(R - 1) / 2], v[R / 2]), 0.5f);
    const float r = nan ? __int_as_float(0x7fc00000) : mid;
    if (MODE == 4 || MODE == 5) __stcs(out + i, r); else out[i] = r;
  }
}

constexpr unsigned kGrid = 132 * 16, kThreads = 256;
}  // namespace

// Not launched: its SASS shows how a shared-memory f32 atomicAdd compiles.
extern "C" __global__ void probe_smem_atomic_add(
    const float* __restrict__ v, const unsigned short* __restrict__ c, int n,
    float* __restrict__ out) {
  __shared__ float s[1 << 12];
  for (int i = threadIdx.x; i < (1 << 12); i += blockDim.x) s[i] = 0.0f;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) atomicAdd(&s[c[i]], v[i]);
  __syncthreads();
  for (int i = threadIdx.x; i < (1 << 12); i += blockDim.x) out[i] = s[i];
}

#define PROBE_CASE(K, launch) case K: launch<K><<<kGrid, kThreads>>>
extern "C" int probe_encode(int mode, const float* v, long long n,
                            unsigned long long base, float* t, int cols,
                            unsigned long long m, const uint32_t* b,
                            const uint32_t* s, float* sink) {
  const fs::RowSeeds sd = fs::make_seeds(b, s, R);
  switch (mode) {
    PROBE_CASE(0, encode)(v, n, base, t, cols, m, sd, sink); break;
    PROBE_CASE(1, encode)(v, n, base, t, cols, m, sd, sink); break;
    PROBE_CASE(2, encode)(v, n, base, t, cols, m, sd, sink); break;
    PROBE_CASE(3, encode)(v, n, base, t, cols, m, sd, sink); break;
    PROBE_CASE(4, encode)(v, n, base, t, cols, m, sd, sink); break;
    PROBE_CASE(5, encode)(v, n, base, t, cols, m, sd, sink); break;
    PROBE_CASE(6, encode)(v, n, base, t, cols, m, sd, sink); break;
    PROBE_CASE(7, encode)(v, n, base, t, cols, m, sd, sink); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int probe_estimate(int mode, const float* t, int cols,
                              unsigned long long base, long long n,
                              float* out, unsigned long long m,
                              const uint32_t* b, const uint32_t* s) {
  const fs::RowSeeds sd = fs::make_seeds(b, s, R);
  switch (mode) {
    PROBE_CASE(0, estimate)(t, cols, base, n, out, m, sd); break;
    PROBE_CASE(1, estimate)(t, cols, base, n, out, m, sd); break;
    PROBE_CASE(2, estimate)(t, cols, base, n, out, m, sd); break;
    PROBE_CASE(3, estimate)(t, cols, base, n, out, m, sd); break;
    PROBE_CASE(4, estimate)(t, cols, base, n, out, m, sd); break;
    PROBE_CASE(5, estimate)(t, cols, base, n, out, m, sd); break;
    PROBE_CASE(7, estimate)(t, cols, base, n, out, m, sd); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""

ROWS, COLS, CHUNK, OFFSET = 5, 1 << 20, 1 << 24, (1 << 32) + 12_345
K = 25_000             # the main path's k: a 2**24 chunk's candidates
# name -> MODE of the probe source
ENCODE = {"as_is": 0, "fastmod": 1, "hash_only": 2, "hash_only_fastmod": 7,
          "atomic_rand": 3, "atomic_seq": 4, "atomic_rand_cs": 5,
          "atomic_rand_last": 6}
ESTIMATE = {"as_is": 0, "fastmod": 1, "hash_only": 2, "hash_only_fastmod": 7,
            "gather_rand": 3, "gather_rand_cg": 4, "gather_rand_last": 5}
SMALL_COLS = 1 << 16   # a 1.3 MB table: the same accesses, far fewer lines


def build_probe() -> ctypes.CDLL:
    from repro_torch.kernels import build
    out_dir = build.BUILD_ROOT / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "probe.cu"
    src.write_text(SOURCE)
    lib = out_dir / "libprobe.so"
    subprocess.run([build.nvcc(), *build.ARCH, "-O3", "-std=c++17",
                    "-Xcompiler", "-fPIC", "-shared", "-I", str(build.CSRC),
                    "-o", str(lib), str(src)], check=True)
    sass = subprocess.run([str(Path(build.nvcc()).with_name("cuobjdump")),
                           "-sass", str(lib)], capture_output=True, text=True)
    atoms = sorted({ln.split("*/")[1].split(";")[0].strip().split(" ")[0]
                    for ln in sass.stdout.splitlines()
                    if "ATOMS" in ln and "*/" in ln})
    print(f"shared-memory atomic instructions in the probe's SASS: {atoms}")
    probe = ctypes.CDLL(str(lib))
    P, LL, ULL, I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
                     ctypes.c_int)
    S = ctypes.POINTER(ctypes.c_uint32)
    probe.probe_encode.argtypes = [I, P, LL, ULL, P, I, ULL, S, S, P]
    probe.probe_estimate.argtypes = [I, P, I, ULL, LL, P, ULL, S, S]
    return probe


def time_ms_cuda(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after a warm-up,
    with a device sleep queued first so the host's launches are ahead."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def probe_first_kernels(torch, dev, gen, results):
    """The first kernels and their variants."""
    from repro_torch.kernels import count_sketch as cs
    probe = build_probe()
    bseeds, sseeds = cs.row_seeds(ROWS, 0)
    values = torch.randn(CHUNK, generator=gen, device=dev)
    table = torch.randn(ROWS, COLS, generator=gen, device=dev)
    sink = torch.empty(132 * 16 * 256, device=dev)
    out = torch.empty(CHUNK, device=dev)

    def encode(mode, cols=COLS):
        rc = probe.probe_encode(mode, values.data_ptr(), CHUNK, OFFSET,
                                table.data_ptr(), cols,
                                cs.fastmod_multiplier(cols), bseeds, sseeds,
                                sink.data_ptr())
        assert rc == 0, rc

    def estimate(mode, cols=COLS):
        rc = probe.probe_estimate(mode, table.data_ptr(), cols, OFFSET, CHUNK,
                                  out.data_ptr(), cs.fastmod_multiplier(cols),
                                  bseeds, sseeds)
        assert rc == 0, rc

    for name, mode in ENCODE.items():
        record(results, f"encode/{name}", time_ms_cuda(lambda: encode(mode)))
    record(results, "encode/atomic_rand@2^16",
           time_ms_cuda(lambda: encode(ENCODE["atomic_rand"], SMALL_COLS)))
    for name, mode in ESTIMATE.items():
        record(results, f"estimate/{name}",
               time_ms_cuda(lambda: estimate(mode)))
    record(results, "estimate/gather_rand@2^16",
           time_ms_cuda(lambda: estimate(ESTIMATE["gather_rand"],
                                         SMALL_COLS)))


def probe_paths(torch, dev, gen, results):
    """The encode's two paths by chunk length, and the estimate."""
    from repro_torch.kernels import count_sketch as cs
    table = torch.zeros(ROWS, COLS, device=dev)
    for log_n in (12, 14, 16, 18, 19, 20, 21, 22, 24):
        n = 1 << log_n
        dense = torch.randn(n, generator=gen, device=dev)
        sparse = dense * (torch.rand(n, generator=gen, device=dev) < 0.1)
        for kind, v in (("dense", dense), ("zeros90", sparse)):
            for path, cap in (("one_pass", 0),
                              ("binned", cs.bins().capacity(n, COLS))):
                record(results, f"encode/{path}/{kind}/2^{log_n}",
                       time_ms_cuda(lambda: cs.sketch_encode(
                           v, OFFSET, ROWS, COLS, out=table,
                           _bin_capacity=cap)))
    # the binned encode of the loop's last (2**24) dense chunk, by kernel
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            cs.sketch_encode(dense, OFFSET, ROWS, COLS, out=table)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        for part in ("partition", "accumulate"):
            if part in e.key and e.count:
                record(results, f"encode/binned/{part}/2^24",
                       e.self_device_time_total / e.count / 1e3)
    record(results, "estimate/new/2^24", time_ms_cuda(
        lambda: cs.sketch_estimate(table, OFFSET, CHUNK)))
    # the fused estimate + selection on the sketch of that chunk
    table = cs.sketch_encode(dense, OFFSET, ROWS, COLS)
    record(results, "estimate/new/2^24/reals", time_ms_cuda(
        lambda: cs.sketch_estimate(table, OFFSET, CHUNK)))
    record(results, "estimate_select/2^24", time_ms_cuda(
        lambda: cs.sketch_estimate_topk(table, OFFSET, CHUNK, K)))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            cs.sketch_estimate_topk(table, OFFSET, CHUNK, K)
        torch.cuda.synchronize()
    parts = {"estimate_hist": "pass1", "refine_kernel<11": "refine2",
             "refine_kernel<8": "refine3", "tile_count": "tile_count",
             "tile_write": "tile_write", "FillFunctor": "zero"}
    for e in prof.key_averages():
        for key, part in parts.items():
            if key in e.key and e.count:
                record(results, f"estimate_select/{part}/2^24",
                       e.self_device_time_total / e.count / 1e3)


def record(results, name, ms):
    results[name] = ms
    print(f"{name:30s} {ms:.6f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/probe_sketch_bounds.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_sketch_bounds: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results: dict[str, float] = {}
    probe_first_kernels(torch, dev, gen, results)
    probe_paths(torch, dev, gen, results)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip())
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
