"""CUDA wrappers of the Count Sketch encode and estimate kernels.

``csrc/encode.cu`` replaces ``repro/kernels/count_sketch.py::_encode_kernel``
and ``csrc/estimate.cu`` replaces ``::_estimate_kernel``;
``csrc/estimate_select.cu`` fuses that estimate with the per-chunk top-k of
``repro/core/topk.py::topk_from_sketch`` (``sketch_estimate_topk``).  The
wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, allocate what the kernels write (and their scratch), launch on
PyTorch's current stream and raise if the launch failed.  ``LAUNCHES``
counts the calls that launched each kernel: one an encode call, whether it
took the one-pass kernel or the binned pair (``PATHS`` splits them), and one
an estimate call, of the plain estimate or of the fused one, whose
selection runs four more kernels after it.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.core import hashing

from . import build

LAUNCHES = {"encode": 0, "estimate": 0}

# encode calls by the path they took (both count in LAUNCHES["encode"])
PATHS = {"one_pass": 0, "binned": 0}


def check_cuda(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"expected CUDA tensors on one device, got "
                             f"{[str(t.device) for t in tensors]}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")
    return dev


def check_table(table: torch.Tensor, rows: int, cols: int) -> None:
    if table.dtype != torch.float32 or tuple(table.shape) != (rows, cols):
        raise ValueError(f"expected a ({rows}, {cols}) float32 table, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if not 1 <= rows <= hashing.MAX_ROWS:
        raise ValueError(f"rows must be in 1..{hashing.MAX_ROWS}, got {rows}")


def row_seeds(rows: int, key: int):
    return (build.seeds(hashing.bucket_seed(j, key) for j in range(rows)),
            build.seeds(hashing.sign_seed(j, key) for j in range(rows)))


def fastmod_multiplier(cols: int) -> int:
    """Lemire's fastmod constant for ``cols``: ``h % cols`` equals
    ``((m * h mod 2**64) * cols) >> 64`` for every 32-bit ``h`` (the
    kernels' bucket, ``hash.cuh``).  Plain integers: torch has no uint64
    arithmetic on the CPU."""
    if not 1 <= cols < 1 << 31:
        raise ValueError(f"cols must be in 1..2**31-1, got {cols}")
    return (((1 << 64) - 1) // cols + 1) % (1 << 64)


@dataclasses.dataclass(frozen=True)
class Bins:
    """The binned encode's geometry: ``cols`` columns a bin, at most
    ``max_bins`` bins a table.  :func:`bins` gives the values that
    ``csrc/encode.cu`` compiles in."""

    cols: int
    max_bins: int

    def per_row(self, cols: int) -> int:
        return -(-cols // self.cols)

    def capacity(self, n: int, cols: int) -> int:
        """Records each bin holds for an n-element chunk: the expected
        count of a full bin, n * min(cols, self.cols) / cols, plus 8
        standard deviations and 64, in multiples of 8; never more than n
        rounded up, which no bin can exceed.  A record that finds its bin
        full is still added (by a global atomic), so this only sizes the
        scratch."""
        mean = n * min(cols, self.cols) / cols
        cap = min(math.ceil(mean + 8 * math.sqrt(mean) + 64), n)
        return -(-cap // 8) * 8

    def use(self, n: int, rows: int, cols: int) -> bool:
        """Whether an n-element chunk takes the binned path.  It pays a
        fixed cost (its accumulate kernel visits every bin of the table)
        and saves on every record against the one-pass atomics; on the
        H100 it wins from about two elements per column of the table on
        (``python -m repro_torch.launch.probe_sketch_bounds`` times both
        paths by chunk length).  Tables of more than ``max_bins`` bins,
        and chunks of 2**31 elements or more, take the one-pass kernel."""
        return (n >= 2 * cols and rows * self.per_row(cols) <= self.max_bins
                and n < 1 << 31)


@functools.cache
def bins() -> Bins:
    lib = build.library()
    return Bins(lib.fs_encode_bin_cols(), lib.fs_encode_max_bins())


def _check_ids(offset: int, n: int) -> None:
    if offset < 0 or offset + n > 1 << 64:
        raise ValueError(f"ids {offset}..{offset + n} are not 64-bit")


def sketch_encode(values: torch.Tensor, offset: int, rows: int, cols: int,
                  key: int = 0, *, out: torch.Tensor | None = None,
                  _bin_capacity: int | None = None) -> torch.Tensor:
    """Add the sketch of the 1-D chunk ``values`` (global ids from
    ``offset``) into ``out`` (a new zero table if None) and return it.

    ``_bin_capacity`` is for the card tests only: 0 takes the one-pass
    kernel, a positive multiple of 8 the binned one with that many records
    a bin (a small one forces its overflow path); None lets ``Bins.use``
    and ``Bins.capacity`` choose."""
    if values.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"encode takes float32 or bfloat16, got "
                         f"{values.dtype}")
    if out is None:
        out = torch.zeros(rows, cols, dtype=torch.float32,
                          device=values.device)
    dev = check_cuda(values, out)
    check_table(out, rows, cols)
    n = values.numel()
    _check_ids(offset, n)
    if n == 0:
        return out
    bseeds, sseeds = row_seeds(rows, key)
    m = fastmod_multiplier(cols)
    geo = bins()
    if _bin_capacity is None:
        cap = geo.capacity(n, cols) if geo.use(n, rows, cols) else 0
    else:
        cap = _bin_capacity
    rec_val = rec_col = cursor = None
    if cap:
        nbins = rows * geo.per_row(cols)
        rec_val = torch.empty(nbins * cap, dtype=torch.float32, device=dev)
        rec_col = torch.empty(nbins * cap, dtype=torch.int16, device=dev)
        cursor = torch.empty(nbins, dtype=torch.int32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.fs_encode(values.data_ptr(),
                           int(values.dtype == torch.bfloat16), n, offset,
                           out.data_ptr(), rows, cols, bseeds, sseeds, m,
                           *(t if t is None else t.data_ptr()
                             for t in (rec_val, rec_col, cursor)),
                           cap, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "encode")
    LAUNCHES["encode"] += 1
    PATHS["binned" if cap else "one_pass"] += 1
    return out


def sketch_estimate(table: torch.Tensor, offset: int, n: int,
                    key: int = 0) -> torch.Tensor:
    """(n,) median-of-rows estimates for global ids offset..offset+n-1."""
    dev = check_cuda(table)
    rows, cols = table.shape
    check_table(table, rows, cols)
    _check_ids(offset, n)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    bseeds, sseeds = row_seeds(rows, key)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.fs_estimate(table.data_ptr(), rows, cols, offset, n,
                             out.data_ptr(), bseeds, sseeds,
                             fastmod_multiplier(cols),
                             torch.cuda.current_stream().cuda_stream)
    build.check(rc, "estimate")
    LAUNCHES["estimate"] += 1
    return out


@dataclasses.dataclass(frozen=True)
class Select:
    """The fused selection's geometry, as ``csrc/estimate_select.cu``
    compiles it: ``tile`` ids a block of its count and write passes,
    ``group_tiles`` tiles a group whose counts are summed by atomics, and
    ``state_words`` 32-bit words of histograms and state."""

    tile: int
    group_tiles: int
    state_words: int

    def tiles(self, n: int) -> int:
        return -(-n // self.tile)

    def work_words(self, n: int) -> int:
        """The zeroed words a call of n ids needs: the state, then one
        64-bit count a group."""
        return self.state_words + 2 * -(-self.tiles(n) // self.group_tiles)

    @staticmethod
    def capacity(n: int, kk: int) -> int:
        """Entries of the compact candidate list: room for 4 kk (the kk
        winners and the ties beside them), at least 2**16, at most n.  A
        tile that finds the list full is written from the scratch."""
        return min(n, max(4 * kk, 1 << 16))


@functools.cache
def select_geometry() -> Select:
    lib = build.library()
    return Select(lib.fs_select_tile(), lib.fs_select_group_tiles(),
                  lib.fs_select_state_words())


def sketch_estimate_topk(table: torch.Tensor, offset: int, n: int, kk: int,
                         key: int = 0, *, _capacity: int | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kk ids of offset..offset+n-1 with the largest |estimate|:
    ``(values (kk,) float32, local_idx (kk,) int64)``, the signed
    estimates and the ids less ``offset``.

    The ids are those ``torch.topk(|estimate|, kk)`` picks, with ties at
    the kk-th magnitude going to the lowest local indices, in ascending
    local index; NaN counts as the largest magnitude.  The estimates are
    ``sketch_estimate``'s, bit for bit.  No host sync: the chunk's n
    estimates live in a scratch of n floats on the card.

    ``_capacity`` is for the card tests only: the compact candidate list's
    entries (0 writes every tile from the scratch); None lets
    ``Select.capacity`` size it."""
    dev = check_cuda(table)
    rows, cols = table.shape
    check_table(table, rows, cols)
    _check_ids(offset, n)
    if not 1 <= n < 1 << 31:
        raise ValueError(f"the fused selection takes 1..2**31-1 ids, got {n}")
    if not 1 <= kk <= n:
        raise ValueError(f"kk must be in 1..n = {n}, got {kk}")
    geo = select_geometry()
    est = torch.empty(n, dtype=torch.float32, device=dev)
    work = torch.zeros(geo.work_words(n), dtype=torch.int32, device=dev)
    tile_counts = torch.empty(geo.tiles(n), dtype=torch.int64, device=dev)
    tile_start = torch.empty(geo.tiles(n), dtype=torch.int32, device=dev)
    capacity = geo.capacity(n, kk) if _capacity is None else _capacity
    cand = torch.empty(capacity, dtype=torch.int64, device=dev)
    values = torch.empty(kk, dtype=torch.float32, device=dev)
    idx = torch.empty(kk, dtype=torch.int64, device=dev)
    bseeds, sseeds = row_seeds(rows, key)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.fs_estimate_select(
            table.data_ptr(), rows, cols, offset, n, kk, est.data_ptr(),
            work.data_ptr(), tile_counts.data_ptr(), tile_start.data_ptr(),
            cand.data_ptr(), capacity, values.data_ptr(), idx.data_ptr(),
            bseeds, sseeds,
            fastmod_multiplier(cols), torch.cuda.current_stream().cuda_stream)
    build.check(rc, "estimate")
    LAUNCHES["estimate"] += 1
    return values, idx
