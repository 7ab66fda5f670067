"""Count Sketch (Charikar et al., 2002) over global 64-bit element ids.

Port of ``repro.core.count_sketch``.  The sketch of a vector ``g`` is an
``(r, c)`` table where row ``j`` holds ``T[j, h_j(i)] += s_j(i) * g_i``;
the map is linear, which is what lets FetchSGD merge client sketches and
keep momentum and error in sketch space.

The table-level functions are the plain PyTorch versions: the CPU path
and the reference the CUDA kernels are held against.  The reference's
``*_dyn`` variants (a traced base offset) collapse into the functions
here, whose offsets are Python ints.  Sparse id sets are int64 tensors of
global ids.

The object API (``CountSketch``, ``zeros``, ``sketch_vector``,
``estimate``, ``hit_mask_chunk``) is the reference's.  ``sketch_vector``
and ``estimate`` dispatch through ``repro_torch.kernels.ops``: a CUDA
tensor launches the encode or estimate kernel, a CPU one takes the plain
version above.  ``kernels.ref`` imports this module, so ``kernels.ops`` is
imported inside those two functions, when they are called.
"""

from __future__ import annotations

import dataclasses

import torch

from . import hashing


@dataclasses.dataclass
class CountSketch:
    """An (r, c) Count Sketch table plus its static hash identity."""

    table: torch.Tensor
    rows: int
    cols: int
    key: int = 0

    # -- linear-space algebra ------------------------------------------------
    def __add__(self, other: "CountSketch") -> "CountSketch":
        self._check_compat(other)
        return dataclasses.replace(self, table=self.table + other.table)

    def __sub__(self, other: "CountSketch") -> "CountSketch":
        self._check_compat(other)
        return dataclasses.replace(self, table=self.table - other.table)

    def scale(self, a) -> "CountSketch":
        return dataclasses.replace(self, table=self.table * a)

    def _check_compat(self, other: "CountSketch") -> None:
        if (self.rows, self.cols, self.key) != (other.rows, other.cols,
                                                other.key):
            raise ValueError(
                "CountSketch hash identities differ; cannot merge.")

    # -- norms ---------------------------------------------------------------
    def l2_estimate(self) -> torch.Tensor:
        """AMS-style estimate of ||g||: median over rows of row l2 norms."""
        return l2_estimate(self.table)


def zeros(rows: int, cols: int, key: int = 0, dtype=torch.float32,
          device=None) -> CountSketch:
    """An empty sketch; ``device`` as ``torch.zeros`` takes it."""
    return CountSketch(torch.zeros(rows, cols, dtype=dtype, device=device),
                       rows, cols, key)


def _row_hashes(hi: torch.Tensor, lo: torch.Tensor, row: int, cols: int,
                key: int) -> tuple[torch.Tensor, torch.Tensor]:
    return (hashing.bucket_hash(lo, hi, row, cols, key),
            hashing.sign_hash(lo, hi, row, key))


def sketch_chunk(values: torch.Tensor, offset: int, rows: int, cols: int,
                 key: int = 0) -> torch.Tensor:
    """(rows, cols) table of a contiguous chunk whose element ``i`` has
    global id ``offset + i``.  One 1-D scatter-add per row."""
    values = values.reshape(-1).to(torch.float32)
    hi, lo = hashing.split64(offset, values.numel(), values.device)
    table = torch.zeros(rows, cols, dtype=torch.float32, device=values.device)
    for j in range(rows):
        idx, sgn = _row_hashes(hi, lo, j, cols, key)
        table[j].index_add_(0, idx, sgn * values)
    return table


def median_rows(x: torch.Tensor) -> torch.Tensor:
    """Median over dim 0 with ``jnp.median``'s semantics.

    ``torch.median`` returns the lower middle value for an even count;
    ``jnp.median`` takes ``(low + high) * 0.5`` (its 'midpoint' quantile)
    and is NaN wherever any input is NaN.
    """
    s = torch.sort(x, dim=0).values
    r = x.shape[0]
    mid = (s[(r - 1) // 2] + s[r // 2]) * 0.5
    return torch.where(torch.isnan(x).any(dim=0), float("nan"), mid)


def l2_estimate(table: torch.Tensor) -> torch.Tensor:
    """Median over rows of the table's row l2 norms (``jnp.median``'s
    midpoint for an even row count)."""
    return median_rows(torch.linalg.vector_norm(table, dim=1))


def estimate_chunk(table: torch.Tensor, offset: int, n: int,
                   key: int = 0) -> torch.Tensor:
    """Median-of-rows estimates for global ids offset..offset+n-1."""
    rows, cols = table.shape
    hi, lo = hashing.split64(offset, n, table.device)
    ests = []
    for j in range(rows):
        idx, sgn = _row_hashes(hi, lo, j, cols, key)
        ests.append(sgn * table[j, idx])
    return median_rows(torch.stack(ests))


def sketch_vector(values: torch.Tensor, rows: int, cols: int, key: int = 0,
                  offset: int = 0) -> CountSketch:
    """Sketch a full vector, whose element ``i`` has global id
    ``offset + i``, into a CountSketch: the encode kernel on the card."""
    from repro_torch.kernels import ops

    values = values.reshape(-1)
    if values.dtype not in (torch.float32, torch.bfloat16):
        values = values.to(torch.float32)
    table = ops.sketch_encode(values.contiguous(), offset, rows, cols, key)
    return CountSketch(table, rows, cols, key)


def estimate(cs: CountSketch, offset: int, n: int) -> torch.Tensor:
    """Estimates of global ids offset..offset+n-1 from ``cs``: the
    estimate kernel on the card."""
    from repro_torch.kernels import ops

    return ops.sketch_estimate(cs.table, offset, n, cs.key)


def hit_mask_chunk(offset: int, n: int, rows: int, cols: int, key: int,
                   active: torch.Tensor) -> torch.Tensor:
    """(rows, cols) bool mask of the cells the ``active`` subset of ids
    offset..offset+n-1 hash into (``active``: bool, (n,)).  The paper's
    practical variant zeroes these cells of S_e (and of S_u, momentum
    factor masking) instead of subtracting S(Delta)."""
    ids = torch.arange(n, dtype=torch.int64, device=active.device) + offset
    return hit_mask_ids(ids[active.reshape(-1).to(torch.bool)], rows, cols,
                        key)


def sketch_sparse(ids: torch.Tensor, values: torch.Tensor, rows: int,
                  cols: int, key: int = 0) -> torch.Tensor:
    """Sketch table of a k-sparse vector given its global ids — S(Delta)."""
    hi, lo = hashing.split_ids(ids)
    values = values.to(torch.float32)
    table = torch.zeros(rows, cols, dtype=torch.float32, device=values.device)
    for j in range(rows):
        idx, sgn = _row_hashes(hi, lo, j, cols, key)
        table[j].index_add_(0, idx, sgn * values)
    return table


def hit_mask_ids(ids: torch.Tensor, rows: int, cols: int,
                 key: int = 0) -> torch.Tensor:
    """(rows, cols) bool mask of the cells any of the given ids hash into."""
    hi, lo = hashing.split_ids(ids)
    mask = torch.zeros(rows, cols, dtype=torch.bool, device=ids.device)
    for j in range(rows):
        mask[j, hashing.bucket_hash(lo, hi, j, cols, key)] = True
    return mask
