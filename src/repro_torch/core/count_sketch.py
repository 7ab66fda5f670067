"""Count Sketch (Charikar et al., 2002) over global 64-bit element ids.

Port of ``repro.core.count_sketch``.  The sketch of a vector ``g`` is an
``(r, c)`` table where row ``j`` holds ``T[j, h_j(i)] += s_j(i) * g_i``;
the map is linear, which is what lets FetchSGD merge client sketches and
keep momentum and error in sketch space.

These are the plain PyTorch versions: the CPU path and the reference the
CUDA kernels are held against.  The reference's ``*_dyn`` variants (a
traced base offset) collapse into the functions here, whose offsets are
Python ints.  Sparse id sets are int64 tensors of global ids.
"""

from __future__ import annotations

import torch

from . import hashing


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
