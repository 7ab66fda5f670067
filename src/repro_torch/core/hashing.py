"""Deterministic hash families for Count Sketch, computed on the fly.

Port of ``repro.core.hashing``: the same murmur3-style finalizer over a
64-bit element id split in two 32-bit words ``(hi, lo)``, with the same
row seeds, so a sketch made here and one made by the reference agree bit
for bit.

torch on the CPU implements no ``>>``, ``%``, ``<`` or ``+`` for uint32,
so the plain code holds each 32-bit word in an int64 tensor and masks
with ``& 0xFFFFFFFF``.  Multiplications by 32-bit constants are split in
16-bit halves so that no intermediate exceeds 2**49.  The CUDA kernels
(``repro_torch/kernels/csrc/hash.cuh``) compute the same words natively in
``uint32_t``.
"""

from __future__ import annotations

import torch

# Distinct odd constants per hash role, derived from splitmix64 outputs.
ROW_SEEDS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1,
             0xD3A2646C, 0xFD7046C5, 0xB55A4F09, 0x8F1BBCDC, 0xCA62C1D6)
MAX_ROWS = len(ROW_SEEDS)
MASK = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for int64 words ``h < 2**32`` and 32-bit ``c``."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _mix(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 — full avalanche on a 32-bit word."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def hash64(lo: torch.Tensor, hi: torch.Tensor, seed: int) -> torch.Tensor:
    """Hash a 64-bit id given as two 32-bit words -> a 32-bit word (int64)."""
    h = _mix(lo ^ seed)
    return _mix(h ^ hi ^ ((seed * 0x9E3779B9 + 1) & MASK))


def bucket_seed(row: int, key: int = 0) -> int:
    return ROW_SEEDS[row % MAX_ROWS] ^ ((key * 0x632BE59B) & MASK)


def sign_seed(row: int, key: int = 0) -> int:
    return ((ROW_SEEDS[(row + 3) % MAX_ROWS] * 0x9E3779B9)
            ^ (key * 0x85EBCA6B)) & MASK


def bucket_hash(lo: torch.Tensor, hi: torch.Tensor, row: int, c: int,
                key: int = 0) -> torch.Tensor:
    """Bucket index in [0, c) for sketch row ``row`` (int64)."""
    return hash64(lo, hi, bucket_seed(row, key)) % c


def sign_hash(lo: torch.Tensor, hi: torch.Tensor, row: int,
              key: int = 0) -> torch.Tensor:
    """Rademacher sign in {-1, +1} (float32) for sketch row ``row``."""
    h = hash64(lo, hi, sign_seed(row, key))
    return torch.where((h >> 31) == 0, 1.0, -1.0).to(torch.float32)


def split_ids(ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of int64 global element ids."""
    return ids >> 32, ids & MASK


def split64(offset: int, n: int, device=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words for global element ids offset .. offset+n-1."""
    ids = torch.arange(n, dtype=torch.int64, device=device) + offset
    return split_ids(ids)


def offset_words(offsets, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Python offsets -> (lo, hi) word tensors."""
    lo = torch.tensor([o & MASK for o in offsets], dtype=torch.int64,
                      device=device)
    hi = torch.tensor([o >> 32 for o in offsets], dtype=torch.int64,
                      device=device)
    return lo, hi


def mul32x32(a: torch.Tensor, b: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Widening multiply: 32-bit words ``a`` (int64 tensor) x a Python int
    ``b < 2**31`` -> the (hi, lo) words of the 64-bit product.

    Long multiplication over 16-bit halves with explicit carries, as the
    reference assembles 64-bit ids from 32-bit lanes; each partial product
    stays below 2**32, so int64 holds it exactly.
    """
    bl, bh = b & 0xFFFF, (b >> 16) & 0xFFFF
    al, ah = a & 0xFFFF, a >> 16
    ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh
    mid = (lh + hl) & MASK
    mid_carry = (mid < lh).to(torch.int64)           # overflowed 32 bits
    lo = (ll + (mid << 16)) & MASK
    c1 = (lo < ll).to(torch.int64)
    hi = (hh + (mid >> 16) + (mid_carry << 16) + c1) & MASK
    return hi, lo


def ids_for_grid(base_lo: int, base_hi: int, row0: int, n_rows: int,
                 row_stride: int, col0: int, n_cols: int, device=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of the strided id grid
    ``base + (row0 + r) * row_stride + col0 + c`` (r < n_rows, c < n_cols),
    flattened row-major to (n_rows * n_cols,).

    The ids of a model shard's column slice of a leaf's 2-D view
    (``core.model_local``); every quantity that can pass 32 bits is a
    (hi, lo) pair, wrapping as the reference's uint32 words do.
    """
    r = (torch.arange(n_rows, dtype=torch.int64, device=device) + row0) & MASK
    rs_hi, rs_lo = mul32x32(r, row_stride)
    lo_r = (rs_lo + base_lo) & MASK
    hi_r = (rs_hi + base_hi + (lo_r < rs_lo).to(torch.int64)) & MASK
    c = (torch.arange(n_cols, dtype=torch.int64, device=device) + col0) & MASK
    lo = (lo_r[:, None] + c[None, :]) & MASK
    hi = (hi_r[:, None] + (lo < lo_r[:, None]).to(torch.int64)) & MASK
    return hi.reshape(-1), lo.reshape(-1)


def join_words(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 global ids from their (hi, lo) words (ids below 2**63)."""
    return (hi << 32) | lo
