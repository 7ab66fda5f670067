"""Plain reference of FetchSGD's sketch and server step (Algorithm 1).

Written from the algorithm and the published hash arithmetic, for the
benchmark's comparison; it shares no code with the program under test.

* Flat id space.  The model is one d-vector: leaves in sorted-path order,
  each leaf row-major, so a leaf's element ``i`` has global id
  ``leaf_offset + i``.  The chunks that bound a selection are row ranges of
  each leaf's 2-D view ``(prod(shape[:-1]), shape[-1])`` (a 1-D leaf is a
  column), at most ``CHUNK_ELEMS`` elements each.
* Hashes.  murmur3's fmix32 over the id's two 32-bit words, row seeds as
  FetchSGD's Count Sketch defines them: bucket ``h % cols``, sign ``+1``
  where the hash's top bit is 0.  Words are int32 tensors; a product wraps
  modulo 2**32 as two's-complement integer multiplication does, and a
  logical right shift is an arithmetic one masked.
* Server step.  ``S_u = rho * S_u + S``, ``S_e = lr * S_u + S_e``; Delta is
  the top-k by magnitude of the median-of-rows estimates of ``S_e``, picked
  as the system states it: each chunk offers its ``kk`` largest
  (``kk = min(k, chunk)``, capped at ``max(512, 4k / chunks)`` when the
  layout has more than 64 chunks), then the k largest of the pool; the
  cells Delta's ids hash into are zeroed in ``S_e`` and ``S_u``;
  ``w -= Delta``.

Ids must lie below 2**32 (both configurations' d do), so an id's high word
is 0.
"""

from __future__ import annotations

import math

import torch

ROW_SEEDS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1,
             0xD3A2646C, 0xFD7046C5, 0xB55A4F09, 0x8F1BBCDC, 0xCA62C1D6)
M32 = 0xFFFFFFFF
CHUNK_ELEMS = 1 << 24
EXACT_CHUNKS = 64


def _s32(c: int) -> int:
    """A 32-bit word as the int32 value with the same bits."""
    c &= M32
    return c - (1 << 32) if c >= 1 << 31 else c


def _srl(h: torch.Tensor, s: int) -> torch.Tensor:
    return (h >> s) & ((1 << (32 - s)) - 1)


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _srl(h, 16)
    h = h * _s32(0x85EBCA6B)
    h = h ^ _srl(h, 13)
    h = h * _s32(0xC2B2AE35)
    return h ^ _srl(h, 16)


def _hash(lo: torch.Tensor, seed: int) -> torch.Tensor:
    """32-bit hash (int32 bits) of ids with low words ``lo`` and high word 0."""
    h = _fmix(lo ^ _s32(seed))
    return _fmix(h ^ _s32((seed * 0x9E3779B9 + 1) & M32))


def bucket_seed(row: int, key: int = 0) -> int:
    return ROW_SEEDS[row % len(ROW_SEEDS)] ^ ((key * 0x632BE59B) & M32)


def sign_seed(row: int, key: int = 0) -> int:
    return ((ROW_SEEDS[(row + 3) % len(ROW_SEEDS)] * 0x9E3779B9)
            ^ (key * 0x85EBCA6B)) & M32


def low_words(ids: torch.Tensor) -> torch.Tensor:
    """int64 ids below 2**32 -> their words as int32 bits."""
    if ids.numel() and int(ids.max()) > M32:
        raise ValueError("the reference hashes ids below 2**32 only")
    return torch.where(ids >= 1 << 31, ids - (1 << 32), ids).to(torch.int32)


def row_hash(lo: torch.Tensor, row: int, cols: int, key: int = 0
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(bucket int64, sign float32) of the ids ``lo`` in sketch row ``row``."""
    h = _hash(lo, bucket_seed(row, key))
    if cols & (cols - 1) == 0:
        bucket = (h & (cols - 1)).to(torch.int64)
    else:
        bucket = (h.to(torch.int64) & M32) % cols
    s = _hash(lo, sign_seed(row, key))
    sign = torch.where(s >= 0, 1.0, -1.0).to(torch.float32)
    return bucket, sign


def block_words(offset: int, n: int, device) -> torch.Tensor:
    return low_words(torch.arange(offset, offset + n, dtype=torch.int64,
                                  device=device))


# -- the flat layout -------------------------------------------------------

def chunks(spec) -> list[tuple[int, int]]:
    """(global offset, size) of each selection chunk; ``spec``: the sorted
    (path, shape) leaves."""
    out, offset = [], 0
    for _, shape in spec:
        if len(shape) == 0:
            n_rows, row_len = 1, 1
        elif len(shape) == 1:
            n_rows, row_len = shape[0], 1
        else:
            n_rows, row_len = math.prod(shape[:-1]), shape[-1]
        per = max(1, CHUNK_ELEMS // row_len)
        for r in range(0, n_rows, per):
            out.append((offset + r * row_len, min(per, n_rows - r) * row_len))
        offset += n_rows * row_len
    return out


def chunk_k(k: int, size: int, n_chunks: int) -> int:
    if n_chunks <= EXACT_CHUNKS:
        return min(k, size)
    return min(k, size, max(512, (4 * k) // n_chunks))


# -- Count Sketch ------------------------------------------------------------

def sketch(flat: torch.Tensor, spans, rows: int, cols: int,
           key: int = 0) -> torch.Tensor:
    """(rows, cols) Count Sketch of the flat float32 vector ``flat``,
    encoded span by span (``spans``: (offset, size) covering it)."""
    table = torch.zeros(rows, cols, dtype=torch.float32, device=flat.device)
    for off, n in spans:
        lo = block_words(off, n, flat.device)
        vals = flat[off:off + n].to(torch.float32)
        for r in range(rows):
            bucket, sign = row_hash(lo, r, cols, key)
            table[r].index_add_(0, bucket, sign * vals)
    return table


def median_rows(x: torch.Tensor) -> torch.Tensor:
    s = torch.sort(x, dim=0).values
    r = x.shape[0]
    return (s[(r - 1) // 2] + s[r // 2]) * 0.5


def estimate(table: torch.Tensor, offset: int, n: int,
             key: int = 0) -> torch.Tensor:
    """Median-of-rows estimates of ids offset .. offset + n - 1."""
    rows, cols = table.shape
    lo = block_words(offset, n, table.device)
    est = []
    for r in range(rows):
        bucket, sign = row_hash(lo, r, cols, key)
        est.append(sign * table[r][bucket])
    return median_rows(torch.stack(est))


def top_k(table: torch.Tensor, spans, k: int, key: int = 0
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(global ids, estimates) of Delta = the top-k of U(table), chunk
    candidates first."""
    ids, vals = [], []
    for off, n in spans:
        est = estimate(table, off, n, key)
        kk = chunk_k(k, n, len(spans))
        idx = torch.topk(est.abs(), kk).indices
        ids.append(idx + off)
        vals.append(est[idx])
    ids, vals = torch.cat(ids), torch.cat(vals)
    sel = torch.topk(vals.abs(), min(k, vals.numel())).indices
    return ids[sel], vals[sel]


def hit_mask(ids: torch.Tensor, rows: int, cols: int,
             key: int = 0) -> torch.Tensor:
    mask = torch.zeros(rows, cols, dtype=torch.bool, device=ids.device)
    lo = low_words(ids)
    for r in range(rows):
        mask[r, row_hash(lo, r, cols, key)[0]] = True
    return mask


class Server:
    """The server's sketches and step; weights as one flat vector."""

    def __init__(self, rows: int, cols: int, k: int, momentum: float,
                 spans, device, key: int = 0):
        self.rows, self.cols, self.k, self.rho = rows, cols, k, momentum
        self.spans, self.key = spans, key
        self.su = torch.zeros(rows, cols, dtype=torch.float32, device=device)
        self.se = torch.zeros_like(self.su)

    def step(self, table: torch.Tensor, lr: float,
             flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Fold in the merged table, pick Delta, zero its cells, and
        apply it to ``flat`` in place; returns Delta (ids, values)."""
        self.su = self.rho * self.su + table
        self.se = torch.tensor(lr, dtype=torch.float32) * self.su + self.se
        ids, vals = top_k(self.se, self.spans, self.k, self.key)
        mask = hit_mask(ids, self.rows, self.cols, self.key)
        self.se = torch.where(mask, 0.0, self.se)
        self.su = torch.where(mask, 0.0, self.su)
        with torch.no_grad():
            flat.index_add_(0, ids, vals.to(flat.dtype), alpha=-1.0)
        return ids, vals
