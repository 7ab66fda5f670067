"""Sliding-window error accumulation (paper Sec. 4.2 / Appendix D).

Port of ``repro.core.sliding_window`` on plain tensors.  Theorem 2 needs
the error sketch to capture signal that is l2-heavy only in a sum of up
to ``I`` *consecutive* gradients; vanilla error accumulation sums all of
history, so the O(t) accumulated noise eventually drowns an O(I)-sized
signal.  Two schemes are provided:

* ``SlidingWindowSketch`` — the straightforward construction from Fig. 2 /
  Fig. 11a: ``I`` staggered Count Sketches; sketch ``i`` is zeroed every
  ``I`` iterations at offset ``i``.  At any time, for every ``I' <= I``
  there is a sketch holding exactly the sum of the last ``I'`` inserts.
  O(I) memory.
* ``LogWindowSketch`` — the smooth-histogram style variant (Braverman &
  Ostrovsky, 2007; Fig. 11b): sketches at geometrically-spaced ages, so
  only O(log I) tables are kept; window sums are answered by the closest
  retained suffix (a (1+eps) approximation of the window asked for).

Both reuse the vanilla ``CountSketch`` table layout.  Every function
returns a new state and leaves its argument as it was.  No orchestrator
path uses them: like the paper's experiments, training keeps a single
vanilla sketch.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SlidingWindowSketch:
    """I staggered (rows, cols) tables; table i is zeroed when t % I == i."""

    tables: torch.Tensor   # (I, rows, cols)
    t: int                 # inserts performed so far
    window: int


def sw_init(window: int, rows: int, cols: int,
            device=None) -> SlidingWindowSketch:
    return SlidingWindowSketch(
        tables=torch.zeros(window, rows, cols, dtype=torch.float32,
                           device=device), t=0, window=window)


def sw_insert(sw: SlidingWindowSketch,
              table: torch.Tensor) -> SlidingWindowSketch:
    """Zero the sketch whose turn it is, then add the new sketched gradient.

    Clearing BEFORE accumulating makes slot j hold inserts j..t-1 at any
    later time t, so every suffix length 1..I is available (Fig. 2: each
    sketch is zeroed every I iterations at its offset).
    """
    tables = sw.tables.clone()
    tables[sw.t % sw.window] = 0.0
    return SlidingWindowSketch(tables=tables + table[None], t=sw.t + 1,
                               window=sw.window)


def sw_suffix(sw: SlidingWindowSketch, length: int) -> torch.Tensor:
    """Table holding the sum of the last ``length`` inserts (length <= I).

    Slot j%I is cleared right before insert j is accumulated, so after t
    inserts it holds inserts j..t-1; the suffix of the last ``length``
    inserts starts at t-length -> slot (t-length) % I.
    """
    return sw.tables[(sw.t - int(length)) % sw.window]


def sw_union_mask(sw: SlidingWindowSketch,
                  threshold: float | torch.Tensor) -> torch.Tensor:
    """Cells exceeding threshold in *any* suffix (FindHeavy over all I')."""
    return torch.any(sw.tables.abs() >= threshold, dim=0)


def sw_subtract(sw: SlidingWindowSketch,
                table: torch.Tensor) -> SlidingWindowSketch:
    """Update(): remove recovered coordinates from every live suffix."""
    return dataclasses.replace(sw, tables=sw.tables - table[None])


def sw_zero_cells(sw: SlidingWindowSketch,
                  mask: torch.Tensor) -> SlidingWindowSketch:
    """Paper's practical zeroing applied to every live suffix."""
    return dataclasses.replace(
        sw, tables=torch.where(mask[None], 0.0, sw.tables))


# -- O(log I) smooth-histogram variant ----------------------------------------

@dataclasses.dataclass
class LogWindowSketch:
    """Geometric ladder of suffix sketches: level j covers ~2^j inserts.

    Level j is restarted (zeroed) every 2^j inserts; a query for window I'
    is served by the smallest level whose span covers I' — its span is at
    most 2x the requested window, the smooth-histogram (1+eps) relaxation
    with eps = 1.  Memory: (log2(I)+1) tables instead of I.
    """

    tables: torch.Tensor   # (L, rows, cols), L = log2(window)+1
    t: int
    window: int


def lw_init(window: int, rows: int, cols: int,
            device=None) -> LogWindowSketch:
    levels = max(1, (window - 1).bit_length() + 1)
    return LogWindowSketch(
        tables=torch.zeros(levels, rows, cols, dtype=torch.float32,
                           device=device), t=0, window=window)


def lw_insert(lw: LogWindowSketch, table: torch.Tensor) -> LogWindowSketch:
    t1 = lw.t + 1
    restart = torch.tensor([t1 % (1 << j) == 0
                            for j in range(lw.tables.shape[0])],
                           device=lw.tables.device)
    tables = torch.where(restart[:, None, None], 0.0,
                         lw.tables + table[None])
    return LogWindowSketch(tables=tables, t=t1, window=lw.window)


def lw_suffix(lw: LogWindowSketch, length: int) -> torch.Tensor:
    """Smallest level whose current span is >= length."""
    level = max(0, (length - 1).bit_length())
    level = min(level, lw.tables.shape[0] - 1)
    return lw.tables[level]
