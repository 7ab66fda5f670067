"""Precomputed gather-plan Count Sketch encoder — the CPU encoder.

Port of ``repro.core.gather_sketch``.  The hash family is a pure function
of static quantities — (chunk offset, chunk size, rows, cols, hash key) —
so for a fixed ``ParamLayout`` and ``FetchSGDConfig`` the whole scatter
pattern is known before any gradient exists.  This module precomputes,
per (chunk, sketch row), with numpy as the reference does:

* ``sgn`` — the Rademacher signs, applied by elementwise multiply;
* ``P`` — a ``(cols, L)`` *position matrix*: ``P[c]`` lists the chunk
  positions hashing to bucket ``c`` in element order, padded with a
  sentinel index pointing at an appended ``0.0``.

Encoding is then sign-multiply -> gather -> ``L`` columnwise adds, in the
reference's order, so the tables equal the reference's gather encoder's
bit for bit on equal gradients.  Buckets and signs are
``fetchsgd.sketch_grads``' own; only the association of each bucket's sum
differs from that scatter, so real-valued tables differ at the last ulp
and integer-valued ones not at all.

It is the federated orchestrator's encoder on the CPU.  On the card the
orchestrator uses ``sketch_grads`` (the encode kernel): the position
matrices hold every element id once per sketch row, padded to the
fullest bucket, which at full width is gigabytes.
The port's layout has only single-offset chunks, so every layout has a
plan (the reference's ``None`` for expert-parallel layouts has no case
here).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import fetchsgd as F
from . import hashing
from . import layout as layout_lib


@dataclasses.dataclass(frozen=True)
class _ChunkPlan:
    leaf: int
    row_start: int
    n_rows: int
    # per sketch row: (P (cols, L) int64 positions, sgn (m,) float32, L)
    row_plans: tuple[tuple[torch.Tensor, torch.Tensor, int], ...]


def _row_plan(lo, hi, row: int, m: int, cfg: F.FetchSGDConfig
              ) -> tuple[torch.Tensor, torch.Tensor, int]:
    idx = hashing.bucket_hash(lo, hi, row, cfg.cols, cfg.hash_key).numpy()
    sgn = hashing.sign_hash(lo, hi, row, cfg.hash_key).numpy()
    order = np.argsort(idx, kind="stable")       # element order per bucket
    counts = np.bincount(idx, minlength=cfg.cols)
    L = max(int(counts.max()), 1)
    startpos = np.zeros(cfg.cols + 1, np.int64)
    np.cumsum(counts, out=startpos[1:])
    P = np.full((cfg.cols, L), m, np.int64)      # m -> appended 0.0 sentinel
    srt = idx[order]
    rank = np.arange(len(order)) - startpos[srt]
    P[srt, rank] = order
    return torch.from_numpy(P), torch.from_numpy(sgn), L


def build_plans(layout: layout_lib.ParamLayout,
                cfg: F.FetchSGDConfig) -> list[_ChunkPlan]:
    """Static gather plans in ``sketch_grads``' chunk accumulation order."""
    plans: list[_ChunkPlan] = []
    for g in layout.groups:
        m = g.n_rows * g.row_len
        for ci in g.chunk_ids:
            ch = layout.chunks[ci]
            hi, lo = hashing.split64(ch.offset, m)
            plans.append(_ChunkPlan(
                leaf=ch.leaf, row_start=ch.row_start, n_rows=ch.n_rows,
                row_plans=tuple(_row_plan(lo, hi, j, m, cfg)
                                for j in range(cfg.rows))))
    return plans


def encode(grads: dict, layout: layout_lib.ParamLayout,
           cfg: F.FetchSGDConfig, plans: list[_ChunkPlan]) -> torch.Tensor:
    """S(g) via the precomputed plans (CPU tensors)."""
    views = layout_lib.leaf_views(grads, layout)
    rows_acc = [torch.zeros(cfg.cols, dtype=torch.float32)
                for _ in range(cfg.rows)]
    zero = torch.zeros(1, dtype=torch.float32)
    for plan in plans:
        vals = views[plan.leaf][plan.row_start:plan.row_start
                                + plan.n_rows].reshape(-1)
        for j, (P, sgn, L) in enumerate(plan.row_plans):
            sv = torch.cat([vals * sgn, zero])
            gathered = sv[P]                     # (cols, L)
            acc = torch.zeros(cfg.cols, dtype=torch.float32)
            for pos in range(L):                 # left-assoc: scatter order
                acc = acc + gathered[:, pos]
            rows_acc[j] = rows_acc[j] + acc
    return torch.stack(rows_acc)


def build_encoder(layout: layout_lib.ParamLayout, cfg: F.FetchSGDConfig):
    """``grads -> table`` closure over the layout's plans."""
    plans = build_plans(layout, cfg)
    return lambda grads: encode(grads, layout, cfg, plans)
