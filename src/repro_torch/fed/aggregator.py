"""Sketch aggregation policies — the merge step of FetchSGD, made pluggable.

Port of ``repro.fed.aggregator`` for the round clock.  The server update
consumes one thing: the mean of the cohort's sketch tables.  Because the
Count Sketch is linear, *how* that mean is formed is a free choice — a
flat reduction, a hierarchical k-ary tree, or an asynchronous buffer that
folds in late arrivals with staleness-discounted weights.  All three give
the same table (exactly, up to float summation order and the staleness
discount), but they move different numbers of bytes over different links,
which is what ``AggregationStats`` accounts for.

Cost model (matching ``core.fetchsgd.upload_bytes``): every edge of the
aggregation topology carries one full (rows x cols) float32 table.

* flat:  every client sends straight to the server: ``n * table_bytes``.
* tree:  clients are leaves of a ``fanout``-ary tree and every node
  forwards one merged table: ``(n + ceil(n/f) + ...) * table_bytes``, but
  no node receives more than ``fanout`` tables.
* async: the totals of flat, but contributions may arrive ``s`` rounds
  late and are merged with weight ``discount**s``.

Every merge keeps the reference's order of summation, so tables of
integer values come out bit for bit as the reference's.  The event
clock's accounting (per-edge seconds, the critical path) waits for the
port of that clock.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import fetchsgd as F


@dataclasses.dataclass(frozen=True)
class LevelStats:
    """One level of the aggregation topology (level 0 = clients/leaves)."""

    level: int
    n_messages: int         # tables sent up from this level
    bytes_on_wire: int      # n_messages * table_bytes


@dataclasses.dataclass(frozen=True)
class AggregationStats:
    """Bytes-on-wire + contribution accounting for one round's merge.

    A round that merges zero tables reports ``levels=()``.
    """

    policy: str
    n_fresh: int            # tables produced this round
    n_late: int             # buffered tables folded in (async only)
    total_weight: float     # sum of effective contribution weights
    levels: tuple[LevelStats, ...]
    max_staleness: float = 0   # oldest late contribution merged, in rounds

    @property
    def upload_bytes(self) -> int:
        return sum(lv.bytes_on_wire for lv in self.levels)

    @property
    def root_ingress_tables(self) -> int:
        """Tables received by the final merge node — the fan-in bottleneck."""
        return self.levels[-1].n_messages if self.levels else 0


def tree_levels(n: int, fanout: int, table_bytes: int
                ) -> tuple[LevelStats, ...]:
    """Per-level message counts for a ``fanout``-ary merge of ``n`` leaves
    (``core.fetchsgd.tree_level_bytes``)."""
    return tuple(LevelStats(level=lv, n_messages=msgs, bytes_on_wire=bts)
                 for lv, (msgs, bts) in
                 enumerate(F.tree_level_bytes(table_bytes, n, fanout)))


def _leaf_level(n: int, table_bytes: int) -> tuple[LevelStats, ...]:
    """Single-level (flat/async) stats; () for an empty round."""
    if n == 0:
        return ()
    return (LevelStats(level=0, n_messages=n, bytes_on_wire=n * table_bytes),)


class Aggregator:
    """Base: merge a round's client sketch tables into one mean table.

    Tables are (rows, cols) float32 tensors on ``device``, where the empty
    merge's zero table is made.
    """

    name = "base"

    def __init__(self, cfg: F.FetchSGDConfig, device=None):
        self.cfg = cfg
        self.device = torch.device("cpu" if device is None else device)
        self.table_bytes = F.upload_bytes(cfg)

    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self.cfg.rows, self.cfg.cols, dtype=torch.float32,
                           device=self.device)

    def aggregate(self, tables: Sequence[torch.Tensor], *,
                  weights: Sequence[float] | None = None,
                  round_idx: int = 0
                  ) -> tuple[torch.Tensor, AggregationStats]:
        raise NotImplementedError

    def aggregate_stream(self, pairs, *, round_idx: int = 0
                         ) -> tuple[torch.Tensor, AggregationStats]:
        """Merge an *iterator* of ``(table, weight)`` pairs as they appear,
        in ``aggregate``'s order of summation (see ``_fold`` for the total
        weight)."""
        raise NotImplementedError

    @staticmethod
    def _weighted(tables, weights):
        if weights is None:
            weights = [1.0] * len(tables)
        if len(weights) != len(tables):
            raise ValueError(f"{len(tables)} tables vs {len(weights)} weights")
        return list(tables), [float(w) for w in weights]

    def _fold(self, pairs) -> tuple[torch.Tensor, int, float]:
        """Left-associated fold of ``(table, weight)`` pairs: (weighted sum,
        count, weights summed one by one).

        ``aggregate`` takes its total weight from ``sum(weights)`` as the
        reference does; on Python 3.12 ``sum`` of floats is compensated, so
        it can differ from the one-by-one sum of ``aggregate_stream`` in the
        last bit.
        """
        n, total_w = 0, 0
        acc = self._zeros()
        for t, w in pairs:
            w = float(w)
            acc = acc + (t if w == 1.0 else w * t)
            total_w = total_w + w
            n += 1
        return acc, n, total_w


class FlatAggregator(Aggregator):
    """Every client sends to the server; one weighted mean."""

    name = "flat"

    def aggregate(self, tables, *, weights=None, round_idx=0):
        tables, weights = self._weighted(tables, weights)
        acc, n, _ = self._fold(zip(tables, weights))
        return self._finish(acc, sum(weights), n)

    def aggregate_stream(self, pairs, *, round_idx=0):
        acc, n, total_w = self._fold(pairs)
        return self._finish(acc, total_w, n)

    def _finish(self, acc, total_w, n):
        table = acc / total_w if total_w > 0 else acc
        return table, AggregationStats(
            policy=self.name, n_fresh=n, n_late=0, total_weight=total_w,
            levels=_leaf_level(n, self.table_bytes))


class TreeAggregator(Aggregator):
    """Hierarchical ``fanout``-ary merge with per-level byte accounting.

    Linearity makes the tree-ordered sum equal to the flat sum (bitwise up
    to float associativity); no node ever merges more than ``fanout``
    tables.
    """

    name = "tree"

    def __init__(self, cfg: F.FetchSGDConfig, fanout: int = 4, device=None):
        super().__init__(cfg, device)
        if fanout < 2:
            raise ValueError(f"fanout must be >= 2, got {fanout}")
        self.fanout = fanout

    def aggregate(self, tables, *, weights=None, round_idx=0):
        tables, weights = self._weighted(tables, weights)
        total_w = sum(weights)
        nodes = [t if w == 1.0 else w * t for t, w in zip(tables, weights)]
        while len(nodes) > 1:
            nodes = [sum(nodes[i:i + self.fanout][1:], start=nodes[i])
                     for i in range(0, len(nodes), self.fanout)]
        acc = nodes[0] if nodes else self._zeros()
        return self._finish(acc, total_w, len(tables))

    def aggregate_stream(self, pairs, *, round_idx=0):
        # Per-level stacks of < fanout pending nodes; a level folds the
        # moment its stack fills.  The groups are the positional chunks
        # ``aggregate`` forms, folded in the same order.
        f = self.fanout
        stacks: list[list] = []
        n, total_w = 0, 0
        for t, w in pairs:
            w = float(w)
            total_w = total_w + w
            n += 1
            node, lv = (t if w == 1.0 else w * t), 0
            while True:
                if lv == len(stacks):
                    stacks.append([])
                stacks[lv].append(node)
                if len(stacks[lv]) < f:
                    break
                group, stacks[lv] = stacks[lv], []
                node = sum(group[1:], start=group[0])
                lv += 1
        # end flush, bottom-up: each level's leftover nodes plus the fold
        # of the level below (positionally its last node) form the final,
        # possibly partial, chunk of the batch fold
        carry = None
        for stack in stacks:
            if carry is not None:
                stack.append(carry)
            if stack:
                carry = sum(stack[1:], start=stack[0])
        acc = carry if carry is not None else self._zeros()
        return self._finish(acc, total_w, n)

    def _finish(self, acc, total_w, n):
        table = acc / total_w if total_w > 0 else acc
        return table, AggregationStats(
            policy=self.name, n_fresh=n, n_late=0, total_weight=total_w,
            levels=tree_levels(n, self.fanout, self.table_bytes))


class AsyncBufferedAggregator(Aggregator):
    """Buffer late sketches; merge them with staleness-discounted weights.

    A client that finishes ``s`` rounds late still contributes: its table
    is folded into round ``r`` with weight ``discount**s``.  By linearity
    this is exact.  With no late arrivals the merge order (and hence the
    result, bitwise) is ``FlatAggregator``'s.  Entries staler than
    ``max_staleness`` rounds are dropped.
    """

    name = "async"

    def __init__(self, cfg: F.FetchSGDConfig, discount: float = 0.9,
                 max_staleness: int = 8, device=None):
        super().__init__(cfg, device)
        if not 0.0 < discount <= 1.0:
            raise ValueError(f"discount must be in (0, 1], got {discount}")
        self.discount = discount
        self.max_staleness = max_staleness
        self._buffer: list[dict] = []   # {table, produced, arrival, weight}

    def submit(self, table: torch.Tensor, *, produced_round: int,
               arrival_round: int, weight: float = 1.0) -> None:
        """Enqueue a straggler's table to be merged once it 'arrives'."""
        if arrival_round <= produced_round:
            raise ValueError("arrival_round must be > produced_round")
        self._buffer.append(dict(table=table, produced=produced_round,
                                 arrival=arrival_round, weight=float(weight)))

    def pending(self) -> int:
        return len(self._buffer)

    def state(self) -> list[dict]:
        """Buffer contents, as a checkpoint would hold them."""
        return [dict(e) for e in self._buffer]

    def load_state(self, entries: list[dict]) -> None:
        """Restore a saved buffer (replaces current contents)."""
        self._buffer = [dict(table=e["table"], produced=int(e["produced"]),
                             arrival=int(e["arrival"]),
                             weight=float(e["weight"])) for e in entries]

    def drain(self, round_idx: int
              ) -> tuple[torch.Tensor, float, int, float]:
        """Pop arrived entries: (discounted weighted sum, weight, n, max_s).

        Entries staler than ``max_staleness`` are dropped on the floor.
        """
        acc, total_w, n, max_s = self._zeros(), 0.0, 0, 0
        keep = []
        for e in self._buffer:
            if e["arrival"] > round_idx:
                keep.append(e)
                continue
            s = round_idx - e["produced"]
            if s > self.max_staleness:
                continue
            w = e["weight"] * self.discount ** s
            acc = acc + w * e["table"]
            total_w += w
            n += 1
            max_s = max(max_s, s)
        self._buffer = keep
        return acc, total_w, n, max_s

    def aggregate(self, tables, *, weights=None, round_idx=0):
        tables, weights = self._weighted(tables, weights)
        late = self.drain(round_idx)
        acc, n, _ = self._fold(zip(tables, weights))
        return self._finish(acc, sum(weights), n, *late)

    def aggregate_stream(self, pairs, *, round_idx=0):
        """Drain the arrived buffer first, then fold the fresh pairs.

        Stragglers submitted while the iterator runs (``arrival >
        round_idx``) land after the kept entries, as they would after
        submit-everything-then-aggregate.
        """
        late = self.drain(round_idx)
        acc, n, fresh_w = self._fold(pairs)
        return self._finish(acc, fresh_w, n, *late)

    def _finish(self, acc, fresh_w, n, late_sum, late_w, n_late, max_s):
        total_w = fresh_w + late_w
        acc = acc + late_sum if n_late else acc
        table = acc / total_w if total_w > 0 else acc
        return table, AggregationStats(
            policy=self.name, n_fresh=n, n_late=n_late,
            total_weight=total_w, max_staleness=max_s,
            levels=_leaf_level(n + n_late, self.table_bytes))


def make_aggregator(policy: str, cfg: F.FetchSGDConfig, *, fanout: int = 4,
                    discount: float = 0.9, max_staleness: int = 8,
                    device=None) -> Aggregator:
    if policy == "flat":
        return FlatAggregator(cfg, device)
    if policy == "tree":
        return TreeAggregator(cfg, fanout=fanout, device=device)
    if policy == "async":
        return AsyncBufferedAggregator(cfg, discount=discount,
                                       max_staleness=max_staleness,
                                       device=device)
    raise ValueError(f"unknown aggregation policy {policy!r}")
