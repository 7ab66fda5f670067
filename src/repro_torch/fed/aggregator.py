"""Sketch aggregation policies — the merge step of FetchSGD, made pluggable.

Port of ``repro.fed.aggregator``.  The server update
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
  late and are merged with weight ``discount**s``.  Under the event clock
  (``staleness_lambda`` set) staleness is measured in *virtual seconds*
  and the discount is ``exp(-lambda * age)``.

Wall-clock accounting: when per-edge bandwidths are supplied
(``bandwidths=`` per leaf, ``link_bandwidth`` for internal tree edges),
each level also reports its slowest edge's transfer time; transfers within
a level run in parallel, so the topology's critical path is the sum of
per-level maxima (``AggregationStats.critical_path_s``).

Every merge keeps the reference's order of summation, so tables of
integer values come out bit for bit as the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch import obs
from repro_torch.core import fetchsgd as F


@dataclasses.dataclass(frozen=True)
class LevelStats:
    """One level of the aggregation topology (level 0 = clients/leaves)."""

    level: int
    n_messages: int         # tables sent up from this level
    bytes_on_wire: int      # n_messages * table_bytes
    max_edge_seconds: float = 0.0   # slowest edge transfer at this level
                                    # (0 when no bandwidths were supplied)


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
    max_staleness: float = 0   # oldest late contribution merged: rounds
                               # (round clock) or virtual seconds (event)

    @property
    def upload_bytes(self) -> int:
        return sum(lv.bytes_on_wire for lv in self.levels)

    @property
    def root_ingress_tables(self) -> int:
        """Tables received by the final merge node — the fan-in bottleneck."""
        return self.levels[-1].n_messages if self.levels else 0

    @property
    def critical_path_s(self) -> float:
        """Wall-clock lower bound of the merge: the sum of each level's
        slowest edge (levels are sequential, edges of a level parallel)."""
        return sum(lv.max_edge_seconds for lv in self.levels)


def tree_levels(n: int, fanout: int, table_bytes: int,
                leaf_bandwidths: Sequence[float] | None = None,
                link_bandwidth: float | None = None
                ) -> tuple[LevelStats, ...]:
    """Per-level message counts for a ``fanout``-ary merge of ``n`` leaves
    (``core.fetchsgd.tree_level_bytes``).  ``leaf_bandwidths`` (bytes/s,
    one per leaf) and ``link_bandwidth`` (internal edges) add per-level
    seconds: level 0's slowest edge is the slowest client uplink, deeper
    levels ride the backbone."""
    def edge_s(lv: int) -> float:
        if lv == 0 and leaf_bandwidths:
            return table_bytes / min(leaf_bandwidths)
        if lv > 0 and link_bandwidth:
            return table_bytes / link_bandwidth
        return 0.0
    return tuple(LevelStats(level=lv, n_messages=msgs, bytes_on_wire=bts,
                            max_edge_seconds=edge_s(lv))
                 for lv, (msgs, bts) in
                 enumerate(F.tree_level_bytes(table_bytes, n, fanout)))


def _leaf_level(n: int, table_bytes: int,
                bandwidths: Sequence[float] | None) -> tuple[LevelStats, ...]:
    """Single-level (flat/async) stats; () for an empty round."""
    if n == 0:
        return ()
    edge = table_bytes / min(bandwidths) if bandwidths else 0.0
    return (LevelStats(level=0, n_messages=n, bytes_on_wire=n * table_bytes,
                       max_edge_seconds=edge),)


class Aggregator:
    """Base: merge a round's client sketch tables into one mean table.

    Tables are (rows, cols) float32 tensors on ``device``, where the empty
    merge's zero table is made.  ``telemetry`` (``repro_torch.obs``) gets
    the reference's ``agg.*`` counters, gauges and histograms.
    """

    name = "base"

    def __init__(self, cfg: F.FetchSGDConfig, device=None, telemetry=None):
        self.cfg = cfg
        self.device = torch.device("cpu" if device is None else device)
        self.table_bytes = F.upload_bytes(cfg)
        self.tele = telemetry if telemetry is not None else obs.NOOP

    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self.cfg.rows, self.cfg.cols, dtype=torch.float32,
                           device=self.device)

    def _observe(self, stats: AggregationStats) -> AggregationStats:
        """Record one merge's stats (no-op unless telemetry is live)."""
        tele = self.tele
        if tele.enabled:
            tele.counter("agg.merges").inc()
            tele.counter("agg.tables_merged").inc(stats.n_fresh
                                                  + stats.n_late)
            tele.counter("agg.bytes_on_wire").inc(stats.upload_bytes)
            for lv in stats.levels:
                tele.counter(f"agg.level{lv.level}.bytes").inc(
                    lv.bytes_on_wire)
                tele.counter(f"agg.level{lv.level}.messages").inc(
                    lv.n_messages)
            tele.gauge("agg.root_ingress_tables").set(
                stats.root_ingress_tables)
            if stats.critical_path_s:
                tele.histogram("agg.critical_path_s").observe(
                    stats.critical_path_s)
        return stats

    def aggregate(self, tables: Sequence[torch.Tensor], *,
                  weights: Sequence[float] | None = None,
                  round_idx: float = 0,
                  bandwidths: Sequence[float] | None = None
                  ) -> tuple[torch.Tensor, AggregationStats]:
        raise NotImplementedError

    def aggregate_stream(self, pairs, *, round_idx: float = 0,
                         bandwidths: Sequence[float] | None = None
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

    def aggregate(self, tables, *, weights=None, round_idx=0,
                  bandwidths=None):
        tables, weights = self._weighted(tables, weights)
        acc, n, _ = self._fold(zip(tables, weights))
        return self._finish(acc, sum(weights), n, bandwidths)

    def aggregate_stream(self, pairs, *, round_idx=0, bandwidths=None):
        acc, n, total_w = self._fold(pairs)
        return self._finish(acc, total_w, n, bandwidths)

    def _finish(self, acc, total_w, n, bandwidths):
        table = acc / total_w if total_w > 0 else acc
        return table, self._observe(AggregationStats(
            policy=self.name, n_fresh=n, n_late=0, total_weight=total_w,
            levels=_leaf_level(n, self.table_bytes, bandwidths)))


class TreeAggregator(Aggregator):
    """Hierarchical ``fanout``-ary merge with per-level byte accounting.

    Linearity makes the tree-ordered sum equal to the flat sum (bitwise up
    to float associativity); no node ever merges more than ``fanout``
    tables.
    """

    name = "tree"

    def __init__(self, cfg: F.FetchSGDConfig, fanout: int = 4,
                 link_bandwidth: float | None = None, device=None,
                 telemetry=None):
        super().__init__(cfg, device, telemetry)
        if fanout < 2:
            raise ValueError(f"fanout must be >= 2, got {fanout}")
        if link_bandwidth is not None and link_bandwidth <= 0:
            raise ValueError("link_bandwidth must be > 0")
        self.fanout = fanout
        self.link_bandwidth = link_bandwidth   # internal-edge bytes/s

    def aggregate(self, tables, *, weights=None, round_idx=0,
                  bandwidths=None):
        tables, weights = self._weighted(tables, weights)
        total_w = sum(weights)
        nodes = [t if w == 1.0 else w * t for t, w in zip(tables, weights)]
        while len(nodes) > 1:
            nodes = [sum(nodes[i:i + self.fanout][1:], start=nodes[i])
                     for i in range(0, len(nodes), self.fanout)]
        acc = nodes[0] if nodes else self._zeros()
        return self._finish(acc, total_w, len(tables), bandwidths)

    def aggregate_stream(self, pairs, *, round_idx=0, bandwidths=None):
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
        return self._finish(acc, total_w, n, bandwidths)

    def _finish(self, acc, total_w, n, bandwidths):
        table = acc / total_w if total_w > 0 else acc
        return table, self._observe(AggregationStats(
            policy=self.name, n_fresh=n, n_late=0, total_weight=total_w,
            levels=tree_levels(n, self.fanout, self.table_bytes,
                               leaf_bandwidths=bandwidths,
                               link_bandwidth=self.link_bandwidth)))


class AsyncBufferedAggregator(Aggregator):
    """Buffer late sketches; merge them with staleness-discounted weights.

    A client that finishes ``s`` rounds late still contributes: its table
    is folded into round ``r`` with weight ``discount**s``.  By linearity
    this is exact.  With no late arrivals the merge order (and hence the
    result, bitwise) is ``FlatAggregator``'s.

    Two clocks share one buffer:

    * **round clock** (default): ``produced``/``arrival`` are round
      indices, the discount is geometric (``discount**s``) and entries
      staler than ``max_staleness`` rounds are dropped.
    * **event clock** (``staleness_lambda`` set): ``produced``/``arrival``
      are virtual seconds, the discount is ``exp(-lambda * age)`` and
      ``max_age`` (seconds, None = keep everything) is the drop threshold.
    """

    name = "async"

    def __init__(self, cfg: F.FetchSGDConfig, discount: float = 0.9,
                 max_staleness: int = 8,
                 staleness_lambda: float | None = None,
                 max_age: float | None = None, device=None,
                 telemetry=None):
        super().__init__(cfg, device, telemetry)
        if not 0.0 < discount <= 1.0:
            raise ValueError(f"discount must be in (0, 1], got {discount}")
        if staleness_lambda is not None and staleness_lambda < 0:
            raise ValueError("staleness_lambda must be >= 0")
        self.discount = discount
        self.max_staleness = max_staleness
        self.staleness_lambda = staleness_lambda
        self.max_age = max_age
        self._buffer: list[dict] = []   # {table, produced, arrival, weight}

    @property
    def timed(self) -> bool:
        """True when staleness is measured in virtual seconds."""
        return self.staleness_lambda is not None

    def _discount_for(self, age) -> float:
        if self.timed:
            return math.exp(-self.staleness_lambda * age)
        return self.discount ** age

    def _too_stale(self, age) -> bool:
        if self.timed:
            return self.max_age is not None and age > self.max_age
        return age > self.max_staleness

    def submit(self, table: torch.Tensor, *, produced_round,
               arrival_round, weight: float = 1.0) -> None:
        """Enqueue a straggler's table to be merged once it 'arrives'.

        Under the event clock the two arguments are virtual-second floats
        (dispatch time and arrival time).
        """
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
        cast = float if self.timed else int
        self._buffer = [dict(table=e["table"], produced=cast(e["produced"]),
                             arrival=cast(e["arrival"]),
                             weight=float(e["weight"])) for e in entries]

    def _new_late(self) -> dict:
        """An empty late fold: (weighted sum, weight, n, max staleness)."""
        return dict(acc=self._zeros(), w=0.0, n=0, max_s=0)

    def _take(self, late: dict, e: dict, now, keep: list) -> None:
        """Fold one buffered entry into ``late`` if it has arrived by
        ``now`` and is not too stale; keep it if it has not arrived."""
        if e["arrival"] > now:
            keep.append(e)
            return
        s = now - e["produced"]
        if self._too_stale(s):
            if self.tele.enabled:
                self.tele.counter("agg.async.dropped_stale").inc()
            return
        w = e["weight"] * self._discount_for(s)
        late["acc"] = late["acc"] + w * e["table"]
        late["w"] += w
        late["n"] += 1
        late["max_s"] = max(late["max_s"], s)
        if self.tele.enabled:
            self.tele.histogram("agg.async.staleness_age").observe(s)

    def _drained(self, keep: list, late: dict) -> None:
        """End a drain: the buffer keeps the entries still in flight."""
        self._buffer = keep
        if self.tele.enabled:
            self.tele.counter("agg.async.late_merged").inc(late["n"])
            self.tele.gauge("agg.async.buffer_depth").set(len(keep))

    def drain(self, round_idx) -> tuple[torch.Tensor, float, int, float]:
        """Pop arrived entries: (discounted weighted sum, weight, n, max_s).

        ``round_idx`` is the current round (round clock) or the current
        virtual time in seconds (event clock).  Entries staler than the
        clock's drop threshold are dropped on the floor.
        """
        late, keep = self._new_late(), []
        for e in self._buffer:
            self._take(late, e, round_idx, keep)
        self._drained(keep, late)
        return late["acc"], late["w"], late["n"], late["max_s"]

    def aggregate(self, tables, *, weights=None, round_idx=0,
                  bandwidths=None):
        tables, weights = self._weighted(tables, weights)
        late = self.drain(round_idx)
        acc, n, _ = self._fold(zip(tables, weights))
        return self._finish(acc, sum(weights), n, *late, bandwidths)

    def aggregate_stream(self, pairs, *, round_idx=0, bandwidths=None):
        """Drain the arrived buffer first, then fold the fresh pairs.

        Stragglers submitted while the iterator runs (``arrival >
        round_idx``) land after the kept entries, as they would after
        submit-everything-then-aggregate.
        """
        late = self.drain(round_idx)
        acc, n, fresh_w = self._fold(pairs)
        if self.tele.enabled:
            # the per-object path drains after this round's submits, so its
            # buffer-depth gauge counts them: so does this one
            self.tele.gauge("agg.async.buffer_depth").set(len(self._buffer))
        return self._finish(acc, fresh_w, n, *late, bandwidths)

    def merge_timed_stream(self, arrivals, *, now, bandwidths=None):
        """Submit-and-drain an *iterator* of ``(table, produced, arrival,
        weight)`` tuples in one pass.

        Bitwise equivalent to ``submit(...)`` per arrival followed by
        ``aggregate([], round_idx=now)``: the buffered entries are visited
        first, then the arrivals in order, under the same discount /
        too-stale / keep rule; but each arrival's table is folded the moment
        the iterator yields it, so the population-scale event loop never
        buffers a cohort's tables.
        """
        late, keep = self._new_late(), []
        for e in self._buffer:
            self._take(late, e, now, keep)
        for table, produced, arrival, weight in arrivals:
            if arrival <= produced:
                raise ValueError("arrival_round must be > produced_round")
            self._take(late, dict(table=table, produced=produced,
                                  arrival=arrival, weight=float(weight)),
                       now, keep)
        self._drained(keep, late)
        # the tail of aggregate([]) op for op: an empty fresh fold, 0 + the
        # late weight, zeros + the late sum
        return self._finish(self._zeros(), 0, 0, late["acc"], late["w"],
                            late["n"], late["max_s"], bandwidths)

    def _finish(self, acc, fresh_w, n, late_sum, late_w, n_late, max_s,
                bandwidths):
        total_w = fresh_w + late_w
        acc = acc + late_sum if n_late else acc
        table = acc / total_w if total_w > 0 else acc
        return table, self._observe(AggregationStats(
            policy=self.name, n_fresh=n, n_late=n_late,
            total_weight=total_w, max_staleness=max_s,
            levels=_leaf_level(n + n_late, self.table_bytes, bandwidths)))


def make_aggregator(policy: str, cfg: F.FetchSGDConfig, *, fanout: int = 4,
                    discount: float = 0.9, max_staleness: int = 8,
                    staleness_lambda: float | None = None,
                    max_age: float | None = None,
                    link_bandwidth: float | None = None,
                    device=None, telemetry=None) -> Aggregator:
    if policy == "flat":
        return FlatAggregator(cfg, device, telemetry)
    if policy == "tree":
        return TreeAggregator(cfg, fanout=fanout,
                              link_bandwidth=link_bandwidth, device=device,
                              telemetry=telemetry)
    if policy == "async":
        return AsyncBufferedAggregator(cfg, discount=discount,
                                       max_staleness=max_staleness,
                                       staleness_lambda=staleness_lambda,
                                       max_age=max_age, device=device,
                                       telemetry=telemetry)
    raise ValueError(f"unknown aggregation policy {policy!r}")


# -- the mesh counterpart (one rank a process, ``launch.mesh``) --------------

def mesh_aggregate(table: torch.Tensor, mesh, axes: tuple[str, ...],
                   policy: str = "flat",
                   weight: float | None = None) -> torch.Tensor:
    """Mean this rank's sketch table over the client ``axes`` of ``mesh``
    (a ``launch.mesh.Mesh``); ``table`` itself is left as it is.

    ``flat`` is one all_reduce over the client group.  ``tree`` reduces
    one axis at a time, innermost first (within a pod, then across pods),
    the mesh realization of ``TreeAggregator``: the same mean, each
    collective over one link class.

    ``weight`` (this rank's client shard's weight, FedSKETCH-style)
    switches both to the exact weighted mean ``sum(w*t) / max(sum(w),
    1e-8)``: numerator and denominator are reduced with the policy's
    topology and divided once at the end.
    """
    if policy not in ("flat", "tree"):
        raise ValueError(f"unknown mesh aggregation policy {policy!r}")
    steps = [tuple(axes)] if policy == "flat" else [(a,) for a in
                                                    reversed(axes)]
    if weight is None:
        out = table.clone()
        for ax in steps:
            mesh.all_mean(out, ax)
        return out
    num = table * weight
    den = torch.full((), weight, dtype=torch.float32, device=table.device)
    for ax in steps:
        mesh.all_sum(num, ax)
        mesh.all_sum(den, ax)
    return num / den.clamp(min=1e-8)
