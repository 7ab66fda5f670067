"""Discrete-event wall-clock federation: heterogeneous clients, virtual time.

The port's own copy of ``repro.fed.simtime`` (numpy only, no torch): the
float64 time arithmetic does the reference's IEEE operations in the
reference's order, so event timestamps, pop order and every
``RoundRecord`` of the event clock equal the reference's.

The round-driven orchestrator measures staleness in *round indices* — a
counter, not time.  Real federations are paced by wall-clock physics:
every client has its own compute speed, uplink bandwidth, and availability
windows, so a "round" is whatever interval the slowest relevant upload
defines.  This module supplies the primitives for the event-driven clock
(``FederationConfig(clock="event")``):

* ``ClientProfile`` — per-client heterogeneity: seconds of local compute
  per round, uplink bytes/second, and a periodic availability window
  (phones charge at night).  ``finish_time`` is the paper-level cost
  model: ``start + compute_seconds + table_bytes / bandwidth``, where
  ``start`` defers to the client's next availability window.
* ``HeterogeneityConfig`` / ``HeterogeneityModel`` — lognormal
  distributions over compute time and bandwidth (heavy-tailed uplinks are
  the realistic regime) sampled *deterministically per client id*, so a
  run is a pure function of ``(seed, config)``.
* ``PopulationModel`` — the same profiles as batched float64 columns, for
  cohorts of 10^4-10^6 clients.
* ``Event`` / ``EventQueue`` / ``BucketedEventQueue`` — future-event lists
  keyed by ``(time, round, slot)``.  The triple is unique per run, so pop
  order is total and deterministic; ``state()/load_state()`` round-trip
  the queue.
* ``SimTimeConfig`` — the event clock's knobs: the exponential staleness
  discount ``exp(-lambda * age_seconds)`` (the continuous-time limit of
  the round clock's ``discount**s``), the async update quorum, and the
  backbone bandwidth of internal tree edges.

The orchestrator's event loop lives in ``fed.orchestrator`` and consumes
these primitives; by Count Sketch linearity the arrival-order merge is
still an exact (discount-weighted) sketch of the weighted mean gradient.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import heapq
import math
from typing import Any, Iterable

import numpy as np

from . import profile_rng
# rng stream id shared by both profile streams (legacy tuple seed / counter
# key) — must not collide with the orchestrator's cohort (0) and fate (1)
# streams, so profile draws never correlate with cohort sampling.
from .profile_rng import PROFILE_STREAM  # noqa: F401  (re-export)

PROFILE_STREAMS = ("legacy", "counter")


@dataclasses.dataclass(frozen=True)
class ClientProfile:
    """One client's wall-clock physics."""

    compute_seconds: float        # local grad+sketch time per round
    bandwidth: float              # uplink, bytes/second
    weight: float = 1.0           # merge weight (FedSKETCH-style)
    avail_period: float = 0.0     # seconds; 0 = always available
    avail_duty: float = 1.0       # fraction of each period the client is up
    avail_offset: float = 0.0     # phase shift of the window start

    def __post_init__(self):
        if self.compute_seconds < 0:
            raise ValueError("compute_seconds must be >= 0")
        if self.bandwidth <= 0:
            raise ValueError("bandwidth must be > 0")
        if not 0.0 < self.avail_duty <= 1.0:
            raise ValueError("avail_duty must be in (0, 1]")

    def next_available(self, t: float) -> float:
        """Earliest time >= t inside this client's availability window."""
        if self.avail_period <= 0 or self.avail_duty >= 1.0:
            return t
        span = self.avail_duty * self.avail_period
        phase = (t - self.avail_offset) % self.avail_period
        return t if phase < span else t + (self.avail_period - phase)

    def upload_seconds(self, n_bytes: int) -> float:
        return n_bytes / self.bandwidth

    def finish_time(self, t: float, table_bytes: int, *,
                    compute_scale: float = 1.0) -> float:
        """When this client's sketch lands at the server, dispatched at t."""
        start = self.next_available(t)
        return (start + self.compute_seconds * compute_scale
                + self.upload_seconds(table_bytes))


@dataclasses.dataclass(frozen=True)
class HeterogeneityConfig:
    """Distributions the per-client profiles are sampled from.

    Compute time and bandwidth are lognormal (median * exp(sigma * N(0,1)))
    — sigma=0 collapses to a homogeneous population, sigma ~ 1+ gives the
    heavy-tailed uplink spread real device fleets show.  Availability duty
    is uniform in [duty_min, duty_max] with a random phase.

    ``profile_stream`` picks which deterministic per-client stream the five
    profile fields are drawn from:

    * ``"counter"`` (default) — the vectorized Philox counter stream
      (``fed.profile_rng``), ~10^6 clients/s; the stream for new runs.
    * ``"legacy"`` — one ``np.random.default_rng((seed, id, stream))`` per
      client, bit-for-bit the reference's older stream (~10^4
      clients/s).

    Both streams draw the same distributions; the scalar and vectorized
    samplers agree field-for-field within either stream.
    """

    compute_median: float = 1.0       # seconds per local round
    compute_sigma: float = 0.5
    bandwidth_median: float = 1e6     # bytes/second uplink
    bandwidth_sigma: float = 1.0
    weight_sigma: float = 0.0         # lognormal client-weight spread
    avail_period: float = 0.0         # 0 = everyone always available
    avail_duty_min: float = 1.0
    avail_duty_max: float = 1.0
    profile_stream: str = "counter"

    def __post_init__(self):
        if self.compute_median < 0 or self.bandwidth_median <= 0:
            raise ValueError("medians must be positive")
        if not 0.0 < self.avail_duty_min <= self.avail_duty_max <= 1.0:
            raise ValueError("need 0 < duty_min <= duty_max <= 1")
        if self.profile_stream not in PROFILE_STREAMS:
            raise ValueError(
                f"profile_stream must be one of {PROFILE_STREAMS}, "
                f"got {self.profile_stream!r}")


def _legacy_row(cfg: HeterogeneityConfig, seed: int,
                client_id: int) -> tuple[float, float, float, float, float]:
    """One client's (compute, bandwidth, weight, duty, offset) from the
    legacy per-client generator stream, in the reference's draw order.
    Do not reorder."""
    rng = np.random.default_rng((seed, client_id, PROFILE_STREAM))
    compute = cfg.compute_median * float(
        np.exp(cfg.compute_sigma * rng.standard_normal()))
    bw = cfg.bandwidth_median * float(
        np.exp(cfg.bandwidth_sigma * rng.standard_normal()))
    weight = float(np.exp(cfg.weight_sigma * rng.standard_normal()))
    duty = float(rng.uniform(cfg.avail_duty_min, cfg.avail_duty_max))
    offset = (float(rng.uniform(0.0, cfg.avail_period))
              if cfg.avail_period > 0 else 0.0)
    return compute, bw, weight, duty, offset


class HeterogeneityModel:
    """Deterministic client_id -> ClientProfile sampler (cached)."""

    def __init__(self, cfg: HeterogeneityConfig, seed: int = 0):
        self.cfg = cfg
        self.seed = seed
        self._cache: dict[int, ClientProfile] = {}

    def profile(self, client_id: int) -> ClientProfile:
        prof = self._cache.get(client_id)
        if prof is None:
            cfg = self.cfg
            if cfg.profile_stream == "counter":
                # a 1-element draw: elementwise Philox, so bit-identical to
                # the same id inside any vectorized block
                c = profile_rng.profile_columns(
                    cfg, self.seed, np.asarray([client_id], np.int64))
                row = tuple(float(c[name][0]) for name in profile_rng.COLS)
            else:
                row = _legacy_row(cfg, self.seed, client_id)
            prof = ClientProfile(
                compute_seconds=row[0], bandwidth=row[1], weight=row[2],
                avail_period=cfg.avail_period, avail_duty=row[3],
                avail_offset=row[4])
            self._cache[client_id] = prof
        return prof


class PopulationModel:
    """Vectorized ``HeterogeneityModel``: batched per-client profile columns.

    Samples the *same* per-client stream as ``HeterogeneityModel.profile``
    (whichever ``cfg.profile_stream`` selects: the vectorized Philox counter
    stream of ``fed.profile_rng``, or the legacy per-client
    ``default_rng((seed, id, PROFILE_STREAM))`` draws) — so ``profile(i)``
    is field-for-field equal for the same seed in both modes.  Clients are
    sampled lazily in fixed-size id blocks and cached as float64 column
    arrays, which is what lets the event loop dispatch 10^4-10^6-client
    cohorts without ever holding one Python ``ClientProfile`` per client.
    The block cache is a bounded LRU (``max_cached_blocks``, default 2048
    blocks = ~8.4M clients at the default block size) — eviction is safe
    because a block is a pure function of ``(cfg, seed, block_id)`` and
    refills identically.

    All vectorized time arithmetic (``next_available`` / ``finish_times``)
    performs the identical IEEE-double operations as the scalar
    ``ClientProfile`` methods, so event timestamps — and therefore queue
    pop order and the whole RoundRecord stream — match the per-object path
    bitwise.
    """

    COLS = profile_rng.COLS

    def __init__(self, cfg: HeterogeneityConfig, seed: int = 0,
                 block: int = 4096, max_cached_blocks: int = 2048):
        if block < 1:
            raise ValueError("block must be >= 1")
        if max_cached_blocks < 1:
            raise ValueError("max_cached_blocks must be >= 1")
        self.cfg = cfg
        self.seed = seed
        self.block = int(block)
        self.max_cached_blocks = int(max_cached_blocks)
        # block_id -> (block, 5) column array, LRU order (oldest first)
        self._blocks: collections.OrderedDict[int, np.ndarray] = \
            collections.OrderedDict()

    @property
    def cache_blocks(self) -> int:
        """Resident profile blocks."""
        return len(self._blocks)

    def _fill(self, b: int) -> np.ndarray:
        cfg = self.cfg
        ids = b * self.block + np.arange(self.block, dtype=np.int64)
        if cfg.profile_stream == "counter":
            c = profile_rng.profile_columns(cfg, self.seed, ids)
            return np.column_stack([c[name] for name in self.COLS])
        out = np.empty((self.block, len(self.COLS)), np.float64)
        for i in range(self.block):
            out[i] = _legacy_row(cfg, self.seed, int(ids[i]))
        return out

    def columns(self, ids: np.ndarray) -> dict[str, np.ndarray]:
        """Profile columns for an id array: {compute, bandwidth, weight,
        duty, offset} -> float64 arrays aligned with ``ids``."""
        ids = np.asarray(ids, np.int64)
        if ids.size and ids.min() < 0:
            raise ValueError("client ids must be >= 0")
        # group ids by block with one argsort instead of one full-length
        # mask scan per block — the scan is O(ids * blocks)
        bids = ids // self.block
        order = np.argsort(bids, kind="stable")
        uniq = np.unique(bids)
        starts = np.searchsorted(bids[order], uniq, side="left")
        ends = np.append(starts[1:], ids.size)
        rows = np.empty((ids.size, len(self.COLS)), np.float64)
        for k in range(len(uniq)):
            b = int(uniq[k])
            blk = self._blocks.get(b)
            if blk is None:
                blk = self._blocks[b] = self._fill(b)
                while len(self._blocks) > self.max_cached_blocks:
                    self._blocks.popitem(last=False)
            else:
                self._blocks.move_to_end(b)
            idx = order[starts[k]:ends[k]]
            rows[idx] = blk[ids[idx] - b * self.block]
        return dict(zip(self.COLS, rows.T))

    def profile(self, client_id: int) -> ClientProfile:
        """Scalar view — field-for-field equal to HeterogeneityModel."""
        c = self.columns(np.asarray([client_id]))
        return ClientProfile(
            compute_seconds=float(c["compute"][0]),
            bandwidth=float(c["bandwidth"][0]),
            weight=float(c["weight"][0]),
            avail_period=self.cfg.avail_period,
            avail_duty=float(c["duty"][0]),
            avail_offset=float(c["offset"][0]))

    def next_available(self, cols: dict[str, np.ndarray],
                       t: float) -> np.ndarray:
        """Vectorized ``ClientProfile.next_available`` (same IEEE ops)."""
        period = self.cfg.avail_period
        n = len(cols["duty"])
        if period <= 0:
            return np.full(n, float(t), np.float64)
        span = cols["duty"] * period
        phase = (t - cols["offset"]) % period
        # duty >= 1 gives span == period > phase, so the "available now"
        # branch fires exactly where the scalar early-return does
        return np.where((phase < span) | (cols["duty"] >= 1.0),
                        float(t), t + (period - phase))

    def finish_times(self, cols: dict[str, np.ndarray], t: float,
                     table_bytes: int,
                     compute_scale: np.ndarray | float = 1.0) -> np.ndarray:
        """Vectorized ``ClientProfile.finish_time`` for one dispatch."""
        start = self.next_available(cols, t)
        finish = (start + cols["compute"] * compute_scale
                  + table_bytes / cols["bandwidth"])
        if not np.isfinite(finish).all():
            raise ValueError("non-finite upload finish time — degenerate "
                             "bandwidth/availability profile")
        return finish


@dataclasses.dataclass(frozen=True)
class SimTimeConfig:
    """Knobs of the event-driven clock."""

    staleness_lambda: float = 0.05    # discount exp(-lambda * age_seconds)
    max_age: float | None = None      # drop contributions older than this
    quorum: int | None = None         # async: update every q arrivals
                                      # (None = clients_per_round)
    link_bandwidth: float = 1e8       # backbone bytes/s: internal tree edges
    heterogeneity: HeterogeneityConfig = HeterogeneityConfig()
    queue_bucket_s: float = 1.0       # BucketedEventQueue bucket width

    def __post_init__(self):
        if self.staleness_lambda < 0:
            raise ValueError("staleness_lambda must be >= 0")
        if self.quorum is not None and self.quorum < 1:
            raise ValueError("quorum must be >= 1")
        if self.queue_bucket_s <= 0:
            raise ValueError("queue_bucket_s must be > 0")


@dataclasses.dataclass
class Event:
    """One sketch upload landing at the server."""

    time: float           # arrival (virtual seconds)
    round_produced: int   # dispatch round — tie-break + staleness reporting
    slot: int             # index within the dispatch cohort — tie-break
    client: int
    produced: float       # dispatch time: the params snapshot this grad saw
    weight: float
    loss: float | None    # None: lazy (vectorized path computes at merge)
    table: Any            # (rows, cols) sketch, or None when lazy

    def key(self) -> tuple[float, int, int]:
        return (self.time, self.round_produced, self.slot)

    def meta(self) -> dict:
        """JSON-serializable fields (the table ships separately)."""
        return {"time": float(self.time),
                "round_produced": int(self.round_produced),
                "slot": int(self.slot), "client": int(self.client),
                "produced": float(self.produced),
                "weight": float(self.weight), "loss": float(self.loss)}


class EventQueue:
    """Future-event list with total, deterministic pop order.

    Heap keys are ``(time, round, slot)`` — unique per run, so the payload
    is never compared and simultaneous arrivals pop in dispatch order,
    which is what makes the RoundRecord stream deterministic.
    """

    def __init__(self):
        self._heap: list[tuple[tuple[float, int, int], Event]] = []

    def push(self, ev: Event) -> None:
        heapq.heappush(self._heap, (ev.key(), ev))

    def pop(self) -> Event:
        if not self._heap:
            raise ValueError("pop from empty event queue — no client upload "
                             "is in flight (empty or all-unavailable cohort?)")
        return heapq.heappop(self._heap)[1]

    def peek_time(self) -> float | None:
        return self._heap[0][0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def events(self) -> list[Event]:
        """Queue contents in pop order (non-destructive)."""
        return [ev for _, ev in sorted(self._heap, key=lambda kv: kv[0])]

    def state(self) -> list[Event]:
        """Events in pop order, as a saved queue would hold them."""
        return self.events()

    def load_state(self, events: list[Event]) -> None:
        self._heap = []
        for ev in events:
            self.push(ev)


class BucketedEventQueue:
    """Time-bucketed future-event list: same pop order as ``EventQueue``,
    O(active-bucket) pops instead of O(log n) heap churn at 10^5+ events.

    Events land in fixed-width time buckets (``bucket_s`` virtual seconds).
    Only the *active* bucket — the one currently being drained — is ever
    sorted (by ``Event.key()``, so tied timestamps fall back to
    ``(round, slot)`` exactly like the heap); other buckets are unsorted
    append-only lists, and a small heap of bucket ids orders the buckets
    themselves.  Bucket width only affects performance, never pop order:
    times in bucket ``b`` are strictly below times in bucket ``b+1``, and
    within a bucket the full ``key()`` ordering applies.  The structure is
    saved and restored by the same ``state()/load_state()`` contract as
    ``EventQueue``.
    """

    def __init__(self, bucket_s: float = 1.0):
        if not (bucket_s > 0 and math.isfinite(bucket_s)):
            raise ValueError(f"bucket_s must be positive, got {bucket_s}")
        self.bucket_s = float(bucket_s)
        self._buckets: dict[int, list[Event]] = {}   # unsorted pending
        self._order: list[int] = []                  # heap of bucket ids
        self._active: int | None = None
        self._sorted: list[Event] = []               # active, key-sorted
        self._keys: list[tuple] = []                 # parallel keys (bisect)
        self._pos = 0
        self._n = 0

    def _bucket(self, t: float) -> int:
        if not math.isfinite(t):
            raise ValueError(f"event time must be finite, got {t}")
        return math.floor(t / self.bucket_s)

    def push(self, ev: Event) -> None:
        b = self._bucket(ev.time)
        self._n += 1
        if b == self._active:
            # insertion into the bucket being drained: keep it sorted so the
            # next pop still returns the globally minimal key
            i = bisect.bisect_left(self._keys, ev.key(), lo=self._pos)
            self._keys.insert(i, ev.key())
            self._sorted.insert(i, ev)
            return
        lst = self._buckets.get(b)
        if lst is None:
            self._buckets[b] = [ev]
            heapq.heappush(self._order, b)
        else:
            lst.append(ev)

    def push_batch(self, events: Iterable[Event]) -> None:
        for ev in events:
            self.push(ev)

    def _min_pending_bucket(self) -> int | None:
        while self._order and not self._buckets.get(self._order[0]):
            heapq.heappop(self._order)    # emptied by load_state/activation
        return self._order[0] if self._order else None

    def _ensure_active(self) -> bool:
        """Make the active bucket hold the globally minimal pending key;
        False when the queue is empty."""
        b = self._min_pending_bucket()
        active_rem = self._pos < len(self._sorted)
        if b is None:
            return active_rem
        if active_rem and self._active is not None and self._active <= b:
            return True
        if active_rem:
            # an out-of-order push created an earlier bucket: park the
            # remainder of the current active bucket and switch down
            self._buckets[self._active] = self._sorted[self._pos:]
            heapq.heappush(self._order, self._active)
        heapq.heappop(self._order)
        lst = self._buckets.pop(b)
        lst.sort(key=Event.key)
        self._active, self._sorted, self._pos = b, lst, 0
        self._keys = [ev.key() for ev in lst]
        return True

    def pop(self) -> Event:
        if not self._ensure_active():
            raise ValueError("pop from empty event queue — no client upload "
                             "is in flight (empty or all-unavailable cohort?)")
        ev = self._sorted[self._pos]
        self._pos += 1
        self._n -= 1
        if self._pos == len(self._sorted):   # drained: free, keep bucket id
            self._sorted, self._keys, self._pos = [], [], 0
        return ev

    def peek_time(self) -> float | None:
        if not self._ensure_active():
            return None
        return self._sorted[self._pos].time

    def __len__(self) -> int:
        return self._n

    def events(self) -> list[Event]:
        """Queue contents in pop order (non-destructive)."""
        pending = self._sorted[self._pos:]
        for lst in self._buckets.values():
            pending.extend(lst)
        return sorted(pending, key=Event.key)

    def state(self) -> list[Event]:
        return self.events()

    def load_state(self, events: list[Event]) -> None:
        self._buckets, self._order = {}, []
        self._active, self._sorted, self._keys, self._pos = None, [], [], 0
        self._n = 0
        for ev in events:
            self.push(ev)
