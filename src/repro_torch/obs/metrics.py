"""Metrics primitives: counters, gauges, fixed-bucket histograms.

The port's own copy of ``repro.obs.metrics`` (stdlib and numpy only), so
that ``repro_torch`` imports nothing of the JAX package; snapshots have
the reference's shape and values.

The registry is deliberately tiny — this is single-process simulation
telemetry, not a Prometheus client.  Three instrument kinds cover the
federation runtime's needs:

* ``Counter`` — monotonically increasing totals (bytes-on-wire, merges);
* ``Gauge`` — last-observed value (loss, buffer depth, sketch norms);
* ``Histogram`` — fixed log-spaced buckets with quantile *estimates* by
  linear interpolation inside the winning bucket.  Fixed buckets keep
  ``observe`` O(log buckets) and the snapshot O(buckets) regardless of
  sample count, which is what lets per-event observations (staleness
  ages, idle seconds) stay cheap over million-event runs.

Everything snapshots to plain JSON-serializable dicts
(``MetricsRegistry.snapshot``) so the sinks never see live objects.
"""

from __future__ import annotations

import bisect
import math


def default_buckets(lo: float = 1e-6, hi: float = 1e9,
                    per_decade: int = 3) -> tuple[float, ...]:
    """Log-spaced bucket upper bounds covering [lo, hi] (1-2-5 style when
    ``per_decade=3``); values above the last bound land in +inf."""
    steps = {1: (1.0,), 2: (1.0, 3.0), 3: (1.0, 2.0, 5.0)}.get(
        per_decade, tuple(10 ** (i / per_decade) for i in range(per_decade)))
    bounds = []
    decade = 10.0 ** math.floor(math.log10(lo))
    while decade <= hi:
        for s in steps:
            b = decade * s
            if lo <= b <= hi:
                bounds.append(b)
        decade *= 10.0
    return tuple(bounds)


class Counter:
    """Monotonic total. ``inc`` with a negative amount is a bug."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n


class Gauge:
    """Last-observed value (None until first set)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with interpolated quantile estimates."""

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, buckets: tuple[float, ...] | None = None):
        self.bounds = tuple(sorted(buckets)) if buckets else default_buckets()
        self.counts = [0] * (len(self.bounds) + 1)   # last = overflow (+inf)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def observe_many(self, values) -> None:
        """Batched ``observe`` for population-scale paths: one searchsorted
        over the whole array instead of 10^5 Python-level bisects."""
        import numpy as np
        vs = np.asarray(values, dtype=np.float64)
        if vs.size == 0:
            return
        idx = np.searchsorted(np.asarray(self.bounds), vs, side="left")
        for i, c in zip(*np.unique(idx, return_counts=True)):
            self.counts[int(i)] += int(c)
        self.count += int(vs.size)
        self.sum += float(vs.sum())
        self.min = min(self.min, float(vs.min()))
        self.max = max(self.max, float(vs.max()))

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0 <= q <= 1) from bucket counts.

        Linear interpolation inside the winning bucket, clamped to the
        observed [min, max] so estimates never leave the data's range.
        An empty histogram returns nan.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return math.nan
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= rank and c > 0:
                lo = self.bounds[i - 1] if i > 0 else min(self.min, 0.0)
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                frac = (rank - seen) / c
                return max(self.min, min(self.max, lo + frac * (hi - lo)))
            seen += c
        return self.max

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "bounds": list(self.bounds), "counts": list(self.counts),
                "p50": self.quantile(0.5) if self.count else None,
                "p90": self.quantile(0.9) if self.count else None,
                "p99": self.quantile(0.99) if self.count else None}


def quantile_from_snapshot(snap: dict, q: float) -> float:
    """Re-estimate a quantile from a serialized histogram snapshot (used by
    ``scripts/report_run.py`` after a JSONL round-trip)."""
    h = Histogram(tuple(snap["bounds"]))
    h.counts = list(snap["counts"])
    h.count = snap["count"]
    h.sum = snap["sum"]
    h.min = snap["min"] if snap["min"] is not None else math.inf
    h.max = snap["max"] if snap["max"] is not None else -math.inf
    return h.quantile(q)


class MetricsRegistry:
    """Name -> instrument map; instruments are created on first touch."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  buckets: tuple[float, ...] | None = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(buckets)
        return h

    def __len__(self) -> int:
        return (len(self._counters) + len(self._gauges)
                + len(self._histograms))

    def snapshot(self) -> dict:
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.snapshot()
                           for k, h in sorted(self._histograms.items())},
        }
