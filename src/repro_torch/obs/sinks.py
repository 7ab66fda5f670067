"""Event sinks: where telemetry events go.

A sink consumes plain-dict events (see ``repro_torch.obs.schema``) and never
hands them back — the JSONL sink is the durable record, the memory sink
is for tests, the stdout sink prints a human summary at close.  All
sinks tolerate ``close()`` twice (the CLI drivers close on both the happy
path and in ``finally``).
"""

from __future__ import annotations

import json
import sys
from typing import IO


class Sink:
    """Base: consume one event dict; flush/teardown on close."""

    def emit(self, event: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullSink(Sink):
    """Discards everything (the disabled default — must stay stateless)."""

    def emit(self, event: dict) -> None:
        pass


class MemorySink(Sink):
    """Keeps events in a list (tests + report rendering)."""

    def __init__(self):
        self.events: list[dict] = []
        self.closed = False

    def emit(self, event: dict) -> None:
        self.events.append(event)

    def close(self) -> None:
        self.closed = True


class JsonlSink(Sink):
    """One JSON object per line, append-mode, flushed per event.

    Per-event flush keeps the file valid after a crash mid-run — the
    whole point of a durable event stream; these are per-round events,
    not per-element, so the syscall cost is noise.
    """

    def __init__(self, path: str):
        self.path = path
        self._f: IO[str] | None = open(path, "a")

    def emit(self, event: dict) -> None:
        if self._f is None:
            raise ValueError(f"JsonlSink({self.path}) already closed")
        self._f.write(json.dumps(event, sort_keys=True,
                                 default=_json_default) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def _json_default(o):
    """Last-resort coercion: numpy scalars and one-element tensors -> python numbers."""
    for attr in ("item",):
        f = getattr(o, attr, None)
        if callable(f):
            return f()
    return str(o)


class StdoutSummarySink(Sink):
    """Aggregates in memory; prints a compact run summary at close."""

    def __init__(self, file: IO[str] | None = None):
        self._file = file or sys.stdout
        self._rounds = 0
        self._spans: dict[str, list[float]] = {}
        self._last_metrics: dict | None = None

    def emit(self, event: dict) -> None:
        t = event.get("type")
        if t == "round":
            self._rounds += 1
        elif t == "span":
            self._spans.setdefault(event["name"], []).append(event["dur_s"])
        elif t == "metrics":
            self._last_metrics = event

    def close(self) -> None:
        out = self._file
        print(f"[obs] {self._rounds} rounds, "
              f"{sum(len(v) for v in self._spans.values())} spans", file=out)
        for name, durs in sorted(self._spans.items(),
                                 key=lambda kv: -sum(kv[1])):
            print(f"[obs]   span {name:<28} n={len(durs):<5} "
                  f"total={sum(durs):8.3f}s mean={sum(durs)/len(durs)*1e3:8.2f}ms",
                  file=out)
        if self._last_metrics:
            for k, v in self._last_metrics.get("counters", {}).items():
                print(f"[obs]   counter {k} = {v}", file=out)


def parse_jsonl(path: str) -> list[dict]:
    """Read back a JSONL event stream (report tooling + tests)."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events
