"""The telemetry front-end: one object the instrumented code talks to.

Port of ``repro.obs.telemetry``; the environment fingerprint reads torch.

``Telemetry`` bundles a ``MetricsRegistry``, a span tracer, and a set of
sinks.  The hot-path contract:

* ``tele.enabled`` is the one branch instrumented code must guard
  expensive derivations with (norms, dense references, histograms).
* ``tele.counter/gauge/histogram`` return live instruments (no-op
  versions on the disabled singleton ``NOOP`` — same API, no state).
* ``tele.span(name)`` returns ``NULL_SPAN`` unless tracing is on; a live
  span's event carries host time, profiler-clock stamps and, on a CUDA
  run, device time and a count of host syncs (``obs.trace``).
* ``tele.emit(type, **fields)`` stamps ``t`` (seconds since telemetry
  construction — monotonic, so event ordering survives clock steps) and
  fans out to every sink.
* ``tele.close()`` emits the spans still waiting for their device time,
  one final ``metrics`` snapshot event, and closes the sinks; safe to
  call twice.

Code below the orchestrator (the model's block spans, the kernel
dispatch) takes no telemetry argument: it opens its spans on
``current()``, the telemetry of the innermost ``active(tele)`` (``NOOP``
outside any).

Observability must never perturb the simulation: nothing here touches
any RNG, and instruments only *read* run state.  The determinism test in
``tests/test_torch_obs.py`` pins that (instrumented == uninstrumented
``RoundRecord`` stream, byte-identical).
"""

from __future__ import annotations

import contextlib
import platform
import sys
import time

from . import metrics as metrics_lib
from . import sinks as sinks_lib
from .trace import NULL_SPAN, DeviceClock, Span


def env_fingerprint() -> dict:
    """Where these numbers came from — stamped into every run: the Python
    and torch versions, the CUDA version torch was built with, and the
    card's name and count (``backend`` cpu and no device without one)."""
    import torch
    fp = {"python": platform.python_version(),
          "platform": platform.platform(),
          "torch": torch.__version__, "cuda": torch.version.cuda}
    if torch.cuda.is_available():
        fp.update(backend="cuda", device=torch.cuda.get_device_name(0),
                  n_devices=torch.cuda.device_count())
    else:
        fp.update(backend="cpu", device=None, n_devices=0)
    return fp


class Telemetry:
    """Live telemetry: metrics + spans + sinks."""

    def __init__(self, sinks: list[sinks_lib.Sink] | None = None, *,
                 trace: bool = False):
        self.sinks = list(sinks or [])
        self.trace_enabled = bool(trace)
        self.metrics = metrics_lib.MetricsRegistry()
        self._span_stack: list[Span] = []
        self._clock: DeviceClock | None = None   # made on a CUDA run
        self._t0 = time.perf_counter()
        self._closed = False

    @property
    def enabled(self) -> bool:
        return True

    # -- instruments --------------------------------------------------------

    def counter(self, name: str) -> metrics_lib.Counter:
        return self.metrics.counter(name)

    def gauge(self, name: str) -> metrics_lib.Gauge:
        return self.metrics.gauge(name)

    def histogram(self, name: str, buckets=None) -> metrics_lib.Histogram:
        return self.metrics.histogram(name, buckets)

    def span(self, name: str, **attrs):
        if not self.trace_enabled:
            return NULL_SPAN
        return Span(self, name, attrs)

    # -- events -------------------------------------------------------------

    def emit(self, type_: str, **fields) -> None:
        ev = {"type": type_, "t": time.perf_counter() - self._t0}
        ev.update(fields)
        for s in self.sinks:
            s.emit(ev)

    def emit_meta(self, **run_fields) -> None:
        """The stream's first event: env fingerprint + run identity."""
        self.emit("meta", env=env_fingerprint(),
                  argv=list(sys.argv), **run_fields)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._clock is not None:
            for ev in self._clock.ready("wait"):
                self.emit("span", **ev)
        snap = self.metrics.snapshot()
        self.emit("metrics", **snap)
        for s in self.sinks:
            s.close()


class _NoopInstrument:
    """Counter/gauge/histogram of the disabled telemetry: accepts
    everything, records nothing."""

    __slots__ = ()
    value = None

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def quantile(self, q):
        return float("nan")


_NOOP_INSTRUMENT = _NoopInstrument()


class NoopTelemetry:
    """The disabled singleton: same surface as ``Telemetry``, zero state.

    Every accessor returns a shared immutable object, so instrumented
    code paths allocate nothing when observability is off.
    """

    enabled = False
    trace_enabled = False
    sinks = ()

    def counter(self, name):
        return _NOOP_INSTRUMENT

    def gauge(self, name):
        return _NOOP_INSTRUMENT

    def histogram(self, name, buckets=None):
        return _NOOP_INSTRUMENT

    def span(self, name, **attrs):
        return NULL_SPAN

    def emit(self, type_, **fields):
        pass

    def emit_meta(self, **run_fields):
        pass

    def close(self):
        pass


NOOP = NoopTelemetry()


# The ambient telemetry, innermost ``active`` last.
_ACTIVE: list = [NOOP]


@contextlib.contextmanager
def active(tele):
    """Open the spans of the code below the orchestrator (model blocks,
    kernel dispatches) on ``tele`` while inside; they are live only when
    ``tele`` traces."""
    _ACTIVE.append(tele)
    try:
        yield
    finally:
        _ACTIVE.pop()


def current():
    """The innermost active telemetry, or ``NOOP``."""
    return _ACTIVE[-1]


# -- CLI plumbing (launch/simulate) ---------------------------------------

def add_cli_flags(ap) -> None:
    ap.add_argument("--metrics", default=None, metavar="PATH.jsonl",
                    help="emit telemetry events as JSONL to this path")
    ap.add_argument("--trace", action="store_true",
                    help="emit tracing spans (host time, profiler-clock "
                         "stamps; on the card device time and host syncs), "
                         "kernel launches included")
    ap.add_argument("--obs-summary", action="store_true",
                    help="print a telemetry summary to stdout at exit")


def from_args(args, **meta) -> "Telemetry | NoopTelemetry":
    """Build telemetry from the shared CLI flags; NOOP when all are off."""
    sinks: list[sinks_lib.Sink] = []
    if getattr(args, "metrics", None):
        sinks.append(sinks_lib.JsonlSink(args.metrics))
    if getattr(args, "obs_summary", False) or (
            getattr(args, "trace", False) and not sinks):
        # --trace with nowhere to put spans still deserves output
        sinks.append(sinks_lib.StdoutSummarySink())
    if not sinks:
        return NOOP
    tele = Telemetry(sinks, trace=getattr(args, "trace", False))
    tele.emit_meta(**meta)
    return tele
