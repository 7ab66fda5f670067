"""Nestable tracing spans on the host's and the device's clocks.

Port of ``repro.obs.trace``.  ``Telemetry.span(name)`` returns a context
manager; on exit it emits a ``span`` event carrying ``dur_s`` (the host's
``perf_counter`` from enter to exit), nesting ``depth``, ``parent`` name,
and ``t0_ns`` / ``t1_ns``: enter and exit on the clock the torch profiler
stamps its host and device events with (``time.time_ns``), so that a span
lines up with a profiler trace.

On a CUDA run (CUDA initialized when the outermost span enters) a span
also carries:

* ``dev_s``: the device time between two CUDA events the span records on
  the current stream, one at enter and one at exit.  Recording them adds
  no sync.  The time is read once the events are known to be done: at the
  exit of the next span that waits for the device (``span.sync``), or at
  ``Telemetry.close()``; an outermost span also takes the events done by
  its exit.  Until then the span's event waits, its other fields as its
  exit took them.
* ``syncs``: the host-device synchronisations made between enter and
  exit, the telemetry's own not counted.  They come from torch's own
  check (``torch.cuda.set_sync_debug_mode("warn")``), armed while an
  outermost span is open, its warnings counted and not printed.

Two properties matter for correctness of the numbers:

* **Device barriers.**  CUDA launches are asynchronous: a kernel call
  returns before the card has run it.  ``span.sync(out)`` registers
  ``out``; at exit, if it holds a CUDA tensor (alone, or in a list, tuple
  or dict), the span calls ``torch.cuda.synchronize`` on that tensor's
  device before it takes the end time, so ``dur_s`` measures the device's
  work, not the launch.  A device error raised there propagates.
* **Zero cost when disabled.**  A disabled tracer hands out the one
  shared ``NULL_SPAN``; entering/exiting it touches no clock, allocates
  nothing, records no event, arms no check, and ``sync`` is the identity,
  so no device sync is added.
"""

from __future__ import annotations

import threading
import time
import warnings

import torch

SYNC_WARNING = "called a synchronizing CUDA operation"


class NullSpan:
    """Shared no-op span: the disabled path (also the no-op telemetry's)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def sync(self, x):
        return x

    def set(self, **attrs) -> None:
        pass


NULL_SPAN = NullSpan()


def cuda_device(x) -> torch.device | None:
    """The device of the first CUDA tensor in ``x`` (a tensor, or lists,
    tuples and dicts of them), or None when it holds none."""
    if isinstance(x, torch.Tensor):
        return x.device if x.is_cuda else None
    items = (x.values() if isinstance(x, dict) else
             x if isinstance(x, (list, tuple)) else ())
    for item in items:
        dev = cuda_device(item)
        if dev is not None:
            return dev
    return None


class SyncCheck:
    """torch's check of host-device syncs, armed while any CUDA run's
    outermost span is open (nested arms counted), each of its warnings
    counted in ``count`` and not shown; while ``paused`` they are not
    counted either.  One for the process (``SYNC_CHECK``), as the check's
    mode and ``warnings.showwarning`` are the process's: spans of two
    telemetries nest on it."""

    def __init__(self):
        self.count = 0
        self.paused = 0
        self._depth = 0
        self._mode = 0
        self._shown = None
        self._hook = self._showwarning
        self._lock = threading.Lock()

    def arm(self) -> None:
        with self._lock:
            if self._depth == 0:
                if not any(f[0] == "always" and f[1] is not None
                           and f[1].pattern == SYNC_WARNING
                           for f in warnings.filters):
                    # every warning counts: no registry may fold repeats
                    warnings.filterwarnings("always", message=SYNC_WARNING)
                self._shown = warnings.showwarning
                warnings.showwarning = self._hook
                self._mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
            self._depth += 1

    def disarm(self) -> None:
        with self._lock:
            self._depth -= 1
            if self._depth == 0:
                torch.cuda.set_sync_debug_mode(self._mode)
                if warnings.showwarning is self._hook:
                    warnings.showwarning = self._shown

    def _showwarning(self, message, category, *rest, **kw):
        if str(message).startswith(SYNC_WARNING):
            if not self.paused:
                self.count += 1
            return
        self._shown(message, category, *rest, **kw)


SYNC_CHECK = SyncCheck()


class DeviceClock:
    """The CUDA side of one telemetry's spans: reused timing events, and
    the spans that wait for theirs to be read."""

    def __init__(self):
        self._free: list = []
        self.pending: list = []          # (event fields, start, end)

    def record(self):
        ev = (self._free.pop() if self._free
              else torch.cuda.Event(enable_timing=True))
        ev.record()
        return ev

    def ready(self, how: str) -> list[dict]:
        """The waiting spans' fields with ``dev_s``, in exit order:
        ``"done"`` every one (the device was just synchronised), ``"poll"``
        those done so far up to the first that is not, ``"wait"`` every
        one after waiting for its end event."""
        out = []
        SYNC_CHECK.paused += 1
        try:
            for ev, start, end in self.pending:
                if how == "poll" and not end.query():
                    break
                if how == "wait":
                    end.synchronize()
                ev["dev_s"] = start.elapsed_time(end) * 1e-3
                self._free += (start, end)
                out.append(ev)
        finally:
            SYNC_CHECK.paused -= 1
            del self.pending[:len(out)]
        return out


class Span:
    """One live span; created by ``Telemetry.span`` only."""

    __slots__ = ("_tele", "name", "attrs", "_t0", "_ns0", "_sync", "depth",
                 "parent", "_clock", "_start", "_syncs0")

    def __init__(self, tele, name: str, attrs: dict):
        self._tele = tele
        self.name = name
        self.attrs = attrs
        self._t0 = None
        self._sync = None
        self.depth = 0
        self.parent = None
        self._clock = None

    def sync(self, x):
        """Register a tensor (or a tree of them) to wait for at exit;
        returns it."""
        self._sync = x
        return x

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        tele = self._tele
        stack = tele._span_stack
        self.depth = len(stack)
        self.parent = stack[-1].name if stack else None
        if not stack:
            if tele._clock is None and torch.cuda.is_initialized():
                tele._clock = DeviceClock()
            if tele._clock is not None:
                SYNC_CHECK.arm()
        stack.append(self)
        self._clock = clock = tele._clock
        if clock is not None:
            self._start = clock.record()
            self._syncs0 = SYNC_CHECK.count
        self._ns0 = time.time_ns()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        tele, clock = self._tele, self._clock
        end = clock.record() if clock is not None else None
        synced = False
        try:
            dev = cuda_device(self._sync)
            if dev is not None:
                SYNC_CHECK.paused += 1
                try:
                    torch.cuda.synchronize(dev)
                finally:
                    SYNC_CHECK.paused -= 1
                synced = True
        finally:
            t1 = time.perf_counter()
            ns1 = time.time_ns()
            stack = tele._span_stack
            if stack and stack[-1] is self:
                stack.pop()
            outermost = not stack
            if clock is not None:
                syncs = SYNC_CHECK.count - self._syncs0
                if outermost:
                    SYNC_CHECK.disarm()
        ev = {"t": t1 - tele._t0, "name": self.name, "dur_s": t1 - self._t0,
              "depth": self.depth, "parent": self.parent,
              "t0_ns": self._ns0, "t1_ns": ns1}
        if clock is not None:
            ev["syncs"] = syncs
        if exc_type is not None:
            ev["error"] = exc_type.__name__
        ev.update(self.attrs)
        if clock is None:
            tele.emit("span", **ev)
            return False
        clock.pending.append((ev, self._start, end))
        if synced or outermost:
            for done in clock.ready("done" if synced else "poll"):
                tele.emit("span", **done)
        return False
