"""Nestable wall-clock tracing spans.

Port of ``repro.obs.trace``.  ``Telemetry.span(name)`` returns a context
manager; on exit it emits a ``span`` event carrying duration, nesting
depth, and parent name.  Two properties matter for correctness of the
numbers:

* **Device barriers.**  CUDA launches are asynchronous: a kernel call
  returns before the card has run it.  ``span.sync(out)`` registers
  ``out``; at exit, if it holds a CUDA tensor (alone, or in a list, tuple
  or dict), the span calls ``torch.cuda.synchronize`` on that tensor's
  device before it takes the end time, so it measures the device's work,
  not the launch.  A device error raised there propagates.
* **Zero cost when disabled.**  A disabled tracer hands out the one
  shared ``NULL_SPAN``; entering/exiting it touches no clock, allocates
  nothing, and ``sync`` is the identity, so no device sync is added.
"""

from __future__ import annotations

import time

import torch


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


class Span:
    """One live span; created by ``Telemetry.span`` only."""

    __slots__ = ("_tele", "name", "attrs", "_t0", "_sync", "depth", "parent")

    def __init__(self, tele, name: str, attrs: dict):
        self._tele = tele
        self.name = name
        self.attrs = attrs
        self._t0 = None
        self._sync = None
        self.depth = 0
        self.parent = None

    def sync(self, x):
        """Register a tensor (or a tree of them) to wait for at exit;
        returns it."""
        self._sync = x
        return x

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        stack = self._tele._span_stack
        self.depth = len(stack)
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            dev = cuda_device(self._sync)
            if dev is not None:
                torch.cuda.synchronize(dev)
        finally:
            dur = time.perf_counter() - self._t0
            stack = self._tele._span_stack
            if stack and stack[-1] is self:
                stack.pop()
        ev = {"name": self.name, "dur_s": dur, "depth": self.depth,
              "parent": self.parent}
        if exc_type is not None:
            ev["error"] = exc_type.__name__
        ev.update(self.attrs)
        self._tele.emit("span", **ev)
        return False
