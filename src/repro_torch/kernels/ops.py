"""Dispatch of the sketch kernels by the device their tensors lie on.

A CUDA tensor launches the hand-written kernel (``count_sketch`` /
``server_step``), which raises if it cannot build or launch; a CPU tensor
takes the plain PyTorch twin in ``ref``.  There is no implementation knob
and no fallback from the card to the plain version.  (The reference's
``--sketch-impl`` and its TPU VMEM size gates have no counterpart here.)

Telemetry: inside ``obs.active(tele)`` a dispatch opens a span when
``tele`` traces: ``kernel.<name>[cuda:<path>]`` on the card (the encode's
path is ``binned`` or ``one_pass``, the fused estimate and selection's
``select``, the others' ``sm_90a``) and ``kernel.<name>[torch:eager]`` on
the CPU.  A span adds no device sync: on the card its ``dur_s`` is the
host's launch time and its ``dev_s`` the kernel's device time, from the
CUDA events the span records around the launch (``obs.trace``), read
once an enclosing span or ``close()`` has waited for the device.  With
tracing off the dispatch adds nothing.
"""

from __future__ import annotations

import torch

from repro_torch import obs

from . import count_sketch as cuda_cs
from . import ref
from . import server_step as cuda_ss


def _span(name: str, operand: torch.Tensor, path="sm_90a"):
    """The dispatch's span on the active telemetry, named only when that
    traces; ``path`` may be a function of no argument, called only then."""
    tele = obs.current()
    if not tele.trace_enabled:
        return obs.NULL_SPAN
    if operand.is_cuda:
        path = path() if callable(path) else path
        return tele.span(f"kernel.{name}[cuda:{path}]")
    return tele.span(f"kernel.{name}[torch:eager]")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no sketch kernel for device {t.device}")


def sketch_encode(values: torch.Tensor, offset: int, rows: int, cols: int,
                  key: int = 0, *, out: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """(rows, cols) sketch of a chunk, added into ``out`` when given."""
    on_cuda = _on_cuda(values)
    fn = cuda_cs.sketch_encode if on_cuda else ref.sketch_encode
    # the path only names the span: read the bin geometry only when tracing
    with _span("encode", values, lambda: "binned" if cuda_cs.bins().use(
            values.numel(), rows, cols) else "one_pass"):
        return fn(values, offset, rows, cols, key, out=out)


def sketch_estimate(table: torch.Tensor, offset: int, n: int,
                    key: int = 0) -> torch.Tensor:
    on_cuda = _on_cuda(table)
    fn = cuda_cs.sketch_estimate if on_cuda else ref.sketch_estimate
    with _span("estimate", table):
        return fn(table, offset, n, key)


def sketch_estimate_topk(table: torch.Tensor, offset: int, n: int, kk: int,
                         key: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, local_idx) of the chunk's kk largest |estimate| ids."""
    on_cuda = _on_cuda(table)
    fn = cuda_cs.sketch_estimate_topk if on_cuda else ref.sketch_estimate_topk
    with _span("estimate", table, "select"):
        return fn(table, offset, n, kk, key)


def momentum_error(agg: torch.Tensor, su: torch.Tensor, se: torch.Tensor,
                   lr: torch.Tensor, momentum: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    on_cuda = _on_cuda(agg)
    fn = cuda_ss.momentum_error if on_cuda else ref.momentum_error
    with _span("momentum_error", agg):
        return fn(agg, su, se, lr, momentum)


def topk_mask(su: torch.Tensor, se: torch.Tensor, ids: torch.Tensor,
              values: torch.Tensor, key: int = 0, *, error_mode: str = "zero",
              momentum_masking: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor]:
    on_cuda = _on_cuda(su)
    fn = cuda_ss.topk_mask if on_cuda else ref.topk_mask
    with _span("topk_mask", su):
        return fn(su, se, ids, values, key, error_mode=error_mode,
                  momentum_masking=momentum_masking)


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    return {**cuda_cs.LAUNCHES, **cuda_ss.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (cuda_cs.LAUNCHES, cuda_cs.PATHS, cuda_ss.LAUNCHES):
        for name in counts:
            counts[name] = 0
