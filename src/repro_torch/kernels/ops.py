"""Dispatch of the four sketch kernels by the device their tensors lie on.

A CUDA tensor launches the hand-written kernel (``count_sketch`` /
``server_step``), which raises if it cannot build or launch; a CPU tensor
takes the plain PyTorch twin in ``ref``.  There is no implementation knob
and no fallback from the card to the plain version.  (The reference's
``--sketch-impl`` and its TPU VMEM size gates have no counterpart here.)
"""

from __future__ import annotations

import torch

from . import count_sketch as cuda_cs
from . import ref
from . import server_step as cuda_ss


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
    fn = cuda_cs.sketch_encode if _on_cuda(values) else ref.sketch_encode
    return fn(values, offset, rows, cols, key, out=out)


def sketch_estimate(table: torch.Tensor, offset: int, n: int,
                    key: int = 0) -> torch.Tensor:
    fn = cuda_cs.sketch_estimate if _on_cuda(table) else ref.sketch_estimate
    return fn(table, offset, n, key)


def momentum_error(agg: torch.Tensor, su: torch.Tensor, se: torch.Tensor,
                   lr: torch.Tensor, momentum: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    fn = cuda_ss.momentum_error if _on_cuda(agg) else ref.momentum_error
    return fn(agg, su, se, lr, momentum)


def topk_mask(su: torch.Tensor, se: torch.Tensor, ids: torch.Tensor,
              values: torch.Tensor, key: int = 0, *, error_mode: str = "zero",
              momentum_masking: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor]:
    fn = cuda_ss.topk_mask if _on_cuda(su) else ref.topk_mask
    return fn(su, se, ids, values, key, error_mode=error_mode,
              momentum_masking=momentum_masking)


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    return {**cuda_cs.LAUNCHES, **cuda_ss.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (cuda_cs.LAUNCHES, cuda_cs.PATHS, cuda_ss.LAUNCHES):
        for name in counts:
            counts[name] = 0
