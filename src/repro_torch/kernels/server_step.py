"""CUDA wrappers of the two FetchSGD server-step kernels.

``csrc/momentum_error.cu`` replaces
``repro/kernels/server_step.py::_momentum_error_kernel`` and
``csrc/topk_mask.cu`` replaces ``::_topk_mask_kernel``.  The wrappers take
CUDA tensors only, check them, launch on PyTorch's current stream and
raise if the launch failed.  ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import torch

from . import build
from .count_sketch import (check_cuda, check_table, fastmod_multiplier,
                           row_seeds)

LAUNCHES = {"momentum_error": 0, "topk_mask": 0}


def momentum_error(agg: torch.Tensor, su: torch.Tensor, se: torch.Tensor,
                   lr: torch.Tensor, momentum: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """New tables ``su' = momentum * su + agg`` and ``se' = lr * su' + se``.

    ``lr`` is a one-element float32 tensor on the same device; the kernel
    reads it by pointer.
    """
    rows, cols = agg.shape
    su_out = torch.empty_like(agg)
    se_out = torch.empty_like(agg)
    dev = check_cuda(agg, su, se, lr, su_out, se_out)
    for t in (agg, su, se, su_out, se_out):
        check_table(t, rows, cols)
        if t.data_ptr() % 16:
            raise ValueError("momentum_error needs 16-byte aligned tables")
    if lr.dtype != torch.float32 or lr.numel() != 1:
        raise ValueError("lr must be a one-element float32 tensor")
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.fs_momentum_error(
            agg.data_ptr(), su.data_ptr(), se.data_ptr(), lr.data_ptr(),
            float(momentum), su_out.data_ptr(), se_out.data_ptr(),
            agg.numel(), torch.cuda.current_stream().cuda_stream)
    build.check(rc, "momentum_error")
    LAUNCHES["momentum_error"] += 1
    return su_out, se_out


def topk_mask(su: torch.Tensor, se: torch.Tensor, ids: torch.Tensor,
              values: torch.Tensor, key: int = 0, *, error_mode: str = "zero",
              momentum_masking: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero (or subtract S(Delta) from) the hit cells of ``se`` and mask
    those of ``su``, **in place**; returns ``(su, se)``.

    ``ids``: (k,) int64 global ids; ``values``: (k,) float32.  With k = 0
    the tables are returned unchanged and nothing is launched.
    """
    if error_mode not in ("zero", "subtract"):
        raise ValueError(f"bad error_mode {error_mode}")
    rows, cols = su.shape
    dev = check_cuda(su, se, ids, values)
    check_table(su, rows, cols)
    check_table(se, rows, cols)
    k = ids.numel()
    if ids.dtype != torch.int64 or ids.dim() != 1:
        raise ValueError("ids must be a 1-D int64 tensor")
    if values.dtype != torch.float32 or tuple(values.shape) != (k,):
        raise ValueError(f"values must be ({k},) float32")
    if k == 0:
        return su, se
    bseeds, sseeds = row_seeds(rows, key)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.fs_topk_mask(
            ids.data_ptr(), values.data_ptr(), k, su.data_ptr(),
            se.data_ptr(), rows, cols, bseeds, sseeds,
            fastmod_multiplier(cols), int(error_mode == "subtract"),
            int(momentum_masking),
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "topk_mask")
    LAUNCHES["topk_mask"] += 1
    return su, se
