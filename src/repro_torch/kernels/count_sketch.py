"""CUDA wrappers of the Count Sketch encode and estimate kernels.

``csrc/encode.cu`` replaces ``repro/kernels/count_sketch.py::_encode_kernel``
and ``csrc/estimate.cu`` replaces ``::_estimate_kernel``.  The wrappers take
CUDA tensors only: they check device, dtype, shape and contiguity, allocate
what the kernel writes, launch on PyTorch's current stream and raise if the
launch failed.  ``LAUNCHES`` counts the launches of each kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core import hashing

from . import build

LAUNCHES = {"encode": 0, "estimate": 0}


def check_cuda(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"expected CUDA tensors on one device, got "
                             f"{[str(t.device) for t in tensors]}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")
    return dev


def check_table(table: torch.Tensor, rows: int, cols: int) -> None:
    if table.dtype != torch.float32 or tuple(table.shape) != (rows, cols):
        raise ValueError(f"expected a ({rows}, {cols}) float32 table, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if not 1 <= rows <= hashing.MAX_ROWS:
        raise ValueError(f"rows must be in 1..{hashing.MAX_ROWS}, got {rows}")


def row_seeds(rows: int, key: int):
    return (build.seeds(hashing.bucket_seed(j, key) for j in range(rows)),
            build.seeds(hashing.sign_seed(j, key) for j in range(rows)))


def _check_ids(offset: int, n: int) -> None:
    if offset < 0 or offset + n > 1 << 64:
        raise ValueError(f"ids {offset}..{offset + n} are not 64-bit")


def sketch_encode(values: torch.Tensor, offset: int, rows: int, cols: int,
                  key: int = 0, *, out: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Add the sketch of the 1-D chunk ``values`` (global ids from
    ``offset``) into ``out`` (a new zero table if None) and return it."""
    if values.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"encode takes float32 or bfloat16, got "
                         f"{values.dtype}")
    if out is None:
        out = torch.zeros(rows, cols, dtype=torch.float32,
                          device=values.device)
    dev = check_cuda(values, out)
    check_table(out, rows, cols)
    n = values.numel()
    _check_ids(offset, n)
    if n == 0:
        return out
    bseeds, sseeds = row_seeds(rows, key)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.fs_encode(values.data_ptr(),
                           int(values.dtype == torch.bfloat16), n, offset,
                           out.data_ptr(), rows, cols, bseeds, sseeds,
                           torch.cuda.current_stream().cuda_stream)
    build.check(rc, "encode")
    LAUNCHES["encode"] += 1
    return out


def sketch_estimate(table: torch.Tensor, offset: int, n: int,
                    key: int = 0) -> torch.Tensor:
    """(n,) median-of-rows estimates for global ids offset..offset+n-1."""
    dev = check_cuda(table)
    rows, cols = table.shape
    check_table(table, rows, cols)
    _check_ids(offset, n)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    bseeds, sseeds = row_seeds(rows, key)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.fs_estimate(table.data_ptr(), rows, cols, offset, n,
                             out.data_ptr(), bseeds, sseeds,
                             torch.cuda.current_stream().cuda_stream)
    build.check(rc, "estimate")
    LAUNCHES["estimate"] += 1
    return out
