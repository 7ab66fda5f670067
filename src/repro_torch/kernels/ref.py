"""Plain PyTorch twins of the CUDA kernels, with their signatures.

They are the CPU path (``repro_torch.kernels.ops`` sends every CPU tensor
here) and the reference each kernel is held against on the card.  They
repeat the kernels' arithmetic op for op — ``repro.kernels.ref`` plus
``momentum_error_jnp`` / ``topk_mask_jnp`` of ``repro.kernels.server_step``
— and are no yardstick of speed.
"""

from __future__ import annotations

import torch

from repro_torch.core import count_sketch as cs


def sketch_encode(values: torch.Tensor, offset: int, rows: int, cols: int,
                  key: int = 0, *, out: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """(rows, cols) sketch of a 1-D chunk with global id ``offset``; with
    ``out``, the chunk's table is added into ``out`` (in place)."""
    table = cs.sketch_chunk(values, offset, rows, cols, key)
    if out is None:
        return table
    return out.add_(table)


def sketch_estimate(table: torch.Tensor, offset: int, n: int,
                    key: int = 0) -> torch.Tensor:
    """Median-of-rows estimates for global ids offset..offset+n-1."""
    return cs.estimate_chunk(table, offset, n, key)


def sketch_estimate_topk(table: torch.Tensor, offset: int, n: int, kk: int,
                         key: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The kk largest |estimate| ids of the chunk: ``(est[idx], idx)``
    with ``idx`` from ``torch.topk(|est|, kk)``, in its order (ties as it
    breaks them, where the kernel keeps the lowest ids)."""
    est = sketch_estimate(table, offset, n, key)
    idx = torch.topk(est.abs(), kk).indices
    return est[idx], idx


def l2_estimate(table: torch.Tensor) -> torch.Tensor:
    """Median over rows of the row l2 norms (``CountSketch.l2_estimate``)."""
    return cs.l2_estimate(table)


def momentum_error(agg: torch.Tensor, su: torch.Tensor, se: torch.Tensor,
                   lr: torch.Tensor, momentum: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``su' = momentum * su + agg``, ``se' = lr * su' + se`` (new tables)."""
    su2 = momentum * su + agg
    se2 = lr * su2 + se
    return su2, se2


def topk_mask(su: torch.Tensor, se: torch.Tensor, ids: torch.Tensor,
              values: torch.Tensor, key: int = 0, *, error_mode: str = "zero",
              momentum_masking: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Post-extraction update of the sketches, **in place**.

    ``error_mode='zero'`` zeroes the cells the extracted ids hash to in
    ``se``; ``'subtract'`` subtracts S(Delta).  ``momentum_masking`` zeroes
    the same cells in ``su``.  Returns ``(su, se)``.
    """
    rows, cols = su.shape
    if error_mode not in ("zero", "subtract"):
        raise ValueError(f"bad error_mode {error_mode}")
    if ids.numel() == 0:
        return su, se
    mask = None
    if error_mode == "zero" or momentum_masking:
        mask = cs.hit_mask_ids(ids, rows, cols, key)
    if error_mode == "zero":
        se.masked_fill_(mask, 0.0)
    else:
        se.sub_(cs.sketch_sparse(ids, values, rows, cols, key))
    if momentum_masking:
        su.masked_fill_(mask, 0.0)
    return su, se
