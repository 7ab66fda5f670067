"""Sketch-space health diagnostics — the FetchSGD-specific telemetry.

Port of ``repro.obs.sketch_health``.  Three signals cover the failure
modes of Algorithm 1:

* ``error_sketch_norm`` — ||S_e||_F.  Error feedback accumulates what
  top-k left behind; unbounded growth means k (or the learning rate) is
  mis-sized and the un-extracted mass is swamping the table.
* ``momentum_sketch_norm`` — ||S_u||_F, momentum-in-sketch magnitude.
* ``recovery_rel_err`` / ``heavy_hitter_overlap`` — on a sampled round,
  compare the server's aggregated table against the *dense* mean
  gradient it is a sketch of: relative L2 error of the estimated top-k
  values, and the fraction of estimated heavy hitters that really are in
  the dense top-k.

Everything stays on the tensors' device: the estimates come from
``core.topk.topk_from_sketch`` (the estimate kernel on the card) and the
dense top-k from ``torch.topk``, where the reference takes
``np.argpartition`` on the host (at d = 162,148,608 that would copy
649 MB to the host every sampled round).  Nothing here mutates run state.
"""

from __future__ import annotations

import torch

from repro_torch.core import layout as layout_lib
from repro_torch.core import topk as topk_lib


def flatten_dense(grads, layout: layout_lib.ParamLayout) -> torch.Tensor:
    """Mean-gradient tree -> the flat float32 d-vector the hashes are
    defined on, on the gradients' device."""
    views = layout_lib.leaf_views(grads, layout)
    return torch.cat([v.reshape(-1).to(torch.float32) for v in views])


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.to(torch.float32)))


def state_norms(opt_state, agg_table) -> dict:
    """Frobenius norms of the server's sketch-space state (cheap gauges)."""
    return {
        "error_sketch_norm": _norm(opt_state.error_sketch),
        "momentum_sketch_norm": _norm(opt_state.momentum_sketch),
        "agg_table_norm": _norm(agg_table),
    }


def recovery_error(agg_table: torch.Tensor, dense_flat: torch.Tensor,
                   layout: layout_lib.ParamLayout, cfg) -> dict:
    """Top-k recovery quality of ``agg_table`` vs its dense reference.

    ``dense_flat`` must be the same weighted mean the table is a sketch
    of (the linearity invariant) — then ``est ~= dense_flat[ids]`` up to
    Count-Sketch estimation noise, and the two numbers below measure
    exactly that noise.
    """
    est = topk_lib.topk_from_sketch(agg_table, layout, cfg.k, cfg.hash_key)
    gidx = topk_lib.global_ids(est, layout)
    true_vals = dense_flat[gidx]
    denom = _norm(true_vals)
    rel_err = _norm(est.values - true_vals) / denom if denom > 0 else 0.0
    k = est.k
    true_top = torch.topk(dense_flat.abs(), k).indices
    # np.intersect1d counts distinct ids; true_top is distinct already
    overlap = int(torch.isin(torch.unique(gidx), true_top).sum()) / max(k, 1)
    return {"recovery_rel_err": rel_err, "heavy_hitter_overlap": overlap}
