"""Local top-k gradient sparsification (Lin et al. 2017 as run in the paper).

Port of ``repro.baselines.local_topk``.  Each client uploads the k
largest-|.| coordinates of its *local* gradient.  The server sums the
sparse uploads (the union can approach W*k non-zeros — why the paper
observes download compression collapsing to ~1x on non-i.i.d. data) and
optionally applies *global momentum* rho_g to the aggregated dense update.

Error feedback needs per-client state: each client keeps the residual
``e_i <- e_i + lr*g_i - uploaded`` and re-adds it next time it
participates.  In true federated settings clients participate once and
the state is dead weight — the paper's central criticism.  It is an option
so that the data-center regime can be simulated too.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import layout as layout_lib
from repro_torch.core import topk as topk_lib
from repro_torch.core.layout import tree_map


@dataclasses.dataclass(frozen=True)
class LocalTopKConfig:
    k: int = 1000
    global_momentum: float = 0.0    # rho_g in the paper (0 or 0.9)
    use_error_feedback: bool = False


@dataclasses.dataclass
class ServerState:
    velocity: dict      # dense tree (global momentum)
    step: int


def init_server_state(params: dict, cfg: LocalTopKConfig) -> ServerState:
    return ServerState(velocity=tree_map(torch.zeros_like, params), step=0)


def init_client_error(params: dict) -> dict:
    """Residual tree for one client (only when use_error_feedback)."""
    return tree_map(torch.zeros_like, params)


def client_compress(grads: dict, error, lr,
                    layout: layout_lib.ParamLayout, cfg: LocalTopKConfig):
    """Top-k of (lr*g + e) -> (SparseDelta upload, new error)."""
    acc = (tree_map(lambda g, e: lr * g + e, grads, error)
           if cfg.use_error_feedback else tree_map(lambda g: lr * g, grads))
    delta = topk_lib.topk_dense(layout_lib.leaf_views(acc, layout), layout,
                                cfg.k)
    if cfg.use_error_feedback:
        # e <- acc - uploaded (acc is this call's own tensor: in place)
        return delta, topk_lib.apply_delta(acc, layout, delta, scale=1.0)
    return delta, error


def server_apply(params: dict, deltas: list, state: ServerState,
                 layout: layout_lib.ParamLayout, cfg: LocalTopKConfig):
    """Sum client uploads, apply global momentum, update the model.

    The sum is materialized densely on the server, which is what makes the
    *download* nearly dense in the non-i.i.d. regime.
    """
    w = 1.0 / len(deltas)
    agg = tree_map(torch.zeros_like, params)
    for d in deltas:
        topk_lib.apply_delta(agg, layout, d, scale=-w)   # += w * delta
    if cfg.global_momentum > 0.0:
        vel = tree_map(lambda v, u: cfg.global_momentum * v + u,
                       state.velocity, agg)
    else:
        vel = agg
    new_params = tree_map(lambda p, v: p - v.to(p.dtype), params, vel)
    return new_params, ServerState(velocity=vel, step=state.step + 1)


def upload_bytes(cfg: LocalTopKConfig) -> int:
    return cfg.k * 8  # (index, value) pairs


def download_bytes(nnz_union: int) -> int:
    """Server->client bytes: union of uploaded supports (measured, not k)."""
    return nnz_union * 8
