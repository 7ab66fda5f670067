"""FedAvg (McMahan et al., 2016) — the paper's primary baseline.

Port of ``repro.baselines.fedavg``.  Each participating client downloads
the model, runs ``local_epochs`` of SGD over its local dataset, and
uploads the model *difference*; the server averages the differences
(weighted by local dataset size) and optionally applies global momentum
rho_g.  FedAvg attains compression only by running fewer rounds —
per-round communication is 2 * d * 4 bytes per client.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import layout as layout_lib
from repro_torch.core.layout import tree_map


@dataclasses.dataclass(frozen=True)
class FedAvgConfig:
    local_epochs: int = 1
    local_batch_size: int = 0       # 0 => full local dataset per step
    global_momentum: float = 0.0


@dataclasses.dataclass
class ServerState:
    velocity: dict
    step: int


def init_server_state(params: dict, cfg: FedAvgConfig) -> ServerState:
    return ServerState(velocity=tree_map(torch.zeros_like, params), step=0)


def client_update(params: dict, batches: dict, lr, grad_fn: Callable,
                  cfg: FedAvgConfig) -> dict:
    """Run local SGD and return the (negated) model delta w0 - w_final.

    ``batches``: dict of tensors with a leading (local_epochs * steps)
    axis, taken in order (the reference's ``lax.scan``) — one client's
    local optimization.  ``grad_fn(params, batch) -> grads``.
    """
    p = params
    for s in range(next(iter(batches.values())).shape[0]):
        g = grad_fn(p, {k: v[s] for k, v in batches.items()})
        p = tree_map(lambda w, gg: w - lr * gg.to(w.dtype), p, g)
    return tree_map(lambda a, b: a - b, params, p)   # w0 - w_K


def server_apply(params: dict, deltas: list, weights, state: ServerState,
                 cfg: FedAvgConfig):
    """Weighted-average client deltas and step the global model."""
    dev = layout_lib.flatten(params)[0][1].device
    weights = torch.tensor([float(w) for w in weights], dtype=torch.float32,
                           device=dev)
    weights = weights / weights.sum()
    agg = tree_map(torch.zeros_like, params)
    for w, d in zip(weights, deltas):
        agg = tree_map(lambda a, dd: a + w * dd, agg, d)
    if cfg.global_momentum > 0.0:
        vel = tree_map(lambda v, u: cfg.global_momentum * v + u,
                       state.velocity, agg)
    else:
        vel = agg
    new_params = tree_map(lambda p, v: p - v.to(p.dtype), params, vel)
    return new_params, ServerState(velocity=vel, step=state.step + 1)


def upload_bytes(d: int) -> int:
    return d * 4


def download_bytes(d: int) -> int:
    return d * 4
