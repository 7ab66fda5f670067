"""Uncompressed distributed SGD with (server-side) momentum.

Port of ``repro.baselines.uncompressed``.  The paper's "Uncompressed"
rows: clients upload the full d-dim gradient, download the full d-dim
update.  Compression is 1x by definition; it is the quality baseline every
method is measured against.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.layout import tree_map


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    momentum: float = 0.9


@dataclasses.dataclass
class SGDState:
    velocity: dict  # tree like params
    step: int


def init_state(params: dict, cfg: SGDConfig) -> SGDState:
    return SGDState(velocity=tree_map(torch.zeros_like, params), step=0)


def step(params: dict, grads: dict, state: SGDState, lr, cfg: SGDConfig):
    vel = tree_map(lambda v, g: cfg.momentum * v + g, state.velocity, grads)
    new_params = tree_map(lambda p, v: p - lr * v.to(p.dtype), params, vel)
    return new_params, SGDState(velocity=vel, step=state.step + 1)


def upload_bytes(d: int) -> int:
    return d * 4


def download_bytes(d: int) -> int:
    return d * 4
