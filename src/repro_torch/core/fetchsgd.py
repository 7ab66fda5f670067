"""FetchSGD — Algorithm 1 of the paper, as a server-side optimizer.

Port of ``repro.core.fetchsgd``:

      S^t    = mean_i S(g_i^t)                    (sketch_grads, per client)
      S_u^t  = rho * S_u^{t-1} + S^t              (momentum, in sketch space)
      S_e^t  = eta * S_u^t + S_e^{t-1}            (error feedback)
      Delta  = Top-k(U(S_e^t))
      S_e    = zero-hit-cells(S_e)   [paper's practical variant]
               or S_e - S(Delta)     [Algorithm 1, line 14]
      S_u    = zero-hit-cells(S_u)   [momentum factor masking, optional]
      w      <- w - Delta

On CUDA tensors the sketch, the momentum/error update, the estimates and
the hit-cell update run the hand-written kernels (``repro_torch.kernels``);
on CPU tensors their plain twins.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops as kernel_ops

from . import count_sketch as cs
from . import layout as layout_lib
from . import topk as topk_lib


@dataclasses.dataclass(frozen=True)
class FetchSGDConfig:
    """Static hyper-parameters of the optimizer."""

    rows: int = 5
    cols: int = 1 << 16
    k: int = 1000
    momentum: float = 0.9
    hash_key: int = 0
    error_mode: str = "zero"        # "zero" (paper practice) | "subtract" (Alg. 1)
    momentum_masking: bool = True

    def __post_init__(self):
        if self.error_mode not in ("zero", "subtract"):
            raise ValueError(f"bad error_mode {self.error_mode}")


@dataclasses.dataclass
class FetchSGDState:
    """Server state: everything lives in sketch space (r x c), never O(d)."""

    momentum_sketch: torch.Tensor  # S_u, (rows, cols)
    error_sketch: torch.Tensor     # S_e, (rows, cols)
    step: int


def init_state(cfg: FetchSGDConfig, device=None) -> FetchSGDState:
    def z():
        return torch.zeros(cfg.rows, cfg.cols, dtype=torch.float32,
                           device=device)
    return FetchSGDState(momentum_sketch=z(), error_sketch=z(), step=0)


def sketch_grads(grads: dict, layout: layout_lib.ParamLayout,
                 cfg: FetchSGDConfig, shard_idx: int | None = None,
                 local: bool = False, values=None) -> torch.Tensor:
    """Client-side compression: S(g) for a gradient tree.

    By linearity each chunk adds an independent partial table; the encode
    kernel adds every local chunk into one table, in the reference's
    order (chunks grouped by leaf, rows and offset count).  ``local``: the
    grads are a rank's shard-local tree (EP leaves sliced), and an
    expert-parallel chunk takes the global offset of data shard
    ``shard_idx`` (a Python int, as every offset here is).  ``values``:
    ``lc -> flat values`` of a local chunk in place of the views of
    ``grads`` (a tensor-parallel rank's chunks gathered over its model
    group, ``model_local.gathered_values``).
    """
    if values is None:
        views = layout_lib.leaf_views(grads, layout, local=local)

        def values(lc):
            return layout_lib.chunk_values(views, lc)
    device = layout_lib.flatten(grads)[0][1].device
    table = torch.zeros(cfg.rows, cfg.cols, dtype=torch.float32,
                        device=device)
    groups: dict[tuple[int, int, int], list] = {}
    for lc in layout.local_chunks:
        groups.setdefault((lc.leaf, lc.n_rows, len(lc.offsets)),
                          []).append(lc)
    for _, lcs in sorted(groups.items()):
        for lc in lcs:
            si = (shard_idx or 0) if len(lc.offsets) > 1 else 0
            kernel_ops.sketch_encode(values(lc),
                                     lc.offsets[si], cfg.rows, cfg.cols,
                                     cfg.hash_key, out=table)
    return table


def unsketch_topk(table: torch.Tensor, layout: layout_lib.ParamLayout,
                  cfg: FetchSGDConfig) -> topk_lib.SparseDelta:
    """Delta = Top-k(U(table)) over the global flat space."""
    return topk_lib.topk_from_sketch(table, layout, cfg.k, cfg.hash_key)


def _as_lr(lr, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(lr, dtype=torch.float32, device=like.device)


def server_step(agg_table: torch.Tensor, state: FetchSGDState, lr,
                layout: layout_lib.ParamLayout, cfg: FetchSGDConfig
                ) -> tuple[topk_lib.SparseDelta, FetchSGDState]:
    """One aggregator update given the mean client sketch S^t.

    ``lr`` is best a 0-d float32 tensor on the tables' device, which the
    momentum/error kernel reads by pointer.  The state passed in is left
    unchanged: the hit-cell update works in place on the new tables.
    """
    su, se = kernel_ops.momentum_error(
        agg_table, state.momentum_sketch, state.error_sketch,
        _as_lr(lr, agg_table), cfg.momentum)
    delta = unsketch_topk(se, layout, cfg)
    ids = topk_lib.global_ids(delta, layout)
    su, se = kernel_ops.topk_mask(
        su, se, ids, delta.values, cfg.hash_key, error_mode=cfg.error_mode,
        momentum_masking=cfg.momentum_masking)
    return delta, FetchSGDState(momentum_sketch=su, error_sketch=se,
                                step=state.step + 1)


def server_step_reference(agg_table: torch.Tensor, state: FetchSGDState, lr,
                          layout: layout_lib.ParamLayout, cfg: FetchSGDConfig
                          ) -> tuple[topk_lib.SparseDelta, FetchSGDState]:
    """Unfused oracle: the update phase by phase as plain tensor ops."""
    su = cfg.momentum * state.momentum_sketch + agg_table
    se = _as_lr(lr, agg_table) * su + state.error_sketch
    delta = topk_lib.topk_from_sketch(se, layout, cfg.k, cfg.hash_key)
    ids = topk_lib.global_ids(delta, layout)
    mask = None
    if cfg.error_mode == "zero" or cfg.momentum_masking:
        mask = cs.hit_mask_ids(ids, cfg.rows, cfg.cols, cfg.hash_key)
    if cfg.error_mode == "zero":
        se = torch.where(mask, 0.0, se)
    else:
        se = se - cs.sketch_sparse(ids, delta.values, cfg.rows, cfg.cols,
                                   cfg.hash_key)
    if cfg.momentum_masking:
        su = torch.where(mask, 0.0, su)
    return delta, FetchSGDState(momentum_sketch=su, error_sketch=se,
                                step=state.step + 1)


def apply_delta(params: dict, layout: layout_lib.ParamLayout,
                delta: topk_lib.SparseDelta, shard_idx: int | None = None,
                local: bool = False, model_plan=None,
                model_idx: int = 0) -> dict:
    """w <- w - Delta in place (Delta already carries the learning rate);
    ``model_plan`` / ``model_idx``: the params are model shard
    ``model_idx``'s (``topk.apply_delta``)."""
    return topk_lib.apply_delta(params, layout, delta, scale=1.0,
                                shard_idx=shard_idx, local=local,
                                model_plan=model_plan, model_idx=model_idx)


def step(params: dict, grads: dict, state: FetchSGDState, lr,
         layout: layout_lib.ParamLayout, cfg: FetchSGDConfig):
    """Single-process convenience path: sketch + server update + apply."""
    table = sketch_grads(grads, layout, cfg)
    delta, new_state = server_step(table, state, lr, layout, cfg)
    return apply_delta(params, layout, delta), new_state, delta


# -- communication accounting -------------------------------------------------

def upload_bytes(cfg: FetchSGDConfig) -> int:
    """Bytes uploaded per client per round: the sketch table."""
    return cfg.rows * cfg.cols * 4


def download_bytes(cfg: FetchSGDConfig) -> int:
    """Bytes downloaded per client per round: k (index, value) pairs."""
    return cfg.k * 8


def tree_upload_bytes(cfg: FetchSGDConfig, n_clients: int,
                      fanout: int = 4) -> list[tuple[int, int]]:
    """Per-level (n_messages, bytes) for a ``fanout``-ary aggregation tree."""
    return tree_level_bytes(upload_bytes(cfg), n_clients, fanout)


def tree_level_bytes(table_bytes: int, n: int,
                     fanout: int = 4) -> list[tuple[int, int]]:
    """The level math behind ``tree_upload_bytes`` (any message size)."""
    if n <= 0:
        return []
    levels = []
    while n > 1:
        levels.append((n, n * table_bytes))
        n = -(-n // fanout)
    return levels or [(n, n * table_bytes)]
