"""Distributed step builders: FetchSGD train, prefill, decode.

Port of ``repro.launch.steps`` on ``torch.distributed``, one process a
rank (``launch.mesh``).  As in the reference, the client axes (``pod``,
``data``) are manual: each client rank takes its slice of the global
batch, computes its own loss and gradient and sketches it, and the only
collective across clients in the optimizer path is the (rows x cols)
table:

    local grad -> sketch (r x c) -> mean over (pod, data) -> server update

after which every rank runs the same ``server_step`` and ``apply_delta``
(the dense-gradient mean it replaces is the ``aggregate='dense'``
baseline).

The ``model`` axis is GSPMD's in the reference: it places tensors and
changes no number.  Here a model group holds replicated parameters and
computes the same gradient; what the model axis does change in the
numbers is kept exactly — the view permutations of
``sharding.layout_view_plan``, which redefine the global ids, and the
model-local sketch (``sketch_mode='model_local'``), where each model rank
sketches the slice ``param_spec`` gives it and the tables are summed over
the model group.

Expert-parallel archs (``cfg.shard_experts_data``) hold only their expert
slice on each data rank (:func:`local_params`); routing goes through
``all_to_all`` (``moe.moe_apply_ep``), expert slices are sketched at their
data shard's global offsets, and the sparse update is applied only to the
chunks the rank owns.

The reference's vectorized cohort step (``make_cohort_fn``) has its
counterpart in the orchestrator (``fed.orchestrator`` materializes a
cohort's lazy events chunk by chunk).  The input structs
(:func:`param_structs`, :func:`batch_structs`, :func:`cache_structs`)
serve the dry-run (``launch/dryrun.py``): a rank's tensors on the
``meta`` device, with the global shapes beside them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.core import fetchsgd as F
from repro_torch.core import layout as layout_lib
from repro_torch.core import model_local
from repro_torch.fed import aggregator as fed_agg
from repro_torch.models import moe, sharding, transformer
from repro_torch.models.config import ArchConfig

from .mesh import Mesh
from .shapes import ShapeSpec

AGGREGATES = ("sketch", "tree", "async", "dense")


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """A step: ``fn`` and the layout its sketches and updates use."""

    fn: Callable
    layout: Any = None               # ParamLayout (train steps)
    plan: Any = None                 # ModelLocalPlan (model_local)
    grad_fn: Callable | None = None  # train: the rank's forward and
                                     # backward on its local batch


# -- placement -------------------------------------------------------------------

def param_structs(cfg: ArchConfig) -> dict:
    """The parameter tree's shapes, on the ``meta`` device."""
    return transformer.init_params(cfg, device="meta")


def ep_info(cfg: ArchConfig, mesh) -> tuple[bool, dict[str, int]]:
    """(has_ep, leaf path -> its data-sharded dim)."""
    axes = sharding.data_shard_axes(param_structs(cfg), cfg, mesh)
    return bool(axes), axes


def build_layout(cfg: ArchConfig, mesh) -> layout_lib.ParamLayout:
    """The global FetchSGD layout of the mesh step: EP leaves owner-aligned
    and the view permutations of the model axis applied."""
    structs = param_structs(cfg)
    _, ds_axes = ep_info(cfg, mesh)
    perms, _, _ = sharding.layout_view_plan(structs, cfg, mesh)
    ep = sharding.mesh_shape(mesh)["data"] if ds_axes else 1
    return layout_lib.build_layout(structs, data_shard_axis=ds_axes,
                                   view_perms=perms, ep=ep)


def local_params(full: dict, cfg: ArchConfig, mesh, data_index=None) -> dict:
    """A rank's tree from the full one: each expert-parallel leaf cut to
    data shard ``data_index``'s slice (a copy), every other leaf whole
    (the same tensor).  What GSPMD places in the reference."""
    _, ds_axes = ep_info(cfg, mesh)
    d = mesh.index("data") if data_index is None else data_index
    n = mesh.shape.get("data", 1)
    out = []
    for path, leaf in layout_lib.flatten(full):
        ax = ds_axes.get(path)
        if ax is not None:
            size = leaf.shape[ax] // n
            leaf = leaf.narrow(ax, d * size, size).contiguous()
        out.append(leaf)
    return layout_lib.unflatten([p for p, _ in layout_lib.flatten(full)],
                                out)


def assemble_params(parts: list[dict], cfg: ArchConfig, mesh) -> dict:
    """The full tree from the local trees of data shards 0, 1, ...: the
    inverse of :func:`local_params`."""
    _, ds_axes = ep_info(cfg, mesh)
    paths = [p for p, _ in layout_lib.flatten(parts[0])]
    leaves = []
    for i, path in enumerate(paths):
        pieces = [layout_lib.flatten(t)[i][1] for t in parts]
        ax = ds_axes.get(path)
        leaves.append(pieces[0] if ax is None else torch.cat(pieces, ax))
    return layout_lib.unflatten(paths, leaves)


def local_batch(batch: dict, mesh: Mesh) -> dict:
    """This client rank's slice of a global batch: every array whose
    leading dim ``sharding.batch_spec`` shards over the client axes, cut
    to its part; the rest whole."""
    out = {}
    for k, v in batch.items():
        if sharding.batch_spec(tuple(v.shape), mesh)[:1] != (None,):
            b = v.shape[0] // mesh.n_clients
            v = v[mesh.client_index * b:(mesh.client_index + 1) * b]
        out[k] = v
    return out


def local_batch_size(global_batch: int, mesh) -> int:
    """The rows of a global batch a client rank takes (``mesh``: a
    :class:`Mesh` or an axis -> size dict)."""
    if sharding.batch_spec((global_batch,), mesh)[0] is None:
        return global_batch
    shape = sharding.mesh_shape(mesh)
    return global_batch // math.prod(
        shape[a] for a in sharding.batch_axes(shape))


# -- input structs ---------------------------------------------------------------

CACHE_DTYPE = torch.bfloat16


def batch_structs(cfg: ArchConfig, shape: ShapeSpec,
                  mesh) -> tuple[dict, dict]:
    """(the rank's batch, the global shapes): ``tokens`` (B, 1) for a
    decode, else ``tokens`` (B, S less the patch prefix), ``labels`` for a
    train step, ``patches`` (B, n_patches, d) for a vision model and
    ``frames`` (B, enc_seq, d) for an encoder-decoder; the rank's tensors
    on ``meta`` with B cut by :func:`local_batch_size`, the global shapes
    as ``name -> (shape, dtype)``."""
    B, S = shape.global_batch, shape.seq_len
    glob = {}
    if shape.kind == "decode":
        glob["tokens"] = ((B, 1), torch.int64)
    else:
        s_text = S - (cfg.n_patches if cfg.frontend == "vision" else 0)
        glob["tokens"] = ((B, s_text), torch.int64)
        if shape.kind == "train":
            glob["labels"] = ((B, s_text), torch.int64)
        if cfg.frontend == "vision":
            glob["patches"] = ((B, cfg.n_patches, cfg.d_model),
                               torch.float32)
        if cfg.is_encdec:
            glob["frames"] = ((B, cfg.enc_seq, cfg.d_model), torch.float32)
    b = local_batch_size(B, mesh)
    local = {k: torch.empty((b,) + s[1:], dtype=dt, device="meta")
             for k, (s, dt) in glob.items()}
    return local, glob


def cache_structs(cfg: ArchConfig, shape: ShapeSpec,
                  mesh) -> tuple[dict, dict]:
    """(the rank's cache, the global shapes): ``transformer.init_cache``
    for ``shape.seq_len`` tokens in ``CACHE_DTYPE`` at the rank's batch on
    ``meta`` (whole on every model rank: the port does not shard a cache),
    and each leaf's global shape as ``path -> shape``."""
    b = local_batch_size(shape.global_batch, mesh)
    local = transformer.init_cache(cfg, b, shape.seq_len, CACHE_DTYPE,
                                   device="meta")
    full = transformer.init_cache(cfg, shape.global_batch, shape.seq_len,
                                  CACHE_DTYPE, device="meta")
    return local, {p: tuple(t.shape) for p, t in layout_lib.flatten(full)}


# -- train step ------------------------------------------------------------------

def make_train_step(cfg: ArchConfig, shape: ShapeSpec, mesh: Mesh,
                    fs_cfg: F.FetchSGDConfig, *,
                    aggregate: str = "sketch",
                    sketch_mode: str = "gathered",
                    weighted: bool = False) -> StepBundle:
    """FetchSGD train step, parameterized by sketch aggregation policy.

    ``aggregate`` selects how client sketch tables merge:

    * ``'sketch'`` / ``'flat'`` — one mean over all client axes;
    * ``'tree'``   — one mean per axis, innermost first;
    * ``'async'``  — the flat merge of this round's cohort plus a
      host-injected buffer of staleness-discounted late tables.  The step
      takes three extra args ``(fresh_w, inject_table, inject_w)`` and
      returns this round's merged table in ``metrics['table']`` so the
      host (``launch.train`` + ``fed.AsyncBufferedAggregator``) can buffer
      a straggled round;
    * ``'dense'``  — the mean of the full gradient (the baseline), except
      expert-parallel leaves, averaged only over the axes other than
      ``data``.

    ``sketch_mode='model_local'`` (flat only): each model rank sketches
    its slice and the tables are summed over the model group.
    ``weighted=True`` (sketch/tree only) appends one trailing arg, one
    weight a client shard (in client-index order), and the merge becomes
    the exact weighted mean.

    Returns ``fn(params, opt_state, batch, lr[, fresh_w, inject,
    inject_w][, weights]) -> (params, opt_state, metrics)``: ``params`` is
    the rank's local tree, updated in place; ``batch`` the global batch
    (each rank takes its slice); ``metrics['loss']`` the clients' mean and
    ``metrics['table']`` this round's merged table (for ``dense``, the
    sketch of the mean gradient).
    """
    if aggregate == "flat":
        aggregate = "sketch"
    if aggregate not in AGGREGATES:
        raise ValueError(f"unknown aggregate policy {aggregate!r}")
    if sketch_mode not in ("gathered", "model_local"):
        raise ValueError(f"unknown sketch mode {sketch_mode!r}")
    if weighted and aggregate not in ("sketch", "tree"):
        raise ValueError("weighted merging needs aggregate='sketch'|'tree' "
                         f"(got {aggregate!r})")
    if weighted and sketch_mode == "model_local":
        raise ValueError("weighted merging is not wired into the "
                         "model_local pipeline")
    del shape   # the port's step takes the batch as it comes
    axes = mesh.client_axes
    has_ep, ds_axes = ep_info(cfg, mesh)
    layout = build_layout(cfg, mesh)
    sidx = mesh.index("data") if has_ep else None
    ep_group = mesh.group(("data",)) if has_ep else None
    dev = mesh.device

    def grad_fn(params, local):
        with moe.expert_parallel(ep_group):
            return transformer.value_and_grad(params, local, cfg)

    def loss_grads(params, batch):
        return grad_fn(params, local_batch(batch, mesh))

    def server_apply(params, opt_state, table, lr):
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        delta, new_state = F.server_step(table, opt_state, lr, layout, fs_cfg)
        F.apply_delta(params, layout, delta, shard_idx=sidx, local=has_ep)
        return params, new_state

    def sketch(grads):
        return F.sketch_grads(grads, layout, fs_cfg, shard_idx=sidx,
                              local=has_ep)

    def mean_loss(loss):
        return mesh.all_mean(loss.to(torch.float32).clone(), axes)

    if aggregate == "sketch" and sketch_mode == "model_local":
        tp = mesh.shape.get("model", 1)
        _, modes, _ = sharding.layout_view_plan(param_structs(cfg), cfg, mesh)
        plan = model_local.build_plan(layout, modes, tp=tp)
        s_m = mesh.index("model")

        def fn_ml(params, opt_state, batch, lr):
            loss, grads = loss_grads(params, batch)
            views = model_local.model_slice(grads, layout, plan, s_m)
            del grads
            table = model_local.sketch_grads(views, layout, plan, fs_cfg,
                                             sidx, s_m)
            mesh.all_sum(table, ("model",))
            table = fed_agg.mesh_aggregate(table, mesh, axes, policy="flat")
            params, opt_state = server_apply(params, opt_state, table, lr)
            return params, opt_state, {"loss": mean_loss(loss),
                                       "table": table}

        return StepBundle(fn=fn_ml, layout=layout, plan=plan,
                          grad_fn=grad_fn)

    if aggregate == "async":
        def fn_async(params, opt_state, batch, lr, fresh_w, inject_table,
                     inject_w):
            """Flat in-step merge + the host buffer's injection.

            ``inject_table`` is a discount-weighted *sum* of buffered
            tables (total weight ``inject_w``); ``fresh_w`` is 0 when the
            host marks this round's cohort as straggling.  With an empty
            buffer and ``fresh_w`` 1 this is the flat policy exactly.  A
            round of total weight 0 leaves params and state untouched.
            """
            loss, grads = loss_grads(params, batch)
            table = sketch(grads)
            del grads
            fresh = fed_agg.mesh_aggregate(table, mesh, axes, policy="flat")
            total_w = float(fresh_w) + float(inject_w)
            if total_w > 0:
                merged = (fresh * float(fresh_w) + inject_table.to(dev)) \
                    / max(total_w, 1e-8)
                params, opt_state = server_apply(params, opt_state, merged,
                                                 lr)
            return params, opt_state, {"loss": mean_loss(loss),
                                       "table": fresh}

        return StepBundle(fn=fn_async, layout=layout, grad_fn=grad_fn)

    def fn(params, opt_state, batch, lr, *weights):
        loss, grads = loss_grads(params, batch)
        if aggregate == "dense":
            for path, g in layout_lib.flatten(grads):
                red = axes if path not in ds_axes else tuple(
                    a for a in axes if a != "data")
                mesh.all_mean(g, red)
            table = sketch(grads)
        else:
            table = sketch(grads)
            w = float(weights[0][mesh.client_index]) if weighted else None
            table = fed_agg.mesh_aggregate(
                table, mesh, axes,
                policy="tree" if aggregate == "tree" else "flat", weight=w)
        del grads
        params, opt_state = server_apply(params, opt_state, table, lr)
        return params, opt_state, {"loss": mean_loss(loss), "table": table}

    return StepBundle(fn=fn, layout=layout, grad_fn=grad_fn)


# -- serve steps -----------------------------------------------------------------

def _serve_step(cfg: ArchConfig, mesh: Mesh, step_fn, global_batch: int):
    has_ep, _ = ep_info(cfg, mesh)
    ep_group = mesh.group(("data",)) if has_ep else None
    split = local_batch_size(global_batch, mesh) != global_batch

    def gather(logits):
        if not split:
            return logits
        return torch.cat(mesh.all_gather(logits, mesh.client_axes))

    def fn(params, inputs, cache):
        with moe.expert_parallel(ep_group):
            logits, cache = step_fn(params, inputs, cfg, cache)
        return gather(logits), cache

    return fn


def make_prefill_step(cfg: ArchConfig, shape: ShapeSpec,
                      mesh: Mesh) -> StepBundle:
    """``fn(params, batch, cache) -> (logits (B, V), cache)``: the global
    batch split over the client ranks when ``batch_spec`` shards it, each
    rank's prefill on its slice into its own cache (sized with
    :func:`local_batch_size`), the logits gathered over the clients."""
    inner = _serve_step(cfg, mesh, transformer.prefill, shape.global_batch)
    return StepBundle(
        fn=lambda params, batch, cache: inner(
            params, local_batch(batch, mesh), cache))


def make_decode_step(cfg: ArchConfig, shape: ShapeSpec,
                     mesh: Mesh) -> StepBundle:
    """``fn(params, tokens (B, 1), cache) -> (logits (B, V), cache)``, split
    and gathered as :func:`make_prefill_step`'s."""
    inner = _serve_step(cfg, mesh, transformer.decode_step,
                        shape.global_batch)
    return StepBundle(
        fn=lambda params, tokens, cache: inner(
            params, local_batch({"tokens": tokens}, mesh)["tokens"], cache))
