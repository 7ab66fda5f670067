"""Top-k over the flat parameter space, and the sparse update.

Port of ``repro.core.topk``.  ``Delta = Top-k(U(S_e))`` — the k largest
|estimate| coordinates of the error sketch over all d global ids — is
found chunk by chunk: each chunk gives its candidates, and one top-k over
the pool picks the winners.  A chunk's candidates come from one fused op
(``kernels.ops.sketch_estimate_topk``): on the card the estimate kernel
with the selection fused into it, which keeps the lowest local indices
among ties at the per-chunk k-th magnitude; on the CPU the estimates and
``torch.topk``, as the reference takes ``lax.top_k`` of them.
``topk_dense`` makes the same selection over a dense accumulator, for the
baselines that keep one (local and true top-k).  The final top-k over the
pool, and ``topk_dense``'s, stay library calls (``torch.topk``), as
``lax.top_k`` stayed XLA in the reference.  ``torch.topk`` does not
promise ``lax.top_k``'s order among equal magnitudes.

The ids are defined over each leaf's permuted 2-D view when the layout
has view permutations (``layout.build_layout(view_perms=)``), so
``global_ids`` and ``densify`` follow the permuted order; ``apply_delta``
writes each permuted leaf through the inverse permutation, and on a mesh
with expert-parallel leaves only the chunks the rank's data shard owns.

Exactness: with at most ``EXACT_CHUNK_LIMIT`` chunks every chunk gives k
candidates, so the result is exactly Top-k(U(S_e)); larger layouts cap
the per-chunk count (``_chunk_k``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops as kernel_ops

from . import layout as layout_lib

EXACT_CHUNK_LIMIT = 64   # <= this many chunks: keep per-chunk k exact


@dataclasses.dataclass
class SparseDelta:
    """k-sparse update over the global flat parameter space."""

    chunk_id: torch.Tensor   # (k,) int64 — index into layout.chunks
    local_idx: torch.Tensor  # (k,) int64 — element offset within the chunk
    values: torch.Tensor     # (k,) float32
    k: int


def _chunk_k(k: int, chunk_size: int, num_chunks: int) -> int:
    if num_chunks <= EXACT_CHUNK_LIMIT:
        return min(k, chunk_size)
    return min(k, chunk_size, max(512, (4 * k) // num_chunks))


def topk_from_sketch(table: torch.Tensor, layout: layout_lib.ParamLayout,
                     k: int, key: int = 0) -> SparseDelta:
    """Top-|.|-k of U(table) over the whole layout (chunked unsketch)."""
    nall = layout.num_chunks
    cand_vals, cand_local, cand_chunk = [], [], []
    for g in layout.groups:
        size = g.n_rows * g.row_len
        kk = _chunk_k(k, size, nall)
        for ci in g.chunk_ids:
            vals, idx = kernel_ops.sketch_estimate_topk(
                table, layout.chunks[ci].offset, size, kk, key)
            cand_vals.append(vals)
            cand_local.append(idx)
            cand_chunk.append(torch.full((kk,), ci, dtype=torch.int64,
                                         device=table.device))
    vals = torch.cat(cand_vals)
    k_eff = min(k, vals.numel())
    sel = torch.topk(vals.abs(), k_eff).indices
    return SparseDelta(chunk_id=torch.cat(cand_chunk)[sel],
                       local_idx=torch.cat(cand_local)[sel],
                       values=vals[sel], k=k_eff)


def topk_dense(acc_views: list, layout: layout_lib.ParamLayout,
               k: int) -> SparseDelta:
    """Exact top-|.|-k of a *dense* accumulator given as each leaf's 2-D
    view (local top-k / true top-k): per-chunk candidates, then one top-k
    over the pool."""
    nall = layout.num_chunks
    cand_vals, cand_local, cand_chunk = [], [], []
    for g in layout.groups:
        kk = _chunk_k(k, g.n_rows * g.row_len, nall)
        view = acc_views[g.leaf]
        for ci in g.chunk_ids:
            rs = layout.chunks[ci].row_start
            vals = view[rs:rs + g.n_rows].reshape(-1).to(torch.float32)
            idx = torch.topk(vals.abs(), kk).indices
            cand_vals.append(vals[idx])
            cand_local.append(idx)
            cand_chunk.append(torch.full((kk,), ci, dtype=torch.int64,
                                         device=vals.device))
    vals = torch.cat(cand_vals)
    k_eff = min(k, vals.numel())
    sel = torch.topk(vals.abs(), k_eff).indices
    return SparseDelta(chunk_id=torch.cat(cand_chunk)[sel],
                       local_idx=torch.cat(cand_local)[sel],
                       values=vals[sel], k=k_eff)


def global_ids(delta: SparseDelta, layout: layout_lib.ParamLayout
               ) -> torch.Tensor:
    """(k,) int64 global element ids of the extracted coordinates."""
    offs = torch.tensor([ch.offset for ch in layout.chunks],
                        dtype=torch.int64, device=delta.values.device)
    return offs[delta.chunk_id] + delta.local_idx


def _storage_index(idx: torch.Tensor, shape: tuple[int, ...], perm,
                   strides: tuple[int, ...]) -> torch.Tensor:
    """Flat indices in the PERMUTED order of a leaf whose permuted shape
    is ``shape`` -> offsets into the leaf's storage (its own strides):
    the write back through the inverse permutation, with no copy."""
    out = torch.zeros_like(idx)
    rem = idx
    for dim in reversed(range(len(shape))):
        out += (rem % shape[dim]) * strides[perm[dim]]
        rem = rem // shape[dim]
    return out


def _model_local_index(sel, idx, shape, view_dims, s_m: int):
    """Flat indices of a leaf's (permuted, data-local) 2-D view -> those
    of model shard ``s_m``'s part of it, which holds ``view_dims``:
    (entries that fall in the shard, their indices, the shard's permuted
    shape)."""
    n_rows, row_len = layout_lib._leaf_2d(shape)
    vr, vc = view_dims
    r, c = idx // row_len, idx % row_len
    if vc != row_len:                      # the shard's columns
        sel = sel & (c // vc == s_m)
        return sel, torch.where(sel, r * vc + c % vc, 0), shape[:-1] + (vc,)
    if vr != n_rows:                       # the shard's rows
        sel = sel & (r // vr == s_m)
        return sel, torch.where(sel, (r % vr) * row_len + c, 0), \
            (vr,) + tuple(shape[1:])
    return sel, idx, shape


def apply_delta(params: dict, layout: layout_lib.ParamLayout,
                delta: SparseDelta, scale: float = 1.0,
                shard_idx: int | None = None, local: bool = False,
                model_plan=None, model_idx: int = 0) -> dict:
    """params <- params - scale * Delta, **in place** (``index_add_`` into
    each leaf's flat storage); returns ``params``.

    Each entry's chunk gives its leaf and its first element in the leaf's
    (local, permuted) view, all from device tables, so no host sync is
    needed to split the ids by leaf: an entry of another leaf, or of an
    EP chunk owned by another data shard than ``shard_idx``, adds
    ``-0.0`` at element 0, which leaves every value unchanged.  A permuted
    leaf is written through the inverse permutation.  ``local``: the
    params are a rank's shard-local tree (EP leaves sliced).
    ``model_plan`` (a ``model_local.ModelLocalPlan``): the params are
    model shard ``model_idx``'s, each leaf the plan's model-local view
    (its columns or rows of the 2-D view); an entry outside the shard's
    strided part is another shard's and changes nothing here.
    """
    dev = delta.values.device
    leaf_of = torch.tensor([ch.leaf for ch in layout.chunks],
                           dtype=torch.int64, device=dev)[delta.chunk_id]
    start = torch.tensor([(ch.lrs if local else ch.row_start) * ch.row_len
                          for ch in layout.chunks],
                         dtype=torch.int64, device=dev)[delta.chunk_id]
    pos = start + delta.local_idx
    mine = torch.ones_like(pos, dtype=torch.bool)
    if shard_idx is not None and layout.has_ep:
        owner = torch.tensor([-1 if ch.owner is None else ch.owner
                              for ch in layout.chunks],
                             dtype=torch.int64, device=dev)[delta.chunk_id]
        mine = (owner < 0) | (owner == shard_idx)
    shapes = layout.leaf_local_shapes if local else layout.leaf_shapes
    leaves = [leaf for _, leaf in layout_lib.flatten(params)]
    with torch.no_grad():
        for i, (leaf, shape, perm) in enumerate(zip(leaves, shapes,
                                                    layout.leaf_perms)):
            sel = mine & (leaf_of == i)
            idx = torch.where(sel, pos, 0)
            if model_plan is not None:
                sel, idx, shape = _model_local_index(
                    sel, idx, shape, model_plan.view_dims[i], model_idx)
            if perm is not None:
                idx = _storage_index(idx, shape, perm, leaf.stride())
            vals = torch.where(sel, delta.values, 0.0).to(leaf.dtype)
            flat = leaf.view(-1)
            flat.index_add_(0, idx, vals, alpha=-scale)
    return params


def densify(delta: SparseDelta, layout: layout_lib.ParamLayout
            ) -> torch.Tensor:
    """The sparse delta as the full flat d-vector (tests only)."""
    flat = torch.zeros(layout.total, dtype=torch.float32,
                       device=delta.values.device)
    return flat.index_add_(0, global_ids(delta, layout), delta.values)
