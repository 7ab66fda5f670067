"""Model-axis-local sketching.

Port of ``repro.core.model_local``.  Sketch linearity holds across any
partition of the flat space, the tensor-parallel one included: each model
shard sketches exactly the elements ``models.sharding.param_spec`` gives
it (a column slice, or a row slice, of each leaf's 2-D view), and the
(rows x cols) tables are summed over the model group:

    sum_m S(g | shard m)  ==  S(g)      (disjoint support, linear map)

Modes per leaf (from the sharding rules and the view permutation):
  * ``cols``       — model shards the view's row_len (most leaves);
  * ``rows``       — model shards the view rows (2-D embed-style leaves);
  * ``replicated`` — leaf not model-sharded: only shard 0 contributes.

A chunk whose ids are contiguous (``n_cols == row_stride``: the ``rows``
and ``replicated`` modes) goes through the encode kernel at its offset.
The ids of a ``cols`` chunk are row-strided (``hashing.ids_for_grid``);
they go through the plain ``count_sketch.sketch_sparse``, as the
reference sketches them with a plain scatter outside its Pallas kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops as kernel_ops

from . import count_sketch as cs
from . import hashing
from . import layout as layout_lib


@dataclasses.dataclass(frozen=True)
class MLChunk:
    """One chunk of a leaf's (data-local, model-local) 2-D view.

    Global id of element (r, c), r < n_rows, c < n_cols, on shards
    (s_d, s_m):

        offs_data[s_d] + s_m * model_stride + (id_row0 + r) * row_stride + c
    """

    leaf: int
    mode: str
    view_row0: int
    id_row0: int
    n_rows: int
    n_cols: int
    row_stride: int
    model_stride: int
    offs_data: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class ModelLocalPlan:
    chunks: tuple[MLChunk, ...]
    view_dims: tuple[tuple[int, int], ...]   # model-local (rows, cols)/leaf
    tp: int


def build_plan(layout: layout_lib.ParamLayout, modes: list, tp: int,
               chunk_elems: int = layout_lib.DEFAULT_CHUNK_ELEMS
               ) -> ModelLocalPlan:
    """The model-local sketch plan of the global layout.

    ``modes[leaf]``: 'cols' | 'rows' | None, in the layout's PERMUTED view
    orientation.  A mode whose dim does not divide ``tp`` falls back to
    ``replicated``.
    """
    n_leaves = len(layout.leaf_shapes)
    by_leaf: dict[int, list] = {i: [] for i in range(n_leaves)}
    for lc in layout.local_chunks:
        by_leaf[lc.leaf].append(lc)
    chunks: list[MLChunk] = []
    view_dims: list[tuple[int, int]] = []
    for leaf in range(n_leaves):
        n_rows, row_len = layout_lib._leaf_2d(layout.leaf_local_shapes[leaf])
        mode = modes[leaf]
        if mode == "cols" and row_len % tp == 0 and row_len >= tp:
            rl_loc = row_len // tp
            view_dims.append((n_rows, rl_loc))
            rows_per_chunk = max(1, chunk_elems // max(rl_loc, 1))
            for lc in by_leaf[leaf]:
                for r, nr in layout_lib._split_rows(lc.n_rows,
                                                    rows_per_chunk):
                    chunks.append(MLChunk(
                        leaf=leaf, mode="cols",
                        view_row0=lc.row_start + r, id_row0=r,
                        n_rows=nr, n_cols=rl_loc, row_stride=row_len,
                        model_stride=rl_loc, offs_data=lc.offsets))
        elif mode == "rows" and n_rows % tp == 0 and n_rows >= tp \
                and len(by_leaf[leaf][0].offsets) == 1:
            rows_loc = n_rows // tp
            view_dims.append((rows_loc, row_len))
            rows_per_chunk = max(1, chunk_elems // row_len)
            first = by_leaf[leaf][0]
            leaf_offset = first.offsets[0] - first.row_start * row_len
            for r, nr in layout_lib._split_rows(rows_loc, rows_per_chunk):
                chunks.append(MLChunk(
                    leaf=leaf, mode="rows", view_row0=r, id_row0=r,
                    n_rows=nr, n_cols=row_len, row_stride=row_len,
                    model_stride=rows_loc * row_len,
                    offs_data=(leaf_offset,)))
        else:
            view_dims.append((n_rows, row_len))
            rows_per_chunk = max(1, chunk_elems // max(row_len, 1))
            for lc in by_leaf[leaf]:
                for r, nr in layout_lib._split_rows(lc.n_rows,
                                                    rows_per_chunk):
                    chunks.append(MLChunk(
                        leaf=leaf, mode="replicated",
                        view_row0=lc.row_start + r, id_row0=r,
                        n_rows=nr, n_cols=row_len, row_stride=row_len,
                        model_stride=0, offs_data=lc.offsets))
    return ModelLocalPlan(chunks=tuple(chunks), view_dims=tuple(view_dims),
                          tp=tp)


def _local_views(grads: dict, layout: layout_lib.ParamLayout,
                 plan: ModelLocalPlan) -> list[torch.Tensor]:
    """Model-local 2-D views: apply the layout perm, then reshape."""
    out = []
    for (_, leaf), perm, dims in zip(layout_lib.flatten(grads),
                                     layout.leaf_perms, plan.view_dims):
        if perm is not None:
            leaf = leaf.permute(perm)
        out.append(leaf.reshape(dims))
    return out


def model_slice(grads: dict, layout: layout_lib.ParamLayout,
                plan: ModelLocalPlan, s_m: int) -> dict:
    """Model shard ``s_m``'s tree from a (data-local) tree: each leaf that
    the plan splits cut to the shard's part of its model dim (the dim a
    ``cols`` leaf's view permutation moves last, or a ``rows`` leaf's
    first), every other leaf whole — what ``param_spec`` places on the
    shard, and what :func:`sketch_grads` of shard ``s_m`` takes."""
    out = []
    for (_, leaf), perm, lshape, (vr, vc) in zip(
            layout_lib.flatten(grads), layout.leaf_perms,
            layout.leaf_local_shapes, plan.view_dims):
        n_rows, row_len = layout_lib._leaf_2d(lshape)
        if vc != row_len:                      # cols: the model dim
            dim = perm[-1] if perm is not None else leaf.dim() - 1
            leaf = leaf.narrow(dim, s_m * vc, vc)
        elif vr != n_rows:                     # rows: the leading dim
            leaf = leaf.narrow(0, s_m * vr, vr)
        out.append(leaf)
    return layout_lib.unflatten(layout.leaf_paths, out)


def split_of(layout: layout_lib.ParamLayout, plan: ModelLocalPlan,
             leaf: int) -> str | None:
    """How the plan splits a leaf's (data-local) 2-D view over the model
    group: ``cols``, ``rows`` or None (whole on every shard)."""
    n_rows, row_len = layout_lib._leaf_2d(layout.leaf_local_shapes[leaf])
    vr, vc = plan.view_dims[leaf]
    return "cols" if vc != row_len else "rows" if vr != n_rows else None


def gathered_values(grads, layout: layout_lib.ParamLayout,
                    plan: ModelLocalPlan, s_m: int, all_gather, all_sum):
    """``values(lc)``: the flat values of the layout's local chunk ``lc``
    of the whole (model-gathered) gradient, from the shard's model-local
    tree ``grads``, one chunk at a time.  A ``cols`` leaf's rows are
    gathered over the model group (``all_gather(t)`` -> the shards' ``t``
    in order); the rows of a ``rows`` leaf that a chunk spans lie on
    several shards, so each shard places its own in a zero buffer and
    the group sums it (``all_sum(t)``, in place).  What
    ``fetchsgd.sketch_grads(values=)`` encodes, chunk by chunk, as the
    reference's GSPMD gathers each chunk."""
    views = _local_views(grads, layout, plan)

    def values(lc) -> torch.Tensor:
        v = views[lc.leaf]
        rows = slice(lc.row_start, lc.row_start + lc.n_rows)
        split = split_of(layout, plan, lc.leaf)
        if split == "cols":
            return torch.cat(all_gather(v[rows].contiguous()),
                             dim=1).reshape(-1)
        if split is None:
            return v[rows].reshape(-1)
        vr = plan.view_dims[lc.leaf][0]
        buf = v.new_zeros(lc.n_rows, v.shape[1])
        lo = max(lc.row_start, s_m * vr)
        hi = min(lc.row_start + lc.n_rows, (s_m + 1) * vr)
        if hi > lo:
            buf[lo - lc.row_start:hi - lc.row_start] = \
                v[lo - s_m * vr:hi - s_m * vr]
        return all_sum(buf).reshape(-1)

    return values


def sketch_grads(grads, layout: layout_lib.ParamLayout,
                 plan: ModelLocalPlan, fs_cfg, s_d: int | None,
                 s_m: int) -> torch.Tensor:
    """Partial sketch of this (data, model) shard's gradient slice.

    ``grads``: the shard's model-local tree (each leaf the slice that
    ``param_spec`` places on model shard ``s_m``: the tensor-parallel
    step's own gradient, or :func:`model_slice` of a whole one).  Sum the
    result over the model group and average it over the client axes to
    obtain the aggregated S(g^t).
    """
    views = _local_views(grads, layout, plan)
    table = torch.zeros(fs_cfg.rows, fs_cfg.cols, dtype=torch.float32,
                        device=views[0].device)
    groups: dict = {}
    for ch in plan.chunks:
        key = (ch.leaf, ch.mode, ch.n_rows, ch.n_cols, ch.row_stride,
               ch.model_stride, len(ch.offs_data))
        groups.setdefault(key, []).append(ch)
    for (_, mode, n_rows, n_cols, row_stride, model_stride,
         n_offs), chs in sorted(groups.items()):
        if mode == "replicated" and s_m != 0:
            continue
        for ch in chs:
            vals = views[ch.leaf][ch.view_row0:ch.view_row0 + n_rows]
            vals = vals.reshape(-1)
            si = (s_d or 0) if n_offs > 1 else 0
            base = (ch.offs_data[si] + s_m * model_stride) % (1 << 64)
            if n_cols == row_stride:       # contiguous ids: the kernel
                kernel_ops.sketch_encode(vals, base + ch.id_row0 * row_stride,
                                         fs_cfg.rows, fs_cfg.cols,
                                         fs_cfg.hash_key, out=table)
                continue
            hi, lo = hashing.ids_for_grid(base & hashing.MASK, base >> 32,
                                          ch.id_row0, n_rows, row_stride, 0,
                                          n_cols, device=vals.device)
            table += cs.sketch_sparse(hashing.join_words(hi, lo), vals,
                                      fs_cfg.rows, fs_cfg.cols,
                                      fs_cfg.hash_key)
    return table
