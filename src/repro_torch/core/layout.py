"""Global element layout of a parameter tree.

Port of ``repro.core.layout``.  FetchSGD treats the model as one flat
d-vector: hashes are a function of the *global element id*, and Top-k is
taken over all d estimates.  The flat space is a static list of chunks
over each leaf's 2-D view ``(n_rows, row_len)``.

Leaves are ordered as JAX flattens a nested dict — by sorted keys — and
each leaf keeps the reference's shape, so global ids (and with them every
hash) match the JAX package's.

On a mesh (``launch.steps``) two things change the ids, exactly as in the
reference:

* a **view permutation** (``view_perms``, from
  ``models.sharding.layout_view_plan``) reorders a leaf's dims before its
  2-D view, and the flat ids are defined over the permuted order.  A
  permuted leaf has no no-copy view: ``leaf_views`` then returns a
  ``permute().reshape()`` copy, and ``topk.apply_delta`` writes through the
  inverse permutation instead of through a view;
* **expert-parallel leaves** (``data_shard_axis``, ``ep`` > 1) hold only
  their data shard's slice on each rank.  Their chunks are owner-aligned:
  each lies within one shard's slice and carries its ``owner`` and its row
  in the shard-local view; ``local_chunks`` are the chunks a rank sketches
  from its local gradient, each with one global offset per data shard.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# Max elements per chunk: bounds the per-chunk temporaries (hash words,
# estimates) of the chunked sketch / unsketch.
DEFAULT_CHUNK_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class Chunk:
    """A contiguous row-range of one leaf's (n_rows, row_len) 2-D view."""

    leaf: int
    path: str
    row_start: int            # in the GLOBAL 2-D view
    n_rows: int
    row_len: int
    offset: int               # global element id of the first element
    owner: int | None = None  # data shard owning this chunk (EP leaves)
    local_row_start: int = -1 # row in the shard-LOCAL 2-D view (-1: =row_start)

    @property
    def size(self) -> int:
        return self.n_rows * self.row_len

    @property
    def lrs(self) -> int:
        return self.row_start if self.local_row_start < 0 \
            else self.local_row_start


@dataclasses.dataclass(frozen=True)
class ChunkGroup:
    """Chunks of identical shape over one leaf."""

    leaf: int
    path: str
    n_rows: int
    row_len: int
    chunk_ids: tuple[int, ...]       # indices into layout.chunks


@dataclasses.dataclass(frozen=True)
class LocalChunk:
    """Client-side sketch chunk over the shard-LOCAL 2-D view.

    ``offsets``: global element offset per data-shard index (len 1 when the
    leaf is replicated over data — every shard sketches the same global
    range).
    """

    leaf: int
    row_start: int            # local view rows
    n_rows: int
    row_len: int
    offsets: tuple[int, ...]

    @property
    def size(self) -> int:
        return self.n_rows * self.row_len


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    chunks: tuple[Chunk, ...]
    groups: tuple[ChunkGroup, ...]
    leaf_paths: tuple[str, ...]
    leaf_shapes: tuple[tuple[int, ...], ...]        # PERMUTED shapes
    leaf_offsets: tuple[int, ...]    # global id of each leaf's first element
    total: int
    local_chunks: tuple[LocalChunk, ...] = ()
    leaf_local_shapes: tuple[tuple[int, ...], ...] = ()  # PERMUTED, local
    leaf_perms: tuple[tuple[int, ...] | None, ...] = ()  # view permutation
    ep: int = 1               # data-shard count used for EP leaves (1 = none)

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    @property
    def has_ep(self) -> bool:
        return any(ch.owner is not None for ch in self.chunks)


def flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(path, leaf) pairs of a nested dict in JAX's order (sorted keys)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(paths, leaves) -> dict:
    """Inverse of :func:`flatten`."""
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure (the
    counterpart of ``jax.tree.map`` for parameter trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _leaf_2d(shape: tuple[int, ...]) -> tuple[int, int]:
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return int(shape[0]), 1   # 1-D leaves chunk by element (rows)
    return math.prod(shape[:-1]), shape[-1]


def _split_rows(n_rows: int, rows_per_chunk: int):
    """Yield (start, n) covering n_rows in uniform pieces + remainder."""
    for r in range(0, n_rows, rows_per_chunk):
        yield r, min(rows_per_chunk, n_rows - r)


def build_layout(params, *, chunk_elems: int = DEFAULT_CHUNK_ELEMS,
                 data_shard_axis: dict[str, int] | None = None,
                 view_perms: dict[str, tuple[int, ...]] | None = None,
                 ep: int = 1) -> ParamLayout:
    """The deterministic flat layout.  Only shapes are read (``meta``
    tensors work).

    ``data_shard_axis``: leaf path -> tensor axis sharded over the data
    mesh axis (EP leaves); ``ep`` = data axis size.  ``view_perms``: leaf
    path -> dim permutation applied before the 2-D view; the flat id space
    is defined over the PERMUTED order.
    """
    data_shard_axis = data_shard_axis or {}
    view_perms = view_perms or {}
    chunks: list[Chunk] = []
    local_chunks: list[LocalChunk] = []
    paths, shapes, local_shapes, perms, offsets = [], [], [], [], []
    offset = 0
    for leaf_idx, (path, leaf) in enumerate(flatten(params)):
        shape = tuple(int(s) for s in leaf.shape)
        perm = view_perms.get(path)
        if perm is not None:
            perm = tuple(perm)
            shape = tuple(shape[i] for i in perm)
        paths.append(path)
        perms.append(perm)
        shapes.append(shape)
        offsets.append(offset)
        n_rows, row_len = _leaf_2d(shape)
        if row_len > chunk_elems:
            raise ValueError(f"leaf {path} row_len {row_len} > chunk_elems")
        rows_per_chunk = max(1, chunk_elems // row_len)
        ax = data_shard_axis.get(path)
        if ax is not None and perm is not None:
            ax = perm.index(ax)
        if ax is None or ep == 1:
            local_shapes.append(shape)
            for r, nr in _split_rows(n_rows, rows_per_chunk):
                chunks.append(Chunk(leaf_idx, path, r, nr, row_len,
                                    offset + r * row_len))
                local_chunks.append(LocalChunk(
                    leaf_idx, r, nr, row_len, (offset + r * row_len,)))
        else:
            # EP leaf: axis ``ax`` sharded ep ways; owner-aligned chunks
            if shape[ax] % ep != 0 or ax >= len(shape) - 1:
                raise ValueError(f"cannot EP-shard {path} axis {ax} of "
                                 f"{shape}")
            shard_sz = shape[ax] // ep
            local_shapes.append(shape[:ax] + (shard_sz,) + shape[ax + 1:])
            outer = math.prod(shape[:ax])
            inner_rows = math.prod(shape[ax + 1:-1])
            block = shard_sz * inner_rows          # rows per (outer, shard)
            for o in range(outer):
                for r, nr in _split_rows(block, rows_per_chunk):
                    # one local chunk; ep global chunks (one per owner)
                    offs = []
                    for s in range(ep):
                        grow = (o * shape[ax] + s * shard_sz) * inner_rows + r
                        offs.append(offset + grow * row_len)
                        chunks.append(Chunk(
                            leaf_idx, path, grow, nr, row_len,
                            offset + grow * row_len, owner=s,
                            local_row_start=o * block + r))
                    local_chunks.append(LocalChunk(
                        leaf_idx, o * block + r, nr, row_len, tuple(offs)))
        offset += n_rows * row_len
    groups: dict[tuple[int, int], list[int]] = {}
    for ci, ch in enumerate(chunks):
        groups.setdefault((ch.leaf, ch.n_rows), []).append(ci)
    group_list = tuple(
        ChunkGroup(leaf=chunks[ids[0]].leaf, path=chunks[ids[0]].path,
                   n_rows=nr, row_len=chunks[ids[0]].row_len,
                   chunk_ids=tuple(ids))
        for (_, nr), ids in sorted(groups.items()))
    return ParamLayout(chunks=tuple(chunks), groups=group_list,
                       leaf_paths=tuple(paths), leaf_shapes=tuple(shapes),
                       leaf_offsets=tuple(offsets), total=offset,
                       local_chunks=tuple(local_chunks),
                       leaf_local_shapes=tuple(local_shapes),
                       leaf_perms=tuple(perms), ep=ep)


def leaf_views(params, layout: ParamLayout,
               local: bool = False) -> list[torch.Tensor]:
    """Each leaf as its (permuted) (n_rows, row_len) 2-D view: no copy
    for an unpermuted leaf, a ``permute().reshape()`` copy for a permuted
    one (write back with :func:`unview`).  ``local``: the shard-local
    shapes of EP leaves."""
    shapes = layout.leaf_local_shapes if local else layout.leaf_shapes
    out = []
    for (_, leaf), shape, perm in zip(flatten(params), shapes,
                                      layout.leaf_perms):
        if perm is not None:
            leaf = leaf.permute(perm)
        out.append(leaf.reshape(_leaf_2d(shape)))
    return out


def unview(views, layout: ParamLayout, local: bool = False) -> dict:
    """The tree of leaves in their stored shapes, from 2-D views."""
    shapes = layout.leaf_local_shapes if local else layout.leaf_shapes
    leaves = []
    for v, s, perm in zip(views, shapes, layout.leaf_perms):
        leaf = v.reshape(s)
        if perm is not None:
            leaf = leaf.permute(inverse_perm(perm))
        leaves.append(leaf)
    return unflatten(layout.leaf_paths, leaves)


def inverse_perm(perm) -> tuple[int, ...]:
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


def chunk_values(views, chunk) -> torch.Tensor:
    """Flat values of a chunk (a :class:`Chunk` at its local row, or a
    :class:`LocalChunk`) from the 2-D leaf views."""
    start = chunk.lrs if isinstance(chunk, Chunk) else chunk.row_start
    return views[chunk.leaf][start:start + chunk.n_rows].reshape(-1)


def describe(layout: ParamLayout) -> str:
    lines = [f"total elements: {layout.total:,} in {layout.num_chunks} chunks"
             f" / {len(layout.groups)} groups (ep={layout.ep})"]
    for g in layout.groups:
        lines.append(f"  {g.path}: {len(g.chunk_ids)} x "
                     f"({g.n_rows} x {g.row_len})")
    return "\n".join(lines)
