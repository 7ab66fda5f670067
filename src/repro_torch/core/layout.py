"""Global element layout of a parameter tree.

Port of ``repro.core.layout`` without expert-parallel sharding (``ep=1``)
or view permutations.  FetchSGD treats the model as one flat d-vector:
hashes are a function of the *global element id*, and Top-k is taken over
all d estimates.  The flat space is a static list of chunks over each
leaf's 2-D view ``(n_rows, row_len)``.

Leaves are ordered as JAX flattens a nested dict — by sorted keys — and
each leaf keeps the reference's shape, so global ids (and with them every
hash) match the JAX package's.
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
    row_start: int
    n_rows: int
    row_len: int
    offset: int               # global element id of the first element

    @property
    def size(self) -> int:
        return self.n_rows * self.row_len


@dataclasses.dataclass(frozen=True)
class ChunkGroup:
    """Chunks of identical shape over one leaf."""

    leaf: int
    path: str
    n_rows: int
    row_len: int
    chunk_ids: tuple[int, ...]       # indices into layout.chunks


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    chunks: tuple[Chunk, ...]
    groups: tuple[ChunkGroup, ...]
    leaf_paths: tuple[str, ...]
    leaf_shapes: tuple[tuple[int, ...], ...]
    leaf_offsets: tuple[int, ...]    # global id of each leaf's first element
    total: int

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)


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


def build_layout(params, *,
                 chunk_elems: int = DEFAULT_CHUNK_ELEMS) -> ParamLayout:
    """The deterministic flat layout.  Only shapes are read."""
    chunks: list[Chunk] = []
    paths, shapes, offsets = [], [], []
    offset = 0
    for leaf_idx, (path, leaf) in enumerate(flatten(params)):
        shape = tuple(int(s) for s in leaf.shape)
        paths.append(path)
        shapes.append(shape)
        offsets.append(offset)
        n_rows, row_len = _leaf_2d(shape)
        if row_len > chunk_elems:
            raise ValueError(f"leaf {path} row_len {row_len} > chunk_elems")
        rows_per_chunk = max(1, chunk_elems // row_len)
        for r in range(0, n_rows, rows_per_chunk):
            nr = min(rows_per_chunk, n_rows - r)
            chunks.append(Chunk(leaf_idx, path, r, nr, row_len,
                                offset + r * row_len))
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
                       leaf_offsets=tuple(offsets), total=offset)


def leaf_views(params, layout: ParamLayout) -> list[torch.Tensor]:
    """Each leaf as its (n_rows, row_len) 2-D view (no copy)."""
    return [leaf.view(_leaf_2d(shape)) for (_, leaf), shape
            in zip(flatten(params), layout.leaf_shapes)]


def unview(views, layout: ParamLayout) -> dict:
    return unflatten(layout.leaf_paths,
                     [v.view(s) for v, s in zip(views, layout.leaf_shapes)])
