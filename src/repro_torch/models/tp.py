"""Tensor parallelism over the mesh's ``model`` axis: the model group and
its autograd collectives.

The reference lets GSPMD partition its forward and backward over
``model`` to match ``sharding.param_spec``.  The port writes the
partition out, Megatron-style.  Inside :func:`model_parallel` (set by the
mesh step, ``launch.steps``) every rank of a model group holds the same
tokens and the residual stream whole, and each parallel region runs on
the rank's shard of its weights:

* :func:`copy_to` enters a region: the identity forward, and in the
  backward the sum over the group of the rank's partial gradient (also
  for a replicated leaf that each rank uses on its part of the work);
* :func:`reduce_from` leaves it: the sum of the ranks' partial results
  forward, the identity backward;
* :func:`gather` rebuilds a tensor held as the rank's shard where it is
  used whole (K/V weights sharded over head_dim, the mLSTM's input to
  its column-parallel projections), and its backward slices the rank's
  part of a gradient every rank holds whole;
* :func:`split` / :func:`gather` keep a checkpointed unit's saved input
  as the rank's slice of ``d`` (the counterpart of the reference's
  ``constrain_activations``): the slice forward and a gather backward,
  and the gather at use with a slicing backward;
* :func:`regroup` moves a tensor split over one dim to a split over
  another (an ``all_to_all``: K/V over head_dim against the query heads
  in decode), and :func:`channels` gives a rank both halves of its
  channels from a ``2 * width`` column split that stores them apart
  (mamba's ``in_proj``, the mLSTM's ``up``); the backward of each is the
  reverse exchange.

With no group every operation is the identity and adds no node to the
graph, so single-device code runs as before.  The collectives go through
:func:`_all_reduce`, :func:`_all_gather` and :func:`_all_to_all`, which
``launch.analysis.CollectiveRecorder`` records as collectives over
``("model",)``.  The serve path's logits, split over vocab, are joined
with :func:`gather`.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_GROUP: list = [None]


@contextlib.contextmanager
def model_parallel(group):
    """Run the model's forward and backward tensor-parallel over ``group``
    (a ``torch.distributed`` process group; None: the whole model on
    this rank)."""
    _GROUP.append(group)
    try:
        yield
    finally:
        _GROUP.pop()


def group():
    """The active model group, or None."""
    return _GROUP[-1]


def size() -> int:
    g = group()
    return 1 if g is None else dist.get_world_size(g)


def rank() -> int:
    g = group()
    return 0 if g is None else dist.get_rank(g)


def splits(n: int) -> bool:
    """Whether a dim of ``n`` is split over the active group: the group
    has more than one rank and divides ``n``, the rule of
    ``sharding.param_spec``."""
    m = size()
    return m > 1 and n % m == 0


# -- collectives (recorded by launch.analysis.CollectiveRecorder) ----------------

def _all_reduce(t: torch.Tensor, grp, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` over ``grp`` in place; returns ``t``."""
    dist.all_reduce(t, op=op, group=grp)
    return t


def _all_gather(t: torch.Tensor, grp, dim: int) -> torch.Tensor:
    """The ranks' ``t`` joined along ``dim``, in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(grp))]
    dist.all_gather(parts, t, group=grp)
    return torch.cat(parts, dim)


def _all_to_all(t: torch.Tensor, grp, send: list[int],
                recv: list[int]) -> torch.Tensor:
    """Rows of ``t`` (dim 0, grouped by destination: ``send[j]`` rows to
    rank ``j``) exchanged over ``grp``; the result's rows are grouped by
    source, ``recv[i]`` from rank ``i``."""
    t = t.contiguous()
    out = t.new_empty((sum(recv),) + tuple(t.shape[1:]))
    dist.all_to_all_single(out, t, output_split_sizes=recv,
                           input_split_sizes=send, group=grp)
    return out


def _slice(t: torch.Tensor, grp, dim: int) -> torch.Tensor:
    n = t.shape[dim] // dist.get_world_size(grp)
    return t.narrow(dim, dist.get_rank(grp) * n, n).contiguous()


# -- autograd functions -------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.grp), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        return _all_reduce(x.contiguous().clone(), grp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return _all_gather(x, grp, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.grp, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        # a copy, so that the whole x is freed
        return _slice(x, grp, dim).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.grp, ctx.dim), None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, send, recv):
        ctx.grp, ctx.send, ctx.recv = grp, send, recv
        return _all_to_all(x, grp, send, recv)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.grp, ctx.recv, ctx.send), None, None, None


def copy_to(x: torch.Tensor) -> torch.Tensor:
    """Enter a parallel region: identity forward, the gradient summed over
    the group backward."""
    return x if size() == 1 else _CopyTo.apply(x, group())


def reduce_from(x: torch.Tensor) -> torch.Tensor:
    """Leave a parallel region: the partial results summed over the group
    forward, identity backward."""
    return x if size() == 1 else _ReduceFrom.apply(x, group())


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' shards of ``x`` joined along ``dim``; the backward takes
    the rank's slice of a gradient that every rank holds whole."""
    return x if size() == 1 else _Gather.apply(x, group(), dim % x.dim())


def split(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The rank's slice of ``x`` along ``dim`` (a copy); the backward
    gathers the ranks' slices of the gradient."""
    return x if size() == 1 else _Split.apply(x, group(), dim % x.dim())


def regroup(x: torch.Tensor, split_dim: int, cat_dim: int) -> torch.Tensor:
    """``x``'s ``split_dim`` cut into ``size()`` equal pieces, piece ``j``
    sent to rank ``j``; the pieces a rank receives are joined along
    ``cat_dim`` in rank order.  A tensor split over ``cat_dim`` becomes
    one split over ``split_dim`` (an ``all_to_all``)."""
    m = size()
    if m == 1:
        return x
    split_dim, cat_dim = split_dim % x.dim(), cat_dim % x.dim()
    n = x.shape[split_dim] // m
    parts = x.unflatten(split_dim, (m, n)).movedim(split_dim, 0)
    got = _Exchange.apply(parts, group(), [1] * m, [1] * m)
    # got: (m, ...) with dim ``split_dim + 1`` of length n; source first
    got = got.movedim(0, cat_dim)
    return got.flatten(cat_dim, cat_dim + 1)


def channels(xz: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A rank's two halves of its channels from the ``(..., 2 * w / m)``
    output of a column-parallel projection whose ``2 * w`` columns
    ``param_spec`` split as one dim (``[x | z]``: the rank stores blocks
    ``2r`` and ``2r + 1`` of the ``2m`` blocks of ``w / m`` columns, so at
    ``m = 2`` rank 0 holds all of ``x`` and rank 1 all of ``z``).  Block
    ``b`` belongs to rank ``b % m``; the exchange leaves rank ``r`` with
    ``x``'s block ``r`` and ``z``'s block ``r``: ``(x_r, z_r)``, each
    ``(..., w / m)``.  Without a group: the two halves of ``xz``."""
    m = size()
    n = xz.shape[-1] // 2
    if m == 1:
        return xz[..., :n], xz[..., n:]
    r = rank()
    blocks = xz.unflatten(-1, (2, n)).movedim(-2, 0)          # (2, ..., n)
    send = [int(j in ((2 * r) % m, (2 * r + 1) % m)) for j in range(m)]
    recv = [int(i in (r // 2, (m + r) // 2)) for i in range(m)]
    got = _Exchange.apply(blocks, group(), send, recv)        # (2, ..., n)
    return got[0], got[1]


def shard_of(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The rank's slice of ``x`` along ``dim`` (a view, no gradient
    rule: the serve path's cache writes)."""
    m = size()
    if m == 1:
        return x
    n = x.shape[dim] // m
    return x.narrow(dim, rank() * n, n)


def all_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the group (no gradient)."""
    if size() == 1:
        return x
    return _all_reduce(x.detach().contiguous().clone(), group(),
                       dist.ReduceOp.MAX)


def whole(x: torch.Tensor, dim: int, full: int) -> torch.Tensor:
    """A leaf used whole: gathered along ``dim`` when the group splits a
    dim of ``full`` (``x`` then holds ``full / size`` of it), else ``x``."""
    if not splits(full) or x.shape[dim] == full:
        return x
    return gather(x, dim)
