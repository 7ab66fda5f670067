"""Shared neural-net primitives over plain dicts of tensors.

Port of ``repro.models.layers``.  Weights keep the reference's ``(in, out)``
layout.  jnp promotes ``bfloat16 @ float32`` to float32, while torch's
matmul and einsum refuse mixed dtypes, so :func:`matmul` and
:func:`einsum` cast both operands to their promoted type first.

Under ``tp.model_parallel`` (the mesh step) the embedding, the
cross entropy and the MLP run on the rank's shard when ``param_spec``
splits their leaves over ``model``: the embedding and the unembedding
over vocab (a masked lookup, and a cross entropy whose max, sum of
exponentials and gold logit are reduced over the group), the MLP
column-parallel into ``w_gate`` / ``w_up`` and row-parallel out of
``w_down``.  A leaf is split when it holds less than the full width the
caller names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from . import tp


def _promoted(*xs: torch.Tensor) -> list[torch.Tensor]:
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _promoted(a, b)
    return a @ b


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _promoted(a, b)
    return torch.einsum(eq, a, b)


# -- norms ---------------------------------------------------------------------

def rmsnorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm computed in float32, returned in ``x``'s dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["scale"].to(torch.float32)).to(dt)


# -- embedding / unembedding ----------------------------------------------------

def embed(p: dict, tokens: torch.Tensor, vocab: int | None = None
          ) -> torch.Tensor:
    """The rows of ``tokens``; a table holding fewer than ``vocab`` rows
    is the rank's shard of a vocab-parallel one: the rank looks up the
    tokens it holds, zeros elsewhere, and the group sums."""
    table = p["table"]
    n = table.shape[0]
    if vocab is None or n == vocab:
        return table[tokens]
    local = tokens - tp.rank() * n
    ok = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return tp.reduce_from(torch.where(ok[..., None], rows, 0.0))


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The logits; the rank's vocab columns when ``p["w"]`` is its shard
    (the serve path gathers them over the model group)."""
    return matmul(x, p["w"])


# -- MLP -------------------------------------------------------------------------

def mlp(p: dict, x: torch.Tensor, act: str,
        d_ff: int | None = None) -> torch.Tensor:
    """The FFN; ``w_down`` holding fewer than ``d_ff`` rows is the rank's
    slice of a column- then row-parallel MLP."""
    par = d_ff is not None and p["w_down"].shape[-2] != d_ff
    if par:
        x = tp.copy_to(x)
    up = matmul(x, p["w_up"])
    if act == "swiglu":
        h = F.silu(matmul(x, p["w_gate"])) * up
    elif act == "gelu":
        # the tanh form, which jax.nn.gelu computes by default
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(f"unknown act {act}")
    out = matmul(h, p["w_down"])
    return tp.reduce_from(out) if par else out


# -- chunked cross-entropy -------------------------------------------------------

def _xent_chunk(unembed_p: dict, hc: torch.Tensor, lc: torch.Tensor,
                vocab: int | None):
    """(sum of the chunk's token losses, its count of valid labels)."""
    w = unembed_p["w"]
    if vocab is None or w.shape[-1] == vocab:
        logits = unembed(unembed_p, hc).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc.clamp(min=0)[..., None])[..., 0]
    else:               # the rank's columns of a vocab-parallel unembed
        hc, w = _promoted(hc, w)
        logits = (tp.copy_to(hc) @ w).to(torch.float32)
        n = w.shape[-1]
        gmax = tp.all_max(logits.detach().amax(dim=-1))
        sumexp = torch.exp(logits - gmax[..., None]).sum(dim=-1)
        logz = gmax + torch.log(tp.reduce_from(sumexp))
        local = lc - tp.rank() * n
        ok = (local >= 0) & (local < n)
        g = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        gold = tp.reduce_from(torch.where(ok, g, 0.0))
    valid = (lc >= 0).to(torch.float32)
    return torch.sum((logz - gold) * valid), torch.sum(valid)


def xent_loss(unembed_p: dict, h: torch.Tensor, labels: torch.Tensor,
              chunk: int, remat: bool = False,
              vocab: int | None = None) -> torch.Tensor:
    """Mean next-token cross entropy, chunked over the sequence axis.

    ``h``: (B, S, d) final hidden states; ``labels``: (B, S) with ``< 0``
    masked out.  Only one chunk's (B, chunk, V) logits exist at a time in
    the forward pass; with ``remat`` each chunk is checkpointed, so the
    backward recomputes its logits instead of keeping every chunk's.  An
    unembedding with fewer than ``vocab`` columns is the rank's shard of
    a vocab-parallel one.
    """
    S = h.shape[1]
    losses, counts = [], []
    for s0 in range(0, S, chunk):
        args = (unembed_p, h[:, s0:s0 + chunk], labels[:, s0:s0 + chunk],
                vocab)
        if remat and torch.is_grad_enabled():
            loss, count = checkpoint.checkpoint(_xent_chunk, *args,
                                                use_reentrant=False)
        else:
            loss, count = _xent_chunk(*args)
        losses.append(loss)
        counts.append(count)
    return torch.stack(losses).sum() / torch.stack(counts).sum().clamp(min=1.0)
