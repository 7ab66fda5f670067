"""Shared neural-net primitives over plain dicts of tensors.

Port of ``repro.models.layers``.  Weights keep the reference's ``(in, out)``
layout.  jnp promotes ``bfloat16 @ float32`` to float32, while torch's
matmul and einsum refuse mixed dtypes, so :func:`matmul` and
:func:`einsum` cast both operands to their promoted type first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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

def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    return matmul(x, p["w"])


# -- MLP -------------------------------------------------------------------------

def mlp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    up = matmul(x, p["w_up"])
    if act == "swiglu":
        h = F.silu(matmul(x, p["w_gate"])) * up
    elif act == "gelu":
        # the tanh form, which jax.nn.gelu computes by default
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(f"unknown act {act}")
    return matmul(h, p["w_down"])


# -- chunked cross-entropy -------------------------------------------------------

def xent_loss(unembed_p: dict, h: torch.Tensor, labels: torch.Tensor,
              chunk: int) -> torch.Tensor:
    """Mean next-token cross entropy, chunked over the sequence axis.

    ``h``: (B, S, d) final hidden states; ``labels``: (B, S) with ``< 0``
    masked out.  Only one chunk's (B, chunk, V) logits exist at a time in
    the forward pass.
    """
    S = h.shape[1]
    losses, counts = [], []
    for s0 in range(0, S, chunk):
        lc = labels[:, s0:s0 + chunk]
        logits = unembed(unembed_p, h[:, s0:s0 + chunk]).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc.clamp(min=0)[..., None])[..., 0]
        valid = (lc >= 0).to(torch.float32)
        losses.append(torch.sum((logz - gold) * valid))
        counts.append(torch.sum(valid))
    return torch.stack(losses).sum() / torch.stack(counts).sum().clamp(min=1.0)
