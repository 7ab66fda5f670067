"""Mixture-of-Experts FFN with capacity-based token dispatch.

Port of ``repro.models.moe`` on one device (``moe_apply_ep``, the
expert-parallel path, needs a mesh and is not ported).  Token-choice top-k
routing with a fixed capacity per expert, dispatch into ``(E, cap, d)``
buffers, the experts as three batched matmuls, and the Switch load-balance
auxiliary loss.

Every kept (expert, slot) receives exactly one token, so dispatch is a
copy of the kept rows, not a sum: the result does not depend on the order
of float atomics.  A dropped token is sent to one extra row past the last
slot, which the experts never read and the combine reads as zeros, so
neither direction needs a data-dependent shape (no host sync, in decode as
in training).

Shared experts (qwen2-moe) are a dense swiglu MLP of width
``n_shared * moe_d_ff`` over every token, added to the routed output.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import layers
from .config import ArchConfig


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots per expert: ``min(max(K, round(T * K / E * cf)), T)``, with
    Python's ``round`` as in the reference."""
    K, E = cfg.expert_top_k, cfg.n_experts
    cap = int(max(K, round(n_tokens * K / E * cfg.capacity_factor)))
    return min(cap, n_tokens)


def no_drop(cfg: ArchConfig) -> ArchConfig:
    """``cfg`` with ``capacity_factor = n_experts / expert_top_k`` (a
    config without experts unchanged): every expert then has a slot for
    every token, so a prefill drops none, as a decode of batch B <= cap
    never does.  A decode step equals a fresh prefill only then."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.expert_top_k)


def moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """x: (B, S, d) -> (out (B, S, d), aux loss, a float32 0-d tensor)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.expert_top_k
    T = B * S
    xt = x.reshape(T, d)

    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, K, dim=-1)                     # (T, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)

    # position in expert: the exclusive cumsum of the one-hot over the
    # token-major (T*K,) order, which decides which tokens drop
    cap = capacity(cfg, T)
    ef = eidx.reshape(-1)                                         # (T*K,)
    onehot = F.one_hot(ef, E)
    pos = torch.cumsum(onehot, dim=0) - onehot
    mypos = torch.gather(pos, 1, ef[:, None])[:, 0]
    slot = torch.where(mypos < cap, ef * cap + mypos, E * cap)   # E*cap: drop

    xe = torch.repeat_interleave(xt, K, dim=0)                    # (T*K, d)
    disp = x.new_zeros(E * cap + 1, d).index_copy(0, slot, xe)
    disp = disp[:-1].reshape(E, cap, d)

    h = layers.matmul(disp, p["w_gate"])                          # (E,cap,ff)
    u = layers.matmul(disp, p["w_up"])
    out_e = layers.matmul(F.silu(h) * u, p["w_down"])             # (E,cap,d)

    out = torch.cat([out_e.reshape(E * cap, d),
                     out_e.new_zeros(1, d)])[slot]                # (T*K, d)
    y = (out.reshape(T, K, d) * gate[..., None].to(x.dtype)).sum(dim=1)

    # load-balance aux (Switch): E * sum_e f_e * P_e
    frac = F.one_hot(eidx, E).to(torch.float32).mean(dim=(0, 1))
    aux = E * torch.sum(frac * probs.mean(dim=0)) * cfg.router_aux_coef

    if "shared" in p:
        y = y + layers.mlp(p["shared"], xt, "swiglu")
    return y.reshape(B, S, d), aux
