"""Mixture-of-Experts FFN with capacity-based token dispatch.

Port of ``repro.models.moe``.  Token-choice top-k routing with a fixed
capacity per expert, dispatch into ``(E, cap, d)`` buffers, the experts as
three batched matmuls, and the Switch load-balance auxiliary loss.

Expert parallelism (``moe_apply_ep``): inside ``expert_parallel(group)``
and with ``cfg.shard_experts_data``, each rank of the data axis's process
group holds ``E / ep`` experts and its own tokens; the dispatch buffers
travel to the experts' owners and back by ``all_to_all``, through an
autograd function whose backward is the reverse exchange.

Every kept (expert, slot) receives exactly one token, so dispatch is a
copy of the kept rows, not a sum: the result does not depend on the order
of float atomics.  A dropped token is sent to one extra row past the last
slot, which the experts never read and the combine reads as zeros, so
neither direction needs a data-dependent shape (no host sync, in decode as
in training).

Shared experts (qwen2-moe) are a dense swiglu MLP of width
``n_shared * moe_d_ff`` over every token, added to the routed output.

The sigmoid router (``cfg.router_score == "sigmoid"``, DeepSeek-V3's
``noaux_tc`` with one group) has its own layer, ``moe_apply_held``:
dropless, and holding only the routed experts ``0 .. cfg.held - 1`` of
the ``n_experts`` it routes over, one chip's share of an expert-parallel
layer without the exchange.

Under ``tp.model_parallel`` the experts' FFN width is split over the
model group when ``param_spec`` splits it: every rank routes the same
tokens with the replicated router, its experts compute their slice of
the width, and the experts' outputs are summed over the group before the
combine (so the gates' gradients are whole); the tokens enter the
experts through ``tp.copy_to``.  With expert parallelism the exchange
runs over the data ranks of the same model index.  The shared experts
follow the dense MLP's rule.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import obs

from . import layers, tp
from .config import ArchConfig


# Standard deviation of the selection bias's draw (``init_params``): a
# tenth of the scores' spread at initialisation, enough that selection by
# score + bias and by score alone differ on a visible share of tokens.
BIAS_INIT = 0.02


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


# Expert-parallel context: the data axis's process group, set by the mesh
# step (``launch.steps``) around its forward passes.
_EP_GROUP: list = [None]


@contextlib.contextmanager
def expert_parallel(group):
    """Route MoE layers through :func:`moe_apply_ep` over ``group`` (a
    ``torch.distributed`` process group; None: the local path)."""
    _EP_GROUP.append(group)
    try:
        yield
    finally:
        _EP_GROUP.pop()


def ep_axis():
    """The active expert-parallel process group, or None."""
    return _EP_GROUP[-1]


def moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """Dispatch to the expert-parallel path when its context is active."""
    if ep_axis() is not None and cfg.shard_experts_data:
        return moe_apply_ep(p, x, cfg, ep_axis())
    return moe_apply_local(p, x, cfg)


def _route(p: dict, xt: torch.Tensor, cfg: ArchConfig):
    """Router: (probs (T, E), gate (T, K), eidx (T, K), slot (T*K,)) with
    ``slot = e * cap + position``, or ``E * cap`` for a dropped token."""
    E, K = cfg.n_experts, cfg.expert_top_k
    T = xt.shape[0]
    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, K, dim=-1)                     # (T, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = capacity(cfg, T)
    ef = eidx.reshape(-1)                                         # (T*K,)
    onehot = F.one_hot(ef, E)
    pos = torch.cumsum(onehot, dim=0) - onehot
    mypos = torch.gather(pos, 1, ef[:, None])[:, 0]
    slot = torch.where(mypos < cap, ef * cap + mypos, E * cap)
    return probs, gate, eidx, slot


def _combine(out_e: torch.Tensor, slot, gate, probs, eidx, p: dict,
             xt: torch.Tensor, x: torch.Tensor, cfg: ArchConfig):
    """Gather each slot's expert output, weight it by its gate, add the
    shared experts; the Switch aux loss."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.expert_top_k
    T = B * S
    out = torch.cat([out_e.reshape(-1, d), out_e.new_zeros(1, d)])[slot]
    y = (out.reshape(T, K, d) * gate[..., None].to(x.dtype)).sum(dim=1)
    frac = F.one_hot(eidx, E).to(torch.float32).mean(dim=(0, 1))
    aux = E * torch.sum(frac * probs.mean(dim=0)) * cfg.router_aux_coef
    if "shared" in p:
        y = y + layers.mlp(p["shared"], xt, "swiglu",
                           d_ff=cfg.n_shared_experts * _ffe(cfg))
    return y.reshape(B, S, d), aux


def _ffe(cfg: ArchConfig) -> int:
    return cfg.moe_d_ff or cfg.d_ff


def _tp_in(p: dict, xt: torch.Tensor, cfg: ArchConfig):
    """(the tokens the experts read, whether their width is split over
    the model group)."""
    par = p["w_down"].shape[-2] != _ffe(cfg)
    return (tp.copy_to(xt) if par else xt), par


def _experts(p: dict, ein: torch.Tensor) -> torch.Tensor:
    h = layers.matmul(ein, p["w_gate"])
    u = layers.matmul(ein, p["w_up"])
    return layers.matmul(F.silu(h) * u, p["w_down"])


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 (the peer index) with a gradient:
    the exchange is its own reverse, so the backward is the same
    exchange of the output's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    # all_to_all_single moves bytes: both sides must be row-major (a
    # gradient can arrive with permuted strides, which empty_like keeps)
    x = x.contiguous()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x, group=group)
    return out


def moe_apply_ep(p: dict, x: torch.Tensor, cfg: ArchConfig, group):
    """Expert-parallel MoE over the ranks of ``group``.

    ``x`` is this rank's tokens; ``p``'s expert stacks hold only the
    ``E_loc = E / ep`` experts this rank owns (the router and the shared
    experts whole).  Tokens route to *global* expert ids with the capacity
    of THIS rank's tokens; the (ep, E_loc, cap, d) dispatch buffer goes to
    the experts' owners by ``all_to_all`` (dim 0 is the destination, then
    the source), the local experts run, and a reverse ``all_to_all``
    brings the outputs home.
    """
    B, S, d = x.shape
    ep = dist.get_world_size(group)
    E_loc = p["w_gate"].shape[0]
    if E_loc * ep != cfg.n_experts:
        raise ValueError(f"{E_loc} local experts x {ep} shards != "
                         f"{cfg.n_experts}")
    T = B * S
    cap = capacity(cfg, T)
    xt = x.reshape(T, d)
    probs, gate, eidx, slot = _route(p, xt, cfg)
    xd, par = _tp_in(p, xt, cfg)
    # global slot e * cap + pos == (owner, local expert, pos) row-major
    xe = torch.repeat_interleave(xd, cfg.expert_top_k, dim=0)
    disp = x.new_zeros(cfg.n_experts * cap + 1, d).index_copy(0, slot, xe)
    disp = disp[:-1].reshape(ep, E_loc, cap, d)
    recv = _AllToAll.apply(disp, group)                   # dim 0: source
    ein = recv.movedim(0, 1).reshape(E_loc, ep * cap, d)
    out_e = _experts(p, ein)                               # (E_loc, ep*cap, d)
    back = out_e.reshape(E_loc, ep, cap, d).movedim(1, 0).contiguous()
    got = _AllToAll.apply(back, group)                     # (ep, E_loc, cap, d)
    if par:
        got = tp.reduce_from(got)
    return _combine(got, slot, gate, probs, eidx, p, xt, x, cfg)


def moe_apply_local(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """x: (B, S, d) -> (out (B, S, d), aux loss, a float32 0-d tensor)."""
    B, S, d = x.shape
    E = cfg.n_experts
    T = B * S
    cap = capacity(cfg, T)
    xt = x.reshape(T, d)
    probs, gate, eidx, slot = _route(p, xt, cfg)
    xd, par = _tp_in(p, xt, cfg)
    # position in expert: the exclusive cumsum of the one-hot over the
    # token-major (T*K,) order, which decides which tokens drop
    xe = torch.repeat_interleave(xd, cfg.expert_top_k, dim=0)     # (T*K, d)
    disp = x.new_zeros(E * cap + 1, d).index_copy(0, slot, xe)
    out_e = _experts(p, disp[:-1].reshape(E, cap, d))            # (E,cap,d)
    if par:
        out_e = tp.reduce_from(out_e)
    return _combine(out_e, slot, gate, probs, eidx, p, xt, x, cfg)


def route_sigmoid(p: dict, xt: torch.Tensor, cfg: ArchConfig):
    """The sigmoid router of tokens xt (T, d): (picked experts (T, K),
    their gates (T, K), float32)."""
    scores = torch.sigmoid(xt.to(torch.float32)
                           @ p["router"].to(torch.float32))        # (T, E)
    bias = p["e_score_correction_bias"].detach().to(torch.float32)
    eidx = torch.topk(scores.detach() + bias, cfg.expert_top_k,
                      dim=-1).indices
    picked = scores.gather(1, eidx)
    return eidx, picked / (picked.sum(-1, keepdim=True) + 1e-20) \
        * cfg.routed_scale


def moe_apply_held(p: dict, x: torch.Tensor, cfg: ArchConfig,
                   span=obs.NULL_SPAN):
    """The sigmoid-routed, dropless expert layer over this model's held
    experts; x: (B, S, d) -> (out (B, S, d), aux loss 0).

    Scores ``s = sigmoid(x @ router)`` in float32 over all ``n_experts``;
    each token picks the ``expert_top_k`` largest ``s + bias`` (the
    selection bias ``e_score_correction_bias`` has no gradient); its
    gates are the picked scores over their sum, held or not, times
    ``routed_scale``.  The (token, pick) pairs whose expert is held are
    sorted by expert, each held expert runs its SwiGLU on exactly its
    rows, and the gated outputs go back to their tokens; the shared
    experts are added for every token.  What the experts held elsewhere
    would add is left out.

    The held experts' row counts are read to the host once a call (one
    sync) to size their products; ``span`` (a live ``model.moe`` span or
    the null one) records ``held_rows``, the pairs computed, and
    ``max_rows``, the most rows of one expert."""
    B, S, d = x.shape
    T, K = B * S, cfg.expert_top_k
    xt = x.reshape(T, d)
    eidx, gate = route_sigmoid(p, xt, cfg)
    ef = eidx.reshape(-1)                                          # (T*K,)
    # a scatter, not bincount, whose size check would sync a second time
    counts = ef.new_zeros(cfg.n_experts).scatter_add_(
        0, ef, torch.ones_like(ef))[:cfg.held].tolist()
    n_held = sum(counts)
    pairs = torch.argsort(ef, stable=True)[:n_held]   # token * K + pick
    xin = xt[pairs // K]
    wg, wu, wd = (torch.unbind(p[k], 0) for k in ("w_gate", "w_up", "w_down"))
    outs = [layers.matmul(F.silu(layers.matmul(xe, wg[e]))
                          * layers.matmul(xe, wu[e]), wd[e])
            for e, xe in enumerate(xin.split(counts)) if len(xe)]
    y = xt.new_zeros(T * K, d, dtype=torch.float32)
    if outs:
        out = torch.cat(outs) * gate.reshape(-1)[pairs, None]
        y = y.index_copy(0, pairs, out.to(y.dtype))
    y = y.reshape(T, K, d).sum(dim=1)
    if "shared" in p:
        y = y + layers.mlp(p["shared"], xt, "swiglu",
                           d_ff=cfg.n_shared_experts * _ffe(cfg))
    span.set(held_rows=n_held, max_rows=max(counts, default=0))
    return y.reshape(B, S, d), torch.zeros((), dtype=torch.float32,
                                           device=x.device)
