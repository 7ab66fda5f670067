"""xLSTM blocks: chunkwise mLSTM (matrix memory) and sequential sLSTM.

Port of ``repro.models.xlstm``.

* **mLSTM**: matrix memory ``C_t = f_t C_{t-1} + i_t k_t v_t^T`` with a
  normalizer ``n_t = f_t n_{t-1} + i_t k_t``; queries read
  ``y_t = C_t q_t / max(|n_t . q_t|, 1)``.  Sigmoid gates with log-space
  cumulative decays, run chunkwise: decay-weighted attention inside a
  chunk of ``MLSTM_CHUNK`` steps, the state carried across chunks.
  The padded tail of the last chunk has forget gate 1 and input gate 0, so
  the state passes through it and the returned state is the one after the
  last real step.  (The reference pads the gates with zeros, and a forget
  gate of 0 wipes the state it returns after a prompt longer than a chunk
  and not a multiple of it; its outputs at real positions are unaffected.)
* **sLSTM**: scalar memory with exponential gating, normalizer ``n`` and
  stabilizer ``m``, and a block-diagonal (per-head) recurrent matrix.  Its
  gates depend on ``h_{t-1}``, so it runs one step a token.

Both blocks carry their own 2x up- and down-projections; xLSTM units have
no FFN.  ``w_if``, ``b_if`` and ``b`` are float32 whatever the parameter
dtype, as in the reference.

Under ``tp.model_parallel``, when the group divides the mLSTM's inner
width ``di``, a rank stores the shard of each mLSTM leaf ``param_spec``
splits over ``model`` (``up``, ``wq``, ``wk``, ``wv`` by columns,
``down`` and ``w_if`` by rows) and runs the block Megatron-style, in
train, prefill and decode alike.  ``up`` splits its ``2 * di`` columns as
one dim, as mamba's ``in_proj`` does: ``tp.channels`` regroups its
output so a rank holds ``x`` and ``z`` of its own channels.  ``wq``,
``wk`` and ``wv`` read all of ``x`` (gathered) and give the rank's
columns; ``w_if`` is row-parallel (the gates' partial sums reduced) and
``down`` too.  The state ``(C, n)`` is split as ``cache_spec`` splits
it:

* over heads when the group divides ``H``: the rank's columns are its
  heads, and the chunkwise scan runs on them with no traffic;
* over the key dim of ``C`` (``dh``) otherwise: q and k are gathered and
  a rank keeps its ``dh / m`` slice of every head, v and the gates whole;
  the scores ``q . k``, the read ``q . C`` and the normalizer ``n . q``
  are partial sums over the slice, reduced over the group, and the rest
  of the chunk is computed whole on every rank (replicated tensors enter
  the slice's part through ``tp.copy_to``, so their gradients are
  summed).

The sLSTM is replicated and computed whole; its serve state is stored as
the rank's slice of its last dim, gathered at use and sliced back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers, tp
from .config import ArchConfig

MLSTM_CHUNK = 128


def mlstm_inner(cfg: ArchConfig) -> int:
    """The mLSTM's inner width, ``d_model * xlstm_proj_factor``."""
    return int(cfg.d_model * cfg.xlstm_proj_factor)


# ---------------------------------------------------------------- mLSTM ------

def _mlstm_qkvif(p: dict, xin: torch.Tensor, cfg: ArchConfig):
    H = cfg.n_heads
    B, S, di = xin.shape
    dh = di // H

    def heads(w):
        return layers.matmul(xin, w).reshape(B, S, H, dh)

    q = heads(p["wq"]) * dh ** -0.5
    k = heads(p["wk"]) * dh ** -0.5
    v = heads(p["wv"])
    gif = xin.to(torch.float32) @ p["w_if"] + p["b_if"]
    return q, k, v, torch.sigmoid(gif[..., :H]), torch.sigmoid(gif[..., H:])


def _mlstm_chunk(C, n, qk, kk, vk, ik, fk, part: bool = False):
    """One chunk: state (C (B,H,dh,dh), n (B,H,dh)), inputs (B,c,H,...).
    Returns (C_new, n_new, y (B,c,H,dh)).

    ``part``: q, k, C and n hold the rank's slice of the key dim and v
    and the gates are whole (the dh-split mLSTM): the three sums over the
    key dim are reduced over the model group, and the replicated tensors
    that meet the slice enter through ``tp.copy_to``."""
    def red(t):
        return tp.reduce_from(t) if part else t

    def enter(t):
        return tp.copy_to(t) if part else t

    c = qk.shape[1]
    qf, kf, vf = (t.to(torch.float32) for t in (qk, kk, vk))
    F_ = torch.cumsum(torch.log(fk.clamp(min=1e-6)), dim=1)  # (B,c,H)
    # intra-chunk: y_t += sum_{j<=t} exp(F_t - F_j) i_j (q_t . k_j) v_j
    d_mat = F_[:, :, None, :] - F_[:, None, :, :]             # (B,t,j,H)
    # masked before the exp: exp(-inf) = 0 is the reference's masked
    # weight, and no overflow above the diagonal reaches the gradient
    mask = torch.tril(torch.ones(c, c, dtype=torch.bool, device=qk.device))
    w = d_mat.masked_fill(~mask[None, :, :, None], float("-inf")).exp() \
        * ik[:, None, :, :]
    s = red(torch.einsum("bthd,bjhd->btjh", qf, kf)) * w
    y_intra = torch.einsum("btjh,bjhd->bthd", s, vf)
    # inter-chunk: y_t += exp(F_t) q_t . C_prev
    eF = torch.exp(F_)
    w, eF, vf, ik, F_ = (enter(t) for t in (w, eF, vf, ik, F_))
    n_intra = torch.einsum("btjh,bjhd->bthd", w, kf)
    y_inter = red(torch.einsum("bthd,bhde->bthe", qf * eF[..., None], C))
    n_all = n[:, None] * eF[..., None] + n_intra
    denom = red(torch.einsum("bthd,bthd->bth", n_all, qf)).abs().clamp(
        min=1.0)
    y = (y_intra + y_inter) / denom[..., None]
    # the state at the end of the chunk
    Ftot = F_[:, -1]                                          # (B,H)
    kw = kf * (ik * torch.exp(Ftot[:, None] - F_))[..., None]
    C_new = C * torch.exp(Ftot)[..., None, None] + \
        torch.einsum("bjhd,bjhe->bhde", kw, vf)
    n_new = n * torch.exp(Ftot)[..., None] + kw.sum(dim=1)
    return C_new, n_new, y


def _mlstm_scan(q, k, v, i_g, f_g, C0, n0, part: bool = False):
    """Chunkwise mLSTM. q/k/v: (B,S,H,dh); gates (B,S,H); C0 (B,H,dh,dh).
    Returns (y (B,S,H,dh) float32, C, n): the state after step S.
    ``part``: :func:`_mlstm_chunk`'s."""
    S = q.shape[1]
    chunk = min(MLSTM_CHUNK, S)
    pad = (-S) % chunk
    if pad:
        def tail(a, value=0.0):
            return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad), value=value)
        q, k, v, i_g = tail(q), tail(k), tail(v), tail(i_g)
        f_g = tail(f_g, 1.0)            # log 1 = 0: the state passes through
    C, n, ys = C0, n0, []
    for s0 in range(0, S + pad, chunk):
        C, n, y = _mlstm_chunk(C, n, *(a[:, s0:s0 + chunk]
                                       for a in (q, k, v, i_g, f_g)),
                               part=part)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], C, n


def _zero_state(x: torch.Tensor, H: int, dk: int, dv: int):
    B = x.shape[0]
    return (torch.zeros(B, H, dk, dv, dtype=torch.float32, device=x.device),
            torch.zeros(B, H, dk, dtype=torch.float32, device=x.device))


def mlstm_forward(p: dict, x: torch.Tensor, cfg: ArchConfig, state=None,
                  return_state: bool = False):
    """mLSTM block over x (B, S, d) from ``state`` = (C, n) (zeros if
    None; the rank's ``cache_spec`` slice under ``tp.model_parallel``);
    with ``return_state``: (out, (C, n))."""
    di, H = mlstm_inner(cfg), cfg.n_heads
    dh = di // H
    B, S, _ = x.shape
    if p["down"].shape[-2] != di:
        return _mlstm_tp(p, x, cfg, state, return_state)
    xin, z = torch.split(layers.matmul(x, p["up"]), [di, di], dim=-1)
    q, k, v, i_g, f_g = _mlstm_qkvif(p, xin, cfg)
    C0, n0 = _zero_state(x, H, dh, dh) if state is None else state
    y, C_f, n_f = _mlstm_scan(q, k, v, i_g, f_g, C0, n0)
    y = y.reshape(B, S, di).to(x.dtype)
    out = layers.matmul(y * F.silu(z), p["down"])
    return (out, (C_f, n_f)) if return_state else out


def _mlstm_tp(p: dict, x: torch.Tensor, cfg: ArchConfig, state,
              return_state: bool):
    """The Megatron mLSTM on the rank's shard (module docstring)."""
    di, H = mlstm_inner(cfg), cfg.n_heads
    dh = di // H
    B, S, _ = x.shape
    m, r = tp.size(), tp.rank()
    # one cast, entering the parallel region in the promoted dtype
    xp = tp.copy_to(x.to(torch.promote_types(x.dtype, p["up"].dtype)))
    xin_r, z = tp.channels(layers.matmul(xp, p["up"]))
    xin = tp.copy_to(tp.gather(xin_r, -1))      # wq/wk/wv read all of x
    gif = tp.reduce_from(xin_r.to(torch.float32) @ p["w_if"])

    def cols(w):                                # the rank's columns
        return layers.matmul(xin, w)

    if tp.splits(H):                            # the rank's heads
        hn = H // m
        q, k, v = (cols(p[w]).reshape(B, S, hn, dh) for w in ("wq", "wk",
                                                              "wv"))
        gif = tp.copy_to(gif + p["b_if"])       # read on the rank's heads
        i_g = torch.sigmoid(gif[..., r * hn:(r + 1) * hn])
        f_g = torch.sigmoid(gif[..., H + r * hn:H + (r + 1) * hn])
        dk, part = dh, False
    elif tp.splits(dh):                         # the rank's slice of dh
        def whole(w):
            return tp.gather(cols(p[w]), -1).reshape(B, S, H, dh)
        dk = dh // m
        q, k = (tp.copy_to(whole(w)).narrow(-1, r * dk, dk)
                for w in ("wq", "wk"))
        v = whole("wv")
        gif = gif + p["b_if"]
        i_g, f_g = torch.sigmoid(gif[..., :H]), torch.sigmoid(gif[..., H:])
        hn, part = H, True
    else:
        raise ValueError(f"the model group ({m}) divides neither the "
                         f"mLSTM's heads ({H}) nor their width ({dh})")
    q, k = q * dh ** -0.5, k * dh ** -0.5
    C0, n0 = _zero_state(x, hn, dk, dh) if state is None else state
    y, C_f, n_f = _mlstm_scan(q, k, v, i_g, f_g, C0, n0, part=part)
    y = y.reshape(B, S, hn * dh)
    if part:                                    # whole: the rank's columns
        y = tp.split(y, -1)
    y = y.to(x.dtype)
    out = tp.reduce_from(layers.matmul(y * F.silu(z), p["down"]))
    return (out, (C_f, n_f)) if return_state else out


def mlstm_decode(p: dict, x: torch.Tensor, C, n, cfg: ArchConfig):
    """One-token mLSTM update. x: (B,1,d).  Returns (out, C, n)."""
    out, (C_f, n_f) = mlstm_forward(p, x, cfg, state=(C, n),
                                    return_state=True)
    return out, C_f, n_f


# ---------------------------------------------------------------- sLSTM ------

def _slstm_step(p: dict, carry, xt: torch.Tensor, cfg: ArchConfig):
    """One sLSTM step. xt: (B, 4*d) the step's input projection."""
    h, c, n, m = carry                          # each (B, H, dh)
    H = cfg.n_heads
    B = h.shape[0]
    dh = cfg.d_model // H
    rec = torch.einsum("bhd,ghde->bghe", h.to(torch.float32),
                       p["r"].to(torch.float32))           # (B,4,H,dh)
    g = xt.to(torch.float32).reshape(B, 4, H, dh) + rec + \
        p["b"].reshape(4, H, dh)
    z_t = torch.tanh(g[:, 0])
    i_t = g[:, 1]                               # log-space input gate
    f_t = g[:, 2]                               # log-space forget gate
    o_t = torch.sigmoid(g[:, 3])
    m_new = torch.maximum(f_t + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_t + m - m_new)
    c_new = f_p * c + i_p * z_t
    n_new = f_p * n + i_p
    h_new = o_t * c_new / n_new.abs().clamp(min=1.0)
    return h_new, c_new, n_new, m_new


def slstm_state_init(cfg: ArchConfig, batch: int, device=None):
    """(h, c, n, m), each (B, H, dh) float32; ``m`` starts at -1e9."""
    H = cfg.n_heads
    z = torch.zeros(batch, H, cfg.d_model // H, dtype=torch.float32,
                    device=device)
    return z, z, z, z - 1e9


def slstm_forward(p: dict, x: torch.Tensor, cfg: ArchConfig, state=None,
                  return_state: bool = False):
    """sLSTM block over x (B, S, d), one step a token, from ``state`` (the
    initial state if None); with ``return_state``: (out, state)."""
    B, S, d = x.shape
    xin = layers.matmul(x, p["w_in"])                      # (B,S,4d)
    carry = state if state is not None else \
        slstm_state_init(cfg, B, x.device)
    hs = []
    for t in range(S):
        carry = _slstm_step(p, carry, xin[:, t], cfg)
        hs.append(carry[0])
    y = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    out = layers.matmul(y, p["down"])
    return (out, carry) if return_state else out


def slstm_decode(p: dict, x: torch.Tensor, state, cfg: ArchConfig):
    """One sLSTM step from ``state``; a state holding the rank's slice of
    its last dim (the serve cache under ``tp.model_parallel``) is
    gathered at use and the new state sliced back."""
    split = state[0].shape[-1] != cfg.d_model // cfg.n_heads
    if split:
        state = tuple(tp.gather(t, -1) for t in state)
    out, new = slstm_forward(p, x, cfg, state=state, return_state=True)
    if split:
        new = tuple(tp.shard_of(t, -1) for t in new)
    return out, new
