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

Under ``tp.model_parallel`` a rank stores the shard of each mLSTM leaf
``param_spec`` splits over ``model`` (``up``, ``wq``, ``wk``, ``wv`` by
columns, ``down`` and ``w_if`` by rows), and the train forward gathers
them at use and computes the block whole on every rank; its Megatron
forward is not written yet.  The sLSTM is replicated.
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


def _mlstm_chunk(C, n, qk, kk, vk, ik, fk):
    """One chunk: state (C (B,H,dh,dh), n (B,H,dh)), inputs (B,c,H,...).
    Returns (C_new, n_new, y (B,c,H,dh))."""
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
    s = torch.einsum("bthd,bjhd->btjh", qf, kf) * w
    y_intra = torch.einsum("btjh,bjhd->bthd", s, vf)
    n_intra = torch.einsum("btjh,bjhd->bthd", w, kf)
    # inter-chunk: y_t += exp(F_t) q_t . C_prev
    eF = torch.exp(F_)
    y_inter = torch.einsum("bthd,bhde->bthe", qf * eF[..., None], C)
    n_all = n[:, None] * eF[..., None] + n_intra
    denom = torch.einsum("bthd,bthd->bth", n_all, qf).abs().clamp(min=1.0)
    y = (y_intra + y_inter) / denom[..., None]
    # the state at the end of the chunk
    Ftot = F_[:, -1]                                          # (B,H)
    kw = kf * (ik * torch.exp(Ftot[:, None] - F_))[..., None]
    C_new = C * torch.exp(Ftot)[..., None, None] + \
        torch.einsum("bjhd,bjhe->bhde", kw, vf)
    n_new = n * torch.exp(Ftot)[..., None] + kw.sum(dim=1)
    return C_new, n_new, y


def _mlstm_scan(q, k, v, i_g, f_g, C0, n0):
    """Chunkwise mLSTM. q/k/v: (B,S,H,dh); gates (B,S,H); C0 (B,H,dh,dh).
    Returns (y (B,S,H,dh) float32, C, n): the state after step S."""
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
                                       for a in (q, k, v, i_g, f_g)))
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], C, n


def mlstm_forward(p: dict, x: torch.Tensor, cfg: ArchConfig, state=None,
                  return_state: bool = False):
    """mLSTM block over x (B, S, d) from ``state`` = (C, n) (zeros if
    None); with ``return_state``: (out, (C, n))."""
    di, H = mlstm_inner(cfg), cfg.n_heads
    dh = di // H
    B, S, _ = x.shape
    p = {k: tp.whole(v, -1, 2 * di) if k == "up" else
         tp.whole(v, -1, di) if k in ("wq", "wk", "wv") else
         tp.whole(v, 0, di) if k in ("down", "w_if") else v
         for k, v in p.items()}
    xin, z = torch.split(layers.matmul(x, p["up"]), [di, di], dim=-1)
    q, k, v, i_g, f_g = _mlstm_qkvif(p, xin, cfg)
    if state is None:
        C0 = torch.zeros(B, H, dh, dh, dtype=torch.float32, device=x.device)
        n0 = torch.zeros(B, H, dh, dtype=torch.float32, device=x.device)
    else:
        C0, n0 = state
    y, C_f, n_f = _mlstm_scan(q, k, v, i_g, f_g, C0, n0)
    y = y.reshape(B, S, di).to(x.dtype)
    out = layers.matmul(y * F.silu(z), p["down"])
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
    return slstm_forward(p, x, cfg, state=state, return_state=True)
