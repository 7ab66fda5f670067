"""Mamba selective-state-space block (jamba's recurrent member).

Port of ``repro.models.ssm``.  Selective scan ``h_t = exp(dt_t * A)
h_{t-1} + dt_t * B_t x_t`` with input-dependent (dt, B, C).  Train and
prefill run a chunked scan: a loop over chunks of ``SSM_CHUNK`` steps
carrying the (B, d_inner, d_state) state, and within a chunk an inclusive
scan of the ``(decay, drive)`` pairs in log2(chunk) doubling passes with
the reference's combine ``(a, b) -> (a0 * b0, a1 * b0 + b1)``.  The
doubling scan multiplies decays (each in (0, 1]) and never divides by a
cumulative decay, which would overflow float32 inside one chunk.  Decode is
the O(1) recurrent update.

Dtypes are the reference's: B, C and the scan in float32, ``y`` cast to
the input's dtype before ``+ xc * D``.

Under ``tp.model_parallel``, when the group divides ``d_inner``, a rank
stores the ``d_inner`` shard of each leaf ``param_spec`` splits over
``model`` and runs the block Megatron-style on its channels, in train,
prefill and decode alike: ``in_proj``, the causal conv, ``dt_proj``,
``dt_bias``, ``D`` and the selective scan (its state ``(B, d_inner / m,
d_state)``, ``A_log``'s rows) are column-parallel with no traffic inside
the scan; ``x_proj`` is row-parallel, its ``(B, S, dt_rank + 2
d_state)`` partial summed over the group (and, since every rank reads
the whole of dt, B and C, its gradient summed too), and ``out_proj`` is
row-parallel, its output summed.  ``param_spec`` splits ``in_proj``'s
``2 * d_inner`` columns as one dim, so a rank stores two blocks of
``x`` or ``z`` that are not its channels; ``tp.channels`` exchanges the
projection's ``(B, S, 2 d_inner / m)`` output so that each rank gets
``x`` and ``z`` of its own channels.  Each leaf keeps the shard the
sketch's ids and ``model_local`` are defined on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from . import layers, tp
from .config import ArchConfig

SSM_CHUNK = 128


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over S by shifted adds. x: (B,S,di), w: (K,di)."""
    K = w.shape[0]
    out = x * w[K - 1]
    for j in range(1, K):
        shifted = F.pad(x, (0, 0, j, 0))[:, :-j]
        out = out + shifted * w[K - 1 - j]
    return out + b


def _split(p: dict, cfg: ArchConfig) -> bool:
    """Whether ``p`` holds the rank's ``d_inner`` shard (the Megatron
    block under ``tp.model_parallel``)."""
    return p["out_proj"].shape[-2] != cfg.d_inner


def _sel_params(p: dict, x_conv: torch.Tensor, cfg: ArchConfig):
    """(dt, Bm, Cm) selective params from the conv output. x_conv: (B,S,di)."""
    dr, ds = cfg.dt_rank, cfg.ssm_d_state
    dbc = layers.matmul(x_conv, p["x_proj"])
    if _split(p, cfg):      # row-parallel; every rank reads the whole sum
        dbc = tp.copy_to(tp.reduce_from(dbc))
    dt_in, Bm, Cm = torch.split(dbc, [dr, ds, ds], dim=-1)
    dt = F.softplus(layers.matmul(dt_in, p["dt_proj"]) + p["dt_bias"])
    return dt, Bm.to(torch.float32), Cm.to(torch.float32)


def _scan_pairs(decay: torch.Tensor, drive: torch.Tensor):
    """Inclusive scan over dim 1 of ``(decay, drive)`` pairs, in doubling
    passes: after the pass of offset ``o``, step t holds the combination
    of steps ``t - 2o + 1 .. t``."""
    c = decay.shape[1]
    o = 1
    while o < c:
        # steps t >= o combine with step t - o; earlier steps keep theirs
        # (the identity (1, 0) on the left)
        dec_l = F.pad(decay[:, :-o], (0, 0, 0, 0, o, 0), value=1.0)
        drv_l = F.pad(drive[:, :-o], (0, 0, 0, 0, o, 0))
        drive = drv_l * decay + drive
        decay = dec_l * decay
        o *= 2
    return decay, drive


def _chunk(h: torch.Tensor, dt_k, B_k, C_k, x_k, A: torch.Tensor):
    """One chunk of the scan from state ``h`` (B,di,ds): (h_last, y)."""
    dtf = dt_k.to(torch.float32)
    decay = torch.exp(dtf[..., None] * (-torch.exp(A)))          # (B,c,di,ds)
    drive = (dtf * x_k.to(torch.float32))[..., None] * B_k[:, :, None, :]
    dec_c, drv_c = _scan_pairs(decay, drive)
    h_all = dec_c * h[:, None] + drv_c
    y = torch.einsum("bcds,bcs->bcd", h_all, C_k)
    return h_all[:, -1], y


def _pad_time(pad: int, *xs: torch.Tensor) -> list[torch.Tensor]:
    return [F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)) for a in xs]


def _scan_chunked(dt, Bm, Cm, xin, A, h0, remat: bool = False):
    """Chunked selective scan.

    dt, xin: (B,S,di); Bm, Cm: (B,S,ds); A: (di,ds); h0: (B,di,ds).
    Returns (y (B,S,di) float32, h_final).  The padded tail has dt = 0:
    decay 1 and drive 0, so the state passes through it.  ``remat``:
    checkpoint each chunk, so the backward pass recomputes its states.
    """
    S = xin.shape[1]
    chunk = min(SSM_CHUNK, S)
    pad = (-S) % chunk
    if pad:
        dt, Bm, Cm, xin = _pad_time(pad, dt, Bm, Cm, xin)
    h, ys = h0, []
    for s0 in range(0, S + pad, chunk):
        args = [a[:, s0:s0 + chunk] for a in (dt, Bm, Cm, xin)]
        if remat and torch.is_grad_enabled():
            h, y = checkpoint.checkpoint(_chunk, h, *args, A,
                                         use_reentrant=False)
        else:
            h, y = _chunk(h, *args, A)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], h


def _fused_chunk(p: dict, cfg: ArchConfig, h, x_k, A):
    dt_k, B_k, C_k = _sel_params(p, x_k, cfg)
    return _chunk(h, dt_k, B_k, C_k, x_k, A)


def _scan_chunked_fused(p: dict, xc: torch.Tensor, A, h0, cfg: ArchConfig):
    """The ``ssm_remat`` path: the selective params (dt, B, C) are
    recomputed inside each checkpointed chunk from the conv output, so
    backward keeps only the conv activations of each chunk.  The padded
    tail's zero input still has ``dt = softplus(dt_bias)``, so the final
    state is not the state at the last real step (as in the reference);
    only ``y`` is used."""
    S = xc.shape[1]
    chunk = min(SSM_CHUNK, S)
    pad = (-S) % chunk
    if pad:
        (xc,) = _pad_time(pad, xc)
    h, ys = h0, []
    for s0 in range(0, S + pad, chunk):
        x_k = xc[:, s0:s0 + chunk]
        if torch.is_grad_enabled():
            h, y = checkpoint.checkpoint(_fused_chunk, p, cfg, h, x_k, A,
                                         use_reentrant=False)
        else:
            h, y = _fused_chunk(p, cfg, h, x_k, A)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], h


def _in_proj(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """(x, z) of the rank's channels: column-parallel, regrouped by
    ``tp.channels`` when ``in_proj`` is the rank's shard."""
    if not _split(p, cfg):
        xz = layers.matmul(x, p["in_proj"])
        return torch.split(xz, [cfg.d_inner, cfg.d_inner], dim=-1)
    # one cast, entering the parallel region in the promoted dtype
    x = tp.copy_to(x.to(torch.promote_types(x.dtype, p["in_proj"].dtype)))
    return tp.channels(layers.matmul(x, p["in_proj"]))


def _out_proj(p: dict, y, xc, z, x: torch.Tensor,
              cfg: ArchConfig) -> torch.Tensor:
    y = y.to(x.dtype) + xc * p["D"]
    out = layers.matmul(y * F.silu(z), p["out_proj"])
    return tp.reduce_from(out) if _split(p, cfg) else out


def _h0(x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """The zero scan state (B, channels, d_state) of ``A``'s channels."""
    return torch.zeros(x.shape[0], *A.shape, dtype=torch.float32,
                       device=x.device)


def mamba_forward(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence mamba block. x: (B, S, d)."""
    xin, z = _in_proj(p, x, cfg)
    xc = F.silu(_causal_conv(xin, p["conv_w"], p["conv_b"]))
    A = p["A_log"].to(torch.float32)
    if cfg.ssm_remat:
        y, _ = _scan_chunked_fused(p, xc, A, _h0(x, A), cfg)
    else:
        dt, Bm, Cm = _sel_params(p, xc, cfg)
        y, _ = _scan_chunked(dt, Bm, Cm, xc, A, _h0(x, A))
    return _out_proj(p, y, xc, z, x, cfg)


def mamba_decode(p: dict, x: torch.Tensor, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor, cfg: ArchConfig):
    """Single-token recurrent update. x: (B,1,d); states (B,K-1,di) and
    (B,di,ds) (the rank's channels under ``tp.model_parallel``).  Returns
    (out, conv_state, ssm_state), the states new."""
    xin, z = _in_proj(p, x, cfg)                                  # (B,1,di)
    window = torch.cat([conv_state, xin], dim=1)                  # (B,K,di)
    xc = layers.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"]
    xc = F.silu(xc)[:, None]                                      # (B,1,di)
    dt, Bm, Cm = _sel_params(p, xc, cfg)
    A = p["A_log"].to(torch.float32)
    dtf = dt[:, 0].to(torch.float32)                              # (B,di)
    decay = torch.exp(dtf[..., None] * (-torch.exp(A))[None])     # (B,di,ds)
    drive = (dtf * xc[:, 0].to(torch.float32))[..., None] * Bm[:, 0, None, :]
    h = decay * ssm_state + drive
    y = torch.einsum("bds,bs->bd", h, Cm[:, 0])[:, None]
    return _out_proj(p, y, xc, z, x, cfg), window[:, 1:], h


def mamba_prefill(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """Forward and the final recurrent states for the decode that follows:
    (out, conv_state (B, K-1, di), ssm_state).  A prompt shorter than
    ``K - 1`` tokens left-pads ``conv_state`` with zeros, the causal
    conv's own history."""
    xin, z = _in_proj(p, x, cfg)
    xc = F.silu(_causal_conv(xin, p["conv_w"], p["conv_b"]))
    dt, Bm, Cm = _sel_params(p, xc, cfg)
    A = p["A_log"].to(torch.float32)
    y, h_final = _scan_chunked(dt, Bm, Cm, xc, A, _h0(x, A),
                               remat=cfg.ssm_remat)
    keep = cfg.ssm_conv - 1
    conv_state = F.pad(xin, (0, 0, max(0, keep - xin.shape[1]), 0))
    return _out_proj(p, y, xc, z, x, cfg), conv_state[:, -keep:], h_final
