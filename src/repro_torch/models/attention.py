"""Causal self-attention for training: RoPE and a chunked softmax.

Port of the train path of ``repro.models.attention`` (GQA, no qk-norm, no
sliding window, no KV cache).  Weights keep the reference's layout:
``wq/wk/wv`` are ``(d, heads, hd)`` and ``wo`` is ``(H, hd, d)``.
Attention is written out as products and a softmax, as the reference's
``_attend`` does, with queries taken in blocks of ``cfg.attn_chunk``.
"""

from __future__ import annotations

import torch

from . import layers
from .config import ArchConfig

NEG_INF = -1e30


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) absolute positions."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[:, :, None].to(torch.float32) * freqs    # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            positions: torch.Tensor, chunk: int) -> torch.Tensor:
    """Causal attention in float32; q: (B,S,H,hd), k/v: (B,S,KV,hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    outs = []
    for s0 in range(0, S, chunk):
        qc = q[:, s0:s0 + chunk]
        c = qc.shape[1]
        qc = qc.reshape(B, c, KV, G, hd)
        s = torch.einsum("bqkgh,bskh->bkgqs", qc, k) * scale
        ok = positions[:, None, :] <= positions[:, s0:s0 + c, None]  # (B,c,S)
        s = torch.where(ok[:, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskh->bqkgh", p, v)
        outs.append(o.reshape(B, c, H, hd))
    return torch.cat(outs, dim=1)


def _qkv(p: dict, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    q = layers.einsum("bsd,dhk->bshk", x, p["wq"])
    k = layers.einsum("bsd,dhk->bshk", x, p["wk"])
    v = layers.einsum("bsd,dhk->bshk", x, p["wv"])
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def attn_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    """Causal self-attention over the full sequence; x: (B, S, d)."""
    B, S, _ = x.shape
    positions = positions.expand(B, S)
    q, k, v = _qkv(p, x, cfg, positions)
    o = _attend(q, k, v, positions, cfg.attn_chunk).to(q.dtype)
    return layers.einsum("bshk,hkd->bsd", o, p["wo"])
