"""GQA attention: RoPE, qk-norm, sliding window, chunked softmax, KV
cache, and whisper's cross-attention.

Port of ``repro.models.attention``.  Weights keep
the reference's layout: ``wq/wk/wv`` are ``(d, heads, hd)`` and ``wo`` is
``(H, hd, d)``.  Attention is written out as products and a softmax, as the
reference's ``_attend`` does, with queries taken in blocks of
``cfg.attn_chunk``.

The KV cache stores the absolute position of every slot (``pos_arr``, -1 =
empty), so full and ring-buffer caches share one masking rule: a slot is
visible iff ``0 <= slot_pos <= q_pos`` (and inside the window, if any).
Cross-attention (the whisper decoder over the encoder's output) has no
mask and no RoPE: every query and key sits at position 0.
Position ``p`` always lives in slot ``p % capacity``, in prefill as in
decode.  The reference's prefill writes its last ``capacity`` keys into
slots ``0..capacity-1`` instead; the two agree whenever the prompt fits
the cache or is a multiple of it, and otherwise the reference's decode
overwrites keys that are still inside the window.

``remat`` (the train path's) checkpoints each query block, as the
reference always does: the backward recomputes a block's scores and
probabilities instead of keeping every block's.

Under ``tp.model_parallel`` (the train path of the mesh step) a self- or
cross-attention whose ``wq`` and ``wo`` ``param_spec`` split over heads
runs head-parallel: a rank computes its own heads, local head ``j`` being
global head ``h = rank * H_loc + j`` of kv head ``h // G``, and the
output projection's partial sums are reduced over the group.  K/V split
over kv heads are the rank's own; K/V that stay replicated (qk-norm) are
computed whole and their weights' gradients summed over the group; K/V
split over head_dim (the fallback) are stored as the shard and gathered
at use.  When the heads do not divide the group, every leaf is gathered
at use and the attention computed whole on each rank.  Prefill and
decode run outside the context, on whole weights.
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint

from . import layers, tp
from .config import ArchConfig

NEG_INF = -1e30


# -- rotary embeddings --------------------------------------------------------

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


# -- cache --------------------------------------------------------------------

def cache_init(cfg: ArchConfig, batch: int, capacity: int, n_units: int,
               members: int, dtype=torch.bfloat16, device=None) -> dict:
    """Stacked KV cache for all attention members of all units: ``k`` and
    ``v`` are ``(n_units, members, batch, capacity, KV, hd)``; ``pos_arr``
    ``(n_units, members, capacity)`` holds each slot's absolute position
    (-1 = empty)."""
    shape = (n_units, members, batch, capacity, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos_arr": torch.full((n_units, members, capacity), -1,
                              dtype=torch.int32, device=device),
    }


# -- core attention -----------------------------------------------------------

def _block(qc, qp, kf, vf, k_pos, *, causal: bool, window: int,
           prep, scale: float):
    """One query block: (B, c, H, hd) from q (B, c, KV, G, hd)."""
    B, c, KV, G, hd = qc.shape
    s = torch.einsum("bqkgh,bskh->bkgqs", qc, kf) * scale
    ok = (k_pos[:, None, :] >= 0).expand(B, c, -1)        # (B,c,Sk)
    if causal:
        ok = ok & (k_pos[:, None, :] <= qp[:, :, None])
    if window:
        ok = ok & (k_pos[:, None, :] > qp[:, :, None] - window)
    s = torch.where(ok[:, None, None], s, NEG_INF)
    p = prep(torch.softmax(s, dim=-1))
    o = torch.einsum("bkgqs,bskh->bqkgh", p, vf)
    return o.reshape(B, c, KV * G, hd)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
            window: int, chunk: int,
            compute_dtype: str = "float32",
            remat: bool = False) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd), q_pos: (B,Sq), k_pos: (B,Sk).

    Chunked over Sq; query head ``h = kv * G + g``.  Slots with
    ``k_pos < 0`` are always masked.  ``compute_dtype="bfloat16"`` rounds
    q, k, v and the softmax to bf16 and multiplies in float32: the product
    of two bf16 values is exact in float32, so this is the reference's
    bf16 einsum with ``preferred_element_type=float32``.  ``remat``
    checkpoints each block.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    low = compute_dtype == "bfloat16"

    def prep(t):
        return t.to(torch.bfloat16).to(torch.float32) if low \
            else t.to(torch.float32)

    qf, kf, vf = prep(q), prep(k), prep(v)
    outs = []
    for s0 in range(0, Sq, chunk):
        qc = qf[:, s0:s0 + chunk]
        args = (qc.reshape(B, qc.shape[1], KV, G, hd),
                q_pos[:, s0:s0 + chunk], kf, vf, k_pos)
        kw = dict(causal=causal, window=window, prep=prep, scale=scale)
        if remat and torch.is_grad_enabled():
            outs.append(checkpoint.checkpoint(_block, *args, **kw,
                                              use_reentrant=False))
        else:
            outs.append(_block(*args, **kw))
    return torch.cat(outs, dim=1).to(q.dtype)


# -- tensor parallelism -------------------------------------------------------

def _tp_weights(p: dict, cfg: ArchConfig):
    """The weights a rank attends with under ``tp.model_parallel``:
    (wq, wk, wv, q_norm, k_norm scales or None, head-parallel?).  The
    whole model's (no group) are ``p``'s own."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    qn = p["q_norm"]["scale"] if "q_norm" in p else None
    kn = p["k_norm"]["scale"] if "k_norm" in p else None
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    if tp.size() == 1:
        return wq, wk, wv, qn, kn, False
    if not tp.splits(H):                 # every leaf whole on every rank
        wq, wk, wv = (tp.whole(w, -1, hd) for w in (wq, wk, wv))
        return wq, wk, wv, qn, kn, False
    # K/V replicated or over head_dim, and the norm scales over head_dim,
    # meet only the rank's heads: their gradients are summed
    if wk.shape[-2] == KV:
        wk, wv = (tp.copy_to(tp.whole(w, -1, hd)) for w in (wk, wv))
    qn, kn = (None if s is None else tp.copy_to(s) for s in (qn, kn))
    return wq, wk, wv, qn, kn, True


def _kv_for_heads(k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig):
    """Whole K/V (B, S, KV, hd) -> the kv heads this rank's query heads
    read, in the order ``_attend`` pairs them."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    G, h_loc = H // KV, H // tp.size()
    first = tp.rank() * h_loc
    if h_loc % G == 0:                   # whole groups: the same G
        return (k.narrow(2, first // G, h_loc // G),
                v.narrow(2, first // G, h_loc // G))
    if G % h_loc == 0:                   # every local head in one group
        return k.narrow(2, first // G, 1), v.narrow(2, first // G, 1)
    idx = (first + torch.arange(h_loc, device=k.device)) // G
    return k[:, :, idx], v[:, :, idx]


def _project(p: dict, x: torch.Tensor, cfg: ArchConfig, positions,
             use_rope: bool, kv_x=None):
    """(q, k, v, head-parallel?) on the train path: projections, qk-norm
    and RoPE; ``kv_x``: the keys' and values' input when it is not ``x``
    (cross-attention)."""
    wq, wk, wv, qn, kn, par = _tp_weights(p, cfg)
    if par:
        # one cast of the input, entering the parallel region once; the
        # whole model casts it for each projection (layers.einsum), as
        # its parity with the reference was measured
        x = tp.copy_to(x.to(torch.promote_types(x.dtype, wq.dtype)))
        if kv_x is not None:
            kv_x = tp.copy_to(kv_x.to(torch.promote_types(kv_x.dtype,
                                                          wk.dtype)))
    kv_x = x if kv_x is None else kv_x
    q = layers.einsum("bsd,dhk->bshk", x, wq)
    k = layers.einsum("bsd,dhk->bshk", kv_x, wk)
    v = layers.einsum("bsd,dhk->bshk", kv_x, wv)
    if cfg.qk_norm and qn is not None:
        q = layers.rmsnorm({"scale": qn}, q, cfg.norm_eps)
        k = layers.rmsnorm({"scale": kn}, k, cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if par and k.shape[2] == cfg.n_kv_heads:
        k, v = _kv_for_heads(k, v, cfg)
    return q, k, v, par


def _out_tp(p: dict, o: torch.Tensor, cfg: ArchConfig,
            par: bool) -> torch.Tensor:
    if par:
        return tp.reduce_from(_out(p, o))
    return _out({"wo": tp.whole(tp.whole(p["wo"], -3, cfg.n_heads), -2,
                                cfg.hd)}, o)


def _qkv(p: dict, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
         use_rope: bool = True):
    q = layers.einsum("bsd,dhk->bshk", x, p["wq"])
    k = layers.einsum("bsd,dhk->bshk", x, p["wk"])
    v = layers.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm and "q_norm" in p:
        q = layers.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(p: dict, o: torch.Tensor) -> torch.Tensor:
    return layers.einsum("bshk,hkd->bsd", o, p["wo"])


def attn_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, *, causal: bool = True,
                 window: int = 0, use_rope: bool = True,
                 remat: bool = False) -> torch.Tensor:
    """Self-attention over the full (possibly banded) sequence for
    training; x: (B, S, d), positions: (S,) or (B, S).  The whisper
    encoder's is bidirectional without RoPE (``causal=False,
    use_rope=False``).  Tensor-parallel inside ``tp.model_parallel``."""
    B, S, _ = x.shape
    positions = positions.expand(B, S)
    q, k, v, par = _project(p, x, cfg, positions, use_rope)
    o = _attend(q, k, v, positions, positions, causal=causal, window=window,
                chunk=cfg.attn_chunk, compute_dtype=cfg.attn_compute_dtype,
                remat=remat)
    return _out_tp(p, o, cfg, par)


def attn_prefill(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 cache_k: torch.Tensor, cache_v: torch.Tensor,
                 pos_arr: torch.Tensor, *, window: int = 0):
    """Prefill: the full forward over the fresh float32 k and v, and the
    prompt's last ``min(S, capacity)`` positions written into the cache,
    position ``p`` into slot ``p % capacity``.

    ``cache_k/v`` (B, cap, KV, hd) and ``pos_arr`` (cap,) are updated in
    place and returned: (out, cache_k, cache_v, pos_arr).
    """
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(p, x, cfg, positions)
    o = _attend(q, k, v, positions, positions, causal=True, window=window,
                chunk=cfg.attn_chunk, compute_dtype=cfg.attn_compute_dtype)
    cap = cache_k.shape[1]
    n = min(S, cap)
    kept = torch.arange(S - n, S, device=x.device)
    slots = kept % cap
    cache_k.index_copy_(1, slots, k[:, S - n:].to(cache_k.dtype))
    cache_v.index_copy_(1, slots, v[:, S - n:].to(cache_v.dtype))
    pos_arr.index_copy_(0, slots, kept.to(pos_arr.dtype))
    return _out(p, o), cache_k, cache_v, pos_arr


def attn_decode(p: dict, x: torch.Tensor, cfg: ArchConfig,
                cache_k: torch.Tensor, cache_v: torch.Tensor,
                pos_arr: torch.Tensor, pos: torch.Tensor, *, window: int = 0):
    """Single-token decode against a (possibly ring-buffer) KV cache.

    x: (B, 1, d); ``pos`` is a 0-d integer tensor, read on the device only
    (no host sync).  The token's k and v go into slot ``pos % capacity``
    (a ring when a window sized the cache, an append when the capacity is
    the whole sequence), then the query attends over the cache, the new
    slot included.  ``cache_k/v`` and ``pos_arr`` are updated in place and
    returned: (out, cache_k, cache_v, pos_arr); the caller advances
    ``pos``.
    """
    B = x.shape[0]
    cap = cache_k.shape[1]
    positions = pos.reshape(1, 1).expand(B, 1)
    q, k_new, v_new = _qkv(p, x, cfg, positions)
    slot = (pos % cap).reshape(1).long()
    cache_k.index_copy_(1, slot, k_new.to(cache_k.dtype))
    cache_v.index_copy_(1, slot, v_new.to(cache_v.dtype))
    pos_arr.index_copy_(0, slot, pos.reshape(1).to(pos_arr.dtype))
    o = _attend(q, cache_k, cache_v, positions, pos_arr.expand(B, cap),
                causal=True, window=window, chunk=cfg.attn_chunk,
                compute_dtype=cfg.attn_compute_dtype)
    return _out(p, o), cache_k, cache_v, pos_arr


# -- cross-attention ----------------------------------------------------------

def cross_kv(p: dict, enc_out: torch.Tensor):
    """The encoder output's keys and values (B, S_enc, KV, hd), which the
    serve path computes once a request and caches."""
    return (layers.einsum("bsd,dhk->bshk", enc_out, p["wk"]),
            layers.einsum("bsd,dhk->bshk", enc_out, p["wv"]))


def _cross(q, k, v, cfg: ArchConfig, remat: bool = False) -> torch.Tensor:
    B, S = q.shape[:2]
    q_pos = torch.zeros((B, S), dtype=torch.int32, device=q.device)
    k_pos = torch.zeros((B, k.shape[1]), dtype=torch.int32, device=q.device)
    return _attend(q, k, v, q_pos, k_pos, causal=False, window=0,
                   chunk=cfg.attn_chunk, compute_dtype=cfg.attn_compute_dtype,
                   remat=remat)


def cross_attend(p: dict, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, d) attends over every one of the encoder's keys and
    values ``k/v`` (B, S_enc, KV, hd): no mask, no RoPE."""
    q = layers.einsum("bsd,dhk->bshk", x, p["wq"])
    return _out(p, _cross(q, k, v, cfg))


def cross_attn_forward(p: dict, x: torch.Tensor, enc_out: torch.Tensor,
                       cfg: ArchConfig, remat: bool = False) -> torch.Tensor:
    """Whisper-style cross-attention of x (B, S, d) over the encoder's
    output (B, S_enc, d), on the train path (tensor-parallel inside
    ``tp.model_parallel``)."""
    q, k, v, par = _project(p, x, cfg, None, False, kv_x=enc_out)
    return _out_tp(p, _cross(q, k, v, cfg, remat), cfg, par)
