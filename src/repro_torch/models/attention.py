"""GQA attention: RoPE, qk-norm, sliding window, chunked softmax, KV
cache, and whisper's cross-attention; and latent attention (MLA) on the
train path.

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

Under ``tp.model_parallel`` (the mesh step) a self- or cross-attention
whose ``wq`` and ``wo`` ``param_spec`` split over heads runs
head-parallel: a rank computes its own heads, local head ``j`` being
global head ``h = rank * H_loc + j`` of kv head ``h // G``, and the
output projection's partial sums are reduced over the group.  K/V split
over kv heads are the rank's own; K/V that stay replicated (qk-norm) are
computed whole and their weights' gradients summed over the group; K/V
weights split over head_dim (the fallback) are stored as the shard and
gathered at use.  When the heads do not divide the group, every leaf is
gathered at use and the attention computed whole on each rank.

The serve path's cache holds the rank's ``cache_spec`` slice (self- and
cross-attention alike): its kv heads, or every kv head's ``hd / m``
slice when the group does not divide the kv heads.  Prefill runs the
forms above over the fresh keys and values and writes the rank's slice.
Decode against kv heads is head-parallel; against a head_dim slice it
reads the cache where it lies: every rank forms its slice's partial
scores for every query head (its queries regrouped from its heads to
its slice by an ``all_to_all``, or gathered where RoPE or qk-norm needs
the whole head), the partial scores ``(B, H, 1, cap)`` are summed over
the group, and ``p . v`` on the slice gives the output's slice, which
goes back to the rank's heads for ``wo`` (or meets ``wo``'s own
head_dim shard).
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


# -- core attention -----------------------------------------------------------

def _block(qc, qp, kf, vf, k_pos, *, causal: bool, window: int,
           prep, scale: float, partial: bool = False):
    """One query block: (B, c, H, dv) from q (B, c, KV, G, hd) and v of
    head dim dv (MLA's is narrower than its queries'); ``partial``: q and
    k hold a slice of head_dim, and the scores are summed over the model
    group."""
    B, c, KV, G, hd = qc.shape
    s = torch.einsum("bqkgh,bskh->bkgqs", qc, kf)
    s = (tp.reduce_from(s) if partial else s) * scale
    ok = (k_pos[:, None, :] >= 0).expand(B, c, -1)        # (B,c,Sk)
    if causal:
        ok = ok & (k_pos[:, None, :] <= qp[:, :, None])
    if window:
        ok = ok & (k_pos[:, None, :] > qp[:, :, None] - window)
    s = torch.where(ok[:, None, None], s, NEG_INF)
    p = prep(torch.softmax(s, dim=-1))
    o = torch.einsum("bkgqs,bskh->bqkgh", p, vf)
    return o.reshape(B, c, KV * G, vf.shape[-1])


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
            window: int, chunk: int,
            compute_dtype: str = "float32",
            remat: bool = False, hd: int | None = None) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd), q_pos: (B,Sq), k_pos: (B,Sk).

    Chunked over Sq; query head ``h = kv * G + g``.  Slots with
    ``k_pos < 0`` are always masked.  ``compute_dtype="bfloat16"`` rounds
    q, k, v and the softmax to bf16 and multiplies in float32: the product
    of two bf16 values is exact in float32, so this is the reference's
    bf16 einsum with ``preferred_element_type=float32``.  ``remat``
    checkpoints each block.  ``hd``: the whole head_dim when q, k and v
    hold the rank's slice of it (the scores are then summed over the
    model group, and the output is the slice).
    """
    B, Sq, H, dq = q.shape
    KV = k.shape[2]
    G = H // KV
    partial = hd is not None and hd != dq
    scale = (hd or dq) ** -0.5
    low = compute_dtype == "bfloat16"

    def prep(t):
        return t.to(torch.bfloat16).to(torch.float32) if low \
            else t.to(torch.float32)

    qf, kf, vf = prep(q), prep(k), prep(v)
    outs = []
    for s0 in range(0, Sq, chunk):
        qc = qf[:, s0:s0 + chunk]
        args = (qc.reshape(B, qc.shape[1], KV, G, dq),
                q_pos[:, s0:s0 + chunk], kf, vf, k_pos)
        kw = dict(causal=causal, window=window, prep=prep, scale=scale,
                  partial=partial)
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
    return q, k, v, par


def _heads_kv(k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig,
              par: bool):
    """The K/V (B, S, ., hd) a rank's query heads read: whole K/V cut to
    the rank's kv heads when it is head-parallel, else as they are."""
    if par and k.shape[2] == cfg.n_kv_heads:
        return _kv_for_heads(k, v, cfg)
    return k, v


def _out_tp(p: dict, o: torch.Tensor, cfg: ArchConfig,
            par: bool) -> torch.Tensor:
    if par:
        return tp.reduce_from(_out(p, o))
    return _out({"wo": tp.whole(tp.whole(p["wo"], -3, cfg.n_heads), -2,
                                cfg.hd)}, o)


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
    k, v = _heads_kv(k, v, cfg, par)
    o = _attend(q, k, v, positions, positions, causal=causal, window=window,
                chunk=cfg.attn_chunk, compute_dtype=cfg.attn_compute_dtype,
                remat=remat)
    return _out_tp(p, o, cfg, par)


def mla_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, remat: bool = False
                ) -> torch.Tensor:
    """Latent attention (DeepSeek-V3's MLA, no query LoRA) over the full
    causal sequence for training; x: (B, S, d), positions: (S,) or (B, S).

    ``wq`` gives each head's query, ``qk_nope_head_dim`` plain dims then
    ``qk_rope_head_dim`` rotary ones; ``wkv_a`` the latent ``c``
    (``kv_lora_rank``) and one rotary key ``k_r`` shared by every head;
    ``wkv_b`` maps ``rmsnorm(c)`` to each head's plain key and its value
    (``v_head_dim``).  The key is ``[k_nope, k_r]``, the softmax's scale
    the query's head dim to the -1/2, and ``wo`` maps the heads' values
    back to d.  RoPE in the port's layout (the two halves of the rotary
    dims)."""
    B, S, _ = x.shape
    H, r, dn = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim
    positions = positions.expand(B, S)
    q = layers.einsum("bsd,dhk->bshk", x, p["wq"])
    q = torch.cat([q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)],
                  dim=-1)
    kva = layers.matmul(x, p["wkv_a"])
    c = layers.rmsnorm(p["kv_norm"], kva[..., :r], cfg.norm_eps)
    k_r = rope(kva[..., None, r:], positions, cfg.rope_theta)
    kv = layers.einsum("bsr,rhk->bshk", c, p["wkv_b"])
    k = torch.cat([kv[..., :dn], k_r.expand(B, S, H, -1)], dim=-1)
    o = _attend(q, k, kv[..., dn:], positions, positions, causal=True,
                window=0, chunk=cfg.attn_chunk,
                compute_dtype=cfg.attn_compute_dtype, remat=remat)
    return _out(p, o)


def _as_stored(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """K or V (B, S, KV, hd) cut to what the cache ``like`` (B, cap, ., .)
    holds: the rank's kv heads or its slice of head_dim."""
    for dim in (2, 3):
        if t.shape[dim] != like.shape[dim]:
            t = tp.shard_of(t, dim)
    return t


def _write(cache: torch.Tensor, slots: torch.Tensor,
           t: torch.Tensor) -> None:
    cache.index_copy_(1, slots, _as_stored(t, cache).to(cache.dtype))


def attn_prefill(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 cache_k: torch.Tensor, cache_v: torch.Tensor,
                 pos_arr: torch.Tensor, *, window: int = 0):
    """Prefill: the full forward over the fresh float32 k and v, and the
    prompt's last ``min(S, capacity)`` positions written into the cache,
    position ``p`` into slot ``p % capacity``; under
    ``tp.model_parallel`` the train path's forms, and the rank's slice of
    k and v written.

    ``cache_k/v`` (B, cap, KV, hd) and ``pos_arr`` (cap,) are updated in
    place and returned: (out, cache_k, cache_v, pos_arr).
    """
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v, par = _project(p, x, cfg, positions, True)
    ka, va = _heads_kv(k, v, cfg, par)
    o = _attend(q, ka, va, positions, positions, causal=True, window=window,
                chunk=cfg.attn_chunk, compute_dtype=cfg.attn_compute_dtype)
    cap = cache_k.shape[1]
    n = min(S, cap)
    kept = torch.arange(S - n, S, device=x.device)
    slots = kept % cap
    _write(cache_k, slots, k[:, S - n:])
    _write(cache_v, slots, v[:, S - n:])
    pos_arr.index_copy_(0, slots, kept.to(pos_arr.dtype))
    return _out_tp(p, o, cfg, par), cache_k, cache_v, pos_arr


def _norm_rope(t: torch.Tensor, cfg: ArchConfig, scale, positions):
    if scale is not None:
        t = layers.rmsnorm({"scale": scale}, t, cfg.norm_eps)
    if positions is not None:
        t = rope(t, positions, cfg.rope_theta)
    return t


def _hd_slice(x: torch.Tensor, w: torch.Tensor, heads: int,
              cfg: ArchConfig, scale=None, positions=None) -> torch.Tensor:
    """A projection (B, S, heads, hd / m) for every head at the rank's
    slice of head_dim, after qk-norm (``scale``) and RoPE (``positions``)
    where given: from the rank's heads by an ``all_to_all``, from ``w``'s
    head_dim shard as it is (gathered first when norm or RoPE needs the
    whole head), or cut from a whole ``w``'s output."""
    t = layers.einsum("bsd,dhk->bshk", x, w)
    if t.shape[2] != heads:                      # the rank's heads
        return tp.regroup(_norm_rope(t, cfg, scale, positions), -1, 2)
    if t.shape[3] != cfg.hd:                     # the rank's slice
        if scale is None and positions is None:
            return t
        t = tp.gather(t, -1)
    return tp.shard_of(_norm_rope(t, cfg, scale, positions), -1)


def _out_hd(p: dict, o: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """``wo`` over an output (B, S, H, hd / m) at the rank's slice of
    head_dim: back to the rank's heads for a ``wo`` split over heads, or
    against ``wo``'s own head_dim shard; the partial sums reduced."""
    wo = p["wo"]
    if wo.shape[-3] != cfg.n_heads:
        o = tp.regroup(o, 2, -1)
    elif wo.shape[-2] == cfg.hd:
        raise ValueError("a head_dim-split cache needs wo split over heads "
                         "or head_dim")
    return tp.reduce_from(_out(p, o))


def attn_decode(p: dict, x: torch.Tensor, cfg: ArchConfig,
                cache_k: torch.Tensor, cache_v: torch.Tensor,
                pos_arr: torch.Tensor, pos: torch.Tensor, *, window: int = 0):
    """Single-token decode against a (possibly ring-buffer) KV cache.

    x: (B, 1, d); ``pos`` is a 0-d integer tensor, read on the device only
    (no host sync).  The token's k and v go into slot ``pos % capacity``
    (a ring when a window sized the cache, an append when the capacity is
    the whole sequence), then the query attends over the cache, the new
    slot included.  Under ``tp.model_parallel`` the cache holds the
    rank's kv heads (head-parallel) or its slice of head_dim (partial
    scores summed over the group).  ``cache_k/v`` and ``pos_arr`` are
    updated in place and returned: (out, cache_k, cache_v, pos_arr); the
    caller advances ``pos``.
    """
    B = x.shape[0]
    cap = cache_k.shape[1]
    positions = pos.reshape(1, 1).expand(B, 1)
    slot = (pos % cap).reshape(1).long()
    kw = dict(causal=True, window=window, chunk=cfg.attn_chunk,
              compute_dtype=cfg.attn_compute_dtype)
    if cache_k.shape[-1] != cfg.hd:              # K/V over head_dim
        qn = p["q_norm"]["scale"] if "q_norm" in p else None
        kn = p["k_norm"]["scale"] if "k_norm" in p else None
        q = _hd_slice(x, p["wq"], cfg.n_heads, cfg, qn, positions)
        _write(cache_k, slot, _hd_slice(x, p["wk"], cfg.n_kv_heads, cfg, kn,
                                        positions))
        _write(cache_v, slot, _hd_slice(x, p["wv"], cfg.n_kv_heads, cfg))
        pos_arr.index_copy_(0, slot, pos.reshape(1).to(pos_arr.dtype))
        o = _attend(q, cache_k, cache_v, positions, pos_arr.expand(B, cap),
                    hd=cfg.hd, **kw)
        return _out_hd(p, o, cfg), cache_k, cache_v, pos_arr
    q, k_new, v_new, par = _project(p, x, cfg, positions, True)
    _write(cache_k, slot, k_new)
    _write(cache_v, slot, v_new)
    pos_arr.index_copy_(0, slot, pos.reshape(1).to(pos_arr.dtype))
    k, v = _heads_kv(cache_k, cache_v, cfg, par)
    o = _attend(q, k, v, positions, pos_arr.expand(B, cap), **kw)
    return _out_tp(p, o, cfg, par), cache_k, cache_v, pos_arr


# -- cross-attention ----------------------------------------------------------

def _cross(q, k, v, cfg: ArchConfig, remat: bool = False,
           hd: int | None = None) -> torch.Tensor:
    B, S = q.shape[:2]
    q_pos = torch.zeros((B, S), dtype=torch.int32, device=q.device)
    k_pos = torch.zeros((B, k.shape[1]), dtype=torch.int32, device=q.device)
    return _attend(q, k, v, q_pos, k_pos, causal=False, window=0,
                   chunk=cfg.attn_chunk, compute_dtype=cfg.attn_compute_dtype,
                   remat=remat, hd=hd)


def cross_prefill(p: dict, x: torch.Tensor, enc_out: torch.Tensor,
                  cfg: ArchConfig, cache_k: torch.Tensor,
                  cache_v: torch.Tensor) -> torch.Tensor:
    """The serve path's cross-attention at prefill: the encoder output's
    keys and values (B, S_enc, KV, hd) computed once a request, the
    rank's slice of them written into ``cache_k/v`` (B, S_enc, ., .), and
    x (B, S, d) attending over the fresh ones (the train path's forms)."""
    q, k, v, par = _project(p, x, cfg, None, False, kv_x=enc_out)
    cache_k.copy_(_as_stored(k, cache_k))
    cache_v.copy_(_as_stored(v, cache_v))
    k, v = _heads_kv(k, v, cfg, par)
    return _out_tp(p, _cross(q, k, v, cfg), cfg, par)


def cross_decode(p: dict, x: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, d) attends over every one of the cached encoder keys and
    values ``k/v`` (B, S_enc, ., .): no mask, no RoPE; head-parallel
    against the rank's kv heads, or with partial scores against its
    slice of head_dim."""
    dt = torch.promote_types(x.dtype, p["wq"].dtype)
    k, v = k.to(dt), v.to(dt)
    if k.shape[-1] != cfg.hd:
        q = _hd_slice(x, p["wq"], cfg.n_heads, cfg)
        return _out_hd(p, _cross(q, k, v, cfg, hd=cfg.hd), cfg)
    wq, _, _, _, _, par = _tp_weights(p, cfg)
    q = layers.einsum("bsd,dhk->bshk", x, wq)
    k, v = _heads_kv(k, v, cfg, par)
    return _out_tp(p, _cross(q, k, v, cfg), cfg, par)


def cross_attn_forward(p: dict, x: torch.Tensor, enc_out: torch.Tensor,
                       cfg: ArchConfig, remat: bool = False) -> torch.Tensor:
    """Whisper-style cross-attention of x (B, S, d) over the encoder's
    output (B, S_enc, d), on the train path (tensor-parallel inside
    ``tp.model_parallel``)."""
    q, k, v, par = _project(p, x, cfg, None, False, kv_x=enc_out)
    k, v = _heads_kv(k, v, cfg, par)
    return _out_tp(p, _cross(q, k, v, cfg, remat), cfg, par)
