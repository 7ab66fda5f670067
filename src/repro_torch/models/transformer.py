"""Model assembly: init, units, and the train / prefill / decode entry
points.

Port of ``repro.models.transformer`` for dense attention units.
Parameters are the reference's tree — nested dicts with units stacked on a
leading ``(n_units,)`` dim — so the flat layout, and with it every sketch
hash, matches the JAX package.

Dtypes follow the reference's jnp promotion.  On the train path the
residual stream enters each unit as bfloat16; inside the unit bfloat16
activations meet float32 weights and promote to float32; the unit's
output is cast back to bfloat16.  The serve path (``prefill``,
``decode_step``) keeps the residual in the parameters' dtype, as the
reference's does; its KV cache is bfloat16.

Entry points:

* ``loss_fn`` / ``value_and_grad`` — next-token cross entropy
* ``init_cache``, ``prefill`` — forward over the prompt, filling the cache
* ``decode_step`` — one token against the cache, with no host sync
"""

from __future__ import annotations

import torch

from repro_torch.core import layout as layout_lib

from . import attention, layers
from .config import ArchConfig


def _check_ported(cfg: ArchConfig) -> None:
    for spec in cfg.unit_pattern:
        if spec.kind != "attn":
            raise NotImplementedError(f"unit kind {spec.kind!r} is not ported")
        if spec.moe:
            raise NotImplementedError("unit kind 'moe' is not ported")
        if not spec.ffn:
            raise NotImplementedError("attention units without an FFN are "
                                      "not ported")


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from ``torch.Generator(seed)`` on ``device``,
    drawn in float32 and cast to ``cfg.param_dtype``, at the reference's
    scales.  Dense attention units only.  On the ``meta`` device nothing
    is drawn: the tree's shapes alone (a parameter count at full width)."""
    _check_ported(cfg)
    dev = torch.device("cpu" if device is None else device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    d, H, KV, hd, n = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.n_units

    def normal(shape, scale):
        # scaled in place: no second copy of a leaf as large as 8.4 GiB
        x = torch.randn(shape, generator=gen, device=dev)
        return x.mul_(scale).to(dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def member():
        attn = {"wq": normal((n, d, H, hd), d ** -0.5),
                "wk": normal((n, d, KV, hd), d ** -0.5),
                "wv": normal((n, d, KV, hd), d ** -0.5),
                "wo": normal((n, H, hd, d), (H * hd) ** -0.5)}
        if cfg.qk_norm:
            attn["q_norm"] = {"scale": ones(n, hd)}
            attn["k_norm"] = {"scale": ones(n, hd)}
        mlp = {"w_up": normal((n, d, cfg.d_ff), d ** -0.5),
               "w_down": normal((n, cfg.d_ff, d), cfg.d_ff ** -0.5)}
        if cfg.act == "swiglu":
            mlp["w_gate"] = normal((n, d, cfg.d_ff), d ** -0.5)
        return {"norm1": {"scale": ones(n, d)}, "attn": attn,
                "norm2": {"scale": ones(n, d)}, "mlp": mlp}

    params = {
        "embed": {"table": normal((cfg.vocab, d), 0.02)},
        "units": {f"m{i}": member() for i in range(len(cfg.unit_pattern))},
        "final_norm": {"scale": ones(d)},
    }
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": normal((d, cfg.vocab), d ** -0.5)}
    return params


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unembed_p(params: dict) -> dict:
    """The output projection: ``unembed``, or the embedding's transpose
    when the embeddings are tied."""
    return params.get("unembed") or {"w": params["embed"]["table"].T}


def _ffn(mp: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h2 = layers.rmsnorm(mp["norm2"], x, cfg.norm_eps)
    return x + layers.mlp(mp["mlp"], h2, cfg.act)


def _apply_unit_train(x: torch.Tensor, unit_p: dict, cfg: ArchConfig,
                      positions: torch.Tensor) -> torch.Tensor:
    """One unit over the full sequence; returns float32 (promoted)."""
    for i, _ in enumerate(cfg.unit_pattern):
        mp = unit_p[f"m{i}"]
        h = layers.rmsnorm(mp["norm1"], x, cfg.norm_eps)
        x = x + attention.attn_forward(mp["attn"], h, cfg, positions,
                                       window=cfg.sliding_window)
        x = _ffn(mp, x, cfg)
    return x


def hidden_states(params: dict, tokens: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """The train path's final hidden states (B, S, d), after the final
    norm."""
    x = layers.embed(params["embed"], tokens).to(torch.bfloat16)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    for u in range(cfg.n_units):
        x = _apply_unit_train(x, _index(params["units"], u), cfg,
                              positions).to(torch.bfloat16)
    return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def loss_fn(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Mean next-token cross-entropy; batch = {tokens, labels} (B, S)."""
    h = hidden_states(params, batch["tokens"], cfg)
    return layers.xent_loss(_unembed_p(params), h, batch["labels"],
                            cfg.loss_chunk)


def value_and_grad(params: dict, batch: dict, cfg: ArchConfig
                   ) -> tuple[torch.Tensor, dict]:
    """(loss, grads) with grads the same tree of float32 tensors."""
    flat = layout_lib.flatten(params)
    paths = [p for p, _ in flat]
    leaves = [t.detach().requires_grad_(True) for _, t in flat]
    loss = loss_fn(layout_lib.unflatten(paths, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), layout_lib.unflatten(paths, grads)


def param_count(params: dict) -> int:
    return sum(t.numel() for _, t in layout_lib.flatten(params))


# -- serving ------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Decode cache sized for ``seq_len`` tokens of context: a ring of the
    window's size if ``cfg.sliding_window`` is smaller.  The reference's
    tree: ``{"pos": 0-d int32, "attn": {"k", "v", "pos_arr"}}``."""
    _check_ported(cfg)
    cap = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "attn": attention.cache_init(cfg, batch, cap, cfg.n_units,
                                         len(cfg.unit_pattern), dtype,
                                         device)}


def _serve(params: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict,
           attend) -> torch.Tensor:
    """Run every unit of the serve path; ``attend(attn_p, h, k, v,
    pos_arr)`` is the attention sub-block against one member's cache."""
    ca = cache["attn"]
    for u in range(cfg.n_units):
        for i, _ in enumerate(cfg.unit_pattern):
            mp = _index(params["units"][f"m{i}"], u)
            h = layers.rmsnorm(mp["norm1"], x, cfg.norm_eps)
            out, *_ = attend(mp["attn"], h, ca["k"][u, i], ca["v"][u, i],
                             ca["pos_arr"][u, i])
            x = _ffn(mp, x + out, cfg)
    h = layers.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return layers.unembed(_unembed_p(params), h)[:, 0]


def prefill(params: dict, batch: dict, cfg: ArchConfig,
            cache: dict) -> tuple[torch.Tensor, dict]:
    """Forward over the prompt ``batch["tokens"]`` (B, S), filling every
    member's cache.  Returns (last-position logits (B, V), cache).

    The cache is updated in place (and returned): two runs that must not
    share state need caches of their own.
    """
    tokens = batch["tokens"]
    x = layers.embed(params["embed"], tokens)
    window = cfg.sliding_window
    logits = _serve(params, x, cfg, cache,
                    lambda p, h, k, v, parr: attention.attn_prefill(
                        p, h, cfg, k, v, parr, window=window))
    cache["pos"] = torch.full((), tokens.shape[1], dtype=torch.int32,
                              device=tokens.device)
    return logits, cache


def decode_step(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One-token decode; tokens: (B, 1).  Returns (logits (B, V), cache).

    The position is read from ``cache["pos"]`` on the device: no host sync
    a token.  The cache is updated in place (and returned), ``pos``
    advanced by one.
    """
    x = layers.embed(params["embed"], tokens)
    pos = cache["pos"]
    window = cfg.sliding_window
    logits = _serve(params, x, cfg, cache,
                    lambda p, h, k, v, parr: attention.attn_decode(
                        p, h, cfg, k, v, parr, pos, window=window))
    cache["pos"] = pos + 1
    return logits, cache
