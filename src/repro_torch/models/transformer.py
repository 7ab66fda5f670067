"""Model assembly for training: init, units, loss.

Port of the train path of ``repro.models.transformer`` for dense attention
units.  Parameters are the reference's tree — nested dicts with units
stacked on a leading ``(n_units,)`` dim — so the flat layout, and with it
every sketch hash, matches the JAX package.

Dtypes follow the reference's jnp promotion: the residual stream enters
each unit as bfloat16; inside the unit bfloat16 activations meet float32
weights and promote to float32; the unit's output is cast back to
bfloat16.
"""

from __future__ import annotations

import torch

from repro_torch.core import layout as layout_lib

from . import attention, layers
from .config import ArchConfig


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Random float32 parameters from ``torch.Generator(seed)`` on
    ``device``.  Dense attention units only."""
    for spec in cfg.unit_pattern:
        if spec.kind != "attn" or spec.moe or not spec.ffn:
            raise NotImplementedError(f"unit {spec} is not ported")
    if cfg.act != "gelu":
        raise NotImplementedError(f"activation {cfg.act} is not ported")
    dev = torch.device("cpu" if device is None else device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, H, KV, hd, n = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.n_units

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def ones(*shape):
        return torch.ones(shape, device=dev)

    def member():
        return {"norm1": {"scale": ones(n, d)},
                "attn": {"wq": normal((n, d, H, hd), d ** -0.5),
                         "wk": normal((n, d, KV, hd), d ** -0.5),
                         "wv": normal((n, d, KV, hd), d ** -0.5),
                         "wo": normal((n, H, hd, d), (H * hd) ** -0.5)},
                "norm2": {"scale": ones(n, d)},
                "mlp": {"w_up": normal((n, d, cfg.d_ff), d ** -0.5),
                        "w_down": normal((n, cfg.d_ff, d),
                                         cfg.d_ff ** -0.5)}}

    return {
        "embed": {"table": normal((cfg.vocab, d), 0.02)},
        "units": {f"m{i}": member() for i in range(len(cfg.unit_pattern))},
        "final_norm": {"scale": ones(d)},
        "unembed": {"w": normal((d, cfg.vocab), d ** -0.5)},
    }


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_unit_train(x: torch.Tensor, unit_p: dict, cfg: ArchConfig,
                      positions: torch.Tensor) -> torch.Tensor:
    """One unit over the full sequence; returns float32 (promoted)."""
    for i, _ in enumerate(cfg.unit_pattern):
        mp = unit_p[f"m{i}"]
        h = layers.rmsnorm(mp["norm1"], x, cfg.norm_eps)
        x = x + attention.attn_forward(mp["attn"], h, cfg, positions)
        h2 = layers.rmsnorm(mp["norm2"], x, cfg.norm_eps)
        x = x + layers.mlp(mp["mlp"], h2, cfg.act)
    return x


def loss_fn(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Mean next-token cross-entropy; batch = {tokens, labels} (B, S)."""
    tokens = batch["tokens"]
    x = layers.embed(params["embed"], tokens).to(torch.bfloat16)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    for u in range(cfg.n_units):
        x = _apply_unit_train(x, _index(params["units"], u), cfg,
                              positions).to(torch.bfloat16)
    h = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.xent_loss(params["unembed"], h, batch["labels"],
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
