"""Model assembly: init, units, and the train / prefill / decode entry
points.

Port of ``repro.models.transformer``.  A unit's members are attention,
mamba, mLSTM or sLSTM blocks, each with a dense or MoE FFN or none.  The
stub frontends join the token stream as the reference's do: ``audio``
(whisper) takes precomputed frame embeddings (B, enc_seq, d) into a
bidirectional encoder whose output every decoder attention member
cross-attends to; ``vision`` (pixtral) takes precomputed patch embeddings
(B, n_patches, d), projected and put before the tokens (prefix fusion;
no loss on the prefix).  A model with ``first_dense_layers`` holds them
outside the stacked units, under ``lead`` (stacked on their own leading
dim): the unit's attention kind with a dense FFN of width ``d_ff``, run
before the units.  Parameters are the
reference's tree (nested dicts with units stacked on a leading
``(n_units,)`` dim), so the flat layout, and with it every sketch hash,
matches the JAX package.

Dtypes follow the reference's jnp promotion.  On the train path the
residual stream enters each unit as bfloat16; inside the unit bfloat16
activations meet float32 weights and promote to float32; the unit's
output is cast back to bfloat16.  The whisper encoder's residual stays
in the frames' dtype, as in the reference.  The serve path (``prefill``,
``decode_step``) keeps the residual in the parameters' dtype, as the
reference's does; its KV cache (self- and cross-attention) is bfloat16
and its recurrent states float32.

Memory on the train path.  ``remat`` (``loss_fn`` / ``value_and_grad``,
default True as in the reference) checkpoints each unit, each attention
query block and each cross-entropy chunk (``torch.utils.checkpoint``,
non-reentrant): the backward recomputes a unit from its saved input.
Inside ``tp.model_parallel`` (the mesh step) the model runs
tensor-parallel over the group (``models/tp.py``), and when the group
divides ``d_model`` a checkpointed unit keeps its saved input as the
rank's slice of ``d`` and gathers it on recompute (the reference's
``constrain_activations``).  The recompute gives the same values, so the
loss and gradients do not depend on ``remat``; it trades memory for a
second forward of each unit.

Entry points:

* ``loss_fn`` / ``value_and_grad`` — next-token cross entropy plus the
  MoE routers' auxiliary loss; a batch holds ``tokens`` and ``labels``,
  and ``frames`` (audio) or ``patches`` (vision)
* ``init_cache``, ``prefill`` — forward over the prompt, filling the cache
* ``decode_step`` — one token against the cache, with no host sync

Latent attention (MLA) runs on the train path only: its serving needs a
latent KV cache the port does not have, so the serve entry points refuse
such a model.

Spans: inside ``obs.active(tele)`` (the orchestrator's client gradients)
with tracing on, each forward of an MLA block opens a ``model.mla`` span
and each forward of a sigmoid-routed expert layer a ``model.moe`` span,
with the layer's index; the backward passes are not spanned.

Inside ``tp.model_parallel`` the serve path runs tensor-parallel too:
each rank holds its ``param_spec`` shard of the parameters and its
``cache_spec`` slice of the cache (``init_cache(model=)``), the blocks
run their Megatron forms, and the logits, split over vocab, are gathered
over the group.
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint

from repro_torch import obs
from repro_torch.core import layout as layout_lib

from . import attention, layers, moe, sharding, ssm, tp, xlstm
from .config import ArchConfig, LayerSpec

KINDS = ("attn", "mla", "mamba", "mlstm", "slstm")
# The train path's residual between units: bfloat16, as the reference
# carries it.  A parity test may set float32 to compare two orders of
# summation (tensor-parallel against whole) without bfloat16 roundings.
RESIDUAL_DTYPE = torch.bfloat16


def _check_kinds(cfg: ArchConfig) -> None:
    for spec in cfg.unit_pattern:
        if spec.kind not in KINDS:
            raise ValueError(f"unknown unit kind {spec.kind!r}")


def _lead_pattern(cfg: ArchConfig) -> tuple[LayerSpec, ...]:
    """A leading dense layer: the unit's attention kind, a dense FFN."""
    return (LayerSpec(cfg.unit_pattern[0].kind),)


def _refuse_mla(cfg: ArchConfig, what: str) -> None:
    if cfg.kv_lora_rank or cfg.first_dense_layers:
        raise NotImplementedError(
            f"{cfg.name}: {what} of a model with latent attention (MLA) or "
            f"leading dense layers is not ported (no latent KV cache); "
            f"such a model trains only")


def _kind_member_index(cfg: ArchConfig) -> dict:
    """member position -> its index among the unit's members of its kind
    (the cache stacks each kind apart)."""
    counters: dict[str, int] = {}
    out = {}
    for i, spec in enumerate(cfg.unit_pattern):
        out[i] = counters.get(spec.kind, 0)
        counters[spec.kind] = out[i] + 1
    return out


def _kind_counts(cfg: ArchConfig) -> dict:
    counts: dict[str, int] = {}
    for spec in cfg.unit_pattern:
        counts[spec.kind] = counts.get(spec.kind, 0) + 1
    return counts


def _sinusoid(seq: int, d: int, device=None) -> torch.Tensor:
    """The whisper encoder's sinusoidal positions (seq, d), float32."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -- init ---------------------------------------------------------------------

def init_params(cfg: ArchConfig, seed: int = 0, device=None,
                shard=None) -> dict:
    """Random parameters from ``torch.Generator(seed)`` on ``device``,
    drawn in float32 and cast to ``cfg.param_dtype`` (MoE routers and the
    xLSTM gate weights stay float32, as in the reference), at the
    reference's scales and constants.  On the ``meta`` device nothing is
    drawn: the tree's shapes alone (a parameter count at full width).

    ``shard``: ``fn(path, leaf) -> leaf`` (``steps.param_shard``) applied
    to each member's leaves as soon as the member is drawn, and to the
    other leaves as each is drawn: a rank's tree, the same numbers as the
    whole tree's parts, with no more of the whole tree alive at once than
    one member.

    An encoder-decoder also has ``enc`` (``enc_layers`` attention-only
    units with a dense FFN and no qk-norm, and a final norm) and an
    ``xnorm`` / ``xattn`` pair in every decoder attention member; a model
    with a frontend has ``frontend_proj`` (d, d)."""
    _check_kinds(cfg)
    dev = torch.device("cpu" if device is None else device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    f32 = torch.float32
    d, H, KV, hd, n = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.n_units

    def normal(shape, scale, dtype=dt):
        # scaled in place: no second copy of a leaf as large as 8.4 GiB
        x = torch.randn(shape, generator=gen, device=dev)
        return x.mul_(scale).to(dtype)

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def mlp(d_ff, act, n=n):
        p = {"w_up": normal((n, d, d_ff), d ** -0.5),
             "w_down": normal((n, d_ff, d), d_ff ** -0.5)}
        if act == "swiglu":
            p["w_gate"] = normal((n, d, d_ff), d ** -0.5)
        return p

    def attn(n=n, qk_norm=cfg.qk_norm):
        p = {"wq": normal((n, d, H, hd), d ** -0.5),
             "wk": normal((n, d, KV, hd), d ** -0.5),
             "wv": normal((n, d, KV, hd), d ** -0.5),
             "wo": normal((n, H, hd, d), (H * hd) ** -0.5)}
        if qk_norm:
            p["q_norm"] = {"scale": full((n, hd), 1.0)}
            p["k_norm"] = {"scale": full((n, hd), 1.0)}
        return p

    def mla(n=n):
        r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_head_dim, \
            cfg.qk_rope_head_dim, cfg.v_head_dim
        return {"wq": normal((n, d, H, dn + dr), d ** -0.5),
                "wkv_a": normal((n, d, r + dr), d ** -0.5),
                "kv_norm": {"scale": full((n, r), 1.0)},
                "wkv_b": normal((n, r, H, dn + dv), r ** -0.5),
                "wo": normal((n, H, dv, d), (H * dv) ** -0.5)}

    def mamba(n=n):
        di, ds, dr = cfg.d_inner, cfg.ssm_d_state, cfg.dt_rank
        a_log = torch.log(torch.arange(1, ds + 1, dtype=f32, device=dev))
        return {"in_proj": normal((n, d, 2 * di), d ** -0.5),
                "conv_w": normal((n, cfg.ssm_conv, di), 0.5),
                "conv_b": full((n, di), 0.0),
                "x_proj": normal((n, di, dr + 2 * ds), di ** -0.5),
                "dt_proj": normal((n, dr, di), dr ** -0.5),
                "dt_bias": full((n, di), -4.6),     # softplus^-1(~0.01)
                "A_log": a_log.repeat(n, di, 1).to(dt),
                "D": full((n, di), 1.0),
                "out_proj": normal((n, di, d), di ** -0.5)}

    def mlstm(n=n):
        di = xlstm.mlstm_inner(cfg)
        b_if = torch.cat([torch.zeros(H, device=dev),
                          torch.full((H,), 3.0, device=dev)])
        return {"up": normal((n, d, 2 * di), d ** -0.5),
                "wq": normal((n, di, di), di ** -0.5),
                "wk": normal((n, di, di), di ** -0.5),
                "wv": normal((n, di, di), di ** -0.5),
                "w_if": normal((n, di, 2 * H), di ** -0.5, f32),
                "b_if": b_if.repeat(n, 1),
                "down": normal((n, di, d), di ** -0.5)}

    def slstm(n=n):
        dh = d // H
        return {"w_in": normal((n, d, 4 * d), d ** -0.5),
                "r": normal((n, 4, H, dh, dh), dh ** -0.5),
                "b": full((n, 4 * d), 0.0, f32),
                "down": normal((n, d, d), d ** -0.5)}

    def moe_ffn():
        E, ffe = cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
        p = {"router": normal((n, d, E), d ** -0.5, f32),
             "w_gate": normal((n, cfg.held, d, ffe), d ** -0.5),
             "w_up": normal((n, cfg.held, d, ffe), d ** -0.5),
             "w_down": normal((n, cfg.held, ffe, d), ffe ** -0.5)}
        if cfg.router_score == "sigmoid":
            p["e_score_correction_bias"] = normal((n, E), moe.BIAS_INIT, f32)
        if cfg.n_shared_experts:
            p["shared"] = mlp(cfg.n_shared_experts * ffe, "swiglu")
        return p

    blocks = {"attn": attn, "mla": mla, "mamba": mamba, "mlstm": mlstm,
              "slstm": slstm}

    def cut(prefix: str, tree: dict) -> dict:
        if shard is None:
            return tree
        flat = layout_lib.flatten(tree, prefix)
        return layout_lib.unflatten([p[len(prefix) + 1:] for p, _ in flat],
                                    [shard(p, t) for p, t in flat])

    def member(spec: LayerSpec, n=n):
        p = {"norm1": {"scale": full((n, d), 1.0)},
             spec.kind: blocks[spec.kind](n)}
        if spec.kind == "attn" and cfg.is_encdec:
            p["xnorm"] = {"scale": full((n, d), 1.0)}
            p["xattn"] = attn(qk_norm=False)
        if spec.ffn:
            p["norm2"] = {"scale": full((n, d), 1.0)}
            if spec.moe:
                p["moe"] = moe_ffn()
            else:
                p["mlp"] = mlp(cfg.d_ff, cfg.act, n)
        return p

    params = {
        "embed": cut("embed", {"table": normal((cfg.vocab, d), 0.02)}),
        "units": {f"m{i}": cut(f"units/m{i}", member(spec))
                  for i, spec in enumerate(cfg.unit_pattern)},
        "final_norm": {"scale": full((d,), 1.0)},
    }
    if cfg.first_dense_layers:
        params["lead"] = {"m0": cut("lead/m0", member(
            _lead_pattern(cfg)[0], cfg.first_dense_layers))}
    if not cfg.tie_embeddings:
        params["unembed"] = cut("unembed", {
            "w": normal((d, cfg.vocab), d ** -0.5)})
    if cfg.is_encdec:
        ne = cfg.enc_layers
        params["enc"] = cut("enc", {
            "units": {"m0": {"norm1": {"scale": full((ne, d), 1.0)},
                             "attn": attn(ne, qk_norm=False),
                             "norm2": {"scale": full((ne, d), 1.0)},
                             "mlp": mlp(cfg.d_ff, cfg.act, ne)}},
            "final_norm": {"scale": full((d,), 1.0)}})
    if cfg.frontend in ("audio", "vision"):
        w = normal((d, d), d ** -0.5)
        params["frontend_proj"] = w if shard is None else \
            shard("frontend_proj", w)
    return params


def _unbind(tree, n: int) -> list:
    """The ``n`` per-unit trees of a tree of stacked ``(n, ...)`` leaves,
    each leaf split once with ``torch.unbind`` into views (the train and
    serve paths).  The backward then has one ``UnbindBackward`` a leaf,
    which stacks the units' gradients in a single write; a ``leaf[u]``
    select a unit would fill a full-size zero tensor for each unit and
    add the ``n`` up."""
    if isinstance(tree, dict):
        per = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[u] for k, v in per.items()} for u in range(n)]
    return torch.unbind(tree, 0)


def _unembed_p(params: dict) -> dict:
    """The output projection: ``unembed``, or the embedding's transpose
    when the embeddings are tied."""
    return params.get("unembed") or {"w": params["embed"]["table"].T}


def _ffn(mp: dict, spec: LayerSpec, x: torch.Tensor, cfg: ArchConfig,
         layer: int = 0):
    """The member's FFN sub-block: (x + ffn(x), the MoE aux loss or None);
    ``layer``: the model's layer index, for its span."""
    if not spec.ffn:
        return x, None
    h2 = layers.rmsnorm(mp["norm2"], x, cfg.norm_eps)
    if spec.moe and cfg.router_score == "sigmoid":
        with obs.current().span("model.moe", layer=layer) as sp:
            y, aux = moe.moe_apply_held(mp["moe"], h2, cfg, sp)
        return x + y, aux
    if spec.moe:
        y, aux = moe.moe_apply(mp["moe"], h2, cfg)
        return x + y, aux
    return x + layers.mlp(mp["mlp"], h2, cfg.act, cfg.d_ff), None


def _apply_unit_train(x: torch.Tensor, unit_p: dict, cfg: ArchConfig,
                      positions: torch.Tensor, enc_out,
                      remat: bool = False, pattern=None, layer: int = 0):
    """One unit over the full sequence: (x, promoted to float32 by the
    float32 blocks; the unit's aux loss, float32).  A decoder attention
    member of an encoder-decoder cross-attends to ``enc_out`` after its
    self-attention.  ``remat`` checkpoints the attention blocks.
    ``pattern``: the unit's members (``cfg.unit_pattern``, or a leading
    dense layer's); ``layer``: the model's index of its first member."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(pattern or cfg.unit_pattern):
        mp = unit_p[f"m{i}"]
        h = layers.rmsnorm(mp["norm1"], x, cfg.norm_eps)
        if spec.kind == "mla":
            with obs.current().span("model.mla", layer=layer + i):
                x = x + attention.mla_forward(mp["mla"], h, cfg, positions,
                                              remat=remat)
        elif spec.kind == "attn":
            x = x + attention.attn_forward(mp["attn"], h, cfg, positions,
                                           window=cfg.sliding_window,
                                           remat=remat)
            if "xattn" in mp:
                hx = layers.rmsnorm(mp["xnorm"], x, cfg.norm_eps)
                x = x + attention.cross_attn_forward(mp["xattn"], hx,
                                                     enc_out, cfg, remat)
        elif spec.kind == "mamba":
            x = x + ssm.mamba_forward(mp["mamba"], h, cfg)
        elif spec.kind == "mlstm":
            x = x + xlstm.mlstm_forward(mp["mlstm"], h, cfg)
        elif spec.kind == "slstm":
            x = x + xlstm.slstm_forward(mp["slstm"], h, cfg)
        x, a = _ffn(mp, spec, x, cfg, layer + i)
        if a is not None:
            aux = aux + a
    return x, aux


def _frontend_proj(params: dict, cfg: ArchConfig) -> torch.Tensor:
    return tp.whole(params["frontend_proj"], -1, cfg.d_model)


def _encoder(params: dict, frames: torch.Tensor, cfg: ArchConfig,
             remat: bool = False) -> torch.Tensor:
    """The whisper encoder: frame embeddings (B, S_enc, d) -> projected,
    plus sinusoidal positions, through ``enc_layers`` bidirectional
    attention units without RoPE -> ``enc_out`` (B, S_enc, d) after the
    encoder's final norm.  The residual stays in the frames' dtype.
    ``remat`` checkpoints the attention blocks (the reference checkpoints
    no encoder unit)."""
    x = layers.matmul(frames, _frontend_proj(params, cfg))
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device)[None].to(x.dtype)
    enc = params["enc"]
    pos = torch.arange(x.shape[1], device=x.device)[None]
    for mp in _unbind(enc["units"]["m0"], cfg.enc_layers):
        h = layers.rmsnorm(mp["norm1"], x, cfg.norm_eps)
        x = x + attention.attn_forward(mp["attn"], h, cfg, pos, causal=False,
                                       use_rope=False, remat=remat)
        h2 = layers.rmsnorm(mp["norm2"], x, cfg.norm_eps)
        x = x + layers.mlp(mp["mlp"], h2, cfg.act, cfg.d_ff)
    return layers.rmsnorm(enc["final_norm"], x, cfg.norm_eps)


def _embed_inputs(params: dict, batch: dict, cfg: ArchConfig,
                  remat: bool = False):
    """Token and patch fusion: (x (B, P + S, d) with the projected patch
    prefix of P = ``batch["patches"].shape[1]`` positions (vision; P = 0
    otherwise), positions (1, P + S), the encoder's output or None)."""
    x = layers.embed(params["embed"], batch["tokens"], cfg.vocab)
    if cfg.frontend == "vision":
        patches = layers.matmul(batch["patches"], _frontend_proj(params, cfg))
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    enc_out = _encoder(params, batch["frames"], cfg, remat) \
        if cfg.is_encdec else None
    positions = torch.arange(x.shape[1], device=x.device)[None]
    return x, positions, enc_out


def _unit(x: torch.Tensor, unit_p: dict, cfg: ArchConfig, positions,
          enc_out, remat: bool, pattern=None, layer: int = 0):
    """One unit of the train path: the residual leaves it in
    ``RESIDUAL_DTYPE``."""
    x, a = _apply_unit_train(x, unit_p, cfg, positions, enc_out, remat,
                             pattern, layer)
    return x.to(RESIDUAL_DTYPE), a


def _unit_from_slice(xs: torch.Tensor, *args):
    """A unit whose saved input is the rank's slice of ``d``, gathered
    here (again on recompute)."""
    return _unit(tp.gather(xs, -1), *args)


def _backbone_train(params: dict, batch: dict, cfg: ArchConfig,
                    remat: bool = False):
    """The train path: (final hidden states (B, P + S, d) after the final
    norm, the MoE aux loss summed over units in float32).  ``remat``
    checkpoints each unit, whose saved input is the rank's slice of ``d``
    when the model group divides it."""
    x, positions, enc_out = _embed_inputs(params, batch, cfg, remat)
    x = x.to(RESIDUAL_DTYPE)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    sliced = tp.splits(cfg.d_model)
    n_lead, width = cfg.first_dense_layers, len(cfg.unit_pattern)
    units = [(unit_p, None, n_lead + u * width) for u, unit_p in
             enumerate(_unbind(params["units"], cfg.n_units))]
    if n_lead:
        units = [(unit_p, _lead_pattern(cfg), l) for l, unit_p in
                 enumerate(_unbind(params["lead"], n_lead))] + units
    for unit_p, pattern, layer in units:
        args = (unit_p, cfg, positions, enc_out, remat, pattern, layer)
        if not (remat and torch.is_grad_enabled()):
            x, a = _unit(x, *args)
        elif sliced:
            x, a = checkpoint.checkpoint(_unit_from_slice, tp.split(x, -1),
                                         *args, use_reentrant=False)
        else:
            x, a = checkpoint.checkpoint(_unit, x, *args,
                                         use_reentrant=False)
        aux = aux + a
    return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def hidden_states(params: dict, tokens: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """The train path's final hidden states (B, S, d) of a model without
    a frontend, after the final norm."""
    return _backbone_train(params, {"tokens": tokens}, cfg)[0]


def loss_fn(params: dict, batch: dict, cfg: ArchConfig, remat: bool = True):
    """Mean next-token cross entropy plus the MoE aux loss; batch =
    {tokens, labels} (B, S), and ``frames`` (B, enc_seq, d) for an
    encoder-decoder or ``patches`` (B, n_patches, d) for a vision model,
    whose prefix has no loss.  Returns ``(loss + aux, {"xent": loss,
    "aux": aux})`` as the reference does; a model without MoE has aux 0,
    and ``loss + 0`` is ``loss`` bit for bit.

    ``remat`` defaults to True, the reference's default, which the mesh
    step runs: each unit, attention query block and cross-entropy chunk
    is checkpointed (the reference checkpoints the blocks and chunks
    always; here they follow ``remat``, and no number depends on it).
    The callers that the reference runs with ``remat=False`` pass it: the
    orchestrator's clients (``fed.orchestrator``, which
    ``launch.profile_round`` drives) and the main path
    (``launch.train_lm``)."""
    h, aux = _backbone_train(params, batch, cfg, remat)
    labels = batch["labels"]
    if cfg.frontend == "vision":             # no loss on the patch prefix
        h = h[:, -labels.shape[1]:]
    loss = layers.xent_loss(_unembed_p(params), h, labels, cfg.loss_chunk,
                            remat=remat, vocab=cfg.vocab)
    return loss + aux, {"xent": loss, "aux": aux}


def value_and_grad(params: dict, batch: dict, cfg: ArchConfig,
                   remat: bool = True) -> tuple[torch.Tensor, dict]:
    """(loss + aux, grads) with grads the same tree of tensors, what the
    reference's ``make_grad_fn`` reports; ``remat`` as in
    :func:`loss_fn`."""
    flat = layout_lib.flatten(params)
    paths = [p for p, _ in flat]
    leaves = [t.detach().requires_grad_(True) for _, t in flat]
    loss, _ = loss_fn(layout_lib.unflatten(paths, leaves), batch, cfg, remat)
    # a leaf the loss does not reach (a router's selection bias) gets zeros
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), layout_lib.unflatten(paths, grads)


def param_count(params: dict) -> int:
    return sum(t.numel() for _, t in layout_lib.flatten(params))


# -- serving ------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None, model: int = 1) -> dict:
    """Decode cache sized for ``seq_len`` tokens of context, the
    reference's tree: ``pos`` (0-d int32), and for each kind of member in
    the unit a stack ``(n_units, members of the kind, ...)``:
    ``attn.{k, v, pos_arr}`` (in ``dtype``; a ring of the window's size if
    ``cfg.sliding_window`` is smaller), ``mamba.{conv, ssm}``,
    ``mlstm.{C, n}`` and ``slstm.{h, c, n, m}`` (float32); an
    encoder-decoder's ``xattn.{k, v}`` ``(n_units, attention members, B,
    enc_seq, KV, hd)`` in ``dtype``, the encoder's keys and values that
    ``prefill`` fills.  A vision model's prompt holds its patch prefix
    too: ``seq_len`` counts it.

    ``model``: the size of the mesh's model axis; each leaf is then the
    one rank's ``sharding.cache_spec`` slice, the dims it splits over
    ``model`` cut by ``model`` (``batch`` is the rank's already).  A
    model with latent attention or leading dense layers is refused."""
    _check_kinds(cfg)
    _refuse_mla(cfg, "serving")
    counts = _kind_counts(cfg)
    n = cfg.n_units
    shapes: dict = {"pos": ((), torch.int32, 0)}
    if "attn" in counts:
        cap = min(seq_len, cfg.sliding_window) if cfg.sliding_window \
            else seq_len
        kv = (n, counts["attn"], batch, cap, cfg.n_kv_heads, cfg.hd)
        shapes["attn/k"] = shapes["attn/v"] = (kv, dtype, 0.0)
        shapes["attn/pos_arr"] = ((n, counts["attn"], cap), torch.int32, -1)
    if "mamba" in counts:
        di = cfg.d_inner
        shapes["mamba/conv"] = ((n, counts["mamba"], batch, cfg.ssm_conv - 1,
                                 di), torch.float32, 0.0)
        shapes["mamba/ssm"] = ((n, counts["mamba"], batch, di,
                                cfg.ssm_d_state), torch.float32, 0.0)
    if "mlstm" in counts:
        H = cfg.n_heads
        dh = xlstm.mlstm_inner(cfg) // H
        shape = (n, counts["mlstm"], batch, H, dh)
        shapes["mlstm/C"] = (shape + (dh,), torch.float32, 0.0)
        shapes["mlstm/n"] = (shape, torch.float32, 0.0)
    if "slstm" in counts:
        H = cfg.n_heads
        shape = (n, counts["slstm"], batch, H, cfg.d_model // H)
        for k in ("h", "c", "n", "m"):
            shapes[f"slstm/{k}"] = (shape, torch.float32,
                                    -1e9 if k == "m" else 0.0)
    if cfg.is_encdec:
        shape = (n, counts["attn"], batch, cfg.enc_seq, cfg.n_kv_heads,
                 cfg.hd)
        shapes["xattn/k"] = shapes["xattn/v"] = (shape, dtype, 0.0)
    axes = {}
    if model > 1:
        axes = sharding.cache_shard_axes(
            layout_lib.unflatten(list(shapes), [
                torch.empty(s, device="meta") for s, _, _ in shapes.values()]),
            cfg, {"model": model})
    leaves = []
    for path, (shape, dt, fill) in shapes.items():
        shape = list(shape)
        if "model" in axes.get(path, {}):
            shape[axes[path]["model"]] //= model
        leaves.append(torch.full(shape, fill, dtype=dt, device=device))
    return layout_lib.unflatten(list(shapes), leaves)


def _serve_member(kind: str, p: dict, h: torch.Tensor, cfg: ArchConfig,
                  st: dict, pos) -> torch.Tensor:
    """One member's block on the serve path against its state ``st`` (the
    cache's views for this unit and member, updated in place): prefill
    when ``pos`` is None, else one decode step at position ``pos``."""
    window = cfg.sliding_window
    if kind == "attn":
        if pos is None:
            out, *_ = attention.attn_prefill(p, h, cfg, st["k"], st["v"],
                                             st["pos_arr"], window=window)
        else:
            out, *_ = attention.attn_decode(p, h, cfg, st["k"], st["v"],
                                            st["pos_arr"], pos, window=window)
        return out
    if kind == "mamba":
        if pos is None:
            out, conv, h_ssm = ssm.mamba_prefill(p, h, cfg)
        else:
            out, conv, h_ssm = ssm.mamba_decode(
                p, h, st["conv"].to(h.dtype), st["ssm"], cfg)
        st["conv"].copy_(conv)
        st["ssm"].copy_(h_ssm)
        return out
    if kind == "mlstm":
        if pos is None:
            out, (C, n) = xlstm.mlstm_forward(p, h, cfg, return_state=True)
        else:
            out, C, n = xlstm.mlstm_decode(p, h, st["C"], st["n"], cfg)
        st["C"].copy_(C)
        st["n"].copy_(n)
        return out
    names = ("h", "c", "n", "m")
    if pos is None:
        out, new = xlstm.slstm_forward(p, h, cfg, return_state=True)
        # computed whole; the cache holds the rank's slice of the last dim
        new = tuple(v if v.shape == st[k].shape else tp.shard_of(v, -1)
                    for k, v in zip(names, new))
    else:
        out, new = xlstm.slstm_decode(p, h, tuple(st[k] for k in names), cfg)
    for k, v in zip(names, new):
        st[k].copy_(v)
    return out


def _serve_cross(p: dict, h: torch.Tensor, cfg: ArchConfig, st: dict,
                 enc_out) -> torch.Tensor:
    """Cross-attention on the serve path against ``st`` (this member's
    ``xattn`` views, the rank's ``cache_spec`` slice under
    ``tp.model_parallel``): prefill computes the encoder's keys and
    values from ``enc_out``, writes them into the cache and attends over
    the fresh ones; decode (``enc_out`` None) attends over the cached
    ones."""
    if enc_out is not None:
        return attention.cross_prefill(p, h, enc_out, cfg, st["k"], st["v"])
    return attention.cross_decode(p, h, st["k"], st["v"], cfg)


def _serve(params: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict,
           pos, enc_out=None) -> torch.Tensor:
    """Every unit of the serve path: a prefill when ``pos`` is None, else
    one decode step at position ``pos``.  Returns the last position's
    logits (B, V), gathered over the model group when the unembedding is
    the rank's vocab shard."""
    kmi = _kind_member_index(cfg)
    for u, unit_p in enumerate(_unbind(params["units"], cfg.n_units)):
        for i, spec in enumerate(cfg.unit_pattern):
            mp = unit_p[f"m{i}"]
            h = layers.rmsnorm(mp["norm1"], x, cfg.norm_eps)
            st = {k: v[u, kmi[i]] for k, v in cache[spec.kind].items()}
            x = x + _serve_member(spec.kind, mp[spec.kind], h, cfg, st, pos)
            if "xattn" in mp:
                hx = layers.rmsnorm(mp["xnorm"], x, cfg.norm_eps)
                st = {k: v[u, kmi[i]] for k, v in cache["xattn"].items()}
                x = x + _serve_cross(mp["xattn"], hx, cfg, st, enc_out)
            x, _ = _ffn(mp, spec, x, cfg)
    h = layers.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    un = _unembed_p(params)
    logits = layers.unembed(un, h)[:, 0]
    return logits if un["w"].shape[-1] == cfg.vocab else tp.gather(logits, -1)


def prefill(params: dict, batch: dict, cfg: ArchConfig,
            cache: dict) -> tuple[torch.Tensor, dict]:
    """Forward over the prompt ``batch["tokens"]`` (B, S), and the
    ``frames`` or ``patches`` of a model with a frontend, filling every
    member's cache.  Returns (last-position logits (B, V), cache).  A
    vision model's patch prefix takes the first ``n_patches`` positions,
    so ``cache["pos"]`` is then ``n_patches + S``.

    The cache is updated in place (and returned): two runs that must not
    share state need caches of their own.
    """
    _refuse_mla(cfg, "prefill")
    x, _, enc_out = _embed_inputs(params, batch, cfg)
    logits = _serve(params, x, cfg, cache, None, enc_out)
    cache["pos"] = torch.full((), x.shape[1], dtype=torch.int32,
                              device=x.device)
    return logits, cache


def decode_step(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One-token decode; tokens: (B, 1).  Returns (logits (B, V), cache).

    The position is read from ``cache["pos"]`` on the device: no host sync
    a token.  The cache is updated in place (and returned), ``pos``
    advanced by one in place, so a CUDA graph that captured the step reads
    the next position at its next replay.
    """
    _refuse_mla(cfg, "decode")
    x = layers.embed(params["embed"], tokens, cfg.vocab)
    logits = _serve(params, x, cfg, cache, cache["pos"])
    cache["pos"].add_(1)
    return logits, cache
