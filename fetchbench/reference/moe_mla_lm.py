"""Plain reference of the DeepSeek-V3 decoder family (Moonlight-16B-A3B):
pre-norm blocks of latent attention (MLA) with no query LoRA, a leading
dense SwiGLU layer, then layers of sigmoid-routed experts with shared
experts; RMS norms, rotary positions, an untied output head.

Written from the published architecture (``modeling_deepseek.py``'s
equations, restated below) and the precision the configuration states,
with plain ``torch`` operations in float32; it shares no code with the
program under test.  Per token ``x`` of a layer ``l``:

* MLA: ``q = x W_q``, each head's ``qk_nope_head_dim`` plain dims then
  ``qk_rope_head_dim`` rotary ones; ``[c, k_r] = x W_kva``; ``[k_nope, v]
  = rmsnorm(c) W_kvb`` a head; RoPE on the queries' rotary dims and on the
  one ``k_r`` every head shares; ``k = [k_nope, k_r]``; causal softmax at
  scale ``(qk_nope + qk_rope)^-1/2``; ``o W_o``.
* The expert layer: ``s = sigmoid(x W_r)`` over all ``n_routed_experts``;
  the ``num_experts_per_tok`` largest ``s + e_score_correction_bias`` are
  picked (``noaux_tc`` with one group: the group step is the identity);
  gates ``s`` of the picks over their sum (``norm_topk_prob``) times
  ``routed_scaling_factor``; each held expert's SwiGLU on its tokens,
  gated, summed into the token; plus the shared experts (one SwiGLU of
  width ``n_shared_experts * moe_intermediate_size``) for every token.

Departures, each also in the configuration's ``assumed``:

* RoPE rotates the two halves of the rotary dims; the published code
  permutes interleaved pairs into that order first, which with weights
  from a seed is a relabelling of the rotary columns.
* Only the experts ``0 .. experts_held - 1`` are held: what the experts
  held on the deployment's other chips would add is left out, here as in
  the program.
* The selection bias is drawn from the seed (``BIAS_STD``) and gets no
  gradient, as in the published recipe, whose bias update runs outside
  the gradient and is not run here; no auxiliary loss.

Parameters are one flat float32 vector; each leaf is a view of it, in the
sorted-path order that defines FetchSGD's flat ids (``param_spec``): the
leading dense layers under ``lead/m0/``, the expert layers under
``units/m0/``, each stacked on a leading dim.  Training numerics as
``dense_lm``'s: the residual stream crosses each layer boundary in
bfloat16, everything else float32.  Each layer is checkpointed (its
backward recomputes it), so that the reference fits on the card beside
the gradients at the published widths.  The control ``lowp`` rounds every
product's operands to TF32's mantissa, the routers' included.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from fetchbench.reference.dense_lm import (LOSS_ROWS, _scores_out,
                                           _xent_block, head, leaf_spans,
                                           leaves, mm, n_params, rmsnorm,
                                           rope)

BF16 = torch.bfloat16
F32 = torch.float32
# the selection bias's draw: a tenth of the scores' spread at init
BIAS_STD = 0.02
# the published config.json's keys that give a width or count the
# program's ArchConfig names otherwise: both are stated, and must agree
PUBLISHED = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
             "num_attention_heads": "n_heads",
             "num_key_value_heads": "n_kv_heads",
             "intermediate_size": "d_ff",
             "moe_intermediate_size": "moe_d_ff",
             "n_routed_experts": "n_experts",
             "num_experts_per_tok": "expert_top_k",
             "first_k_dense_replace": "first_dense_layers",
             "routed_scaling_factor": "routed_scale",
             "rms_norm_eps": "norm_eps", "vocab_size": "vocab",
             "tie_word_embeddings": "tie_embeddings"}
# the published keys that fix this family's equations, at the values it
# computes
FIXED = {"model_type": "deepseek_v3", "hidden_act": "silu",
         "scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
         "topk_group": 1, "norm_topk_prob": True, "q_lora_rank": None,
         "attention_bias": False, "moe_layer_freq": 1,
         "num_nextn_predict_layers": 0, "tie_word_embeddings": False}
# ep_size: the published code's own expert-parallel degree, not this
# deployment's; seq_aux: a training-time auxiliary loss, not run;
# max_position_embeddings: bounds the sequence
READS = tuple(PUBLISHED) + tuple(k for k in FIXED if k not in PUBLISHED) \
    + ("ep_size", "seq_aux", "max_position_embeddings")
# micro widths, for the CPU tests: one leading dense and two expert
# layers, 8 experts of which 4 held, 3 a token, 2 shared
MICRO = {"n_layers": 3, "first_dense_layers": 1, "d_model": 64,
         "n_heads": 4, "n_kv_heads": 4, "kv_lora_rank": 32,
         "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
         "d_ff": 128, "moe_d_ff": 32, "n_experts": 8, "experts_held": 4,
         "expert_top_k": 3, "n_shared_experts": 2, "vocab": 256}
MICRO.update({pub: MICRO[ours] for pub, ours in PUBLISHED.items()
              if ours in MICRO})


def check_family(cfg: dict) -> None:
    for pub, ours in PUBLISHED.items():
        if cfg[pub] != cfg[ours]:
            raise ValueError(f"moe_mla_lm: {pub} {cfg[pub]!r} is not "
                             f"{ours} {cfg[ours]!r}")
    for key, value in FIXED.items():
        if cfg.get(key, "missing") != value:
            raise ValueError(f"moe_mla_lm covers {key}={value!r}, not "
                             f"{cfg.get(key, 'missing')!r}")
    if cfg["router_score"] != "sigmoid":
        raise ValueError("moe_mla_lm routes by sigmoid scores")
    if not 0 < cfg["experts_held"] <= cfg["n_experts"]:
        raise ValueError(f"experts_held {cfg['experts_held']} of "
                         f"{cfg['n_experts']}")


def _dims(cfg: dict):
    return (cfg["d_model"], cfg["n_heads"], cfg["kv_lora_rank"],
            cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
            cfg["v_head_dim"])


def param_spec(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(path, shape) of every leaf, in flat-id order."""
    check_family(cfg)
    d, H, r, dn, dr, dv = _dims(cfg)
    Ld = cfg["first_dense_layers"]
    Lm = cfg["n_layers"] - Ld
    ff, ffe, V = cfg["d_ff"], cfg["moe_d_ff"], cfg["vocab"]
    E, Eh, fs = cfg["n_experts"], cfg["experts_held"], \
        cfg["n_shared_experts"] * cfg["moe_d_ff"]

    def block(pre, n):
        return {pre + "mla/wq": (n, d, H, dn + dr),
                pre + "mla/wkv_a": (n, d, r + dr),
                pre + "mla/kv_norm/scale": (n, r),
                pre + "mla/wkv_b": (n, r, H, dn + dv),
                pre + "mla/wo": (n, H, dv, d),
                pre + "norm1/scale": (n, d), pre + "norm2/scale": (n, d)}

    leaves_ = {"embed/table": (V, d), "final_norm/scale": (d,),
               "unembed/w": (d, V)}
    if Ld:
        m = "lead/m0/mlp/"
        leaves_.update(block("lead/m0/", Ld))
        leaves_.update({m + "w_gate": (Ld, d, ff), m + "w_up": (Ld, d, ff),
                        m + "w_down": (Ld, ff, d)})
    u = "units/m0/moe/"
    leaves_.update(block("units/m0/", Lm))
    leaves_.update({u + "router": (Lm, d, E),
                    u + "e_score_correction_bias": (Lm, E),
                    u + "w_gate": (Lm, Eh, d, ffe), u + "w_up": (Lm, Eh, d, ffe),
                    u + "w_down": (Lm, Eh, ffe, d),
                    u + "shared/w_gate": (Lm, d, fs),
                    u + "shared/w_up": (Lm, d, fs),
                    u + "shared/w_down": (Lm, fs, d)})
    return sorted(leaves_.items(), key=lambda kv: kv[0].split("/"))


def init_scale(path: str, shape) -> float | None:
    """Standard deviation of a leaf's normal init; None: ones (norms)."""
    parts = path.split("/")
    if parts[-1] == "scale":
        return None
    if path == "embed/table":
        return 0.02
    if path == "unembed/w":
        return shape[0] ** -0.5
    if parts[-1] == "e_score_correction_bias":
        return BIAS_STD
    if parts[-1] == "wo":                          # (L, H, dv, d)
        return (shape[1] * shape[2]) ** -0.5
    if parts[-2] == "moe":                         # (L, E, fan_in, out)
        return shape[2] ** -0.5
    return shape[1] ** -0.5                        # (L, fan_in, ...)


def init_flat(spec, cfg: dict, seed: int, device) -> torch.Tensor:
    """The weights from ``seed``: one normal draw on ``device``, scaled
    leaf by leaf."""
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(n_params(spec), dtype=F32, device=device)
    flat.normal_(generator=gen)
    for (path, shape), (_, off, n) in zip(spec, leaf_spans(spec)):
        scale = init_scale(path, shape)
        if scale is None:
            flat[off:off + n].fill_(1.0)
        else:
            flat[off:off + n].mul_(scale)
    return flat


# -- the blocks ------------------------------------------------------------------

def mla(P: dict, pre: str, l: int, h: torch.Tensor, cfg: dict,
        lowp: bool) -> torch.Tensor:
    """Causal latent attention of layer ``l`` over h (B, S, d)."""
    d, H, r, dn, dr, dv = _dims(cfg)
    B, S, _ = h.shape
    a, theta = pre + "mla/", cfg["rope_theta"]
    pos = torch.arange(S, device=h.device)
    q = mm("bsd,dhk->bshk", h, P[a + "wq"][l], lowp)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, theta)], dim=-1)
    kva = mm("bsd,dk->bsk", h, P[a + "wkv_a"][l], lowp)
    c = rmsnorm(kva[..., :r], P[a + "kv_norm/scale"][l], cfg["norm_eps"])
    k_r = rope(kva[..., None, r:], pos, theta)                 # (B, S, 1, dr)
    kv = mm("bsr,rhk->bshk", c, P[a + "wkv_b"][l], lowp)
    k = torch.cat([kv[..., :dn], k_r.expand(B, S, H, dr)], dim=-1)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    # every head its own key and value: dense_lm's scores with one query
    # head a key head
    o = _scores_out(q.reshape(B, S, H, 1, dn + dr), k, kv[..., dn:], causal,
                    dn + dr, lowp)
    return mm("bshk,hkd->bsd", o.reshape(B, S, H, dv), P[a + "wo"][l], lowp)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down, lowp: bool
           ) -> torch.Tensor:
    up = mm("...d,df->...f", x, w_up, lowp)
    a = F.silu(mm("...d,df->...f", x, w_gate, lowp)) * up
    return mm("...f,fd->...d", a, w_down, lowp)


def route(P: dict, l: int, x: torch.Tensor, cfg: dict, lowp: bool):
    """(picked experts (T, K), their gates (T, K)) of tokens x (T, d)."""
    u = "units/m0/moe/"
    s = torch.sigmoid(mm("td,de->te", x, P[u + "router"][l], lowp))
    bias = P[u + "e_score_correction_bias"][l].detach()
    idx = torch.topk(s.detach() + bias, cfg["expert_top_k"], dim=-1).indices
    g = s.gather(1, idx)
    return idx, g / (g.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scale"]


def experts(P: dict, l: int, h: torch.Tensor, cfg: dict, lowp: bool
            ) -> torch.Tensor:
    """The expert layer of expert layer ``l`` over h (B, S, d): the held
    experts' gated outputs and the shared experts'."""
    u = "units/m0/moe/"
    B, S, d = h.shape
    x = h.reshape(B * S, d)
    idx, gate = route(P, l, x, cfg, lowp)
    ws = [P[u + k][l].unbind(0) for k in ("w_gate", "w_up", "w_down")]
    # the (token, pick) pairs of each held expert, expert by expert
    sel = [(idx == e).nonzero(as_tuple=True)
           for e in range(cfg["experts_held"])]
    tok, pick = (torch.cat(t) for t in zip(*sel))
    xs = x[tok].split([len(t) for t, _ in sel])
    out = torch.cat([swiglu(xe, ws[0][e], ws[1][e], ws[2][e], lowp)
                     for e, xe in enumerate(xs)])
    picks = x.new_zeros(B * S, cfg["expert_top_k"], d)   # each pick's output
    picks = picks.index_put((tok, pick), out * gate[tok, pick, None])
    y = picks.sum(dim=1) + swiglu(x, P[u + "shared/w_gate"][l],
                                  P[u + "shared/w_up"][l],
                                  P[u + "shared/w_down"][l], lowp)
    return y.reshape(B, S, d)


def _layer(P: dict, pre: str, l: int, cfg: dict, lowp: bool,
           x: torch.Tensor) -> torch.Tensor:
    """Layer ``l`` of the stack under ``pre``: bfloat16 in and out."""
    eps = cfg["norm_eps"]
    h = rmsnorm(x, P[pre + "norm1/scale"][l], eps).to(BF16)
    x = x.to(F32) + mla(P, pre, l, h, cfg, lowp)
    h2 = rmsnorm(x, P[pre + "norm2/scale"][l], eps)
    if pre == "lead/m0/":
        m = pre + "mlp/"
        y = swiglu(h2, P[m + "w_gate"][l], P[m + "w_up"][l],
                   P[m + "w_down"][l], lowp)
    else:
        y = experts(P, l, h2, cfg, lowp)
    return (x + y).to(BF16)


# -- training --------------------------------------------------------------------

def by_layer(P: dict) -> dict:
    """Stacked leaves as tuples of layers, split once."""
    return {k: v.unbind(0) if k.startswith(("lead/", "units/")) else v
            for k, v in P.items()}


def train_loss(P: dict, tokens: torch.Tensor, labels: torch.Tensor,
               cfg: dict, lowp: bool = False) -> torch.Tensor:
    """Mean next-token cross entropy, with the training numerics."""
    if tokens.shape[1] > cfg["max_position_embeddings"]:
        raise ValueError("sequence longer than max_position_embeddings")
    P = by_layer(P)
    x = P["embed/table"][tokens].to(BF16)
    Ld = cfg["first_dense_layers"]
    stack = [("lead/m0/", l) for l in range(Ld)] + \
        [("units/m0/", l) for l in range(cfg["n_layers"] - Ld)]
    for pre, l in stack:
        x = checkpoint.checkpoint(functools.partial(_layer, P, pre, l, cfg,
                                                    lowp), x,
                                  use_reentrant=False)
    h = rmsnorm(x, P["final_norm/scale"], cfg["norm_eps"]).to(BF16).to(F32)
    h = h.reshape(-1, h.shape[-1])
    labels = labels.reshape(-1)
    total = h.new_zeros(())
    for t0 in range(0, h.shape[0], LOSS_ROWS):
        total = total + checkpoint.checkpoint(
            _xent_block, h[t0:t0 + LOSS_ROWS], head(P),
            labels[t0:t0 + LOSS_ROWS], lowp, use_reentrant=False)
    return total / labels.numel()


def loss_and_grad(flat: torch.Tensor, spec, tokens: torch.Tensor,
                  labels: torch.Tensor, cfg: dict, lowp: bool = False
                  ) -> tuple[float, torch.Tensor]:
    """(loss, flat gradient) of one client's batch."""
    w = flat.detach().requires_grad_(True)
    loss = train_loss(leaves(w, spec), tokens, labels, cfg, lowp)
    (grad,) = torch.autograd.grad(loss, [w])
    return float(loss.detach()), grad


# -- serving ---------------------------------------------------------------------

def cache_dtype(cfg: dict):
    raise NotImplementedError("moe_mla_lm has no serving: the program has "
                              "no latent attention (MLA) KV cache")


def serve_logits(P: dict, tokens: torch.Tensor, start: int, cfg: dict,
                 **lowp):
    return cache_dtype(cfg)
