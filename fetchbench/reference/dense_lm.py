"""Plain reference of the dense decoder family (GPT-2 small as the port
runs it, InternLM2): pre-norm blocks of causal GQA attention with rotary
positions and a GELU or SwiGLU MLP, RMS norms, an output head of its own
or tied to the embedding (the head is then the table's transpose).

Written from the published architecture and the precision the
configuration states, with plain ``torch`` operations in float32; it
shares no code with the program under test.

* Parameters are one flat float32 vector; each leaf is a view of it, in
  the sorted-path order that defines FetchSGD's flat ids (``param_spec``).
  Layers are stacked on a leading ``n_layers`` dim.
* Training numerics, as the configuration states them: the residual
  stream crosses each layer boundary in bfloat16 (the embedding output,
  each layer's output, the first norm's output and the final norm's
  output are rounded to it); everything else is float32.
* Serving numerics, as the configuration states them: float32, with keys
  and values held in the cache's type (bfloat16).  The prefill attends
  over its own float32 keys and values; every decode step attends over
  the cache, so a query after the prompt reads keys and values rounded to
  the cache's type, its own among them.
* The controls, each one step below what the configuration states:
  ``lowp`` rounds every matrix product's operands to TF32's 10-bit
  mantissa first (a TF32 tensor-core product accumulates in float32);
  ``kv_dtype`` holds the cache in another type (float8 e4m3).
"""

from __future__ import annotations

import math

import torch
from torch.utils import checkpoint

BF16 = torch.bfloat16
F32 = torch.float32
LOSS_ROWS = 4096      # tokens per checkpointed cross-entropy block
# keys of a configuration file read here and not by the program, which
# runs RMS norms and rotary positions without biases
READS = ("norm", "positions", "bias")
# micro widths, for the CPU tests
MICRO = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab": 256}


def check_family(cfg: dict) -> None:
    want = {"norm": "rmsnorm", "positions": "rope", "bias": False}
    for key, value in want.items():
        if cfg.get(key) != value:
            raise ValueError(f"dense_lm covers {key}={value!r}, "
                             f"not {cfg.get(key)!r}")
    if not isinstance(cfg.get("tie_embeddings"), bool):
        raise ValueError("dense_lm needs tie_embeddings true or false")
    if cfg["act"] not in ("gelu", "swiglu"):
        raise ValueError(f"unknown act {cfg['act']!r}")


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def param_spec(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(path, shape) of every leaf, in flat-id order."""
    check_family(cfg)
    L, d, H, KV = cfg["n_layers"], cfg["d_model"], cfg["n_heads"], \
        cfg["n_kv_heads"]
    hd, ff, V = head_dim(cfg), cfg["d_ff"], cfg["vocab"]
    u = "units/m0/"
    leaves = {"embed/table": (V, d), "final_norm/scale": (d,),
              u + "attn/wq": (L, d, H, hd), u + "attn/wk": (L, d, KV, hd),
              u + "attn/wv": (L, d, KV, hd), u + "attn/wo": (L, H, hd, d),
              u + "mlp/w_up": (L, d, ff), u + "mlp/w_down": (L, ff, d),
              u + "norm1/scale": (L, d), u + "norm2/scale": (L, d)}
    if cfg["act"] == "swiglu":
        leaves[u + "mlp/w_gate"] = (L, d, ff)
    if not cfg["tie_embeddings"]:
        leaves["unembed/w"] = (d, V)
    return sorted(leaves.items(), key=lambda kv: kv[0].split("/"))


def n_params(spec) -> int:
    return sum(math.prod(s) for _, s in spec)


def init_scale(path: str, shape, cfg: dict) -> float | None:
    """Standard deviation of a leaf's normal init; None: ones (norms)."""
    name = path.split("/")[-1]
    if name == "scale":
        return None
    if path == "embed/table":
        return 0.02
    if path == "unembed/w":
        return shape[0] ** -0.5
    if name == "wo":                       # (L, H, hd, d)
        return (shape[1] * shape[2]) ** -0.5
    return shape[1] ** -0.5                # (L, fan_in, ...)


def init_flat(spec, cfg: dict, seed: int, device) -> torch.Tensor:
    """The weights from ``seed``: one normal draw on ``device``, scaled
    leaf by leaf."""
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(n_params(spec), dtype=F32, device=device)
    flat.normal_(generator=gen)
    off = 0
    for path, shape in spec:
        n = math.prod(shape)
        scale = init_scale(path, shape, cfg)
        if scale is None:
            flat[off:off + n].fill_(1.0)
        else:
            flat[off:off + n].mul_(scale)
        off += n
    return flat


def leaves(flat: torch.Tensor, spec) -> dict[str, torch.Tensor]:
    out, off = {}, 0
    for path, shape in spec:
        n = math.prod(shape)
        out[path] = flat[off:off + n].view(shape)
        off += n
    return out


def leaf_spans(spec) -> list[tuple[str, int, int]]:
    out, off = [], 0
    for path, shape in spec:
        n = math.prod(shape)
        out.append((path, off, n))
        off += n
    return out


# -- arithmetic ----------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest even at TF32's 10-bit mantissa."""
    b = x.to(F32).contiguous().view(torch.int32)
    b = (b + (0xFFF + ((b >> 13) & 1))) & ~0x1FFF
    return b.view(F32)


class _Operand(torch.autograd.Function):
    """A product's operand at TF32's precision; its gradient passes."""

    @staticmethod
    def forward(ctx, x):
        return tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Product(torch.autograd.Function):
    """A product's output as it is; the gradient coming back, an operand
    of the backward's products, at TF32's precision."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tf32(g)


def mm(eq: str, a: torch.Tensor, b: torch.Tensor, lowp: bool
       ) -> torch.Tensor:
    """A product in float32; ``lowp``: at TF32's precision, forward and
    backward."""
    a, b = a.to(F32), b.to(F32)
    if not lowp:
        return torch.einsum(eq, a, b)
    return _Product.apply(torch.einsum(eq, _Operand.apply(a),
                                       _Operand.apply(b)))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    x = x.to(F32)
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = pos.to(F32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def cache_dtype(cfg: dict) -> torch.dtype:
    """The KV cache's type as the configuration states it."""
    return getattr(torch, cfg["precision"]["kv_cache"])


def head(P: dict) -> torch.Tensor:
    """The output head (d, V): its own leaf, or the embedding's
    transpose."""
    return P["unembed/w"] if "unembed/w" in P else P["embed/table"].T


def _scores_out(q, k, v, causal, hd, lowp):
    s = mm("bqkgh,bskh->bkgqs", q, k, lowp) * hd ** -0.5
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return mm("bkgqs,bskh->bqkgh", p, v, lowp)


def attention(P: dict, l: int, h: torch.Tensor, cfg: dict, lowp: bool,
              cached: int | None = None, kv_dtype=BF16) -> torch.Tensor:
    """Causal self-attention of layer ``l`` over h (B, S, d).  ``cached``:
    the queries from this position on read keys and values rounded to
    ``kv_dtype``, as decode steps read them from the cache."""
    u = "units/m0/attn/"
    S = h.shape[1]
    pos = torch.arange(S, device=h.device)
    q = rope(mm("bsd,dhk->bshk", h, P[u + "wq"][l], lowp), pos,
             cfg["rope_theta"])
    k = rope(mm("bsd,dhk->bshk", h, P[u + "wk"][l], lowp), pos,
             cfg["rope_theta"])
    v = mm("bsd,dhk->bshk", h, P[u + "wv"][l], lowp)
    B, KV, hd = h.shape[0], cfg["n_kv_heads"], head_dim(cfg)
    q = q.reshape(B, S, KV, cfg["n_heads"] // KV, hd)  # head kv * G + g
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    c = S if cached is None else cached
    o = _scores_out(q[:, :c], k, v, causal[:c], hd, lowp)
    if c < S:
        kc, vc = (t.to(kv_dtype).to(F32) for t in (k, v))
        o = torch.cat([o, _scores_out(q[:, c:], kc, vc, causal[c:], hd,
                                      lowp)], dim=1)
    o = o.reshape(B, S, -1, hd)
    return mm("bshk,hkd->bsd", o, P[u + "wo"][l], lowp)


def mlp(P: dict, l: int, h: torch.Tensor, cfg: dict, lowp: bool
        ) -> torch.Tensor:
    u = "units/m0/mlp/"
    up = mm("bsd,df->bsf", h, P[u + "w_up"][l], lowp)
    if cfg["act"] == "swiglu":
        a = torch.nn.functional.silu(
            mm("bsd,df->bsf", h, P[u + "w_gate"][l], lowp)) * up
    else:
        a = torch.nn.functional.gelu(up, approximate="tanh")
    return mm("bsf,fd->bsd", a, P[u + "w_down"][l], lowp)


# -- training --------------------------------------------------------------------

def _xent_block(h, w, labels, lowp):
    logits = mm("td,dv->tv", h, w, lowp)
    gold = logits.gather(-1, labels[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def by_layer(P: dict) -> dict:
    """Stacked leaves as tuples of layers: the backward then stacks the
    layers' gradients once, where indexing each layer would add a
    zero-filled leaf a layer."""
    return {k: v.unbind(0) if k.startswith("units/") else v
            for k, v in P.items()}


def train_loss(P: dict, tokens: torch.Tensor, labels: torch.Tensor,
               cfg: dict, lowp: bool = False) -> torch.Tensor:
    """Mean next-token cross entropy, with the training numerics."""
    eps = cfg["norm_eps"]
    P = by_layer(P)
    x = P["embed/table"][tokens].to(BF16)
    for l in range(cfg["n_layers"]):
        h = rmsnorm(x, P["units/m0/norm1/scale"][l], eps).to(BF16)
        x = x.to(F32) + attention(P, l, h, cfg, lowp)
        h2 = rmsnorm(x, P["units/m0/norm2/scale"][l], eps)
        x = (x + mlp(P, l, h2, cfg, lowp)).to(BF16)
    h = rmsnorm(x, P["final_norm/scale"], eps).to(BF16).to(F32)
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


# -- serving -------------------------------------------------------------------

@torch.no_grad()
def serve_logits(P: dict, tokens: torch.Tensor, start: int, cfg: dict,
                 lowp: bool = False, kv_dtype=None) -> torch.Tensor:
    """Logits (B, T - start, V) of positions start .. T - 1 of the full
    causal forward over tokens (B, T), with the serving numerics: the
    prompt is tokens[:, :start + 1], and every later position reads the
    cached keys and values."""
    eps = cfg["norm_eps"]
    kv_dtype = kv_dtype or cache_dtype(cfg)
    P = by_layer(P)
    x = P["embed/table"][tokens]
    for l in range(cfg["n_layers"]):
        h = rmsnorm(x, P["units/m0/norm1/scale"][l], eps)
        x = x + attention(P, l, h, cfg, lowp, start + 1, kv_dtype)
        h2 = rmsnorm(x, P["units/m0/norm2/scale"][l], eps)
        x = x + mlp(P, l, h2, cfg, lowp)
    h = rmsnorm(x[:, start:], P["final_norm/scale"], eps)
    return mm("bsd,dv->bsv", h, head(P), lowp)
