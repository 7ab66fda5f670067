"""train.mfu: the clients' forward and backward FLOPs over the traced
window's wall time, as a share of the H100's float32 peak (the
configurations state float32 products with TF32 off).

FLOPs are counted from shapes, as the model needs them: each matrix
product's 2 * m * n * k, causal attention over the S(S+1)/2 pairs it
uses, the output head over every position, and a backward pass of twice
the forward.  Nothing recomputed counts."""


def forward_flops(cfg: dict, batch: int, seq: int) -> int:
    d, L, H, KV = cfg["d_model"], cfg["n_layers"], cfg["n_heads"], \
        cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    n_mlp = 3 if cfg["act"] == "swiglu" else 2
    per_token = L * 2 * (d * H * hd + 2 * d * KV * hd + H * hd * d
                         + n_mlp * d * cfg["d_ff"]) + 2 * d * cfg["vocab"]
    attn = L * 2 * H * hd * seq * (seq + 1)      # q.k and p.v, causal
    return batch * (seq * per_token + attn)


def read(ctx):
    if not ctx.clients or ctx.window_s <= 0:
        return None
    flops = sum(3 * forward_flops(ctx.config, n, s) for n, s in ctx.clients)
    return 100.0 * flops / (ctx.window_s * ctx.peaks["fp32_flops"])
