"""train.mfu_moe_mla: the clients' forward and backward FLOPs over the
traced window's wall time, as a share of the H100's float32 peak (the
configuration states float32 products with TF32 off), for the
DeepSeek-V3 block of ``moe_mla_lm``.

FLOPs are counted from shapes, as the model needs them, each matrix
product's 2 * m * n * k a token: the latent attention's four projections
and its causal core over the S(S+1)/2 pairs it uses; the leading dense
layers' SwiGLU; in each expert layer the router, the shared experts and
the held experts at the expected pairs a token, ``expert_top_k *
experts_held / n_experts`` (the model's work under uniform routing, not
the program's count); the output head over every position; and a
backward pass of twice the forward.  Nothing recomputed counts."""


def forward_flops(cfg: dict, batch: int, seq: int) -> float:
    d, H, V = cfg["d_model"], cfg["n_heads"], cfg["vocab"]
    r, dn, dr, dv = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"], \
        cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    L, Ld = cfg["n_layers"], cfg["first_dense_layers"]
    ffe = cfg["moe_d_ff"]
    mla = 2 * (d * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv)
               + H * dv * d)
    dense = 2 * 3 * d * cfg["d_ff"]
    pairs = cfg["expert_top_k"] * cfg["experts_held"] / cfg["n_experts"]
    moe = 2 * d * cfg["n_experts"] \
        + 2 * 3 * d * ffe * (cfg["n_shared_experts"] + pairs)
    per_token = L * mla + Ld * dense + (L - Ld) * moe + 2 * d * V
    core = L * H * (dn + dr + dv) * seq * (seq + 1)    # q.k and p.v, causal
    return batch * (seq * per_token + core)


def read(ctx):
    if not ctx.clients or ctx.window_s <= 0:
        return None
    flops = sum(3 * forward_flops(ctx.config, n, s) for n, s in ctx.clients)
    return 100.0 * flops / (ctx.window_s * ctx.peaks["fp32_flops"])
