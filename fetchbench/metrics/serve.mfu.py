"""serve.mfu: the serve calls' prefill and decode FLOPs over the traced
window's wall time, as a share of the H100's float32 peak.

FLOPs are counted from shapes, as the model needs them: the prefill's
products over the prompt with causal attention and the output head at the
last position; each decode step's products for one token per request,
attention over the positions before it and itself, and the output head."""


def _layer_flops(cfg: dict) -> tuple[int, int]:
    """(products of one token through every layer, the head's)."""
    d, L, H, KV = cfg["d_model"], cfg["n_layers"], cfg["n_heads"], \
        cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    n_mlp = 3 if cfg["act"] == "swiglu" else 2
    lin = L * 2 * (d * H * hd + 2 * d * KV * hd + H * hd * d
                   + n_mlp * d * cfg["d_ff"])
    return lin, 2 * d * cfg["vocab"]


def call_flops(cfg: dict, batch: int, prompt: int, new_tokens: int) -> int:
    lin, head = _layer_flops(cfg)
    L, H, d = cfg["n_layers"], cfg["n_heads"], cfg["d_model"]
    hd = cfg.get("head_dim") or d // H
    prefill = prompt * lin + L * 2 * H * hd * prompt * (prompt + 1) + head
    decode = sum(lin + L * 4 * H * hd * (prompt + j + 1) + head
                 for j in range(new_tokens - 1))
    return batch * (prefill + decode)


def read(ctx):
    if not ctx.calls or ctx.window_s <= 0:
        return None
    flops = len(ctx.calls) * call_flops(ctx.config, ctx.batch,
                                        ctx.prompt_len, ctx.new_tokens)
    return 100.0 * flops / (ctx.window_s * ctx.peaks["fp32_flops"])
