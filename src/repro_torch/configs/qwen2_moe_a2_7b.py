"""qwen2-moe-a2.7b — 24L MoE, 60 routed experts top-4 + 4 shared.

[hf:Qwen/Qwen1.5-MoE-A2.7B] 24L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=151936.  Every layer is attention + MoE FFN; the shared experts form
a dense MLP of width 4*1408 applied to all tokens.
"""
from repro_torch.models.config import ArchConfig, LayerSpec, reduce_for_smoke

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", arch_type="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, head_dim=128,
    unit_pattern=(LayerSpec("attn", moe=True),),
    n_experts=60, n_shared_experts=4, expert_top_k=4, moe_d_ff=1408,
)
SMOKE = reduce_for_smoke(CONFIG)
