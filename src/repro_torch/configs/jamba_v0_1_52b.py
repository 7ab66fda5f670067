"""jamba-v0.1-52b — hybrid Mamba+attention (1:7) with MoE (16e top-2).

[arXiv:2403.19887] 32L d_model=4096 32H (kv=8) d_ff=14336 vocab=65536.
Unit of 8: one attention layer per 7 mamba layers; MoE FFN on every other
layer.  Expert stacks (~45B of 52B params) shard over data (16 % 16 == 0);
params bf16.  SSM state decode is O(1) -> long_500k native (the 4
attention layers use their 524k cache, sharded per sharding.py).
"""
from repro_torch.models.config import ArchConfig, LayerSpec, reduce_for_smoke

_UNIT = (
    LayerSpec("mamba", moe=False), LayerSpec("mamba", moe=True),
    LayerSpec("mamba", moe=False), LayerSpec("mamba", moe=True),
    LayerSpec("attn",  moe=False), LayerSpec("mamba", moe=True),
    LayerSpec("mamba", moe=False), LayerSpec("mamba", moe=True),
)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", arch_type="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, head_dim=128,
    unit_pattern=_UNIT,
    n_experts=16, expert_top_k=2, moe_d_ff=14336,
    ssm_d_state=16, ssm_conv=4, ssm_expand=2,
    param_dtype="bfloat16", shard_experts_data=True,
)
SMOKE = reduce_for_smoke(CONFIG)
