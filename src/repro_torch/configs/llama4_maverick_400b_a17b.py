"""llama4-maverick-400b-a17b — 400B-param MoE, 128 experts top-1, 17B active.

[hf:meta-llama/Llama-4-Scout-17B-16E family] 48L d_model=5120 40H (kv=8)
d_ff=8192 vocab=202048; dense/MoE layers alternate (unit of 2).  Expert
stacks hold ~386B params -> bf16 + ZeRO-style expert sharding over the
data axis (128 % 16 == 0).  Early-fusion vision tokens are out of scope
for the shape matrix (text backbone per the assignment).
"""
from repro_torch.models.config import ArchConfig, LayerSpec, reduce_for_smoke

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", arch_type="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    unit_pattern=(LayerSpec("attn", moe=False),
                  LayerSpec("attn", moe=True)),
    n_experts=128, expert_top_k=1, moe_d_ff=8192,
    param_dtype="bfloat16", shard_experts_data=True,
    # 40 heads don't divide the 16-way model axis -> head_dim shards and
    # score blocks carry all 40 heads per device; a smaller query block
    # keeps the per-block (B, H, chunk, S) scores inside the HBM budget.
    attn_chunk=128,
)
SMOKE = reduce_for_smoke(CONFIG)
