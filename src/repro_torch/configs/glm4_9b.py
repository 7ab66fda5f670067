"""glm4-9b — dense decoder, extreme GQA (kv=2).

[hf:THUDM/glm-4-9b] 40L d_model=4096 32H (kv=2) d_ff=13696 vocab=151552.
kv=2 cannot shard over model=16, so K/V shard over head_dim=128 instead
(sharding.py divisibility fallback).
"""
from repro_torch.models.config import ArchConfig, LayerSpec, reduce_for_smoke

CONFIG = ArchConfig(
    name="glm4-9b", arch_type="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=151552, head_dim=128,
    unit_pattern=(LayerSpec("attn"),),
)
SMOKE = reduce_for_smoke(CONFIG)
