"""qwen3-0.6b — dense decoder with qk-norm GQA.

[hf:Qwen/Qwen3-8B family] 28L d_model=1024 16H (kv=8) d_ff=3072
vocab=151936, head_dim=128, qk RMS-norm before RoPE.
"""
from repro_torch.models.config import ArchConfig, LayerSpec, reduce_for_smoke

CONFIG = ArchConfig(
    name="qwen3-0.6b", arch_type="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6,
    unit_pattern=(LayerSpec("attn"),),
)
SMOKE = reduce_for_smoke(CONFIG)
