"""internlm2-1.8b — dense GQA decoder.

[arXiv:2403.17297] 24L d_model=2048 16H (kv=8) d_ff=8192 vocab=92544.
"""
from repro_torch.models.config import ArchConfig, LayerSpec, reduce_for_smoke

CONFIG = ArchConfig(
    name="internlm2-1.8b", arch_type="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92544,
    unit_pattern=(LayerSpec("attn"),),
)
SMOKE = reduce_for_smoke(CONFIG)
