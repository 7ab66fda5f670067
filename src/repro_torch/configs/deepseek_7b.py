"""deepseek-7b — dense llama-architecture decoder.

[arXiv:2401.02954] 30L d_model=4096 32H (kv=32, i.e. MHA) d_ff=11008
vocab=102400.  long_500k uses the sliding-window variant (kv=32 full
caches at 524k positions exceed per-chip HBM; DESIGN.md §Arch-applicability).
"""
from repro_torch.models.config import ArchConfig, LayerSpec, reduce_for_smoke

CONFIG = ArchConfig(
    name="deepseek-7b", arch_type="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=102400,
    unit_pattern=(LayerSpec("attn"),),
)
SMOKE = reduce_for_smoke(CONFIG)
