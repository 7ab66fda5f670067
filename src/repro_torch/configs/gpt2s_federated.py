"""gpt2s-federated — the paper's own PersonaChat model (Sec. 5.3).

GPT2-small-shaped decoder (124M): 12L d_model=768 12H d_ff=3072
vocab=50257, GELU MLPs (RoPE substituted for learned positions).  The same
configuration as ``repro.configs.gpt2s_federated``.
"""
from repro_torch.models.config import ArchConfig, LayerSpec, reduce_for_smoke

CONFIG = ArchConfig(
    name="gpt2s-federated", arch_type="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=50257, act="gelu",
    unit_pattern=(LayerSpec("attn"),),
)
SMOKE = reduce_for_smoke(CONFIG)
