"""pixtral-12b — VLM: ViT frontend stubbed, mistral-nemo style decoder.

[hf:mistralai/Pixtral-12B-2409] 40L d_model=5120 32H (kv=8) d_ff=14336
vocab=131072, head_dim=128.  The vision stub supplies 1024 patch
embeddings, prefix-fused with the token stream; loss is on text positions.
long_500k runs the sliding-window attention variant (see launch/shapes).
"""
from repro_torch.models.config import ArchConfig, LayerSpec, reduce_for_smoke

CONFIG = ArchConfig(
    name="pixtral-12b", arch_type="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, head_dim=128,
    unit_pattern=(LayerSpec("attn"),),
    frontend="vision", n_patches=1024,
)
SMOKE = reduce_for_smoke(CONFIG)
