"""whisper-small — encoder-decoder ASR backbone, conv/mel frontend stubbed.

[arXiv:2212.04356] 12 enc + 12 dec layers, d_model=768, 12H, d_ff=3072,
vocab=51865, GELU MLPs.  The frontend stub supplies 1500 precomputed frame
embeddings; deviations: RoPE replaces the learned decoder positional
embedding (keeps the 32k decode shapes well-posed); sinusoidal encoder
positions as in the paper.
"""
from repro_torch.models.config import ArchConfig, LayerSpec, reduce_for_smoke

CONFIG = ArchConfig(
    name="whisper-small", arch_type="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, act="gelu",
    unit_pattern=(LayerSpec("attn"),),
    enc_layers=12, enc_seq=1500, frontend="audio",
)
SMOKE = reduce_for_smoke(CONFIG)
