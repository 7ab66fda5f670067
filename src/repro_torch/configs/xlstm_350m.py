"""xlstm-350m — mLSTM/sLSTM blocks, no FFN (d_ff=0).

[arXiv:2405.04517] 24L d_model=1024 4H vocab=50304; 7:1 mLSTM:sLSTM ratio
(one sLSTM per 8-layer unit).  Blocks carry their own 2x up/down
projections; decode state is O(1), so long_500k runs natively.
"""
from repro_torch.models.config import ArchConfig, LayerSpec, reduce_for_smoke

_UNIT = tuple([LayerSpec("mlstm", ffn=False)] * 7 +
              [LayerSpec("slstm", ffn=False)])

CONFIG = ArchConfig(
    name="xlstm-350m", arch_type="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    unit_pattern=_UNIT, xlstm_proj_factor=2.0,
)
SMOKE = reduce_for_smoke(CONFIG)
