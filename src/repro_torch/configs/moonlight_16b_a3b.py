"""moonlight-16b-a3b — DeepSeek-V3 block: latent attention (MLA), one
leading dense layer, then sigmoid-routed experts.

[hf:moonshotai/Moonlight-16B-A3B] 27L d_model=2048 16H, MLA with no query
LoRA (kv_lora_rank=512, qk_nope/rope/v head dims 128/64/128); layer 0 a
dense SwiGLU of width 11264 (first_k_dense_replace=1), then 26 MoE layers
of 64 routed experts of width 1408, 6 a token by sigmoid score plus a
selection bias (noaux_tc, one group), gates normalised over the 6 and
scaled by 2.446, and 2 shared experts; no token dropped; vocab=163840,
untied head, rope_theta=50000.  ``experts_held`` 64: every expert.
"""
from repro_torch.models.config import ArchConfig, LayerSpec, reduce_for_smoke

CONFIG = ArchConfig(
    name="moonlight-16b-a3b", arch_type="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=11264, vocab=163840, rope_theta=50000.0,
    unit_pattern=(LayerSpec("mla", moe=True),),
    first_dense_layers=1,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=64, n_shared_experts=2, expert_top_k=6, moe_d_ff=1408,
    router_score="sigmoid", routed_scale=2.446, experts_held=64,
    router_aux_coef=0.0,
)
SMOKE = reduce_for_smoke(CONFIG, n_layers=3, kv_lora_rank=64,
                         qk_nope_head_dim=32, qk_rope_head_dim=16,
                         v_head_dim=32, experts_held=2)
