"""Architecture configuration.

Port of ``repro.models.config``: a model is ``n_layers`` units of
``unit_pattern``, with parameters stacked on a leading ``(n_units,)`` dim
as in the reference.  Heterogeneous architectures (jamba's mamba and
attention interleave, llama4's dense and MoE alternation, xLSTM's mLSTM
and sLSTM mix) are expressed through the pattern.  Every field of the
reference keeps its name and default.

The port's own fields (latent attention, leading dense layers, the
sigmoid-routed expert layer that holds a share of the experts) default
to values that leave every model of the reference's zoo as it is: a
configuration takes their paths only by stating them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str          # attn | mla | mamba | mlstm | slstm
    moe: bool = False  # MoE FFN instead of the dense FFN
    ffn: bool = True   # has an FFN sub-block (xLSTM blocks have none)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str             # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    unit_pattern: tuple[LayerSpec, ...] = (LayerSpec("attn"),)
    head_dim: int = 0          # 0 -> d_model // n_heads
    act: str = "swiglu"        # swiglu | gelu
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    expert_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_score: str = "softmax"  # softmax: top-k with capacity (drops);
                                   # sigmoid: top-k of score + a selection
                                   # bias, dropless (``moe.moe_apply_held``)
    routed_scale: float = 1.0      # sigmoid: gates scaled after normalising
    experts_held: int = 0          # sigmoid: routed experts held here, ids
                                   # 0 .. experts_held-1 (0: all n_experts)
    # leading dense layers (DeepSeek-V3's first_k_dense_replace): the
    # unit's attention kind with a dense FFN of width d_ff, held outside
    # the stacked units
    first_dense_layers: int = 0
    # latent attention (MLA, kind "mla"), no query LoRA
    kv_lora_rank: int = 0          # 0: no MLA
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba)
    ssm_d_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0       # 0 -> d_model // 16
    ssm_remat: bool = False    # checkpoint the chunked selective scan
                               # (recompute intra-chunk states in backward)
    # xLSTM
    xlstm_proj_factor: float = 2.0
    # encoder-decoder (whisper): encoder is attn-only, bidirectional
    enc_layers: int = 0
    enc_seq: int = 1500        # whisper frame count (stub frontend output)
    # multimodal stub frontends
    frontend: str = "none"     # none | audio | vision
    n_patches: int = 0         # vision prefix length (pixtral)
    # attention variant
    sliding_window: int = 0    # 0 = full attention; >0 = window size
    # numerics
    param_dtype: str = "float32"
    attn_compute_dtype: str = "float32"   # "bfloat16": q, k, v and the
                                          # softmax rounded to bf16, products
                                          # summed in float32
    shard_experts_data: bool = False   # expert sharding over data (kept as
                                       # a field: one device has no mesh)
    attn_chunk: int = 512      # query-block size for chunked attention
    loss_chunk: int = 512      # sequence-block size for chunked xent

    def __post_init__(self):
        stacked = self.n_layers - self.first_dense_layers
        if stacked % len(self.unit_pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers {self.n_layers} less "
                f"{self.first_dense_layers} leading dense layers not "
                f"divisible by unit length {len(self.unit_pattern)}")
        if self.router_score not in ("softmax", "sigmoid"):
            raise ValueError(f"{self.name}: unknown router_score "
                             f"{self.router_score!r}")
        if self.router_score == "softmax" and (
                self.experts_held or self.routed_scale != 1.0):
            raise ValueError(f"{self.name}: experts_held and routed_scale "
                             f"belong to the sigmoid router")
        if self.router_score == "sigmoid" and self.router_aux_coef:
            raise ValueError(f"{self.name}: the sigmoid router has no "
                             f"auxiliary loss (router_aux_coef 0)")
        if not 0 <= self.experts_held <= self.n_experts:
            raise ValueError(f"{self.name}: experts_held "
                             f"{self.experts_held} of {self.n_experts}")
        mla = any(s.kind == "mla" for s in self.unit_pattern)
        dims = (self.kv_lora_rank, self.qk_nope_head_dim,
                self.qk_rope_head_dim, self.v_head_dim)
        if mla != bool(self.kv_lora_rank) or (mla and min(dims) <= 0):
            raise ValueError(f"{self.name}: an mla unit needs kv_lora_rank "
                             f"and its head dims, and only it reads them")

    @property
    def n_units(self) -> int:
        return (self.n_layers - self.first_dense_layers) \
            // len(self.unit_pattern)

    @property
    def held(self) -> int:
        """Routed experts whose weights this model holds."""
        return self.experts_held or self.n_experts

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(1, self.d_model // 16)


def reduce_for_smoke(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Reduced variant of the same family: <=2 units, d_model<=256, <=4
    experts."""
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    changes = dict(
        name=cfg.name + "-smoke",
        n_layers=len(cfg.unit_pattern) * min(2, cfg.n_units),
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=max(1, min(cfg.n_kv_heads, n_heads)),
        head_dim=d_model // n_heads,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        n_experts=min(cfg.n_experts, 4),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        expert_top_k=min(cfg.expert_top_k, 2),
        moe_d_ff=min(cfg.moe_d_ff, 256) if cfg.moe_d_ff else 0,
        enc_layers=min(cfg.enc_layers, 2),
        enc_seq=min(cfg.enc_seq, 64),
        n_patches=min(cfg.n_patches, 16),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window
        else 0,
        attn_chunk=64,
        loss_chunk=64,
        param_dtype="float32",
        shard_experts_data=False,
    )
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
