"""The assigned input-shape matrix and per-shape config adaptation.

Port of ``repro.launch.shapes`` (pure Python; the port keeps its own
copy).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig

# Window used by the dense-arch long_500k sliding-window variant (DESIGN.md
# §Arch-applicability): bounds the decode KV cache at O(window).
LONG_CONTEXT_WINDOW = 16384


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeSpec("long_500k", "decode", 524288, 1),
}


class SkipShape(Exception):
    """Raised when an (arch, shape) pair is skipped by design (DESIGN.md)."""


def adapt_config(cfg: ArchConfig, shape: ShapeSpec) -> ArchConfig:
    """Per-shape architecture adjustments.

    * ``long_500k`` on attention-bearing archs without native sub-quadratic
      state: switch to the sliding-window variant (ring-buffer KV cache).
      SSM archs run natively.  jamba keeps full windows on its 4 attention
      layers? — no: its KV at 524k x kv=8 shards over model via head_dim and
      fits, so it stays exact (hybrid native).
    * whisper (enc-dec audio) skips ``long_500k`` — no sliding-window
      analogue preserves cross-attention semantics at 500k decoder steps.
    """
    if shape.name == "long_500k":
        if cfg.arch_type == "audio":
            raise SkipShape(f"{cfg.name}: long_500k skipped (enc-dec; see "
                            "DESIGN.md §Arch-applicability)")
        if cfg.arch_type in ("dense", "moe", "vlm"):
            cfg = dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg
