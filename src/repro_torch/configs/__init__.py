"""Architecture registry (port of ``repro.configs``).

The zoo and the paper's own model, ``gpt2s-federated``, in the
reference's order, and the port's own ``EXTRA``.
``get_config(name)`` returns the full ArchConfig; ``get_smoke(name)`` the
reduced same-family variant.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

ARCHS = (
    "qwen2-moe-a2.7b",
    "whisper-small",
    "xlstm-350m",
    "pixtral-12b",
    "llama4-maverick-400b-a17b",
    "deepseek-7b",
    "qwen3-0.6b",
    "glm4-9b",
    "jamba-v0.1-52b",
    "internlm2-1.8b",
    # the paper's own experiment model (Sec. 5.3)
    "gpt2s-federated",
)

# The port's configurations beyond the reference's zoo: resolved by name,
# not listed, so that ``list_archs()`` stays the zoo the reference has.
EXTRA = ("moonlight-16b-a3b",)

_MOD = {name: name.replace("-", "_").replace(".", "_")
        for name in ARCHS + EXTRA}


def _module(name: str):
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{list(ARCHS + EXTRA)}")
    return importlib.import_module(f"repro_torch.configs.{_MOD[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE


def list_archs() -> tuple[str, ...]:
    return ARCHS
