"""Prompts for the serving cells: token ids drawn uniformly from the
vocabulary, one batch a call, from the run's seed and the call's index."""

from __future__ import annotations

import torch


def batch(seed: int, call: int, size: int, length: int,
          vocab: int) -> torch.Tensor:
    """(size, length) int64 prompt ids of call ``call`` (on the CPU)."""
    gen = torch.Generator().manual_seed((seed * 1_000_003 + call) % 2**63)
    return torch.randint(0, vocab, (size, length), generator=gen)
