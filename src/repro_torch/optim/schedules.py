"""LR schedules from the paper's experiments (Appendix A).

Port of ``repro.optim.schedules``.  Each schedule returns a float32 value
computed in float32 arithmetic, as the reference computes it with jnp.
"""

from __future__ import annotations

import numpy as np

_F = np.float32


def triangular(peak_lr: float, total_steps: int, pivot_frac: float = 0.2):
    """CIFAR/FEMNIST schedule: linear warmup to ``pivot``, linear decay to 0."""
    pivot = max(1, int(total_steps * pivot_frac))

    def lr(step) -> np.float32:
        step = _F(step)
        if step < pivot:
            return _F(peak_lr) * step / _F(pivot)
        return (_F(peak_lr) * np.maximum(_F(total_steps) - step, _F(0))
                / _F(max(total_steps - pivot, 1)))

    return lr


def linear_decay(peak_lr: float, total_steps: int):
    """PersonaChat schedule: linear decay from peak to 0."""

    def lr(step) -> np.float32:
        step = _F(step)
        return (_F(peak_lr) * np.maximum(_F(total_steps) - step, _F(0))
                / _F(total_steps))

    return lr
