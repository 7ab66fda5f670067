"""Client sampling for the federated simulation.

Port of ``repro.data.federated.sample_clients`` (numpy only): each round
draws W clients uniformly, as in the paper's setup.
"""

from __future__ import annotations

import numpy as np


def sample_clients(n_clients: int, w: int, round_idx: int,
                   seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed * 2654435761 + round_idx)
    return rng.choice(n_clients, size=min(w, n_clients), replace=False)
