"""Client sampling for the federated simulation.

Port of ``repro.data.federated.sample_clients`` (numpy, as the reference
draws): each round draws W clients uniformly, as in the paper's setup.
``to_batch`` hands a client's numpy batch to the model.
"""

from __future__ import annotations

import numpy as np
import torch


def sample_clients(n_clients: int, w: int, round_idx: int,
                   seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed * 2654435761 + round_idx)
    return rng.choice(n_clients, size=min(w, n_clients), replace=False)


def to_batch(client_batch: dict, device) -> dict:
    """A client's numpy tokens and labels as int64 tensors on ``device``."""
    return {k: torch.as_tensor(client_batch[k], dtype=torch.int64,
                               device=device) for k in ("tokens", "labels")}
