"""Federated clients for the benchmark: PersonaChat-style personas with
power-law local dataset sizes, and the uniform cohort draw.

A frozen copy of the repository's ``PersonaLM`` generator and of its
``sample_clients`` draw (numpy), with one change: the client sizes and the
cohorts come from ``population_seed``, which a workload file fixes, while
the tokens come from the run's seed.  Every seed then gives the window the
same clients, of the same sizes, in the same order, and so the same work;
the seed changes what the clients hold.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PersonaLM:
    """Persona-mixture LM clients with power-law local dataset sizes."""

    vocab: int
    seq_len: int
    n_clients: int
    n_topics: int
    mean_samples: int
    power: float
    max_samples: int
    population_seed: int
    seed: int

    def client_size(self, client: int) -> int:
        rng = np.random.default_rng(self.population_seed * 31 + client)
        size = int(rng.pareto(self.power) * self.mean_samples) + 1
        return min(size, self.max_samples)

    def client_batch(self, client: int) -> dict:
        """One client's examples: int32 ``tokens`` and ``labels`` (n, S)."""
        rng = np.random.default_rng((self.seed, client))
        # persona = two topics; a topic is a band of the vocabulary
        topics = rng.choice(self.n_topics, size=2, replace=False)
        band = self.vocab // self.n_topics
        n, S = self.client_size(client), self.seq_len
        base = rng.integers(0, 2, size=(n, S + 1))
        toks = (topics[base] * band
                + rng.integers(0, band, size=(n, S + 1))).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def sample_clients(n_clients: int, w: int, round_idx: int,
                   seed: int) -> np.ndarray:
    """Round ``round_idx``'s cohort: ``w`` distinct clients, uniformly."""
    rng = np.random.default_rng(seed * 2654435761 + round_idx)
    return rng.choice(n_clients, size=min(w, n_clients), replace=False)


def from_workload(wl: dict, vocab: int, seed: int) -> PersonaLM:
    t = wl["traffic"]
    return PersonaLM(vocab=vocab, seq_len=t["seq_len"],
                     n_clients=t["population"], n_topics=t["topics"],
                     mean_samples=t["mean_samples"], power=t["power"],
                     max_samples=t["max_samples"],
                     population_seed=t["population_seed"], seed=seed)
