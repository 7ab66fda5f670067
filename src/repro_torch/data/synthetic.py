"""Synthetic non-i.i.d. federated datasets, generated locally (no downloads).

A copy of ``repro.data.synthetic`` (numpy only), so that both packages
draw identical client batches from one seed.

Two generators matching the paper's experimental regimes:

* ``ClassShardLM`` — the CIFAR-style pathological split (Sec. 5.1): each
  client holds data from a *single* latent class.  Here a "class" is a
  latent markov-chain over tokens; classes differ in transition structure,
  so client gradients are maximally non-i.i.d., which is exactly the regime
  where FetchSGD's linearity wins.
* ``PersonaLM`` — the PersonaChat-style split (Sec. 5.3): each client is a
  "persona" = a distinct token-distribution mixture; client sizes follow a
  power law (Sec. 1's observation that user data is power-law distributed).

Both produce (tokens, labels) next-token-prediction examples with a
deterministic per-client RNG, so any client's data can be regenerated
on-demand — the federated simulation never materializes the full corpus.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClassShardLM:
    """One latent class per client; class = markov chain over tokens."""

    vocab: int
    seq_len: int
    n_classes: int = 10
    n_clients: int = 1000
    samples_per_client: int = 5
    seed: int = 0

    def client_class(self, client: int) -> int:
        return client % self.n_classes

    def _chain(self, cls: int) -> np.ndarray:
        """Per-class preferred-successor table (vocab,)."""
        rng = np.random.default_rng(self.seed * 7919 + cls)
        return rng.integers(0, self.vocab, size=self.vocab)

    def client_batch(self, client: int) -> dict:
        """All of one client's examples: tokens/labels (n, seq_len)."""
        cls = self.client_class(client)
        succ = self._chain(cls)
        rng = np.random.default_rng(self.seed * 104729 + client)
        n, S = self.samples_per_client, self.seq_len
        toks = np.empty((n, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=n)
        for t in range(S):
            follow = rng.random(n) < 0.8          # 80% on-chain transitions
            nxt = np.where(follow, succ[toks[:, t]],
                           rng.integers(0, self.vocab, size=n))
            toks[:, t + 1] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass(frozen=True)
class PersonaLM:
    """Persona-mixture LM clients with power-law local dataset sizes."""

    vocab: int
    seq_len: int
    n_clients: int = 1000
    n_topics: int = 50
    mean_samples: int = 4
    power: float = 1.5
    seed: int = 0

    def client_size(self, client: int) -> int:
        rng = np.random.default_rng(self.seed * 31 + client)
        size = int(rng.pareto(self.power) * self.mean_samples) + 1
        return min(size, 16 * self.mean_samples)

    def client_batch(self, client: int) -> dict:
        rng = np.random.default_rng(self.seed * 15485863 + client)
        # persona = sparse preference over topics; topic = token band
        topics = rng.choice(self.n_topics, size=2, replace=False)
        band = self.vocab // self.n_topics
        n, S = self.client_size(client), self.seq_len
        base = rng.integers(0, 2, size=(n, S + 1))
        toks = (topics[base] * band
                + rng.integers(0, band, size=(n, S + 1))).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
