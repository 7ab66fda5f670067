"""Client sampling and cohort batching for the federated simulation.

Port of ``repro.data.federated`` (numpy, as the reference draws): each
round, ``sample_clients`` draws W clients uniformly (the paper's setup);
``cohort_batch`` stacks their local data into one global batch with a
client-id vector.  ``to_batch`` hands a client's numpy batch to the model.
"""

from __future__ import annotations

import numpy as np
import torch


def sample_clients(n_clients: int, w: int, round_idx: int,
                   seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed * 2654435761 + round_idx)
    return rng.choice(n_clients, size=min(w, n_clients), replace=False)


def to_batch(client_batch: dict, device) -> dict:
    """A client's numpy tokens and labels as int64 tensors on ``device``.

    On a CUDA device each is staged as int64 in pinned host memory and
    copied with ``non_blocking=True``, so the host goes on dispatching
    while the device still runs earlier work.  The staging comes from
    PyTorch's caching host allocator, which hands a freed block out again
    only after the copy that read it has run on its stream.
    """
    if torch.device(device).type != "cuda":
        return {k: torch.as_tensor(client_batch[k], dtype=torch.int64,
                                   device=device)
                for k in ("tokens", "labels")}
    out = {}
    for k in ("tokens", "labels"):
        src = torch.as_tensor(client_batch[k])
        staged = torch.empty(src.shape, dtype=torch.int64, pin_memory=True)
        out[k] = staged.copy_(src).to(device, non_blocking=True)
    return out


def cohort_batch(dataset, clients, pad_to: int | None = None) -> dict:
    """Stack the cohort's examples: {tokens, labels, client_id,
    sample_weight} as numpy arrays.

    ``pad_to`` pads the example dimension to a fixed size (repeating the
    last example, weight-masked via ``sample_weight``) or truncates it.
    """
    parts = [dataset.client_batch(int(c)) for c in clients]
    toks = np.concatenate([p["tokens"] for p in parts])
    labs = np.concatenate([p["labels"] for p in parts])
    cid = np.concatenate([np.full(len(p["tokens"]), c, np.int32)
                          for p, c in zip(parts, clients)])
    weight = np.ones(len(toks), np.float32)
    if pad_to is not None:
        if len(toks) > pad_to:
            toks, labs, cid, weight = (a[:pad_to] for a in
                                       (toks, labs, cid, weight))
        elif len(toks) < pad_to:
            pad = pad_to - len(toks)

            def rep(a):
                return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
            toks, labs, cid = rep(toks), rep(labs), rep(cid)
            weight = np.concatenate([weight, np.zeros(pad, np.float32)])
    return {"tokens": toks, "labels": labs, "client_id": cid,
            "sample_weight": weight}
