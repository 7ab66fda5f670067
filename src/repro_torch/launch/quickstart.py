"""Quickstart: FetchSGD vs uncompressed on a non-i.i.d. federated LM task.

Port of the reference's ``examples/quickstart.py``.  Trains the paper's
GPT2-family model (the micro variant on the command line) on the
pathological one-class-per-client split — each simulated edge client
holds 4 sequences from a single latent distribution — and prints loss
curves and the communication ledger.  Runs on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu \\
        [--rounds 30]

``run`` is the experiment at any width: ``chip_smoke.py`` calls it with
gpt2s-federated at full width.
"""

from __future__ import annotations

import argparse
from typing import Callable

from repro_torch import resolve_device
from repro_torch.core import fetchsgd as F
from repro_torch.core.layout import tree_map
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import simulate

# (name, round, loss) after every round of every run
Progress = Callable[[str, int, float], None]


def default_fs_cfg() -> F.FetchSGDConfig:
    """The reference example's sketch."""
    return F.FetchSGDConfig(rows=5, cols=1 << 14, k=512, momentum=0.9)


def copy_params(params: dict | None) -> dict | None:
    """A run's own copy of the common initial weights (a run updates its
    tree in place)."""
    return None if params is None else tree_map(lambda x: x.clone(), params)


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """Kernel launches since ``before = kernel_ops.launch_counts()``."""
    return {k: v - before[k] for k, v in kernel_ops.launch_counts().items()}


def run(cfg, dataset, fs_cfg: F.FetchSGDConfig, rounds: int, *,
        clients_per_round: int = 4, peak_lr: float = 0.5, device=None,
        params: dict | None = None,
        progress: Progress | None = None) -> list[dict]:
    """Uncompressed, then FetchSGD, each from the same initial weights:
    ``params`` (copied for each run) or, without it, those of seed 0.

    Returns one dict a run: ``method``, ``losses``, ``traffic``
    (``core.compression``'s ledger) and ``launches`` (the sketch kernels
    the run launched; zeros on the CPU).
    """
    out = []
    for method, kw in (("uncompressed", {}), ("fetchsgd", {"fs_cfg": fs_cfg})):
        before = kernel_ops.launch_counts()
        res = simulate.run_simulation(
            cfg, method=method, rounds=rounds,
            clients_per_round=clients_per_round, peak_lr=peak_lr,
            dataset=dataset, params=copy_params(params), device=device,
            progress=progress and (lambda r, loss, m=method:
                                   progress(m, r, loss)), **kw)
        out.append(dict(method=method, losses=res.losses,
                        traffic=res.traffic, launches=launches_since(before)))
    return out


def main(argv=None, log=print) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients-per-round", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = simulate.micro_cfg()
    dataset = simulate.micro_dataset(cfg)
    log(f"model: {cfg.name} (reduced: {cfg.n_layers}L d={cfg.d_model} "
        f"vocab={cfg.vocab})")
    runs = run(cfg, dataset, default_fs_cfg(), args.rounds,
               clients_per_round=args.clients_per_round,
               device=resolve_device(args.device))
    for res in runs:
        t, losses = res["traffic"], res["losses"]
        log("")
        log(f"== {res['method']}")
        log(f"   loss: {' '.join(f'{l:.2f}' for l in losses[::5])} "
            f"-> {losses[-1]:.3f}")
        log(f"   compression: up={t['upload_x']:.1f}x "
            f"down={t['download_x']:.1f}x total={t['total_x']:.1f}x "
            f"({t['upload_bytes']/1e6:.1f}MB up, "
            f"{t['download_bytes']/1e6:.1f}MB down)")
    return runs


if __name__ == "__main__":
    main()
