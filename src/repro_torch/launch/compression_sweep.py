"""Pareto sweep: quality vs total compression across methods (Fig. 3 shape).

Port of the reference's ``examples/compression_sweep.py``.  Sweeps
FetchSGD (cols x k grid), local top-k (k grid) and FedAvg (local epochs)
against uncompressed on the non-i.i.d. class-shard task and prints a CSV
whose columns mirror the axes of the paper's Figure 3: method, hyper,
total compression, final loss.  Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.compression_sweep \\
        --device cpu [--rounds 20]

``run`` takes the grid: ``GRID`` is the reference's, for the micro model;
``chip_smoke.py`` sweeps gpt2s-federated at full width with its own.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch import resolve_device
from repro_torch.baselines import fedavg, local_topk
from repro_torch.core import fetchsgd as F
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import simulate
from repro_torch.launch.quickstart import (Progress, copy_params,
                                          launches_since)

# the reference example's sweep: FetchSGD over cols x k, local top-k over
# k, FedAvg over local epochs, then uncompressed
GRID = {"cols": (1 << 13, 1 << 15), "k": (128, 1024),
        "local_k": (128, 1024), "local_epochs": (1, 3)}
CSV_HEADER = "name,total_compression_x,upload_x,final_loss"


def sweep_runs(grid: dict) -> list[tuple[str, str, dict]]:
    """(name, method, run_simulation keywords) for each run of ``grid``,
    in the reference's order."""
    runs = []
    for cols in grid["cols"]:
        for k in grid["k"]:
            runs.append((f"fetchsgd_c{cols}_k{k}", "fetchsgd",
                         dict(fs_cfg=F.FetchSGDConfig(rows=5, cols=cols,
                                                      k=k, momentum=0.9))))
    for k in grid["local_k"]:
        runs.append((f"local_topk_k{k}", "local_topk",
                     dict(topk_cfg=local_topk.LocalTopKConfig(k=k))))
    for le in grid["local_epochs"]:
        runs.append((f"fedavg_e{le}", "fedavg",
                     dict(fa_cfg=fedavg.FedAvgConfig(local_epochs=le))))
    runs.append(("uncompressed", "uncompressed", {}))
    return runs


def csv_row(res: dict) -> str:
    return (f"{res['name']},{res['traffic']['total_x']:.2f},"
            f"{res['traffic']['upload_x']:.2f},{res['final_loss']:.4f}")


def run(cfg, dataset, grid: dict, rounds: int, *,
        clients_per_round: int = 4, peak_lr: float = 0.5, device=None,
        params: dict | None = None, progress: Progress | None = None,
        on_run=None) -> list[dict]:
    """Every run of ``grid`` from the same initial weights: ``params``
    (copied for each run) or, without it, those of seed 0.

    Returns one dict a run: ``name``, ``method``, ``losses``, ``traffic``,
    ``final_loss`` (the reference's: the last three losses summed over 3)
    and ``launches``.  ``on_run(result)`` is called as each run ends.
    """
    out = []
    for name, method, kw in sweep_runs(grid):
        before = kernel_ops.launch_counts()
        res = simulate.run_simulation(
            cfg, method=method, rounds=rounds,
            clients_per_round=clients_per_round, peak_lr=peak_lr,
            dataset=dataset, params=copy_params(params), device=device,
            progress=progress and (lambda r, loss, n=name:
                                   progress(n, r, loss)), **kw)
        out.append(dict(name=name, method=method, losses=res.losses,
                        traffic=res.traffic,
                        final_loss=sum(res.losses[-3:]) / 3,
                        launches=launches_since(before)))
        if on_run:
            on_run(out[-1])
    return out


def main(argv=None, log=print) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    cfg = simulate.micro_cfg()
    dataset = simulate.micro_dataset(cfg)

    log(CSV_HEADER)

    def emit(res):
        log(csv_row(res))
        sys.stdout.flush()

    return run(cfg, dataset, GRID, args.rounds,
               device=resolve_device(args.device), on_run=emit)


if __name__ == "__main__":
    main()
