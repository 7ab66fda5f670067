"""Wall-clock federation over a heterogeneous client population.

Port of the reference's ``examples/heterogeneous_federation.py``.  The
round clock hides the thing FetchSGD is actually for: real clients differ
by orders of magnitude in uplink bandwidth and compute speed, and some
are only periodically available.  This runs the same federation through
the event-driven virtual clock (``fed.simtime``) three ways:

* **flat (sync)** — every round barriers on the cohort's slowest upload.
  One phone on a 2G link stalls the entire federation.
* **tree (sync)** — same barrier, but the merge topology's wall-clock
  critical path (per-level slowest edge) is reported alongside byte
  totals: bytes say tree costs *more*, the clock says the root stops
  being the bottleneck.
* **async (quorum)** — the server updates every ``quorum`` arrivals,
  merging by arrival order with weight ``w * exp(-lambda * age_seconds)``.
  Slow uploads land rounds later and are discounted, not lost — by sketch
  linearity the merged table is still an exact weighted-mean sketch.

The virtual clock is numpy on the host: ``t_virtual`` and the critical
paths depend on the seed and the configuration, not on the model or the
device.  Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.heterogeneous_federation \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.heterogeneous_federation \\
        --device cpu --bw-sigma 2.5 --rounds 12 --quorum 2
"""

from __future__ import annotations

import argparse
import math

from repro_torch import resolve_device
from repro_torch.core import fetchsgd as F
from repro_torch.fed import (FederationConfig, HeterogeneityConfig,
                             Orchestrator, SimTimeConfig)
from repro_torch.launch import simulate
from repro_torch.launch.async_federated import (default_fs_cfg, final_loss,
                                                policy_run)
from repro_torch.launch.quickstart import Progress, copy_params

# the example's client population: compute seconds and uplink bytes/s
# lognormal, each client up for at least half of every 120 s window
HET_DEFAULTS = dict(compute_median=2.0, compute_sigma=0.6,
                    bandwidth_median=5e4, bandwidth_sigma=2.0,
                    avail_period=120.0, avail_duty_min=0.5)


def run(cfg, dataset, fs_cfg: F.FetchSGDConfig, rounds: int, *,
        het: HeterogeneityConfig | None = None, clients_per_round: int = 6,
        quorum: int = 3, staleness_lambda: float = 0.01,
        peak_lr: float = 0.2, seed: int = 0, device=None,
        params: dict | None = None,
        progress: Progress | None = None) -> dict:
    """Flat, tree and async (``quorum``) on the event clock over the
    population ``het`` (the example's, ``HET_DEFAULTS``, when None), each
    from the same initial weights: ``params`` (copied for each run) or,
    without it, those of ``seed``.

    Returns ``{policy: run}`` as ``async_federated.run`` does, each run
    with its summary too: ``t_virtual``, ``upload_mb``, ``cp_sum_s`` (the
    critical paths summed) and ``final_loss``.
    """
    het = het or HeterogeneityConfig(**HET_DEFAULTS)
    out = {}
    for policy, q in (("flat", None), ("tree", None), ("async", quorum)):
        fed_cfg = FederationConfig(
            rounds=rounds, clients_per_round=clients_per_round,
            aggregate=policy, tree_fanout=2, clock="event",
            simtime=SimTimeConfig(
                staleness_lambda=staleness_lambda, quorum=q,
                link_bandwidth=1e8, heterogeneity=het),
            seed=seed)
        orch = Orchestrator(cfg, fs_cfg, fed_cfg, dataset,
                            params=copy_params(params), peak_lr=peak_lr,
                            device=device)
        res = policy_run(orch, policy, progress)
        del orch
        recs = res["records"]
        res.update(upload_mb=sum(r["upload_bytes"] for r in recs) / 1e6,
                   cp_sum_s=sum(r["critical_path_s"] for r in recs),
                   final_loss=final_loss(res["losses"], policy))
        out[policy] = res
    return out


def record_line(policy: str, rec: dict) -> str:
    loss = f"{rec['loss']:.4f}" if rec["loss"] is not None else "  -   "
    return (f"[{policy:5s}] round {rec['round_idx']:2d}  loss {loss}  "
            f"t={rec['t_virtual']:8.1f}s  "
            f"merged={rec['n_fresh'] + rec['n_late']}"
            f"  in_flight={rec['n_straggling']}  "
            f"critical_path={rec['critical_path_s']:6.1f}s")


def main(argv=None, log=print) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients-per-round", type=int, default=6)
    ap.add_argument("--quorum", type=int, default=3,
                    help="async: server updates every N arrivals")
    ap.add_argument("--compute-median", type=float,
                    default=HET_DEFAULTS["compute_median"])
    ap.add_argument("--compute-sigma", type=float,
                    default=HET_DEFAULTS["compute_sigma"])
    ap.add_argument("--bw-median", type=float,
                    default=HET_DEFAULTS["bandwidth_median"],
                    help="median uplink bytes/s (5e4 ~ a weak mobile link)")
    ap.add_argument("--bw-sigma", type=float,
                    default=HET_DEFAULTS["bandwidth_sigma"],
                    help="lognormal spread: 2.0 means ~50x slow tail")
    ap.add_argument("--avail-period", type=float,
                    default=HET_DEFAULTS["avail_period"],
                    help="availability window period in virtual seconds")
    ap.add_argument("--avail-duty-min", type=float,
                    default=HET_DEFAULTS["avail_duty_min"])
    ap.add_argument("--staleness-lambda", type=float, default=0.01)
    ap.add_argument("--peak-lr", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = simulate.micro_cfg()
    fs = default_fs_cfg()
    het = HeterogeneityConfig(
        compute_median=args.compute_median, compute_sigma=args.compute_sigma,
        bandwidth_median=args.bw_median, bandwidth_sigma=args.bw_sigma,
        avail_period=args.avail_period, avail_duty_min=args.avail_duty_min)
    log(f"model {cfg.name}  sketch {fs.rows}x{fs.cols} k={fs.k} "
        f"table={F.upload_bytes(fs)/1e3:.0f}kB")
    log(f"population: compute ~lognorm(median {het.compute_median}s, "
        f"sigma {het.compute_sigma}), uplink ~lognorm(median "
        f"{het.bandwidth_median:.0f}B/s, sigma {het.bandwidth_sigma}), "
        f"availability {args.avail_duty_min:.0%}+ of each "
        f"{args.avail_period:.0f}s window")
    log("")

    results = run(cfg, simulate.micro_dataset(cfg, seed=args.seed), fs,
                  args.rounds, het=het,
                  clients_per_round=args.clients_per_round,
                  quorum=args.quorum,
                  staleness_lambda=args.staleness_lambda,
                  peak_lr=args.peak_lr, seed=args.seed,
                  device=resolve_device(args.device))
    for policy, res in results.items():
        for rec in res["records"]:
            log(record_line(policy, rec))
        log("")

    log(f"{'policy':6s} {'t_virtual':>10s} {'upload_MB':>10s} "
        f"{'cp_sum_s':>9s} {'final_loss':>10s}")
    for policy, res in results.items():
        loss = res["final_loss"]
        log(f"{policy:6s} {res['t_virtual']:9.1f}s {res['upload_mb']:10.2f} "
            f"{res['cp_sum_s']:9.1f} {loss:10.4f}")
        if not math.isfinite(loss):
            raise RuntimeError(f"[{policy}] non-finite final loss {loss}")
    log("")
    log("same byte totals, very different clocks: the skewed uplink "
        "tail sets sync wall-clock;")
    log("async keeps updating while stragglers' sketches are still in "
        "flight.")
    return results


if __name__ == "__main__":
    main()
