"""Asynchronous federated FetchSGD: stragglers don't stall the round.

Port of the reference's ``examples/async_federated.py``.  Demonstrates
the federation runtime (``repro_torch.fed``) under an unreliable client
population: every sampled client independently drops out or straggles.
Two runs over identical cohorts and failure draws:

* **flat** (synchronous): the round barrier loses every straggler's
  gradient — a 30% straggle rate wastes 30% of client compute;
* **async**: stragglers land in the ``AsyncBufferedAggregator`` and are
  merged 1-3 rounds later with weight ``discount**staleness`` — exact up
  to the discount, because the Count Sketch is linear.

A checkpoint directory can be passed to exercise mid-run persistence:
each policy checkpoints into ``<dir>-flat`` / ``<dir>-async`` every
``rounds // 4`` rounds and after the last, and a run with more rounds
resumes after the newest checkpoint.  Runs on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.async_federated \\
        --device cpu --rounds 30
    PYTHONPATH=src python -m repro_torch.launch.async_federated \\
        --device cpu --rounds 30 --checkpoint-dir fed_ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import math

from repro_torch import resolve_device
from repro_torch.core import fetchsgd as F
from repro_torch.fed import FederationConfig, Orchestrator, StragglerModel
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import simulate
from repro_torch.launch.quickstart import (Progress, copy_params,
                                          launches_since)

POLICIES = ("flat", "async")


def default_fs_cfg() -> F.FetchSGDConfig:
    """The reference example's sketch."""
    return F.FetchSGDConfig(rows=5, cols=1 << 12, k=256, momentum=0.9)


def final_loss(losses: list, policy: str) -> float:
    """The last round's loss that some client reported."""
    seen = [l for l in losses if l is not None]
    if not seen:
        raise RuntimeError(
            f"[{policy}] no round reported a loss: no client participated, "
            f"or a checkpoint already covers every round")
    return seen[-1]


def policy_run(orch: Orchestrator, policy: str,
               progress: Progress | None) -> dict:
    """Run ``orch`` and return its rounds as plain data."""
    before = kernel_ops.launch_counts()
    start = orch.start_round
    res = orch.run(progress=progress and (
        lambda rec: progress(policy, rec.round_idx, rec.loss)))
    return dict(start_round=start, losses=res.losses,
                records=[dataclasses.asdict(r) for r in res.records],
                traffic=res.traffic, launches=launches_since(before),
                pending_late=res.extras["pending_late"],
                t_virtual=res.extras["t_virtual"])


def run(cfg, dataset, fs_cfg: F.FetchSGDConfig, rounds: int, *,
        clients_per_round: int = 6, straggler: StragglerModel | None = None,
        discount: float = 0.9, peak_lr: float = 0.2,
        checkpoint_dir: str | None = None, seed: int = 0, device=None,
        params: dict | None = None,
        progress: Progress | None = None) -> dict:
    """Flat, then async, over the same cohorts and failure draws, each from
    the same initial weights: ``params`` (copied for each run) or, without
    it, those of ``seed``.

    Returns ``{policy: run}``, each run a dict with its ``start_round``
    (after a checkpoint), ``losses``, ``records`` (``RoundRecord`` fields),
    ``traffic``, ``launches``, ``pending_late`` and ``t_virtual``.
    """
    straggler = straggler or StragglerModel(dropout_prob=0.1,
                                            straggle_prob=0.3, max_delay=3)
    out = {}
    for policy in POLICIES:
        fed_cfg = FederationConfig(
            rounds=rounds, clients_per_round=clients_per_round,
            aggregate=policy, staleness_discount=discount,
            straggler=straggler, seed=seed,
            checkpoint_dir=(checkpoint_dir + "-" + policy
                            if checkpoint_dir else None),
            checkpoint_every=max(1, rounds // 4))
        orch = Orchestrator(cfg, fs_cfg, fed_cfg, dataset,
                            params=copy_params(params), peak_lr=peak_lr,
                            device=device)
        out[policy] = policy_run(orch, policy, progress)
        del orch
    return out


def record_line(policy: str, rec: dict) -> str:
    loss = f"{rec['loss']:.4f}" if rec["loss"] is not None else "  -   "
    return (f"[{policy}] round {rec['round_idx']:3d}  loss {loss}  "
            f"fresh={rec['n_fresh']} late={rec['n_late']} "
            f"dropped={rec['n_dropped']} "
            f"straggling={rec['n_straggling']}")


def main(argv=None, log=print) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients-per-round", type=int, default=6)
    ap.add_argument("--dropout-prob", type=float, default=0.1)
    ap.add_argument("--straggle-prob", type=float, default=0.3)
    ap.add_argument("--max-delay", type=int, default=3)
    ap.add_argument("--discount", type=float, default=0.9)
    ap.add_argument("--peak-lr", type=float, default=0.2)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = simulate.micro_cfg()
    fs = default_fs_cfg()
    straggler = StragglerModel(dropout_prob=args.dropout_prob,
                               straggle_prob=args.straggle_prob,
                               max_delay=args.max_delay)
    log(f"model {cfg.name}  sketch {fs.rows}x{fs.cols} k={fs.k}")
    log(f"failure model: dropout {straggler.dropout_prob:.0%}, "
        f"straggle {straggler.straggle_prob:.0%} "
        f"(delay 1-{straggler.max_delay} rounds, "
        f"discount {args.discount})")
    log("")

    results = run(cfg, simulate.micro_dataset(cfg, seed=args.seed), fs,
                  args.rounds, clients_per_round=args.clients_per_round,
                  straggler=straggler, discount=args.discount,
                  peak_lr=args.peak_lr, checkpoint_dir=args.checkpoint_dir,
                  seed=args.seed, device=resolve_device(args.device))
    for policy, res in results.items():
        if res["start_round"]:
            log(f"[{policy}] resuming from round {res['start_round']}")
        for rec in res["records"]:
            log(record_line(policy, rec))
        log("")

    flat, asyn = results["flat"], results["async"]

    def used(res):
        return sum(r["n_fresh"] + r["n_late"] for r in res["records"])

    def dropped(res):
        return sum(r["n_dropped"] for r in res["records"])

    log(f"flat : gradients merged {used(flat):3d}, lost to the barrier + "
        f"dropout {dropped(flat)}")
    log(f"async: gradients merged {used(asyn):3d}, still buffered "
        f"{asyn['pending_late']}, lost to dropout only {dropped(asyn)}")
    f_loss = final_loss(flat["losses"], "flat")
    a_loss = final_loss(asyn["losses"], "async")
    log(f"final loss: flat {f_loss:.4f} vs async {a_loss:.4f}")
    if not (math.isfinite(a_loss) and math.isfinite(f_loss)):
        raise RuntimeError(f"non-finite final loss: flat {f_loss}, "
                           f"async {a_loss}")
    return results


if __name__ == "__main__":
    main()
