"""Single-host federated simulation — the engine behind the paper's figures.

Port of ``repro.launch.simulate``.  Runs any of the paper's methods
(FetchSGD, local top-k, FedAvg, uncompressed, true top-k) over the
synthetic non-i.i.d. federated datasets and reports loss history and
upload/download compression.  FetchSGD goes through the federation
runtime (``repro_torch.fed``), on the round or the event clock; the
baselines keep their own loops.  Runs on the card unless
``device="cpu"``.

    PYTHONPATH=src python -m repro_torch.launch.simulate --device cpu \\
        --aggregate tree --rounds 5
    PYTHONPATH=src python -m repro_torch.launch.simulate --device cpu \\
        --method fedavg --rounds 5
    PYTHONPATH=src python -m repro_torch.launch.simulate --device cpu \\
        --clock event --aggregate async --rounds 5 --bw-sigma 2.0
    PYTHONPATH=src python -m repro_torch.launch.simulate --device cpu \\
        --clock event --population 100000 --rounds 3
    PYTHONPATH=src python -m repro_torch.launch.simulate --device cpu \\
        --aggregate async --straggle-prob 0.5 --rounds 6 \\
        --checkpoint-dir ckpt --checkpoint-every 3 --metrics run.jsonl --trace

The same command again resumes after the newest checkpoint in
``--checkpoint-dir``; ``python -m repro_torch.obs run.jsonl`` (or the
reference's ``python -m repro.obs``) validates the telemetry stream.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch import configs, fed, obs, resolve_device
from repro_torch.baselines import fedavg, local_topk, uncompressed
from repro_torch.core import compression, fetchsgd as F
from repro_torch.core import layout as layout_lib
from repro_torch.core import topk as TK
from repro_torch.core.layout import tree_map
from repro_torch.data import federated, synthetic
from repro_torch.models import transformer
from repro_torch.models.config import reduce_for_smoke
from repro_torch.optim import triangular

METHODS = ("fetchsgd", "true_topk", "local_topk", "fedavg", "uncompressed")


@dataclasses.dataclass
class SimResult:
    method: str
    losses: list
    traffic: dict
    extras: dict


def micro_cfg(name: str = "gpt2s-federated"):
    """Micro variant for CPU-speed convergence runs (tests/benches):
    2 layers, d=64, vocab=128."""
    return reduce_for_smoke(
        configs.get_config(name), name=name + "-micro", d_model=64,
        n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128, vocab=128,
        attn_chunk=32, loss_chunk=32)


def micro_dataset(cfg, seed: int = 0, n_clients: int = 64):
    return synthetic.ClassShardLM(vocab=cfg.vocab, seq_len=16, n_classes=4,
                                  n_clients=n_clients, samples_per_client=4,
                                  seed=seed)


def _zero_at(tree: dict, layout: layout_lib.ParamLayout,
             delta: TK.SparseDelta) -> None:
    """Zero the coordinates of ``delta``'s ids in ``tree``, in place (the
    momentum factor masking of true top-k)."""
    gid = TK.global_ids(delta, layout)
    for (_, leaf), start in zip(layout_lib.flatten(tree), layout.leaf_offsets):
        flat = leaf.view(-1)
        mine = (gid >= start) & (gid < start + flat.numel())
        flat[gid[mine] - start] = 0.0


def _true_topk_update(mom: dict, err: dict, params: dict, gs: dict, lr,
                      lay: layout_lib.ParamLayout, fs_cfg: F.FetchSGDConfig):
    """One server step of true top-k (Appendix A.3, Fig. 10): momentum and
    error accumulate densely, only the top-k of the error moves."""
    mom = tree_map(lambda m, g: fs_cfg.momentum * m + g, mom, gs)
    acc = tree_map(lambda e, m: e + lr * m, err, mom)
    delta = TK.topk_dense(layout_lib.leaf_views(acc, lay), lay, fs_cfg.k)
    TK.apply_delta(params, lay, delta)
    err = TK.apply_delta(acc, lay, delta)      # acc - extracted
    _zero_at(mom, lay, delta)
    return mom, err, params


def run_simulation(cfg, *, method: str = "fetchsgd", rounds: int = 30,
                   clients_per_round: int = 4, peak_lr: float = 0.2,
                   fs_cfg: F.FetchSGDConfig | None = None,
                   topk_cfg: local_topk.LocalTopKConfig | None = None,
                   fa_cfg: fedavg.FedAvgConfig | None = None,
                   dataset=None, seed: int = 0, aggregate: str = "flat",
                   fed_cfg: fed.FederationConfig | None = None,
                   params: dict | None = None, device=None,
                   progress: Callable[[int, float], None] | None = None,
                   telemetry=None, health_every: int = 1) -> SimResult:
    """Run ``method`` for ``rounds`` rounds; returns losses and traffic.

    ``params`` (a tree on ``device``, which the run may update in place)
    replaces the initialisation from ``seed``; ``progress(round, loss)`` is
    called after every round.  FetchSGD's orchestrator reports to
    ``telemetry`` (``repro_torch.obs``), with a sketch-health sample every
    ``health_every`` rounds.
    """
    device = resolve_device(device)
    dataset = dataset or synthetic.ClassShardLM(
        vocab=cfg.vocab, seq_len=32, n_classes=8, n_clients=256,
        samples_per_client=4, seed=seed)
    if params is None:
        params = transformer.init_params(cfg, seed, device)
    lay = layout_lib.build_layout(params)
    d = lay.total
    gf = fed.orchestrator.make_grad_fn(cfg)
    lr_fn = triangular(peak_lr, rounds)
    meter = compression.TrafficMeter(d=d)
    losses, extras = [], {}

    def cohort(r):
        return federated.sample_clients(dataset.n_clients,
                                        clients_per_round, r, seed)

    def batch(c):
        return federated.to_batch(dataset.client_batch(int(c)), device)

    def finish_round(r, loss):
        losses.append(loss)
        if progress:
            progress(r, loss)

    if method == "fetchsgd":
        fs_cfg = fs_cfg or F.FetchSGDConfig(rows=5, cols=1 << 14, k=512,
                                            momentum=0.9)
        fed_cfg = fed_cfg or fed.FederationConfig(
            rounds=rounds, clients_per_round=clients_per_round,
            aggregate=aggregate, seed=seed)
        if fed_cfg.rounds != rounds:   # fed_cfg wins; keep the lr schedule
            lr_fn = triangular(peak_lr, fed_cfg.rounds)   # aligned with it
        res = fed.Orchestrator(cfg, fs_cfg, fed_cfg, dataset, params=params,
                               lr_fn=lr_fn, grad_fn=gf, device=device,
                               telemetry=telemetry,
                               health_every=health_every).run(
            progress=progress and (lambda rec: progress(
                rec.round_idx, rec.loss)))
        extras["fs_cfg"] = fs_cfg
        extras["fed_records"] = res.records
        extras["pending_late"] = res.extras["pending_late"]
        extras["in_flight"] = res.extras["in_flight"]
        extras["t_virtual"] = res.extras["t_virtual"]
        return SimResult(method=method,
                         losses=[l if l is not None else float("nan")
                                 for l in res.losses],
                         traffic=res.traffic, extras=extras)

    elif method == "true_topk":
        # Appendix A.3 Fig. 10: full gradients to the server; the server
        # keeps a dense error accumulator and applies only the top-k
        fs_cfg = fs_cfg or F.FetchSGDConfig(k=512, momentum=0.9)
        err = tree_map(torch.zeros_like, params)
        mom = tree_map(torch.zeros_like, params)
        for r in range(rounds):
            gs, loss_acc = None, 0.0
            for c in cohort(r):
                loss, grads = gf(params, batch(c))
                gs = grads if gs is None else tree_map(torch.add, gs, grads)
                loss_acc += float(loss)
            gs = tree_map(lambda x: x / clients_per_round, gs)
            mom, err, params = _true_topk_update(mom, err, params, gs,
                                                 float(lr_fn(r)), lay, fs_cfg)
            meter.record(compression.RoundTraffic(upload=d * 4,
                                                  download=fs_cfg.k * 8),
                         clients_per_round)
            finish_round(r, loss_acc / clients_per_round)

    elif method == "local_topk":
        topk_cfg = topk_cfg or local_topk.LocalTopKConfig(k=512)
        st = local_topk.init_server_state(params, topk_cfg)
        for r in range(rounds):
            deltas, loss_acc = [], 0.0
            for c in cohort(r):
                loss, grads = gf(params, batch(c))
                deltas.append(local_topk.client_compress(
                    grads, None, float(lr_fn(r)), lay, topk_cfg)[0])
                loss_acc += float(loss)
            params, st = local_topk.server_apply(params, deltas, st, lay,
                                                 topk_cfg)
            union = len(np.unique(np.concatenate(
                [dd.chunk_id.cpu().numpy() * (2 ** 26)
                 + dd.local_idx.cpu().numpy() for dd in deltas])))
            meter.record(compression.local_topk_round(topk_cfg.k, union),
                         clients_per_round)
            finish_round(r, loss_acc / len(deltas))

    elif method == "fedavg":
        fa_cfg = fa_cfg or fedavg.FedAvgConfig(local_epochs=2)
        st = fedavg.init_server_state(params, fa_cfg)

        def gf_batch(p, b):
            return gf(p, b)[1]

        for r in range(rounds):
            deltas, weights, loss_acc = [], [], 0.0
            for c in cohort(r):
                b = batch(c)
                loss, _ = gf(params, b)
                loss_acc += float(loss)
                reps = {k: torch.stack([v] * fa_cfg.local_epochs)
                        for k, v in b.items()}
                deltas.append(fedavg.client_update(params, reps,
                                                   float(lr_fn(r)), gf_batch,
                                                   fa_cfg))
                weights.append(len(b["tokens"]))
            params, st = fedavg.server_apply(params, deltas, weights, st,
                                             fa_cfg)
            meter.record(compression.fedavg_round(d), clients_per_round)
            finish_round(r, loss_acc / len(deltas))

    elif method == "uncompressed":
        ucfg = uncompressed.SGDConfig(momentum=0.9)
        st = uncompressed.init_state(params, ucfg)
        for r in range(rounds):
            gs, loss_acc = None, 0.0
            for c in cohort(r):
                loss, grads = gf(params, batch(c))
                gs = grads if gs is None else tree_map(torch.add, gs, grads)
                loss_acc += float(loss)
            gs = tree_map(lambda x: x / clients_per_round, gs)
            params, st = uncompressed.step(params, gs, st, float(lr_fn(r)),
                                           ucfg)
            meter.record(compression.uncompressed_round(d), clients_per_round)
            finish_round(r, loss_acc / clients_per_round)
    else:
        raise ValueError(method)

    return SimResult(method=method, losses=losses,
                     traffic=meter.compression(clients_per_round),
                     extras=extras)


def main(argv=None, log=print):
    """Command line: micro-config federated runs, on the round or the event
    clock."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--method", default="fetchsgd", choices=METHODS)
    ap.add_argument("--aggregate", default="flat",
                    choices=("flat", "tree", "async"))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--clients-per-round", type=int, default=None,
                    help="cohort size (default 4; with --population, "
                         "max(4, population // 100))")
    ap.add_argument("--population", type=int, default=None,
                    help="total client population; switches on the "
                         "vectorized dispatch path (event clock: lazy "
                         "events + bucketed queue; round clock: column "
                         "fates/weights + streaming folds)")
    ap.add_argument("--profile-stream", default="counter",
                    choices=("legacy", "counter"),
                    help="per-client profile rng: counter = vectorized "
                         "Philox (fed.profile_rng, the default); legacy = "
                         "per-client default_rng")
    ap.add_argument("--min-clients-per-round", type=int, default=None)
    ap.add_argument("--tree-fanout", type=int, default=2)
    ap.add_argument("--dropout-prob", type=float, default=0.0)
    ap.add_argument("--straggle-prob", type=float, default=0.0)
    ap.add_argument("--max-delay", type=int, default=2)
    ap.add_argument("--staleness-discount", type=float, default=0.9)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--peak-lr", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--weight-by", default="uniform",
                    choices=("uniform", "samples", "profile"),
                    help="per-client merge weights (FedSKETCH-style)")
    # event clock (fed.simtime): wall-clock federation over heterogeneous
    # client profiles
    ap.add_argument("--clock", default="round", choices=("round", "event"))
    ap.add_argument("--quorum", type=int, default=None,
                    help="event+async: server updates every N arrivals")
    ap.add_argument("--staleness-lambda", type=float, default=0.05,
                    help="event: discount exp(-lambda * age_seconds)")
    ap.add_argument("--max-age", type=float, default=None,
                    help="event: drop contributions older than this (s)")
    ap.add_argument("--link-bandwidth", type=float, default=1e8,
                    help="event: backbone bytes/s for internal tree edges")
    ap.add_argument("--compute-median", type=float, default=1.0,
                    help="event: median client compute seconds/round")
    ap.add_argument("--compute-sigma", type=float, default=0.5)
    ap.add_argument("--bw-median", type=float, default=1e6,
                    help="event: median client uplink bytes/s")
    ap.add_argument("--bw-sigma", type=float, default=1.0,
                    help="event: lognormal uplink spread (2+ = heavy skew)")
    ap.add_argument("--avail-period", type=float, default=0.0,
                    help="event: availability window period (0 = always up)")
    ap.add_argument("--avail-duty-min", type=float, default=1.0)
    ap.add_argument("--avail-duty-max", type=float, default=1.0)
    obs.add_cli_flags(ap)   # --metrics PATH.jsonl / --trace / --obs-summary
    ap.add_argument("--health-every", type=int, default=1,
                    help="emit sketch-health diagnostics every N rounds "
                         "(0 = never; only active with --metrics)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    if args.population is not None and args.population < 1:
        ap.error(f"--population must be >= 1, got {args.population}")
    if args.clients_per_round is None:
        args.clients_per_round = (max(4, args.population // 100)
                                  if args.population is not None else 4)

    cfg = micro_cfg()
    dataset = micro_dataset(cfg, seed=args.seed,
                            n_clients=args.population or 64)
    telemetry = obs.from_args(args, run="simulate", method=args.method,
                              aggregate=args.aggregate, clock=args.clock,
                              seed=args.seed)
    # built for both clocks: the round clock reads the heterogeneity
    # profiles too (weight_by=profile, vectorized column weights)
    simtime = fed.SimTimeConfig(
        staleness_lambda=args.staleness_lambda, max_age=args.max_age,
        quorum=args.quorum, link_bandwidth=args.link_bandwidth,
        heterogeneity=fed.HeterogeneityConfig(
            compute_median=args.compute_median,
            compute_sigma=args.compute_sigma,
            bandwidth_median=args.bw_median,
            bandwidth_sigma=args.bw_sigma,
            avail_period=args.avail_period,
            avail_duty_min=args.avail_duty_min,
            avail_duty_max=args.avail_duty_max,
            profile_stream=args.profile_stream))
    fed_cfg = fed.FederationConfig(
        rounds=args.rounds, clients_per_round=args.clients_per_round,
        min_clients_per_round=args.min_clients_per_round,
        aggregate=args.aggregate, tree_fanout=args.tree_fanout,
        staleness_discount=args.staleness_discount,
        straggler=fed.StragglerModel(dropout_prob=args.dropout_prob,
                                     straggle_prob=args.straggle_prob,
                                     max_delay=args.max_delay),
        clock=args.clock, simtime=simtime, weight_by=args.weight_by,
        seed=args.seed, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        vectorized=args.population is not None)
    try:
        with obs.active(telemetry):
            res = run_simulation(
                cfg, method=args.method, rounds=args.rounds,
                clients_per_round=args.clients_per_round,
                peak_lr=args.peak_lr, dataset=dataset, seed=args.seed,
                aggregate=args.aggregate,
                fed_cfg=fed_cfg if args.method == "fetchsgd" else None,
                device=args.device, telemetry=telemetry,
                health_every=args.health_every)
    finally:
        telemetry.close()
    if args.metrics:
        log(f"telemetry: {args.metrics}")
    log(f"method={args.method} aggregate={args.aggregate} "
        f"clock={args.clock}")
    if not res.losses:
        log(f"nothing to do: checkpoint in {args.checkpoint_dir} already "
            f"covers all {args.rounds} rounds")
        return res
    records = res.extras.get("fed_records") or [None] * len(res.losses)
    for r, (loss, rec) in enumerate(zip(res.losses, records)):
        detail = (f"  fresh={rec.n_fresh} late={rec.n_late} "
                  f"dropped={rec.n_dropped}" if rec else "")
        if rec and rec.t_virtual is not None:
            detail += (f" t={rec.t_virtual:8.1f}s"
                       f" critical_path={rec.critical_path_s:6.1f}s"
                       f" in_flight={rec.n_straggling}")
        log(f"round {rec.round_idx if rec else r}: loss {loss:.4f}{detail}")
    t = res.traffic
    log(f"traffic: up={t['upload_bytes']/1e6:.2f}MB "
        f"down={t['download_bytes']/1e6:.2f}MB "
        f"compression {t['total_x']:.1f}x")
    if res.extras.get("t_virtual") is not None:
        log(f"virtual wall-clock: {res.extras['t_virtual']:.1f}s for "
            f"{len(res.losses)} rounds "
            f"({res.extras['in_flight']} uploads still in flight)")
    if not math.isfinite(res.losses[-1]):
        raise RuntimeError(
            "non-finite final loss (diverged, or no client participated)")
    return res


if __name__ == "__main__":
    main()
