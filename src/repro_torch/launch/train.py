"""Mesh training driver: FetchSGD on the distributed step builders.

Port of ``repro.launch.train``, with its flags (but ``--sketch-impl``) and
its output, plus ``--device`` and ``--sketch-mode``.  Each data shard of
the mesh is a client cohort; aggregation goes through ``fed``: ``--aggregate
flat`` is one mean, ``tree`` reduces one mesh axis at a time, ``async``
pipelines rounds through a staleness-discounted buffer (a straggling
round lands one or more rounds late), and ``dense`` is the
full-gradient-mean baseline.

The world comes from ``torchrun``'s environment.  Without one,
``--debug-mesh DxM`` spawns the D*M ranks itself on 127.0.0.1 (``gloo``
on the CPU; on the card ``nccl`` when each rank has a card, else ``gloo``
over CUDA tensors), and a run without ``--debug-mesh`` is a world of 1.

    python -m repro_torch.launch.train --device cpu --smoke \\
        --debug-mesh 2x2 --rounds 3 --aggregate tree
    python -m repro_torch.launch.train --rounds 3 --cols 1048576 --k 25000
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, obs, resolve_device
from repro_torch.core import fetchsgd as F
from repro_torch.data import synthetic
from repro_torch.fed import aggregator as fed_agg
from repro_torch.launch import mesh as mesh_lib, shapes, steps
from repro_torch.models import transformer
from repro_torch.optim import triangular


@dataclasses.dataclass
class RoundResult:
    round: int
    loss: float
    seconds: float       # wall time of the step, ended by a device sync
    tag: str


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--debug-mesh", default=None,
                    help="e.g. 4x2 = (data=4, model=2); 2x4x2 adds a pod axis")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--cols", type=int, default=1 << 14)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--aggregate", default="flat",
                    choices=("flat", "sketch", "tree", "async", "dense"))
    ap.add_argument("--sketch-mode", default="gathered",
                    choices=("gathered", "model_local"),
                    help="flat only: model_local sketches each model rank's "
                         "slice and sums the tables over the model group")
    ap.add_argument("--straggle-prob", type=float, default=0.3,
                    help="async: probability a round's cohort reports late")
    ap.add_argument("--staleness-discount", type=float, default=0.9)
    ap.add_argument("--clock", default="round", choices=("round", "event"),
                    help="async: measure staleness in rounds or in virtual "
                         "seconds from heterogeneous upload times")
    ap.add_argument("--staleness-lambda", type=float, default=0.05,
                    help="event clock: discount exp(-lambda * age_seconds)")
    ap.add_argument("--compute-median", type=float, default=1.0)
    ap.add_argument("--bw-median", type=float, default=1e6)
    ap.add_argument("--bw-sigma", type=float, default=1.0)
    ap.add_argument("--profile-stream", default="counter",
                    choices=("legacy", "counter"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    obs.add_cli_flags(ap)   # --metrics PATH.jsonl / --trace / --obs-summary
    return ap.parse_args(argv)


def _mesh_parts(args) -> list[int] | None:
    return [int(p) for p in args.debug_mesh.split("x")] \
        if args.debug_mesh else None


def make_mesh(args, device) -> mesh_lib.Mesh:
    parts = _mesh_parts(args)
    if parts:
        axes = ("data", "model") if len(parts) == 2 else \
            ("pod", "data", "model")
        return mesh_lib.make_mesh(tuple(parts), axes, device)
    if dist.get_world_size() == 1:
        return mesh_lib.make_debug_mesh(1, 1, device)
    return mesh_lib.make_production_mesh(multi_pod=args.multi_pod,
                                         device=device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(args, mesh: mesh_lib.Mesh, log=print) -> list[RoundResult]:
    """The training loop on this rank; ``log`` prints rank 0's lines."""
    dev = mesh.device
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    shape = shapes.ShapeSpec("train", "train", args.seq_len,
                             args.global_batch)
    fs = F.FetchSGDConfig(rows=5, cols=args.cols, k=args.k, momentum=0.9)
    bundle = steps.make_train_step(cfg, shape, mesh, fs,
                                   aggregate=args.aggregate,
                                   sketch_mode=args.sketch_mode)
    tele = obs.from_args(args, run="train", arch=args.arch,
                         aggregate=args.aggregate, clock=args.clock) \
        if mesh.rank == 0 else obs.NOOP
    full = transformer.init_params(cfg, seed=0, device=dev)
    n_params = transformer.param_count(full)
    params = steps.local_params(full, cfg, mesh)
    del full
    opt = F.init_state(fs, dev)
    ds = synthetic.ClassShardLM(vocab=cfg.vocab, seq_len=args.seq_len,
                                n_clients=256,
                                samples_per_client=args.global_batch)
    lr_fn = triangular(args.lr, args.rounds)
    log(f"mesh {mesh.shape}  arch {cfg.name}  d={n_params / 1e6:.1f}M  "
        f"aggregate={args.aggregate}")
    log(f"world {dist.get_world_size()}  backend {mesh.backend}  "
        f"device {dev}  sketch_mode={args.sketch_mode}")

    is_async = args.aggregate == "async"
    is_event = args.clock == "event"
    if is_event and not is_async:
        raise SystemExit("--clock event requires --aggregate async here; "
                         "for sync policies under the event clock use "
                         "repro_torch.launch.simulate --clock event")
    if is_async:
        buf = fed_agg.AsyncBufferedAggregator(
            fs, discount=args.staleness_discount,
            staleness_lambda=args.staleness_lambda if is_event else None,
            device=dev)
        straggle_rng = np.random.default_rng(1234)
    if is_event:
        from repro_torch.fed import simtime as fed_sim
        het = fed_sim.HeterogeneityModel(fed_sim.HeterogeneityConfig(
            compute_median=args.compute_median,
            bandwidth_median=args.bw_median,
            bandwidth_sigma=args.bw_sigma,
            profile_stream=args.profile_stream), seed=1234)
        table_bytes = F.upload_bytes(fs)
        now = 0.0
    out = []
    for r in range(args.rounds):
        cb = ds.client_batch(r % 256)
        batch = {k: torch.as_tensor(cb[k][:args.global_batch],
                                    dtype=torch.int64, device=dev)
                 for k in ("tokens", "labels")}
        if cfg.frontend == "vision":
            batch["patches"] = torch.zeros(
                args.global_batch, cfg.n_patches, cfg.d_model, device=dev)
        if cfg.is_encdec:
            batch["frames"] = torch.zeros(
                args.global_batch, cfg.enc_seq, cfg.d_model, device=dev)
        lr = torch.full((), lr_fn(r), dtype=torch.float32, device=dev)
        sync(dev)
        t0 = time.time()
        if is_async:
            t_now = now if is_event else r
            inject, inject_w, n_late, max_s = buf.drain(t_now)
            # the last round always lands on time so training never ends
            # with an unapplied cohort
            straggle = (straggle_rng.random() < args.straggle_prob
                        and r < args.rounds - 1)
            with tele.span("train.step", round=r) as sp:
                params, opt, m = bundle.fn(params, opt, batch, lr,
                                           0.0 if straggle else 1.0, inject,
                                           inject_w)
                sp.sync(m["loss"])
            if is_event:
                prof = het.profile(r % 256)
                arrive = prof.finish_time(
                    now, table_bytes, compute_scale=2.0 if straggle else 1.0)
            if straggle:
                buf.submit(m["table"], produced_round=t_now,
                           arrival_round=(arrive if is_event else r + 1))
                if is_event:
                    now += args.compute_median
            elif is_event:
                now = max(now, arrive)
            unit = "s" if is_event else ""
            tag = (" [straggled]" if straggle else
                   f" [late merged: {n_late}, "
                   f"staleness {max_s:.1f}{unit}]" if n_late else "")
            if is_event:
                tag += f" t={now:.1f}s"
        else:
            with tele.span("train.step", round=r) as sp:
                params, opt, m = bundle.fn(params, opt, batch, lr)
                sp.sync(m["loss"])
            tag = ""
        sync(dev)
        dt = time.time() - t0
        loss = float(m["loss"])
        if tele.enabled:
            tele.gauge("train.loss").set(loss)
            tele.counter("train.rounds").inc()
            tele.histogram("train.step_seconds").observe(dt)
            tele.emit("train_round", round=r, loss=loss, step_seconds=dt)
        log(f"round {r}: loss {loss:.4f} ({dt:.1f}s){tag}")
        out.append(RoundResult(r, loss, dt, tag))
    tele.close()
    if not math.isfinite(out[-1].loss):
        raise SystemExit(f"loss {out[-1].loss} is not finite")
    log("done")
    return out


def _rank_main(rank: int, argv) -> list[RoundResult]:
    """One rank of a spawned ``--debug-mesh`` world."""
    args = parse_args(argv)
    mesh = make_mesh(args, args.device or "cuda")

    def log(line):
        if rank == 0:
            print(line, flush=True)
    return train(args, mesh, log=log)


def main(argv=None, log=print) -> list[RoundResult]:
    """Run the driver; returns rank 0's rounds (this rank's under
    ``torchrun``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    device = resolve_device(args.device)
    parts = _mesh_parts(args)
    world = math.prod(parts) if parts else 1
    if "RANK" not in os.environ and not dist.is_initialized() and world > 1:
        return mesh_lib.spawn(_rank_main, world, (argv,), device)[0]
    mesh_lib.init_from_env(device)
    mesh = make_mesh(args, device)
    rank0 = dist.get_rank() == 0
    return train(args, mesh, log=log if rank0 else (lambda *_: None))


if __name__ == "__main__":
    main()
