"""Where the time of a full-width FetchSGD round goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_round [--rounds 3]

Runs the round of ``train_lm.train`` with the ``--full`` settings
(gpt2s-federated, 4 clients, seq 256, a 5 x 2**20 sketch, k = 25,000)
phase by phase: ``--rounds`` rounds with a device sync after each phase,
timed on the host clock, then one round under ``torch.profiler``.  Prints
each phase's seconds per round (median over the timed rounds after the
first), the device time by kernel, and the share of the profiled round's
wall time in which the device ran a kernel or a copy.  The profiler's full
table goes to ``--out``.

It also splits the server's top-k (``core/topk.topk_from_sketch``) on the
final error sketch with CUDA events: the per-chunk fused estimate and
selection that ``topk_from_sketch`` runs (``estimate_select``), the final
top-k over the candidate pool, and, as the yardstick of the fusion, the
unfused per-chunk estimate kernels and the per-chunk ``torch.topk`` calls
(with the ``abs`` they take) that it replaced; each group timed on its own
behind a queued device sleep, the median of 5 repetitions.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import time
from pathlib import Path

import torch

from repro_torch import configs, resolve_device
from repro_torch.core import fetchsgd as F
from repro_torch.core import layout as layout_lib
from repro_torch.core import topk as topk_lib
from repro_torch.data import federated, synthetic
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.train_lm import sync
from repro_torch.models import transformer
from repro_torch.optim import linear_decay

PHASES = ("grad", "sketch", "mean", "server_step", "apply")


def run_round(r, state, ctx, times):
    """One round of ``train_lm.train``, each phase ended by a device sync
    and its host time added to ``times``; returns the new server state."""
    cfg, fs_cfg, params, lay, dataset, lr_fn, device = ctx

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        sync(device)
        times[name] += time.perf_counter() - t
        return out

    tables = []
    for c in federated.sample_clients(dataset.n_clients, 4, r):
        batch = federated.to_batch(dataset.client_batch(int(c)), device)
        _, g = timed("grad", lambda: transformer.value_and_grad(
            params, batch, cfg, remat=False))
        tables.append(timed("sketch", lambda: F.sketch_grads(g, lay,
                                                             fs_cfg)))
        del g
    agg = timed("mean", lambda: sum(tables) / len(tables))
    lr = torch.full((), lr_fn(r), dtype=torch.float32, device=device)
    delta, state = timed("server_step", lambda: F.server_step(
        agg, state, lr, lay, fs_cfg))
    timed("apply", lambda: F.apply_delta(params, lay, delta))
    return state


def device_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn()`` (CUDA events), each repetition
    behind a queued device sleep so that the host is ahead of the card."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)   # clock cycles: ~50 ms at ~2 GHz
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_topk(table, lay, k: int, key: int = 0) -> dict[str, float]:
    """Device ms of the parts of ``topk_from_sketch`` on ``table``: the
    per-chunk fused estimate and selection and the final top-k over the
    pool (the same calls, in the same order, as ``core/topk.py``), and the
    unfused estimates and per-chunk top-k that the fusion replaced."""
    nall = lay.num_chunks
    work = []                            # (offset, size, per-chunk k)
    for g in lay.groups:
        size = g.n_rows * g.row_len
        kk = topk_lib._chunk_k(k, size, nall)
        work += [(lay.chunks[ci].offset, size, kk) for ci in g.chunk_ids]
    ests = [kernel_ops.sketch_estimate(table, off, size, key)
            for off, size, _ in work]
    idxs = [torch.topk(e.abs(), kk).indices for e, (_, _, kk)
            in zip(ests, work)]
    pool = torch.cat([e[i] for e, i in zip(ests, idxs)])
    return {
        "estimate_select": device_ms(lambda: [
            kernel_ops.sketch_estimate_topk(table, off, size, kk, key)
            for off, size, kk in work]),
        "estimate": device_ms(lambda: [
            kernel_ops.sketch_estimate(table, off, size, key)
            for off, size, _ in work]),
        "chunk_topk": device_ms(lambda: [
            torch.topk(e.abs(), kk).indices
            for e, (_, _, kk) in zip(ests, work)]),
        "final_topk": device_ms(lambda: torch.topk(
            pool.abs(), min(k, pool.numel())).indices),
        "chunks": len(work),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/profile_round.txt")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_config("gpt2s-federated")
    fs_cfg = F.FetchSGDConfig(rows=5, cols=1 << 20, k=25_000, momentum=0.9)
    params = transformer.init_params(cfg, seed=0, device=device)
    lay = layout_lib.build_layout(params)
    total = args.rounds + 1
    dataset = synthetic.PersonaLM(vocab=cfg.vocab, seq_len=256,
                                  n_clients=total * 4)
    ctx = (cfg, fs_cfg, params, lay, dataset, linear_decay(0.16, total),
           device)
    state = F.init_state(fs_cfg, device)
    per_round = []
    for r in range(args.rounds):
        times = collections.Counter()
        state = run_round(r, state, ctx, times)
        per_round.append(times)
    steady = per_round[1:] or per_round
    print(f"{torch.cuda.get_device_name(0)}; phase seconds per round "
          f"(median of rounds 1..{len(per_round) - 1}):")
    for name in PHASES:
        print(f"  {name:12s} {statistics.median(t[name] for t in steady):.6f}")
    print(f"  {'round':12s} "
          f"{statistics.median(sum(t.values()) for t in steady):.6f}")
    parts = time_topk(state.error_sketch, lay, fs_cfg.k, fs_cfg.hash_key)
    print(f"server top-k on the error sketch, device ms ({parts['chunks']} "
          f"chunks, median of 5):")
    for name in ("estimate_select", "estimate", "chunk_topk", "final_topk"):
        print(f"  {name:12s} {parts[name]:.6f}")

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t = time.perf_counter()
        run_round(args.rounds, state, ctx, collections.Counter())
        wall = time.perf_counter() - t
    events = prof.key_averages()
    # device-side entries only: an operator's entry repeats its kernels'
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"profiled round: wall {wall:.6f} s, device busy "
          f"{busy_us / 1e6:.6f} s ({busy_us / 1e6 / wall:.1%}), idle share "
          f"{1 - busy_us / 1e6 / wall:.1%}")
    print("device time by kernel (ms, launches):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} {e.count:6d}  "
              f"{e.key[:90]}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(events.table(sort_by="self_device_time_total",
                                row_limit=60))


if __name__ == "__main__":
    main()
