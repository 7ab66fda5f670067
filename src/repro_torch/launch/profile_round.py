"""Where the time of a full-width FetchSGD round goes on the card, read
from the round's own spans.

    PYTHONPATH=src python -m repro_torch.launch.profile_round \
        [--config gpt2s-federated] [--clients 4] [--seq-len 256] [--rounds 3]

Drives ``Orchestrator`` rounds (round clock, flat, every client fresh: the
benchmark's training path; PersonaLM clients, sketch 5 x 2**20, k 25,000)
with tracing on and prints each span's host ms, device ms and host syncs a
round, the mean of ``--rounds`` rounds after a warm-up one.  One more round
runs under the profiler (host and device activity), and the device's idle
time in it is put down to the innermost span open at the time, through the
spans' ``t0_ns`` / ``t1_ns`` against the union of the trace's device
intervals, or to no span.  ``time_topk`` then splits the server's top-k.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import time

import torch

from repro_torch import configs, obs, resolve_device
from repro_torch.core import fetchsgd as F
from repro_torch.core import topk as topk_lib
from repro_torch.data import synthetic
from repro_torch.fed import orchestrator as orch_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.optim import linear_decay


def device_busy(prof) -> list[list[int]]:
    """The union of the trace's device intervals (kernels, copies, sets)
    on the profiler's clock, sorted."""
    ivs = sorted((e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA
                 and e.duration_ns() > 0)
    busy: list[list[int]] = []
    for s, e in ivs:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    return busy


def idle_s(busy, t0: int, t1: int) -> float:
    """Seconds of [t0, t1] (ns) in no interval of ``busy``."""
    covered = sum(max(0, min(e, t1) - max(s, t0)) for s, e in busy)
    return max(0, t1 - t0 - covered) * 1e-9


def idle_by_span(spans: list[dict], busy, t0: int, t1: int) -> dict:
    """Device idle seconds of [t0, t1] by the innermost span open at the
    time; ``(no span)`` outside every span."""
    def own(sp, depth):
        return idle_s(busy, sp["t0_ns"], sp["t1_ns"]) - sum(
            idle_s(busy, k["t0_ns"], k["t1_ns"]) for k in spans
            if k["depth"] == depth and sp["t0_ns"] <= k["t0_ns"]
            and k["t1_ns"] <= sp["t1_ns"])
    out = collections.Counter()
    for sp in spans:
        out[sp["name"]] += own(sp, sp["depth"] + 1)
    out["(no span)"] = own({"t0_ns": t0, "t1_ns": t1}, 0)
    return out


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
    ap.add_argument("--config", default="gpt2s-federated")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_config(args.config)
    sink = obs.MemorySink()
    tele = obs.Telemetry([sink], trace=True)
    orch = orch_lib.Orchestrator(
        cfg, F.FetchSGDConfig(rows=5, cols=1 << 20, k=25_000, momentum=0.9),
        orch_lib.FederationConfig(rounds=10**6,
                                  clients_per_round=args.clients),
        synthetic.PersonaLM(vocab=cfg.vocab, seq_len=args.seq_len,
                            n_clients=17_568),
        lr_fn=linear_decay(0.16, 10**6), device=resolve_device(None),
        telemetry=tele, health_every=0)
    marks = []                           # time_ns before each round
    for r in range(args.rounds + 1):
        marks.append(time.time_ns())
        orch.run_round(r)
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        marks.append(time.time_ns())
        orch.run_round(args.rounds + 1)
        torch.cuda.synchronize()
        marks.append(time.time_ns())
    tele.close()
    spans = [e for e in sink.events if e["type"] == "span"]
    per = collections.defaultdict(collections.Counter)
    for e in spans:
        if marks[1] <= e["t0_ns"] < marks[-2]:     # rounds 1..n
            per[e["name"]].update(n=1, host=e["dur_s"], dev=e["dev_s"],
                                  syncs=e["syncs"])
    n = args.rounds
    print(f"{torch.cuda.get_device_name(0)}; {args.config}, {args.clients} "
          f"clients at seq {args.seq_len}; spans a round (mean of rounds "
          f"1..{n}): count, host ms, device ms, syncs")
    for name, p in per.items():
        print(f"  {name:20s} {p['n'] / n:5.1f} {p['host'] / n * 1e3:10.3f} "
              f"{p['dev'] / n * 1e3:10.3f} {p['syncs'] / n:6.1f}")
    busy = device_busy(prof)
    t0, t1 = marks[-2], marks[-1]
    idle = idle_by_span([e for e in spans if e["t0_ns"] >= t0], busy, t0, t1)
    print(f"profiled round: wall {(t1 - t0) * 1e-9:.6f} s, device idle "
          f"{idle_s(busy, t0, t1):.6f} s; idle s by the innermost span:")
    for name, s in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"  {name:20s} {s:.6f}")
    parts = time_topk(orch.opt_state.error_sketch, orch.layout,
                      orch.fs_cfg.k, orch.fs_cfg.hash_key)
    print(f"server top-k on the error sketch, device ms "
          f"({parts.pop('chunks')} chunks, median of 5):")
    for name, ms in parts.items():
        print(f"  {name:12s} {ms:.6f}")


if __name__ == "__main__":
    main()
