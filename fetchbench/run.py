"""Run one cell of the benchmark and print its result line.

    python -m fetchbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, weights from the seed, the program's first steps, which
build and warm every kernel) is ``setup_s``.  The window then runs steps
until ``--seconds`` have passed and the device has finished.  With
``--trace 0`` the line carries the cell's end-to-end metrics; with
``--trace 1`` the window also runs under the program's spans and
``torch.profiler`` recording the device's activity alone (recording every
host operation would slow a host-bound window down), and the line carries
the per-layer metrics, the device's busy time and a breakdown; one more
step after the window, traced with the host's operations too, names what
the host was doing in the device's idle gaps.  Either way the program's outputs are then held
to the plain reference, and each compared number is printed beside its
limit, last on standard error and last in the line.

The run refuses to start without a CUDA device, and refuses to report if
JAX, its libraries or the JAX package were loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):           # run as a file: the repo on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fetchbench import harness, reference  # noqa: E402

GIB = 1 << 30


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(args, device=None, root: Path = harness.ROOT,
        log=sys.stderr) -> dict:
    """Set up, measure and check one cell of the benchmark at ``root``;
    the result line's fields.  ``device`` None: the cell's CUDA devices,
    which must be there."""
    import torch
    cell = harness.find_cell(harness.manifest(root), args.workload, root)
    if device is None:
        chips = cell.entry["chips"]
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise SystemExit(f"the cell needs {chips} CUDA device(s); "
                             f"{torch.cuda.device_count()} available")
        device = torch.device("cuda")
    on_cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    entry = harness.entry_module(cell.workload["entry"])
    session = entry.Session(cell, args.seed, device, bool(args.trace))
    smi = harness.power_limit() if on_cuda else ""
    sync()
    setup_s = time.perf_counter() - T_START
    session.begin_window()
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        host, dev = ProfilerActivity.CPU, ProfilerActivity.CUDA
        prof = profile(activities=[dev] if on_cuda else [host])
        prof.__enter__()
    t0 = time.perf_counter()
    marks = [t0]
    while True:
        session.step()
        marks.append(time.perf_counter())
        if marks[-1] - t0 >= args.seconds:
            break
    sync()
    elapsed = time.perf_counter() - t0
    n = len(marks) - 1
    steps = sorted(b - a for a, b in zip(marks, marks[1:]))
    print(f"window {elapsed:.3f} s, {n} steps of {steps[0]:.4f} / "
          f"{steps[n // 2]:.4f} / {steps[-1]:.4f} s (least / median / most)",
          file=log)
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    if prof is not None:
        prof.__exit__(None, None, None)

    device_info = {"platform": "gpu" if on_cuda else device.type,
                   "kind": torch.cuda.get_device_name() if on_cuda
                   else device.type,
                   "count": 1, "memory_peak_bytes": peak,
                   "power": smi}
    metrics, brk = {}, None
    if args.trace:
        trace = harness.reduce_trace(prof)
        del prof
        ctx = types.SimpleNamespace(
            cell=cell.workload, config=cell.config,
            family=reference.family(cell.config, cell.root), window_s=elapsed,
            busy_s=trace.busy_s, kernels=trace.kernels,
            peaks=harness.PEAKS, **session.layer_stats())
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=trace.busy_s, window_s=elapsed)
        with profile(activities=[host] + ([dev] if on_cuda else [])) as tail:
            session.step()
            sync()
        trace.idle_gaps = harness.reduce_trace(tail).idle_gaps
        del tail
        brk = harness.breakdown(trace)
    else:
        values = dict(session.window_metrics(elapsed, n),
                      peak_mem_gib=peak / GIB, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    session.release()
    limits = cell.workload["limits"]
    t_ref = time.perf_counter()
    checks = {k: (v, limits[k]) for k, v in session.check().items()}
    print(f"reference and comparison took "
          f"{time.perf_counter() - t_ref:.1f} s", file=log)
    correct = all(v <= lim for v, lim in checks.values())
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=log)
    return dict(correct=correct, attempted=session.steps_attempted(n),
                failed=0, metrics=metrics, device=device_info,
                checks=checks, breakdown_=brk)


def main(argv=None) -> int:
    args = parse(argv)
    harness.setup_env()
    out = run(args)
    found = harness.forbidden_modules()
    if found:
        raise SystemExit(f"JAX or the JAX package was loaded: {found}")
    print(harness.result_line(**out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
