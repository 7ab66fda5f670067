"""Render the dry-run's roofline table from its ``--json`` lines.

Port of the dry-run view of ``scripts/report_roofline.py``:

    python -m repro_torch.launch.report_roofline dryrun1.jsonl [more.jsonl]

One row a (arch, shape, mesh, aggregate), sorted, with the three roofline
terms against the H100's constants, the bottleneck, the useful share of
the step's FLOPs and the per-rank peak memory.  The ``--kernels`` view of
the reference reads ``BENCH_kernels.json``, which the port's benchmarks do
not write yet: it has no counterpart here.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+", help="dry-run JSONL result files")
    args = ap.parse_args(argv)
    dryrun_table(args.paths)
    return 0


def dryrun_table(paths) -> None:
    rows = []
    for p in paths:
        with open(p) as f:
            for line in f:
                try:
                    rows.append(json.loads(line))
                except Exception:
                    pass
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"],
                             r.get("aggregate", "")))
    print("| arch | shape | mesh | agg | t_comp(ms) | t_mem(ms) | t_coll(ms) "
          "| bottleneck | useful | peak GiB |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
              f"| {r.get('aggregate','-')} "
              f"| {r['t_compute']*1e3:.2f} | {r['t_memory']*1e3:.2f} "
              f"| {r['t_collective']*1e3:.2f} | {r['bottleneck']} "
              f"| {r['useful']:.3f} | {r['peak_mem']/2**30:.2f} |")


if __name__ == "__main__":
    raise SystemExit(main())
