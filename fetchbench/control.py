"""Readings that set a cell's limits: the control and the faults, at the
cell's own size, over several seeds, in one process.

    python -m fetchbench.control --workload <cell> --seeds 11 12 13

* Training cells: the reference in float32 against the control (every
  product at TF32's precision, ``lowp``) and against the fault of half of
  each client's batch left out.  A step that leaves the state unchanged
  reads 1 on ``first_grad_gap`` and ``change_gap`` by their definition and
  needs no run.
* Serving cells: the program's calls on the cell's batches, and over
  the same prompts and served tokens the compared numbers of the program,
  of each control in its place (``control_tf32``: products at TF32's
  precision; ``control_fp8kv``: the cache's keys and values in float8
  e4m3), each control's token the one it puts first, and of a served
  token altered (the next id in the vocabulary).

Each reading is one JSON line on standard output.  The benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from fetchbench import harness


def fed_readings(cell: harness.Cell, seed: int, device) -> dict:
    from fetchbench import reference
    from fetchbench.reference import federated
    args = (reference.family(cell.config, cell.root), cell.config,
            cell.workload, seed, device)
    ref = federated.run(*args)
    out = {}
    for name, kw in (("control", {"lowp": True}),
                     ("half_batch", {"half_batch": True})):
        r = federated.run(*args, **kw)
        out[name] = federated.gaps(r, ref)
        out[name + "_details"] = federated.details(r, ref)
    harness.free_device(device)
    return out


def serve_readings(cell: harness.Cell, seed: int, device) -> dict:
    import torch

    from fetchbench.entries import serve
    s = serve.Session(cell, seed, device, False)
    for _ in range(cell.workload["check_calls"]):
        s.step()
    calls = s.calls
    s.release()
    flat = s.fam.init_flat(s.spec, s.cfg, seed, device)
    P = s.fam.leaves(flat, s.spec)
    controls = {"control_tf32": {"lowp": True},
                "control_fp8kv": {"kv_dtype": torch.float8_e4m3fn}}
    out: dict = {}

    def take(name, read):
        prev = out.setdefault(name, dict.fromkeys(read, 0.0))
        for k, v in read.items():
            prev[k] = max(prev[k], v)

    for c in calls:
        prompt, served = s.prompts(c["call"]), c["tokens"]
        ref = serve.served_logits(s.fam, P, prompt, served, s.cfg)
        take("program", serve.gaps(ref, served, c["logits"]))
        take("altered", serve.gaps(ref, (served + 1) % s.cfg["vocab"],
                                   c["logits"]))
        for name, kw in controls.items():
            ctl = serve.served_logits(s.fam, P, prompt, served, s.cfg, **kw)
            take(name, serve.gaps(ref, ctl.argmax(dim=-1), ctl[:, -1]))
            del ctl
        del ref
    del flat, P
    harness.free_device(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    harness.setup_env()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("the readings are taken on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.find_cell(harness.manifest(), args.workload)
    read = {"fed_round": fed_readings,
            "serve": serve_readings}[cell.workload["entry"]]
    for seed in args.seeds:
        out = read(cell, seed, torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
