"""What every cell shares: finding a cell's files by name, the run's
environment, the device guard, the result line, and the reduction of a
profiler trace to busy time, kernel times and idle gaps.

A cell is found from ``BENCHMARK.json`` alone: its workload file
``workloads/<cell>.json`` names its entry kind (``entries/<kind>.py``) and
its configuration (``configs`` in the manifest names the file), whose
``family`` names its plain reference (``reference/<family>.py``); its
metrics are the manifest's, and each per-layer metric is read by
``metrics/<metric>.py``.  Adding a cell, a configuration, a family or a
metric is adding files and entries.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# Published peaks of one NVIDIA H100 SXM (data sheet, dense): the yardstick
# of every share of a peak or a roofline.
PEAKS = {"fp32_flops": 67e12, "hbm_bytes": 3.35e12}


def setup_env() -> None:
    """The program's import path, fixed cache directories inside the
    checkout, and nothing that could load JAX through a library.  Call
    before importing torch."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    cache = BENCH / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    # one host thread for the CPU's work: no pool spins beside the thread
    # that launches the device's work
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


# -- the manifest ------------------------------------------------------------------

def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the manifest's workloads entry
    workload: dict       # workloads/<name>.json
    config: dict         # the configuration's file
    end_to_end: list     # the manifest's metrics this cell reports
    per_layer: list
    root: Path           # the benchmark's root, where its files are found


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(man: dict, name: str, root: Path = ROOT) -> Cell:
    entries = {w["name"]: w for w in man["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    wl = json.loads((root / "fetchbench" / "workloads" /
                     f"{name}.json").read_text())
    for key in ("config", "chips", "why"):
        if wl[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {wl[key]!r} in its "
                             f"workload file, {entry[key]!r} in "
                             f"BENCHMARK.json")
    configs = {c["name"]: c for c in man["configs"]}
    cfg = json.loads((root / configs[entry["config"]]["file"]).read_text())
    e2e = [m for m in man["end_to_end"] if reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in e2e_names)]
    return Cell(name, entry, wl, cfg, e2e, per, root)


def entry_module(kind: str):
    return importlib.import_module(f"fetchbench.entries.{kind}")


def metric_reader(name: str, root: Path = ROOT):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = root / "fetchbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "fetchbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- the program's configuration -----------------------------------------------------

# keys of a configuration file that say what it is, where it comes from
# and how it was cut, and set no width of either side
DESCRIPTIVE = ("arch", "source", "family", "reduced", "published", "assumed",
               "precision")


def arch_config(cfg: dict, fam):
    """The port's ArchConfig of a configuration file: the registry's
    ``arch`` with every field the file states.  A key that is no field,
    not one the family ``fam`` reads and not descriptive is refused, so
    that no width the file states leaves the program on the registry's
    value while the reference reads the file's."""
    from repro_torch import configs
    from repro_torch.models.config import ArchConfig
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    unread = sorted(set(cfg) - fields - set(fam.READS) - set(DESCRIPTIVE))
    if unread:
        raise ValueError(f"{cfg.get('arch')}: keys {unread} are read by "
                         f"neither the program nor the reference")
    return dataclasses.replace(configs.get_config(cfg["arch"]),
                               **{k: cfg[k] for k in fields & set(cfg)})


def check_tree(model_cfg, spec) -> None:
    """The port's parameter tree has the reference's leaves, in order."""
    from repro_torch.core import layout
    from repro_torch.models import transformer
    meta = transformer.init_params(model_cfg, device="meta")
    got = [(p, tuple(t.shape)) for p, t in layout.flatten(meta)]
    if got != [(p, tuple(s)) for p, s in spec]:
        raise ValueError(f"the port's tree {got} is not the reference's "
                         f"{spec}")


def tree(views: dict) -> dict:
    """Nested dicts of leaves from ``path -> leaf``."""
    out: dict = {}
    for path, leaf in views.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


# -- the device -----------------------------------------------------------------------

def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def free_device(device) -> None:
    """Return what the program's freed state held to the device."""
    import gc

    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# -- the trace ------------------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    busy_s: float
    kernels: dict        # device op name -> seconds in the window
    idle_gaps: list      # [(what the host was doing, seconds)], longest first


def reduce_trace(prof, top_gaps: int = 2000) -> Trace:
    """Busy time (the union of the device's kernel, copy and set
    intervals), device time by operation, and the idle gaps between device
    intervals named by the outermost host operation (not a CUDA runtime
    call) running at their middle ("python" when none was)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        t = e.device_type()
        if t == DeviceType.CUDA:
            if e.duration_ns() > 0:
                dev.append((e.start_ns(), e.end_ns(), e.name()))
        elif t == DeviceType.CPU and not e.name().startswith("cuda"):
            host.append((e.start_ns(), e.end_ns(), e.name()))
    kernels: dict[str, float] = {}
    for s, e, n in dev:
        kernels[n] = kernels.get(n, 0.0) + (e - s) * 1e-9
    dev.sort()
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    # outermost host ops: sorted by start, longest first among equal starts
    host.sort(key=lambda x: (x[0], -x[1]))
    top, end = [], -1
    for s, e, n in host:
        if s >= end:
            top.append((s, e, n))
            end = e
    starts = [s for s, _, _ in top]
    named: dict[str, float] = {}
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top_gaps]:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        what = top[i][2] if i >= 0 and top[i][1] >= mid else "python"
        named[what] = named.get(what, 0.0) + (g1 - g0) * 1e-9
    idle = sorted(named.items(), key=lambda kv: -kv[1])
    return Trace(busy * 1e-9, kernels, idle)


def breakdown(trace: Trace) -> dict:
    ops = sorted(trace.kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in trace.idle_gaps[:10]]}


# -- the result --------------------------------------------------------------------------

def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown_: dict | None = None
                ) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown_ is not None:
        out["breakdown"] = breakdown_
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return json.dumps(out)
