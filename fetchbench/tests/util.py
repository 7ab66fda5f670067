"""Helpers of the benchmark's CPU tests: micro cells added to a copy of
the benchmark as files and manifest entries alone."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

MICRO = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab": 256}


def add_micro_cells(root: Path) -> dict:
    """Micro configurations and cells beside the real ones, each with a
    real cell's traffic, sketch and limits at micro sizes: new files and
    new entries only.  Returns {micro cell: the real cell it mirrors}."""
    man = json.loads((root / "BENCHMARK.json").read_text())
    bench = root / "fetchbench"
    mirrors = {}
    for c in list(man["configs"]):
        cfg = json.loads((root / c["file"]).read_text())
        cfg.update(MICRO)
        name = f"micro-{c['name']}"
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        man["configs"].append(dict(c, name=name,
                                   file=f"fetchbench/configs/{name}.json"))
    for w in list(man["workloads"]):
        wl = json.loads((bench / "workloads" / f"{w['name']}.json")
                        .read_text())
        t = wl["traffic"]
        if wl["entry"] == "fed_round":
            t.update(clients_per_round=2, seq_len=16, population=100)
            wl["sketch"].update(cols=4096, k=64)
        else:
            t.update(batch=4, prompt_len=32, new_tokens=16)
        name = f"micro-{w['name']}"
        wl["config"] = f"micro-{w['config']}"
        (bench / "workloads" / f"{name}.json").write_text(json.dumps(wl))
        man["workloads"].append(dict(w, name=name, config=wl["config"]))
        for m in man["end_to_end"] + man["per_layer"]:
            if w["name"] in m.get("workloads", ()):
                m["workloads"].append(name)
        mirrors[name] = w["name"]
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return mirrors


