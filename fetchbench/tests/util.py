"""Helpers of the benchmark's CPU tests: micro cells added to a copy of
the benchmark as files and manifest entries alone."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from fetchbench import reference  # noqa: E402


def add_micro_cells(root: Path, prefix: str = "micro",
                    family: str | None = None) -> dict:
    """Micro configurations and cells beside the real ones, each with a
    real cell's traffic, sketch and limits at its family's micro widths
    (``family``: naming another family in place of the real one): new
    files and new entries only.  Returns {micro cell: the real cell it
    mirrors}."""
    man = json.loads((root / "BENCHMARK.json").read_text())
    bench = root / "fetchbench"
    mirrors = {}
    for c in list(man["configs"]):
        cfg = json.loads((root / c["file"]).read_text())
        cfg.update(reference.family(cfg, root).MICRO)
        cfg["family"] = family or cfg["family"]
        name = f"{prefix}-{c['name']}"
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
        name = f"{prefix}-{w['name']}"
        wl["config"] = f"{prefix}-{w['config']}"
        (bench / "workloads" / f"{name}.json").write_text(json.dumps(wl))
        man["workloads"].append(dict(w, name=name, config=wl["config"]))
        for m in man["end_to_end"] + man["per_layer"]:
            if w["name"] in m.get("workloads", ()):
                m["workloads"].append(name)
        mirrors[name] = w["name"]
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return mirrors


