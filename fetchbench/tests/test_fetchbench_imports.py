"""Nothing the benchmark runs loads JAX or the JAX package, and nothing of
the benchmark reads the old JAX benchmark's folder."""

import json
import subprocess
import sys

from fetchbench.tests.util import ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())

SCRIPT = r"""
import importlib, importlib.util, json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
from fetchbench import harness
harness.setup_env()
import fetchbench.run, fetchbench.control
for kind in sys.argv[2].split(","):
    importlib.import_module("fetchbench.entries." + kind)
for name in sys.argv[3].split(","):
    harness.metric_reader(name)
from repro_torch.launch import serve_lm
from repro_torch.fed import orchestrator
print(json.dumps(sorted(sys.modules)))
"""


def test_no_jax_or_jax_package_is_loaded():
    kinds = sorted({json.loads((ROOT / "fetchbench" / "workloads" /
                                f"{w['name']}.json").read_text())["entry"]
                    for w in MAN["workloads"]})
    metrics = [m["name"] for m in MAN["per_layer"]]
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(ROOT), ",".join(kinds),
         ",".join(metrics)], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    top = {m.split(".", 1)[0] for m in mods}
    assert not top & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in top and "fetchbench" in top


def test_forbidden_names_compare_whole_top_level_names():
    from fetchbench import harness
    assert "repro_torch" not in [m for m in sys.modules
                                 if m.split(".", 1)[0] in harness.FORBIDDEN]
    sys.modules["repro_fake_for_test"] = sys
    try:
        assert "repro_fake_for_test" not in harness.forbidden_modules()
    finally:
        del sys.modules["repro_fake_for_test"]


def test_nothing_reads_the_old_benchmark_folder():
    for path in (ROOT / "fetchbench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "benchmarks." not in text, path
        assert "import jax" not in text and "from repro " not in text
        assert "from repro." not in text and "import repro\n" not in text
