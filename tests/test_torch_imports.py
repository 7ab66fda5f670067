"""The port imports neither jax nor the reference package.

In a fresh interpreter, every module under ``src/repro_torch/`` is
imported (``__main__`` modules are command lines, run and not imported),
and every module that ``chip_smoke.py`` imports (at its top and inside
its functions, found by parsing it; the script itself is imported without
being run); then neither ``jax`` nor ``repro`` nor any module
under them may be in ``sys.modules``.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBE = r'''
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1] + "/src")
sys.path.insert(0, sys.argv[1])
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")
    if not m.name.endswith(".__main__")]      # a CLI, run not imported
for name in names + json.loads(sys.argv[2]):
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(json.dumps({"imported": names, "bad": bad}))
'''


def chip_smoke_imports() -> list[str]:
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return sorted(out)


def test_the_port_and_chip_smoke_import_no_jax_and_no_reference():
    mods = chip_smoke_imports()
    assert any(m.startswith("repro_torch") for m in mods)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", PROBE, str(ROOT),
                          json.dumps(mods)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["bad"] == []
    for name in ("repro_torch.launch.dryrun", "repro_torch.launch.analysis",
                 "repro_torch.launch.report_roofline",
                 "repro_torch.launch.hillclimb", "repro_torch.kernels.ops",
                 "repro_torch.launch.quickstart",
                 "repro_torch.launch.compression_sweep",
                 "repro_torch.launch.async_federated",
                 "repro_torch.launch.heterogeneous_federation",
                 "repro_torch.core.count_sketch"):
        assert name in out["imported"]
    assert len(out["imported"]) > 40
