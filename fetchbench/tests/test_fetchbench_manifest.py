"""The manifest keeps the benchmark's contract, and every cell, metric and
configuration is found by its name alone."""

import hashlib
import json
import re
import types

import pytest
import torch

from fetchbench.tests.util import ROOT
from fetchbench import harness, reference
from fetchbench import run as run_mod

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["fetchbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]]
                         + CELLS + [m["name"] for m in METRICS]
                         + [w["traffic"] for w in MAN["workloads"]])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    keys = {"name", "unit", "better", "source", "workloads"}
    if metric in MAN["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert set(metric) <= keys | {"bound"}
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert set(metric) <= keys | {"layer", "moves"}
        assert "\n" not in metric["layer"] and "\t" not in metric["layer"]


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_by_each_of_its_cells(metric):
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    moved = e2e[metric["moves"]]
    for cell in metric.get("workloads", CELLS):
        assert harness.reports(moved, cell), (metric["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = harness.find_cell(MAN, cell)
    assert c.workload["config"] == c.entry["config"]
    assert c.workload["chips"] == c.entry["chips"]
    assert c.workload["why"] == c.entry["why"]
    assert hasattr(harness.entry_module(c.workload["entry"]), "Session")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))


@pytest.mark.parametrize("key", ["config", "chips", "why"])
def test_a_workload_file_that_departs_from_its_entry_is_refused(key):
    man = json.loads(json.dumps(MAN))
    entry = man["workloads"][0]
    entry[key] = 4 if key == "chips" else "other"
    with pytest.raises(ValueError, match=key):
        harness.find_cell(man, entry["name"])


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_file_matches_its_entry(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["reduced"] == cfg["reduced"]
    assert set(data["reduced"]) <= set(data)
    assert any(cfg["name"] == w["config"] for w in MAN["workloads"])
    fam = reference.family(data)
    harness.check_tree(harness.arch_config(data, fam), fam.param_spec(data))


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "fetchbench").rglob("*")) if p.is_file()}


def _copy(tmp_path):
    import shutil
    root = tmp_path / "copy"
    shutil.copytree(ROOT / "fetchbench", root / "fetchbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_cells_added_as_files_alone_are_picked_up(micro_root, tmp_path):
    from fetchbench.tests.util import add_micro_cells
    root = _copy(tmp_path)
    before = _digest(root)
    mirrors = add_micro_cells(root)
    after = _digest(root)
    assert all(after[p] == h for p, h in before.items())
    man = harness.manifest(root)
    for cell, real in mirrors.items():
        c = harness.find_cell(man, cell, root)
        assert c.config["d_model"] == 64
        assert [m["name"] for m in c.per_layer] == \
            [m["name"] for m in harness.find_cell(man, real, root).per_layer]


TWIN = '''"""A family for the benchmark's tests: the dense decoder's
reference under another name."""
from fetchbench.reference.dense_lm import *  # noqa: F401,F403
'''


def test_a_family_added_as_files_alone_runs(tmp_path):
    """A family module, a configuration naming it and a training and a
    serving cell on it, added as new files and entries: both cells run
    on the reference the configuration names and come out correct."""
    from fetchbench.tests.util import add_micro_cells
    root = _copy(tmp_path)
    before = _digest(root)
    (root / "fetchbench" / "reference" / "dense_lm_twin.py").write_text(TWIN)
    mirrors = add_micro_cells(root, prefix="twin", family="dense_lm_twin")
    after = _digest(root)
    assert all(after[p] == h for p, h in before.items())
    man = harness.manifest(root)
    kinds = {}
    for cell in mirrors:
        c = harness.find_cell(man, cell, root)
        assert c.config["family"] == "dense_lm_twin"
        assert reference.family(c.config, root).__file__ == \
            str(root / "fetchbench" / "reference" / "dense_lm_twin.py")
        kinds.setdefault(c.workload["entry"], cell)
    assert set(kinds) == {"fed_round", "serve"}
    for cell in kinds.values():
        args = types.SimpleNamespace(workload=cell, seed=2**31 + 13,
                                     seconds=0.2, trace=0)
        with open("/dev/null", "w") as log:
            out = run_mod.run(args, device=torch.device("cpu"), root=root,
                              log=log)
        assert out["correct"] is True, (cell, out["checks"])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("real", CELLS)
def test_result_line_keys(micro_root, real, trace):
    root, mirrors = micro_root
    cell = next(c for c, r in mirrors.items() if r == real)
    args = types.SimpleNamespace(workload=cell, seed=2**31 + 11,
                                 seconds=0.3, trace=trace)
    out = run_mod.run(args, device=torch.device("cpu"), root=root,
                      log=open("/dev/null", "w"))
    line = json.loads(harness.result_line(**out))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["checks"]) == set(harness.find_cell(
        harness.manifest(root), cell, root).workload["limits"])
    want = ({m["name"] for m in harness.find_cell(
        harness.manifest(root), cell, root).end_to_end} if not trace else
        set())
    assert want <= set(line["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        # the CPU run reads no device trace: those metrics are left out
        assert not any("idle" in m or "roofline" in m
                       for m in line["metrics"])
