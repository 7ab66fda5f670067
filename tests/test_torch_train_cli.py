"""The port's mesh training driver (``python -m repro_torch.launch.train``)
on the CPU: ``--debug-mesh 2x2`` spawns four ``gloo`` ranks itself, and a
run without it is a world of one.  The output keeps the reference CLI's
lines (``src/repro/launch/train.py``: the mesh line, one ``round r: loss
L (Ts)[tag]`` line a round with the async tags, ``done``), plus one line
naming the world's size and backend; every loss is finite.  (The
reference's own CLI builds its mesh with ``jax.make_mesh``'s default axis
types, which jax 0.9 makes ``Explicit``, and fails there as
``tests/test_distributed.py`` does; so its lines are matched here by the
format of its f-strings, not by running it.)
"""

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
COMMON = ["--device", "cpu", "--smoke", "--cols", "4096", "--k", "128",
          "--seq-len", "32", "--global-batch", "4"]
RUNS = {
    "tree-2x2": ["--debug-mesh", "2x2", "--rounds", "3", "--aggregate",
                 "tree"],
    "async-event-2x2": ["--debug-mesh", "2x2", "--rounds", "4",
                        "--aggregate", "async", "--clock", "event",
                        "--straggle-prob", "0.5"],
    "dense-world-of-1": ["--rounds", "2", "--aggregate", "dense"],
}
ROUND = re.compile(r"^round (\d+): loss (-?\d+\.\d{4}|nan|inf) "
                   r"\((\d+\.\d)s\)(.*)$")


@pytest.fixture(scope="module")
def outputs():
    # one after another, one intra-op thread a process: the suite runs
    # files in parallel workers, which the ranks' thread pools would
    # oversubscribe
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    out = {}
    for name, argv in RUNS.items():
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *COMMON,
             *argv], capture_output=True, text=True, env=env, cwd=ROOT,
            timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[name] = proc.stdout.splitlines()
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_lines_have_the_reference_format(outputs, name):
    lines = outputs[name]
    agg = RUNS[name][RUNS[name].index("--aggregate") + 1]
    mesh = "{'data': 2, 'model': 2}" if "2x2" in name else \
        "{'data': 1, 'model': 1}"
    assert re.fullmatch(rf"mesh {re.escape(mesh)}  arch qwen3-0\.6b-smoke  "
                        rf"d=\d+\.\dM  aggregate={agg}", lines[0]), lines[0]
    world = 4 if "2x2" in name else 1
    assert re.fullmatch(rf"world {world}  backend gloo  device cpu  "
                        r"sketch_mode=gathered", lines[1]), lines[1]
    rounds = int(RUNS[name][RUNS[name].index("--rounds") + 1])
    matches = [ROUND.match(line) for line in lines[2:-1]]
    assert all(matches) and len(matches) == rounds, lines
    assert [int(m.group(1)) for m in matches] == list(range(rounds))
    assert all(math.isfinite(float(m.group(2))) for m in matches)
    assert lines[-1] == "done"


def test_async_event_tags(outputs):
    tags = [ROUND.match(line).group(4)
            for line in outputs["async-event-2x2"][2:-1]]
    tag = re.compile(r"( \[straggled\]| \[late merged: \d+, staleness "
                     r"\d+\.\ds\])? t=\d+\.\ds")
    assert all(tag.fullmatch(t) for t in tags), tags
    # round 1 draws 0.38 < 0.5 from the straggle generator (seed 1234)
    # and straggles; the last round always lands on time
    assert [" [straggled]" in t for t in tags] == [False, True, False, False]
    clock = [float(re.search(r"t=(\d+\.\d)s", t).group(1)) for t in tags]
    assert clock == sorted(clock) and clock[0] > 0


def test_the_same_batch_gives_the_same_first_loss(outputs):
    """Round 0's loss is the clients' mean before any update: the same for
    every policy and mesh, as the halves of the batch are equal in size."""
    first = {name: float(ROUND.match(lines[2]).group(2))
             for name, lines in outputs.items()}
    assert len(set(first.values())) == 1, first
