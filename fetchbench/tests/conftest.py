"""Fixtures of the benchmark's CPU tests."""

import shutil

import pytest

from fetchbench.tests.util import ROOT, add_micro_cells


@pytest.fixture(scope="session")
def micro_root(tmp_path_factory):
    """(root of a copy of the benchmark with micro cells, their mirrors)."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "fetchbench", root / "fetchbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root, add_micro_cells(root)
