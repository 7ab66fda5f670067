"""The port's example entry points against the reference's ``examples/``:
``repro_torch.launch.quickstart`` and ``.compression_sweep`` here,
``.async_federated`` and ``.heterogeneous_federation`` in
``test_torch_examples_async.py``.

Each reference example is loaded by path and its ``main`` run with
``--rounds 2``; its printed lines are captured, and so are the results it
prints from (``run_simulation``'s, or each ``Orchestrator.run``'s).  The
port's ``main([..., "--device", "cpu"])`` then runs from the reference's
initial weights (``repro_torch.models.transformer.init_params`` patched
to return them, converted by ``params_from_numpy``) and must print every
line the reference prints once the losses are masked: cohorts, fates,
upload bytes, compression ratios, the CSV's hyper-parameters, virtual
times and critical paths are exact.  Its losses, which it returns, agree
with the reference's within rtol 1e-3.  At 2 rounds the triangular
schedule's round 0 has lr 0, so every loss is taken at the initial
weights (``test_torch_baselines.py`` holds trained losses).  The port's
own weights (its own generator) change only the losses.
"""

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch import simulate as jsim
from repro.models import transformer as jt
from repro_torch.convert import params_from_numpy
from repro_torch.core import layout as TL
from repro_torch.launch import compression_sweep, quickstart
from repro_torch.models import transformer as tt

ROOT = Path(__file__).resolve().parent.parent
ARGV = ["--rounds", "2"]
LOSS_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The micro model's ops are tiny: one intra-op thread is as fast
    alone and does not oversubscribe the cores when test files run in
    parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_reference(name: str, argv: list[str]):
    """The reference example's printed lines, and the results of each
    ``run_simulation`` or ``Orchestrator.run`` it made, in order."""
    mod = reference_example(name)
    results = []
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [f"{name}.py", *argv])
        if hasattr(mod, "Orchestrator"):
            class Recording(mod.Orchestrator):
                def run(self, *a, **kw):
                    results.append(super().run(*a, **kw))
                    return results[-1]
            mp.setattr(mod, "Orchestrator", Recording)
        else:
            inner = jsim.run_simulation

            def recording(*a, **kw):
                results.append(inner(*a, **kw))
                return results[-1]
            mp.setattr(jsim, "run_simulation", recording)
        with contextlib.redirect_stdout(out):
            mod.main()
    return out.getvalue().splitlines(), results


def reference_params() -> dict:
    """The reference's initial micro weights (seed 0), as numpy."""
    return jax.tree_util.tree_map(
        np.asarray, jt.init_params(jsim.micro_cfg(), jax.random.PRNGKey(0)))


@contextlib.contextmanager
def common_weights():
    """Every ``init_params`` of the port returns the reference's weights."""
    jp = reference_params()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tt, "init_params",
                   lambda cfg, seed=0, device=None: params_from_numpy(
                       jp, device))
        yield


def run_port(module, argv: list[str], common: bool = True):
    lines: list[str] = []
    with common_weights() if common else contextlib.nullcontext():
        got = module.main(argv + ["--device", "cpu"], log=lines.append)
    return lines, got


LOSS_MASKS = [
    (re.compile(r"^(   loss:).*$"), r"\1 -"),                  # quickstart
    (re.compile(r"^((?:fetchsgd|local_topk|fedavg|uncompressed)"
                r"[^,]*,[^,]*,[^,]*),.*$"), r"\1,-"),          # sweep CSV
    (re.compile(r"loss \S+"), "loss -"),                       # records
    (re.compile(r"^(final loss: flat) \S+ (vs async) \S+$"), r"\1 - \2 -"),
    (re.compile(r"^((?:flat|tree|async) +\S+ +\S+ +\S+) +\S+$"), r"\1 -"),
]


def loss_free(lines: list[str]) -> list[str]:
    out = []
    for ln in lines:
        for pat, rep in LOSS_MASKS:
            ln = pat.sub(rep, ln)
        out.append(ln)
    return out


def assert_losses_close(got: list, want: list) -> None:
    assert len(got) == len(want)
    assert all(g is not None for g in got)
    np.testing.assert_allclose(got, [float(w) for w in want],
                               rtol=LOSS_RTOL)


@pytest.fixture(scope="module")
def quickstart_ref():
    return run_reference("quickstart", ARGV)


@pytest.fixture(scope="module")
def sweep_ref():
    return run_reference("compression_sweep", ARGV)


def test_quickstart_prints_the_references_lines(quickstart_ref):
    want, ref = quickstart_ref
    got, runs = run_port(quickstart, ARGV)
    assert loss_free(got) == loss_free(want)
    assert got[0] == want[0] == ("model: gpt2s-federated-micro (reduced: "
                                 "2L d=64 vocab=128)")
    assert [r["method"] for r in runs] == ["uncompressed", "fetchsgd"]
    for run, res in zip(runs, ref):
        assert run["traffic"] == res.traffic
        assert_losses_close(run["losses"], res.losses)
        assert not any(run["launches"].values())     # the CPU: plain twins


def test_quickstart_with_its_own_weights(quickstart_ref):
    """The command line as a user runs it: the port draws its own
    weights, and only the losses differ."""
    want, _ = quickstart_ref
    got, runs = run_port(quickstart, ARGV, common=False)
    assert loss_free(got) == loss_free(want)
    assert all(np.isfinite(r["losses"]).all() for r in runs)


def test_quickstart_run_takes_params_and_leaves_them(quickstart_ref):
    """``run`` copies ``params`` for each run: both start from them, and
    the caller's tree is not updated."""
    _, ref = quickstart_ref
    cfg = quickstart.simulate.micro_cfg()
    params = params_from_numpy(reference_params())
    before = {k: v.clone() for k, v in TL.flatten(params)}
    seen = []
    runs = quickstart.run(cfg, quickstart.simulate.micro_dataset(cfg),
                          quickstart.default_fs_cfg(), 2, params=params,
                          device="cpu", progress=lambda *a: seen.append(a))
    for run, res in zip(runs, ref):
        assert_losses_close(run["losses"], res.losses)
    assert [(m, r) for m, r, _ in seen] == [
        ("uncompressed", 0), ("uncompressed", 1), ("fetchsgd", 0),
        ("fetchsgd", 1)]
    for k, v in TL.flatten(params):
        assert torch.equal(v, before[k])


def test_sweep_grid_is_the_references():
    names = [n for n, _, _ in compression_sweep.sweep_runs(
        compression_sweep.GRID)]
    assert names == [
        "fetchsgd_c8192_k128", "fetchsgd_c8192_k1024",
        "fetchsgd_c32768_k128", "fetchsgd_c32768_k1024",
        "local_topk_k128", "local_topk_k1024", "fedavg_e1", "fedavg_e3",
        "uncompressed"]
    src = (ROOT / "examples" / "compression_sweep.py").read_text()
    assert "for cols in (1 << 13, 1 << 15):" in src
    assert "for k in (128, 1024):" in src and "for le in (1, 3):" in src


def test_sweep_prints_the_references_csv(sweep_ref):
    """Every CSV field but the final loss equals the reference's, except
    local top-k's total compression: its download is the union of the
    clients' uploaded top-k supports, a function of the gradients, which
    the two packages agree on to about a bfloat16 step
    (``test_torch_model.py``), so a near-tie at the k-th magnitude can
    trade an id (2 of 8,576 at k = 1024 when this was written).  Its upload
    is exact, and its download is held within 1e-3."""
    want, ref = sweep_ref
    got, runs = run_port(compression_sweep, ARGV)
    assert got[0] == want[0] == compression_sweep.CSV_HEADER

    def fixed(lines):
        return [re.sub(r"^(local_topk_k\d+),[^,]*,", r"\1,-,", ln)
                for ln in loss_free(lines)]
    assert fixed(got) == fixed(want)
    assert len(runs) == len(ref) == 9
    for run, res in zip(runs, ref):
        assert run["method"] == res.method
        if run["method"] == "local_topk":
            t, w = run["traffic"], res.traffic
            assert (t["upload_bytes"], t["upload_x"]) == \
                (w["upload_bytes"], w["upload_x"])
            assert t["download_bytes"] == pytest.approx(
                w["download_bytes"], rel=1e-3)
        else:
            assert run["traffic"] == res.traffic
        assert_losses_close(run["losses"], res.losses)
        assert run["final_loss"] == pytest.approx(
            sum(res.losses[-3:]) / 3, rel=LOSS_RTOL)
