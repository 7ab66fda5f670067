"""A run with the program's timed path broken underneath comes out not
correct, for each fault a cell can have; the control, the reference at
the next precision down, fails the cell's limits too.  At micro width on
the CPU, with the real cells' limits."""

import contextlib
import types

import pytest
import torch

from fetchbench import control, harness
from fetchbench import run as run_mod


def _run(root, cell, seed=2**31 + 21):
    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=0.2,
                                 trace=0)
    with open("/dev/null", "w") as log:
        return run_mod.run(args, device=torch.device("cpu"), root=root,
                           log=log)


def _cell(micro_root, entry):
    root, mirrors = micro_root
    man = harness.manifest(root)
    return [c for c in mirrors
            if harness.find_cell(man, c, root).workload["entry"] == entry]


@contextlib.contextmanager
def _state_unchanged(mp):
    from repro_torch.core import fetchsgd as F
    step = F.server_step

    def frozen(table, state, lr, layout, cfg):
        delta, _ = step(table, state, lr, layout, cfg)
        delta.values = torch.zeros_like(delta.values)
        return delta, state
    mp.setattr(F, "server_step", frozen)
    yield


@contextlib.contextmanager
def _half_batch(mp):
    from repro_torch.models import transformer
    vg = transformer.value_and_grad

    def half(params, batch, cfg, remat=True):
        keep = (batch["tokens"].shape[0] + 1) // 2
        if batch["tokens"].shape[0] > 1:
            keep = batch["tokens"].shape[0] // 2
        return vg(params, {k: v[:keep] for k, v in batch.items()}, cfg,
                  remat)
    mp.setattr(transformer, "value_and_grad", half)
    yield


@contextlib.contextmanager
def _token_altered(mp):
    from repro_torch.launch import serve_lm
    serve = serve_lm.serve

    def altered(*a, **k):
        res = serve(*a, **k)
        res.tokens[0, 2] = (res.tokens[0, 2] + 1) % a[0].vocab
        return res
    mp.setattr(serve_lm, "serve", altered)
    yield


FAULTS = {"fed_round": [_state_unchanged, _half_batch],
          "serve": [_token_altered]}


@pytest.mark.parametrize("entry,fault", [(e, f) for e, fs in FAULTS.items()
                                         for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_comes_out_not_correct(micro_root, monkeypatch, entry, fault):
    for cell in _cell(micro_root, entry):
        assert _run(micro_root[0], cell)["correct"] is True
        with monkeypatch.context() as mp, fault(mp):
            out = _run(micro_root[0], cell)
        assert out["correct"] is False, (cell, out["checks"])


@pytest.mark.parametrize("entry", FAULTS)
def test_control_fails_the_limits(micro_root, entry):
    root = micro_root[0]
    man = harness.manifest(root)
    for cell in _cell(micro_root, entry):
        c = harness.find_cell(man, cell, root)
        limits = c.workload["limits"]
        for seed in (31, 32):
            if entry == "fed_round":
                read = control.fed_readings(c, seed, torch.device("cpu"))
                ctl = read["control"]
                assert any(ctl[k] > limits[k] for k in limits), ctl
                half = read["half_batch"]
                assert any(half[k] > limits[k] for k in limits), half
            else:
                read = control.serve_readings(c, seed, torch.device("cpu"))
                prog = read["program"]
                assert all(prog[k] <= limits[k] for k in limits), read
                for name in ("control_tf32", "control_fp8kv", "altered"):
                    r = read[name]
                    assert any(r[k] > limits[k] for k in limits), (name,
                                                                   read)
