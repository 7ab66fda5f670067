"""The port's ``repro_torch.launch.async_federated`` and
``.heterogeneous_federation`` against the reference's examples of the
same names, as ``test_torch_examples.py`` holds the other two (its
helpers and its masks): the printed lines equal once the losses are
masked (cohorts, fresh / late / dropped / straggling, the buffered
tables, upload bytes, ``t_virtual`` and the critical paths exact), the
losses from common weights within rtol 1e-3, and async_federated's resume
from its checkpoint directories (``<dir>-flat``, ``<dir>-async``).

The resumed rounds come after a round 1 that updated the weights, and
the triangular schedule's round 0 (lr 0) extracts a top-k of ties, whose
masked momentum cells differ between ``torch.topk`` and ``lax.top_k``
(ROADMAP §3): the resumed losses are only checked finite, every other
printed field exactly.
"""

import numpy as np
import pytest

from repro_torch.launch import async_federated, heterogeneous_federation

from test_torch_examples import (ARGV, assert_losses_close,  # noqa: F401
                                 loss_free, one_torch_thread, run_port,
                                 run_reference)


@pytest.fixture(scope="module")
def async_ref():
    return run_reference("async_federated", ARGV)


@pytest.fixture(scope="module")
def hetero_ref():
    return run_reference("heterogeneous_federation", ARGV)


def record_fields(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k != "loss"}


def assert_runs_follow(runs: dict, ref: list, policies: tuple) -> None:
    assert tuple(runs) == policies and len(ref) == len(policies)
    for (policy, run), res in zip(runs.items(), ref):
        assert [record_fields(r) for r in run["records"]] == [
            record_fields(vars(r)) for r in res.records], policy
        assert run["traffic"] == res.traffic
        assert run["pending_late"] == res.extras["pending_late"]
        assert run["t_virtual"] == res.extras["t_virtual"]
        assert_losses_close(run["losses"], res.losses)


def test_async_federated_prints_the_references_lines(async_ref):
    want, ref = async_ref
    got, runs = run_port(async_federated, ARGV)
    assert loss_free(got) == loss_free(want)
    assert got[0] == "model gpt2s-federated-micro  sketch 5x4096 k=256"
    assert_runs_follow(runs, ref, ("flat", "async"))
    asyn = runs["async"]["records"]
    assert sum(r["n_late"] for r in asyn) > 0        # a late table merged
    assert not any(runs["async"]["launches"].values())


def test_async_federated_with_its_own_weights(async_ref):
    want, _ = async_ref
    got, runs = run_port(async_federated, ARGV, common=False)
    assert loss_free(got) == loss_free(want)
    assert all(np.isfinite(run["losses"]).all() for run in runs.values())


def test_async_federated_resumes_from_its_checkpoints(tmp_path):
    """2 rounds into ``--checkpoint-dir``, then 4 rounds with the same
    directory: each policy resumes after round 1 (its checkpoint after the
    last round), in both packages, and prints the same records."""
    lines = {}
    for pkg in ("reference", "port"):
        d = str(tmp_path / pkg / "ckpt")
        for rounds in ("2", "4"):
            argv = ["--rounds", rounds, "--checkpoint-dir", d]
            if pkg == "reference":
                lines[pkg, rounds], _ = run_reference("async_federated", argv)
            else:
                lines[pkg, rounds], runs = run_port(async_federated, argv)
        assert (tmp_path / pkg / "ckpt-flat").is_dir()
        assert (tmp_path / pkg / "ckpt-async").is_dir()
    want, got = lines["reference", "4"], lines["port", "4"]
    assert loss_free(got) == loss_free(want)
    assert "[flat] resuming from round 2" in got
    assert "[async] resuming from round 2" in got
    assert [r["round_idx"] for r in runs["async"]["records"]] == [2, 3]
    assert all(run["start_round"] == 2 for run in runs.values())
    assert all(np.isfinite([l for l in run["losses"] if l is not None]).all()
               for run in runs.values())


def test_async_federated_refuses_a_finished_checkpoint(tmp_path):
    """The same command again finds every round checkpointed: no round is
    left to report a loss, so the run raises (the reference's raises an
    ``IndexError`` at the same line)."""
    argv = ["--rounds", "2", "--checkpoint-dir", str(tmp_path / "c")]
    run_port(async_federated, argv)
    with pytest.raises(RuntimeError, match="no round reported a loss"):
        run_port(async_federated, argv)


def test_heterogeneous_federation_prints_the_references_lines(hetero_ref):
    want, ref = hetero_ref
    got, runs = run_port(heterogeneous_federation, ARGV)
    assert loss_free(got) == loss_free(want)
    assert got[0] == ("model gpt2s-federated-micro  sketch 5x4096 k=256 "
                      "table=82kB")
    assert_runs_follow(runs, ref, ("flat", "tree", "async"))
    for run, res in zip(runs.values(), ref):
        assert run["upload_mb"] == sum(r.upload_bytes
                                       for r in res.records) / 1e6
        assert run["cp_sum_s"] == sum(r.critical_path_s for r in res.records)
        assert run["final_loss"] == pytest.approx(
            [l for l in res.losses if l is not None][-1], rel=1e-3)


def test_heterogeneous_federation_with_its_own_weights(hetero_ref):
    """The virtual clock is numpy on the host: the port's own weights
    change the losses only, never ``t_virtual`` or a critical path."""
    want, _ = hetero_ref
    got, runs = run_port(heterogeneous_federation, ARGV, common=False)
    assert loss_free(got) == loss_free(want)
    assert all(np.isfinite(run["final_loss"]) for run in runs.values())
