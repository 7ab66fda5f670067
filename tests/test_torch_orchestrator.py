"""Port parity for the federated round clock: ``repro_torch.fed.Orchestrator``
against ``repro.fed.Orchestrator`` from the same weights (converted with
``params_from_numpy``) on the same micro dataset, both on the CPU, both
sketching with the gather-plan encoder.

Cohorts, fates and every count come from the same numpy draws, so they,
the bytes and the traffic dict are compared for equality.  Gradients agree
to about one bfloat16 step (``test_torch_model.py``), so losses are held
to rtol=1e-3, as in ``test_torch_round.py``.

The parity runs take the learning rate from ``linear_decay``, as
``test_torch_round.py`` does.  The orchestrator's default, ``triangular``,
gives round 0 a learning rate of 0: the error sketch is then all zeros
and Delta is a top-k of ties, where ``torch.topk`` and ``lax.top_k`` pick
different (zero-valued) ids and so mask different momentum cells.
``test_zero_first_learning_rate_moves_nothing`` holds what does agree in
that case.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import fed as jfed
from repro.core import fetchsgd as JF
from repro.launch import simulate as jsim
from repro.models import transformer as jt
from repro.optim import linear_decay as j_linear_decay
from repro_torch import fed as tfed
from repro_torch.convert import params_from_numpy
from repro_torch.core import fetchsgd as TF
from repro_torch.core import layout as L
from repro_torch.data import federated
from repro_torch.launch import simulate as tsim
from repro_torch.optim import linear_decay as t_linear_decay
from repro_torch.optim import triangular as t_triangular

SKETCH = dict(rows=3, cols=1 << 12, k=64)
ROUNDS, LR = 3, 0.2
CASES = {
    "flat-dropout": dict(clients_per_round=4, aggregate="flat",
                         straggler=dict(dropout_prob=0.25), seed=2),
    "flat-stragglers-samples": dict(
        clients_per_round=4, aggregate="flat", weight_by="samples",
        straggler=dict(straggle_prob=0.5, max_delay=2), seed=3),
    "tree": dict(clients_per_round=5, aggregate="tree", tree_fanout=2,
                 seed=0),
    "async-stragglers": dict(
        clients_per_round=4, aggregate="async",
        straggler=dict(straggle_prob=0.5, dropout_prob=0.1, max_delay=2),
        seed=3),
    "variable-cohort": dict(clients_per_round=6, min_clients_per_round=1,
                            aggregate="async", seed=1),
}


def fed_cfg(mod, case):
    kw = dict(CASES[case])
    sm = mod.StragglerModel(**kw.pop("straggler", {}))
    return mod.FederationConfig(rounds=ROUNDS, straggler=sm, **kw)


@pytest.fixture(scope="module")
def micro():
    cfg = jsim.micro_cfg()
    jp = jax.tree_util.tree_map(np.asarray,
                                jt.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, tsim.micro_cfg(), jp, jsim.micro_dataset(cfg)


@pytest.fixture(scope="module")
def reference_runs(micro):
    """Every case through the reference, once (one shared jitted grad)."""
    cfg, _, jp, ds = micro
    grad_fn = jfed.orchestrator.make_grad_fn(cfg)
    return {case: jfed.Orchestrator(
                cfg, JF.FetchSGDConfig(**SKETCH), fed_cfg(jfed, case), ds,
                params=jax.tree_util.tree_map(jax.numpy.asarray, jp),
                lr_fn=j_linear_decay(LR, ROUNDS), grad_fn=grad_fn).run()
            for case in CASES}


def port_run(micro, case, device="cpu", lr_fn=None):
    _, tcfg, jp, ds = micro
    return tfed.Orchestrator(tcfg, TF.FetchSGDConfig(**SKETCH),
                             fed_cfg(tfed, case), ds,
                             params=params_from_numpy(jp, device),
                             lr_fn=lr_fn or t_linear_decay(LR, ROUNDS),
                             device=device).run()


def without_loss(rec) -> dict:
    """A record's fields but its loss (the event clock's fields included:
    unset on the round clock, in both packages)."""
    d = dataclasses.asdict(rec)
    del d["loss"]
    return d


@pytest.mark.parametrize("case", list(CASES))
def test_rounds_follow_the_reference(micro, reference_runs, case):
    want, got = reference_runs[case], port_run(micro, case)
    assert [without_loss(r) for r in got.records] \
        == [without_loss(r) for r in want.records]
    assert got.traffic == want.traffic
    assert got.extras["pending_late"] == want.extras["pending_late"]
    assert int(got.opt_state.step) == int(want.opt_state.step)
    assert [l is None for l in got.losses] == [l is None for l in want.losses]
    np.testing.assert_allclose(
        [l for l in got.losses if l is not None],
        [l for l in want.losses if l is not None], rtol=1e-3)
    for r in got.records:
        assert r.n_fresh + r.n_dropped + r.n_straggling == len(r.cohort)


def test_zero_first_learning_rate_moves_nothing(micro):
    """Under ``triangular`` round 0 has lr 0: both packages extract k
    zero-valued coordinates, the weights do not move, and round 1 starts
    from the initial weights in both."""
    cfg, tcfg, jp, ds = micro
    case = "tree"
    want = jfed.Orchestrator(
        cfg, JF.FetchSGDConfig(**SKETCH), fed_cfg(jfed, case), ds,
        params=jax.tree_util.tree_map(jax.numpy.asarray, jp)).run()
    got = port_run(micro, case, lr_fn=t_triangular(0.2, ROUNDS))
    assert [without_loss(r) for r in got.records] \
        == [without_loss(r) for r in want.records]
    assert got.traffic == want.traffic
    np.testing.assert_allclose(got.losses[:2], want.losses[:2], rtol=1e-5)


@pytest.mark.parametrize("vectorized", [False, True],
                         ids=["round", "vectorized"])
def test_round_loss_is_the_cohort_mean_of_each_clients_loss(micro,
                                                            vectorized):
    """``RoundRecord.loss`` is, bit for bit, the cohort-order mean of each
    client's ``float(loss)`` from ``grad_fn`` on the round's weights: the
    loop keeps the losses on the device and reads them at once, which
    changes no float."""
    _, tcfg, jp, ds = micro
    orch = tfed.Orchestrator(
        tcfg, TF.FetchSGDConfig(**SKETCH),
        tfed.FederationConfig(rounds=2, clients_per_round=4, seed=2,
                              vectorized=vectorized),
        ds, params=params_from_numpy(jp, "cpu"),
        lr_fn=t_linear_decay(LR, 2), device="cpu")
    for r in range(2):
        before = L.tree_map(torch.clone, orch.params)
        rec = orch.run_round(r)
        assert rec.n_fresh == len(rec.cohort) == 4
        losses = [float(orch.grad_fn(before, federated.to_batch(
                      ds.client_batch(c), "cpu"))[0]) for c in rec.cohort]
        assert rec.loss == sum(losses) / len(losses)


def test_cases_exercise_every_fate(reference_runs):
    recs = {c: r.records for c, r in reference_runs.items()}
    assert sum(r.n_dropped for r in recs["flat-dropout"]) > 0
    assert sum(r.n_late for r in recs["async-stragglers"]) > 0
    assert len({len(r.cohort) for r in recs["variable-cohort"]}) > 1


def test_loss_falls_on_the_micro_run():
    """The reference's sanity check, on the port alone: loss about 5.3 at
    init, below 4.9 within 5 rounds (the default simulate run)."""
    cfg = tsim.micro_cfg()
    res = tsim.run_simulation(cfg, rounds=5, dataset=tsim.micro_dataset(cfg),
                              device="cpu")
    assert 5.0 < res.losses[0] < 5.6
    assert min(res.losses) < 4.9


@pytest.mark.parametrize("cls,kw", [
    ("SimTimeConfig", dict(quorum=0)),
    ("SimTimeConfig", dict(staleness_lambda=-0.5)),
    ("SimTimeConfig", dict(queue_bucket_s=0.0)),
    ("HeterogeneityConfig", dict(profile_stream="quantum"))])
def test_bad_event_knobs_raise_as_in_the_reference(cls, kw):
    for mod in (jfed, tfed):
        with pytest.raises(ValueError):
            getattr(mod, cls)(**kw)


def test_bad_options_raise_as_in_the_reference():
    with pytest.raises(ValueError):
        tfed.FederationConfig(clock="wall")
    with pytest.raises(ValueError):
        tfed.FederationConfig(weight_by="size")
    with pytest.raises(ValueError):
        tfed.StragglerModel(dropout_prob=0.6, straggle_prob=0.6)
    with pytest.raises(ValueError):
        tfed.StragglerModel(max_delay=0)
