"""Port parity for the event clock: ``repro_torch.fed.Orchestrator(clock=
"event")`` against ``repro.fed``'s, both on the CPU, from the same weights
(converted with ``params_from_numpy``) on the same micro dataset.

Every ``RoundRecord`` field but the loss (cohorts, fates, counts, bytes,
``t_dispatch``, ``t_virtual``, ``critical_path_s``) is a function of the
seed, the configuration and numpy's float64 time arithmetic, so it is
compared for equality, as are the traffic and what is left in flight.

Losses: the packages' gradients agree to about one bfloat16 step
(``test_torch_model.py``), and a near-tie at the k-th |estimate| turns
that into a different coordinate of Delta.  In the async case below
(quorum 2 of 6) the two packages' first updates share 63 of their 64
coordinates, and by round 2 the losses differ by 3e-3 (5.0237 against
5.0086 in a 3 x 4096 sketch with quorum 3; 1.9e-3 at 3 x 2**16).  So the
port's own model is held to the reference on the first round's loss
(computed from the common initial weights, rtol 1e-4), and every round's
loss is held to rtol 1e-3 in a second run that hands the port the
reference's gradients: the event loop, the timed merges and the server
step are then all that can differ.  Both use ``linear_decay``, as
``test_torch_orchestrator.py`` does (``triangular`` starts at lr 0).

The reference's vectorized and per-object runs give byte-identical
records (``tests/test_population.py``), so one reference run, vectorized,
is the oracle of both port paths; the port's two paths are held to each
other byte for byte, losses and weights included.
"""

import dataclasses

import jax
import jax.numpy as jnp
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
from repro_torch.launch import simulate as tsim
from repro_torch.optim import linear_decay as t_linear_decay

SKETCH = dict(rows=3, cols=1 << 12, k=64)
ROUNDS, LR = 3, 0.2
SKEWED = dict(compute_median=1.0, compute_sigma=0.5, bandwidth_median=1e5,
              bandwidth_sigma=2.0)
WINDOWED = dict(SKEWED, avail_period=50.0, avail_duty_min=0.4,
                avail_duty_max=0.9)
CASES = {
    "flat": dict(aggregate="flat", het=WINDOWED, seed=0,
                 straggler=dict(dropout_prob=0.15, straggle_prob=0.25,
                                max_delay=2)),
    "tree": dict(aggregate="tree", tree_fanout=2, het=SKEWED, seed=1,
                 sim=dict(link_bandwidth=2e5),
                 straggler=dict(dropout_prob=0.15)),
    "async": dict(aggregate="async", het=SKEWED, seed=3,
                  sim=dict(quorum=2, staleness_lambda=0.05, max_age=2.0),
                  straggler=dict(straggle_prob=0.25, max_delay=2)),
    "async-legacy-profile": dict(
        aggregate="async", het=dict(WINDOWED, weight_sigma=0.3,
                                    profile_stream="legacy"),
        weight_by="profile", seed=4, sim=dict(quorum=4),
        straggler=dict(dropout_prob=0.1, straggle_prob=0.25, max_delay=2)),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The micro model's ops are tiny: one intra-op thread is as fast
    alone and does not oversubscribe the cores when test files run in
    parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fed_cfg(mod, case, vectorized=False):
    kw = dict(CASES[case])
    het = mod.HeterogeneityConfig(**kw.pop("het"))
    sim = mod.SimTimeConfig(heterogeneity=het, **kw.pop("sim", {}))
    sm = mod.StragglerModel(**kw.pop("straggler", {}))
    return mod.FederationConfig(rounds=ROUNDS, clients_per_round=6,
                                clock="event", simtime=sim, straggler=sm,
                                vectorized=vectorized, **kw)


@pytest.fixture(scope="module")
def micro():
    cfg = jsim.micro_cfg()
    jp = jax.tree_util.tree_map(np.asarray,
                                jt.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, tsim.micro_cfg(), jp, jsim.micro_dataset(cfg)


@pytest.fixture(scope="module")
def ref_grad(micro):
    return jfed.orchestrator.make_grad_fn(micro[0])


@pytest.fixture(scope="module")
def reference_runs(micro, ref_grad):
    """Every case through the reference's vectorized event loop, once."""
    cfg, _, jp, ds = micro
    return {case: jfed.Orchestrator(
                cfg, JF.FetchSGDConfig(**SKETCH),
                fed_cfg(jfed, case, vectorized=True), ds,
                params=jax.tree_util.tree_map(jnp.asarray, jp),
                lr_fn=j_linear_decay(LR, ROUNDS), grad_fn=ref_grad).run()
            for case in CASES}


def reference_grads(ref_grad):
    """The port's ``grad_fn`` signature over the reference's gradient."""
    def grad_fn(params, batch):
        jp = L.tree_map(lambda x: jnp.asarray(x.numpy()), params)
        loss, g = ref_grad(jp, {k: jnp.asarray(v.numpy().astype(np.int32))
                                for k, v in batch.items()})
        return (torch.tensor(float(loss)),
                L.tree_map(lambda x: torch.from_numpy(np.array(x)), g))
    return grad_fn


def port_orch(micro, case, vectorized=False, grad_fn=None):
    _, tcfg, jp, ds = micro
    return tfed.Orchestrator(tcfg, TF.FetchSGDConfig(**SKETCH),
                             fed_cfg(tfed, case, vectorized), ds,
                             params=params_from_numpy(jp, "cpu"),
                             lr_fn=t_linear_decay(LR, ROUNDS),
                             grad_fn=grad_fn, device="cpu")


def without_loss(rec) -> dict:
    d = dataclasses.asdict(rec)
    del d["loss"]
    return d


def assert_follows(got, want):
    assert [without_loss(r) for r in got.records] \
        == [without_loss(r) for r in want.records]
    assert got.traffic == want.traffic
    for key in ("pending_late", "in_flight", "t_virtual"):
        assert got.extras[key] == want.extras[key], key
    assert int(got.opt_state.step) == int(want.opt_state.step)
    assert [l is None for l in got.losses] == [l is None for l in want.losses]


@pytest.mark.parametrize("vectorized", [False, True],
                         ids=["per-object", "vectorized"])
@pytest.mark.parametrize("case", list(CASES))
def test_event_records_follow_the_reference(micro, reference_runs, case,
                                            vectorized):
    want = reference_runs[case]
    got = port_orch(micro, case, vectorized).run()
    assert_follows(got, want)
    np.testing.assert_allclose(got.losses[0], want.losses[0], rtol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_event_losses_follow_the_reference(micro, reference_runs, ref_grad,
                                           case):
    want = reference_runs[case]
    got = port_orch(micro, case, grad_fn=reference_grads(ref_grad)).run()
    assert_follows(got, want)
    np.testing.assert_allclose(
        [l for l in got.losses if l is not None],
        [l for l in want.losses if l is not None], rtol=1e-3)


def test_cases_exercise_the_event_clock(reference_runs):
    recs = {c: r.records for c, r in reference_runs.items()}
    for rs in recs.values():
        times = [r.t_virtual for r in rs]
        assert times == sorted(times) and times[0] > 0
        assert all(r.t_dispatch < r.t_virtual for r in rs)
        # a merge of nothing (every arrival too stale) has no levels
        assert all((r.critical_path_s > 0) == (r.n_fresh + r.n_late > 0)
                   for r in rs)
    assert sum(r.n_dropped for r in recs["flat"]) > 0
    # tree: backbone forwards are charged beside the leaf uploads
    tb = TF.upload_bytes(TF.FetchSGDConfig(**SKETCH))
    assert any(r.upload_bytes > (len(r.cohort) - r.n_dropped) * tb
               for r in recs["tree"])
    # async: uploads stay in flight across updates, and max_age drops some
    for case in ("async", "async-legacy-profile"):
        assert all(r.n_straggling > 0 for r in recs[case])
        assert reference_runs[case].extras["in_flight"] > 0
    merged = sum(r.n_late for r in recs["async"])
    assert merged < 2 * ROUNDS


@pytest.mark.parametrize("case", list(CASES))
def test_vectorized_equals_per_object_bytewise(micro, case):
    obj = port_orch(micro, case).run()
    vec = port_orch(micro, case, vectorized=True).run()
    assert [dataclasses.asdict(r) for r in vec.records] \
        == [dataclasses.asdict(r) for r in obj.records]
    assert vec.traffic == obj.traffic
    for (_, a), (_, b) in zip(L.flatten(vec.params), L.flatten(obj.params)):
        assert torch.equal(a, b)


def test_lazy_events_use_the_weights_they_were_dispatched_with(micro):
    """Async, quorum 2 of a cohort of 6: round-r events merge after round
    r's and later updates, which change the weights in place.  A lazy event
    must be computed against a copy of the weights of its dispatch round;
    a shared reference would compute it against the newest weights, and
    its loss and table would differ from the per-object run's."""
    obj = port_orch(micro, "async")
    vec = port_orch(micro, "async", vectorized=True)
    late_merges = 0
    for r in range(ROUNDS):
        a, b = obj.run_round(r), vec.run_round(r)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert vec.held_snapshots >= 1      # events of a past update wait
        for rr, snap in vec._snapshots.items():
            assert all(s.data_ptr() != p.data_ptr() for (_, s), (_, p)
                       in zip(L.flatten(snap), L.flatten(vec.params)))
            late_merges += rr < r
    assert late_merges > 0
    for (_, a), (_, b) in zip(L.flatten(vec.params), L.flatten(obj.params)):
        assert torch.equal(a, b)


def test_snapshots_are_released_when_their_events_arrive(micro):
    vec = port_orch(micro, "flat", vectorized=True)
    for r in range(ROUNDS):
        vec.run_round(r)
        # flat drains the queue each round: nothing stays in flight
        assert vec.held_snapshots == 0 and len(vec._queue) == 0


def test_bad_populations_raise_as_in_the_reference(micro):
    cfg, tcfg, _, _ = micro
    for mod, fs, model_cfg, kw in ((jfed, JF, cfg, {}),
                                   (tfed, TF, tcfg, dict(device="cpu"))):
        for n, match in ((4, "exceeds the population"),
                         (0, "empty population")):
            with pytest.raises(ValueError, match=match):
                mod.Orchestrator(model_cfg, fs.FetchSGDConfig(**SKETCH),
                                 fed_cfg(mod, "flat", True),
                                 jsim.micro_dataset(cfg, n_clients=n), **kw)
