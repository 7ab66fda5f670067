"""Port parity for the population-scale paths: the vectorized round clock
(``FederationConfig(vectorized=True)``, ``weight_by="profile"``, both
profile streams) and a 10^4-client event-clock population, against
``repro``'s.

As in ``test_torch_event_clock.py``: every ``RoundRecord`` field but the
loss is compared for equality; the port's own model is held to the first
round's loss (rtol 1e-4), and every round's loss to rtol 1e-3 in a run
that hands the port the reference's gradients (the packages' gradients
differ by about one bfloat16 step, which a near-tie in the top-k turns
into a different coordinate of Delta).  The port's vectorized and
per-object paths are held to each other byte for byte.
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
HET = dict(compute_median=1.0, compute_sigma=0.5, bandwidth_median=1e5,
           bandwidth_sigma=2.0, weight_sigma=0.3)
CASES = {
    "round-flat-counter": dict(aggregate="flat", clients_per_round=6,
                               stream="counter", seed=0, straggler=dict(
                                   dropout_prob=0.15, straggle_prob=0.25)),
    "round-tree-legacy": dict(aggregate="tree", tree_fanout=2,
                              clients_per_round=5, stream="legacy", seed=1),
    "round-async-counter": dict(aggregate="async", clients_per_round=6,
                                stream="counter", seed=3, straggler=dict(
                                    straggle_prob=0.5, max_delay=2)),
    # a cohort of 1,000 lazy events from 10^4 clients, 8 materialized a
    # round
    "event-async-10k": dict(aggregate="async", clients_per_round=1000,
                            stream="counter", seed=5, clock="event",
                            n_clients=10_000, weight_by="uniform",
                            sim=dict(quorum=8)),
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


def fed_cfg(mod, case, vectorized=True):
    kw = dict(CASES[case])
    kw.pop("n_clients", None)
    het = mod.HeterogeneityConfig(**HET, profile_stream=kw.pop("stream"))
    sim = mod.SimTimeConfig(heterogeneity=het, **kw.pop("sim", {}))
    sm = mod.StragglerModel(**kw.pop("straggler", {}))
    return mod.FederationConfig(**dict(
        dict(rounds=ROUNDS, weight_by="profile", clock="round"), **kw,
        simtime=sim, straggler=sm, vectorized=vectorized))


@pytest.fixture(scope="module")
def micro():
    cfg = jsim.micro_cfg()
    jp = jax.tree_util.tree_map(np.asarray,
                                jt.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, tsim.micro_cfg(), jp


def dataset(micro, case):
    return jsim.micro_dataset(micro[0],
                              n_clients=CASES[case].get("n_clients", 64))


@pytest.fixture(scope="module")
def ref_grad(micro):
    return jfed.orchestrator.make_grad_fn(micro[0])


@pytest.fixture(scope="module")
def reference_runs(micro, ref_grad):
    cfg, _, jp = micro
    return {case: jfed.Orchestrator(
                cfg, JF.FetchSGDConfig(**SKETCH), fed_cfg(jfed, case),
                dataset(micro, case),
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


def port_run(micro, case, vectorized=True, grad_fn=None):
    _, tcfg, jp = micro
    return tfed.Orchestrator(tcfg, TF.FetchSGDConfig(**SKETCH),
                             fed_cfg(tfed, case, vectorized),
                             dataset(micro, case),
                             params=params_from_numpy(jp, "cpu"),
                             lr_fn=t_linear_decay(LR, ROUNDS),
                             grad_fn=grad_fn, device="cpu").run()


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
    assert [l is None for l in got.losses] == [l is None for l in want.losses]


@pytest.mark.parametrize("case", list(CASES))
def test_vectorized_records_follow_the_reference(micro, reference_runs,
                                                 case):
    want = reference_runs[case]
    got = port_run(micro, case)
    assert_follows(got, want)
    np.testing.assert_allclose(got.losses[0], want.losses[0], rtol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_vectorized_losses_follow_the_reference(micro, reference_runs,
                                                ref_grad, case):
    want = reference_runs[case]
    got = port_run(micro, case, grad_fn=reference_grads(ref_grad))
    assert_follows(got, want)
    np.testing.assert_allclose(
        [l for l in got.losses if l is not None],
        [l for l in want.losses if l is not None], rtol=1e-3)


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("round")])
def test_round_clock_vectorized_equals_per_object_bytewise(micro, case):
    obj, vec = port_run(micro, case, False), port_run(micro, case)
    assert [dataclasses.asdict(r) for r in vec.records] \
        == [dataclasses.asdict(r) for r in obj.records]
    assert vec.traffic == obj.traffic
    for (_, a), (_, b) in zip(L.flatten(vec.params), L.flatten(obj.params)):
        assert torch.equal(a, b)


def test_cases_exercise_the_population_paths(reference_runs):
    recs = {c: r.records for c, r in reference_runs.items()}
    assert sum(r.n_dropped for r in recs["round-flat-counter"]) > 0
    assert sum(r.n_late for r in recs["round-async-counter"]) > 0
    big = reference_runs["event-async-10k"]
    assert all(len(r.cohort) == 1000 and r.n_late == 8
               for r in big.records)
    assert big.extras["in_flight"] == ROUNDS * (1000 - 8)
