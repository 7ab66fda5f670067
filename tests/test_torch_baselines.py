"""Port parity for the paper's baselines and for ``run_simulation``:
``repro_torch.baselines`` / ``core.topk.topk_dense`` /
``launch.simulate`` against their ``repro`` namesakes.

Functions are fed the same numpy trees.  Elementwise updates repeat the
reference's float32 operations and are compared exactly; a top-k is
compared as a set of ids (``torch.topk`` and ``lax.top_k`` may order ties
differently).  ``run_simulation`` runs 3 micro rounds of every method from
the reference's weights (``params_from_numpy``): losses within rtol=1e-3
(gradients agree to about one bfloat16 step, ``test_torch_model.py``) and
the traffic dict equal.  Those runs use a 3 x 4096 sketch and k = 64: at
simulate's default k = 512 the top-k reacts so strongly to its inputs that
a 1e-6 relative change of the port's own weights moves its round-1 loss by
about 6e-4, and bfloat16-level gradient differences by more than 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import fedavg as JFA
from repro.baselines import local_topk as JLT
from repro.baselines import uncompressed as JU
from repro.core import fetchsgd as JF
from repro.core import layout as JL
from repro.core import topk as JTK
from repro.launch import simulate as jsim
from repro.models import transformer as jt
from repro_torch.baselines import fedavg as TFA
from repro_torch.baselines import local_topk as TLT
from repro_torch.baselines import uncompressed as TU
from repro_torch.convert import params_from_numpy
from repro_torch.core import fetchsgd as TF
from repro_torch.core import layout as TL
from repro_torch.core import topk as TTK
from repro_torch.launch import simulate as tsim

SHAPES = {"a": {"w": (64, 48)}, "b": (300,), "c": {"x": (3, 5, 7)}}
K = 64
SKETCH = dict(rows=3, cols=1 << 12, k=K, momentum=0.9)


def tree(seed: int, integer: bool = False) -> dict:
    rng = np.random.default_rng(seed)

    def leaf(shape):
        x = rng.integers(-8, 9, shape) if integer else \
            rng.standard_normal(shape)
        return x.astype(np.float32)

    def build(s):
        return {k: build(v) for k, v in s.items()} if isinstance(s, dict) \
            else leaf(s)
    return build(SHAPES)


def jx(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def assert_trees_equal(jtree, ttree, **tol):
    want = dict(TL.flatten(jax.tree_util.tree_map(np.asarray, jtree)))
    got = {p: x.numpy() for p, x in TL.flatten(ttree)}
    assert want.keys() == got.keys()
    for p in want:
        if tol:
            np.testing.assert_allclose(got[p], want[p], **tol)
        else:
            np.testing.assert_array_equal(got[p], want[p])


def ids(delta, lay, mod):
    if mod is JTK:
        offs = np.asarray([ch.offset for ch in lay.chunks], np.int64)
        return offs[np.asarray(delta.chunk_id)] + np.asarray(delta.local_idx)
    return TTK.global_ids(delta, lay).numpy()


@pytest.fixture(scope="module")
def lays():
    t = tree(0)
    return (JL.build_layout(jx(t), chunk_elems=1000),
            TL.build_layout(params_from_numpy(t), chunk_elems=1000))


def test_uncompressed_step_matches_the_reference():
    p, g1, g2 = tree(1), tree(2), tree(3)
    jcfg, tcfg = JU.SGDConfig(momentum=0.9), TU.SGDConfig(momentum=0.9)
    jp, js = jx(p), JU.init_state(jx(p), jcfg)
    tp, ts = params_from_numpy(p), TU.init_state(params_from_numpy(p), tcfg)
    for g in (g1, g2):
        jp, js = JU.step(jp, jx(g), js, 0.1, jcfg)
        tp, ts = TU.step(tp, params_from_numpy(g), ts, 0.1, tcfg)
    assert_trees_equal(jp, tp)
    assert_trees_equal(js.velocity, ts.velocity)
    assert int(js.step) == ts.step == 2


@pytest.mark.parametrize("k", [1, 7, K, 500])
def test_topk_dense_picks_the_references_ids(lays, k):
    jlay, tlay = lays
    acc = tree(k)
    jd = JTK.topk_dense(JL.leaf_views(jx(acc), jlay), jlay, k)
    td = TTK.topk_dense(TL.leaf_views(params_from_numpy(acc), tlay), tlay, k)
    assert td.k == jd.k
    jid, tid = ids(jd, jlay, JTK), ids(td, tlay, TTK)
    assert set(tid) == set(jid) and len(set(tid)) == td.k
    np.testing.assert_array_equal(td.values.numpy()[np.argsort(tid)],
                                  np.asarray(jd.values)[np.argsort(jid)])


@pytest.mark.parametrize("feedback", [False, True])
def test_local_topk_compress_and_apply_match_the_reference(lays, feedback):
    jlay, tlay = lays
    jcfg = JLT.LocalTopKConfig(k=K, use_error_feedback=feedback,
                               global_momentum=0.9)
    tcfg = TLT.LocalTopKConfig(k=K, use_error_feedback=feedback,
                               global_momentum=0.9)
    p = tree(10)
    jerr = JLT.init_client_error(jx(p)) if feedback else None
    terr = TLT.init_client_error(params_from_numpy(p)) if feedback else None
    jds, tds = [], []
    for seed in (11, 12, 13):
        g = tree(seed)
        jdelta, jerr = JLT.client_compress(jx(g), jerr, 0.5, jlay, jcfg)
        tdelta, terr = TLT.client_compress(params_from_numpy(g), terr, 0.5,
                                           tlay, tcfg)
        assert set(ids(tdelta, tlay, TTK)) == set(ids(jdelta, jlay, JTK))
        jds.append(jdelta)
        tds.append(tdelta)
    if feedback:
        assert_trees_equal(jerr, terr)
    jp, js = JLT.server_apply(jx(p), jds, JLT.init_server_state(jx(p), jcfg),
                              jlay, jcfg)
    tp, ts = TLT.server_apply(params_from_numpy(p), tds,
                              TLT.init_server_state(params_from_numpy(p),
                                                    tcfg), tlay, tcfg)
    assert_trees_equal(jp, tp)
    assert_trees_equal(js.velocity, ts.velocity)


def test_fedavg_client_and_server_match_the_reference():
    p = tree(20)
    cfg_kw = dict(local_epochs=3, global_momentum=0.9)
    jcfg, tcfg = JFA.FedAvgConfig(**cfg_kw), TFA.FedAvgConfig(**cfg_kw)
    xs = np.asarray([1.0, 0.5, -0.25], np.float32)

    def jgrad(params, x):       # dL/dw = w * x
        return jax.tree_util.tree_map(lambda w: w * x, params)

    def tgrad(params, batch):
        return TL.tree_map(lambda w: w * batch["x"], params)

    jdeltas, tdeltas = [], []
    for scale in (1.0, 2.0):
        jdeltas.append(JFA.client_update(jx(p), jnp.asarray(scale * xs), 0.5,
                                         jgrad, jcfg))
        tdeltas.append(TFA.client_update(
            params_from_numpy(p), {"x": torch.from_numpy(scale * xs)}, 0.5,
            tgrad, tcfg))
        assert_trees_equal(jdeltas[-1], tdeltas[-1], rtol=1e-6, atol=1e-6)
    jp, js = JFA.server_apply(jx(p), jdeltas, [1.0, 3.0],
                              JFA.init_server_state(jx(p), jcfg), jcfg)
    tp, ts = TFA.server_apply(params_from_numpy(p), tdeltas, [1.0, 3.0],
                              TFA.init_server_state(params_from_numpy(p),
                                                    tcfg), tcfg)
    assert_trees_equal(jp, tp, rtol=1e-6, atol=1e-6)
    assert ts.step == int(js.step) == 1


@pytest.fixture(scope="module")
def micro():
    cfg = jsim.micro_cfg()
    jp = jax.tree_util.tree_map(np.asarray,
                                jt.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, jp, jsim.micro_dataset(cfg)


@pytest.mark.parametrize("method", tsim.METHODS)
def test_run_simulation_follows_the_reference(micro, method):
    cfg, jp, ds = micro
    want = jsim.run_simulation(
        cfg, method=method, rounds=3, dataset=ds,
        fs_cfg=JF.FetchSGDConfig(**SKETCH),
        topk_cfg=JLT.LocalTopKConfig(k=K))
    seen = []
    got = tsim.run_simulation(
        tsim.micro_cfg(), method=method, rounds=3, dataset=ds,
        fs_cfg=TF.FetchSGDConfig(**SKETCH),
        topk_cfg=TLT.LocalTopKConfig(k=K), params=params_from_numpy(jp),
        device="cpu", progress=lambda r, loss: seen.append((r, loss)))
    assert got.method == want.method
    assert got.traffic == want.traffic
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-3)
    assert seen == list(enumerate(got.losses))


@pytest.mark.parametrize("argv", [
    ["--method", "fetchsgd", "--aggregate", "async", "--straggle-prob",
     "0.3", "--dropout-prob", "0.2"],
    ["--method", "fedavg"]])
def test_cli_prints_the_references_format(capsys, argv):
    tsim.main(["--device", "cpu", "--rounds", "2", *argv])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"method={argv[1]} aggregate=")
    assert lines[1].startswith("round 0: loss ")
    assert lines[-1].startswith("traffic: up=")
    if argv[1] == "fetchsgd":
        assert "fresh=" in lines[1] and "dropped=" in lines[1]
