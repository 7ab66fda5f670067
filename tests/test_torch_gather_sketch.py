"""Port parity for the gather-plan encoder: ``repro_torch.core.gather_sketch``
against ``repro.core.gather_sketch`` and against the port's own scatter
encoder (``sketch_grads``, the plain twin of the encode kernel), on the
micro gpt2s-federated layout.

Tolerances: integer-valued gradients keep every float32 sum exact, so all
three encoders agree bit for bit.  On real values the port's plans repeat
the reference's gather and its order of summation; they are held to
rtol=1e-6, atol=1e-6 against the reference, and to the same tolerance
against the scatter, which associates each bucket's sum differently.
"""

import jax
import numpy as np
import pytest

from repro.core import fetchsgd as JF
from repro.core import gather_sketch as JG
from repro.core import layout as JL
from repro.launch import simulate as jsim
from repro.models import transformer as jt
from repro_torch.convert import params_from_numpy
from repro_torch.core import fetchsgd as TF
from repro_torch.core import gather_sketch as TG
from repro_torch.core import layout as TL

SKETCHES = [dict(rows=5, cols=1 << 14, k=512),
            dict(rows=3, cols=1000, k=64, hash_key=1),
            dict(rows=1, cols=4099, k=4)]


@pytest.fixture(scope="module")
def micro():
    cfg = jsim.micro_cfg()
    shapes = {p: np.asarray(x).shape for p, x in TL.flatten(
        jax.tree_util.tree_map(np.asarray,
                               jt.init_params(cfg, jax.random.PRNGKey(0))))}
    jparams = TL.unflatten(list(shapes), [np.zeros(s, np.float32)
                                          for s in shapes.values()])
    return shapes, JL.build_layout(jparams), TL.build_layout(
        params_from_numpy(jparams))


def grads(shapes, seed: int, integer: bool):
    rng = np.random.default_rng(seed)
    leaves = [(rng.integers(-8, 9, s) if integer else rng.standard_normal(s))
              .astype(np.float32) for s in shapes.values()]
    return TL.unflatten(list(shapes), leaves)


@pytest.mark.parametrize("sk", SKETCHES)
@pytest.mark.parametrize("integer", [True, False])
def test_gather_encoder_matches_the_reference_and_the_scatter(micro, sk,
                                                              integer):
    shapes, jlay, tlay = micro
    g = grads(shapes, sk["cols"], integer)
    jcfg, tcfg = JF.FetchSGDConfig(**sk), TF.FetchSGDConfig(**sk)
    want = np.asarray(jax.jit(JG.build_encoder(jlay, jcfg))(
        jax.tree_util.tree_map(jax.numpy.asarray, g)))
    tg = params_from_numpy(g)
    got = TG.build_encoder(tlay, tcfg)(tg).numpy()
    scatter = TF.sketch_grads(tg, tlay, tcfg).numpy()
    assert got.shape == (tcfg.rows, tcfg.cols) and got.dtype == np.float32
    if integer:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, scatter)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, scatter, rtol=1e-6, atol=1e-6)


def test_plans_follow_the_references_chunk_order(micro):
    _, jlay, tlay = micro
    cfg = dict(rows=2, cols=257, k=8)
    jp = JG.build_plans(jlay, JF.FetchSGDConfig(**cfg))
    tp = TG.build_plans(tlay, TF.FetchSGDConfig(**cfg))
    assert [(p.leaf, p.row_start, p.n_rows) for p in tp] \
        == [(p.leaf, p.row_start, p.n_rows) for p in jp]
    for a, b in zip(jp, tp):
        for (jP, jsgn, jL), (tP, tsgn, tL) in zip(a.row_plans, b.row_plans):
            assert jL == tL
            np.testing.assert_array_equal(np.asarray(jP), tP.numpy())
            np.testing.assert_array_equal(np.asarray(jsgn), tsgn.numpy())
