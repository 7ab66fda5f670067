"""Port parity for the Count Sketch object API: ``CountSketch`` (``+``,
``-``, ``scale``, the compatibility check, ``l2_estimate``), ``zeros``,
``sketch_vector``, ``estimate``, ``hit_mask_chunk`` and
``kernels.ref.l2_estimate`` of ``repro_torch`` against their
``repro.core.count_sketch`` / ``repro.kernels.ref`` namesakes, and twins of
the reference's object-API and recovery cases
(``tests/test_count_sketch.py``).

On the CPU ``sketch_vector`` and ``estimate`` take the plain versions
through ``kernels.ops``; ``tests/test_torch_cuda.py`` holds them on the
card, where they launch the encode and estimate kernels.

Tolerances: integer-valued inputs keep every float32 sum exact, so those
tables and estimates are compared exactly; real values at the
reference's own tolerances (rtol = atol = 1e-5 for tables); the row norms
under ``l2_estimate`` are summed in another order by the two packages,
so rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import count_sketch as jcs
from repro.kernels import ref as jref
from repro_torch.core import count_sketch as tcs
from repro_torch.kernels import ref as tref

ROWS, COLS = 5, 4096
OFFSETS = [0, 1234, 2**32 - 7, 2**41 + 99]


def int_values(rng, n):
    return rng.integers(-8, 9, size=n).astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def tsketch(v, rows=ROWS, cols=COLS, key=0, offset=0):
    return tcs.sketch_vector(t(v), rows, cols, key=key, offset=offset)


@pytest.mark.parametrize("rows,cols", [(ROWS, COLS), (2, 384), (4, 130)])
@pytest.mark.parametrize("offset", OFFSETS)
def test_sketch_vector_and_estimate_exact_on_integers(rng, rows, cols,
                                                      offset):
    v = int_values(rng, 3000)
    got = tsketch(v, rows, cols, key=3, offset=offset)
    want = jcs.sketch_vector(jnp.asarray(v), rows, cols, key=3, offset=offset)
    assert (got.rows, got.cols, got.key) == (want.rows, want.cols, want.key)
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))
    np.testing.assert_array_equal(
        tcs.estimate(got, offset, 3000).numpy(),
        np.asarray(jcs.estimate(want, offset, 3000)))


def test_sketch_vector_of_a_2d_real_vector(rng):
    """Any shape is flattened; the reference's tolerance on reals."""
    v = rng.normal(size=(40, 25)).astype(np.float32)
    got = tsketch(v, offset=77)
    want = jcs.sketch_vector(jnp.asarray(v), ROWS, COLS, offset=77)
    np.testing.assert_allclose(got.table.numpy(), np.asarray(want.table),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float64, np.int32])
def test_sketch_vector_casts_to_float32(rng, dtype):
    v = int_values(rng, 500).astype(dtype)
    got = tsketch(v)
    want = jcs.sketch_vector(jnp.asarray(v.astype(np.float32)), ROWS, COLS)
    assert got.table.dtype == torch.float32
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))


def test_add_sub_scale_exact_on_integers(rng):
    a, b = int_values(rng, 900), int_values(rng, 900)
    ta, tb = tsketch(a), tsketch(b)
    ja = jcs.sketch_vector(jnp.asarray(a), ROWS, COLS)
    jb = jcs.sketch_vector(jnp.asarray(b), ROWS, COLS)
    for got, want in (((ta + tb).table, (ja + jb).table),
                      ((ta - tb).table, (ja - jb).table),
                      (ta.scale(3.0).table, ja.scale(3.0).table),
                      (ta.scale(-0.5).table, ja.scale(-0.5).table)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # linearity: S(a) + S(b) = S(a + b), S(3a) = 3 S(a), exact on integers
    assert torch.equal((ta + tb).table, tsketch(a + b).table)
    assert torch.equal(ta.scale(3.0).table, tsketch(3 * a).table)
    assert torch.equal((ta - tb).table, tsketch(a - b).table)
    merged = ta + tb
    assert (merged.rows, merged.cols, merged.key) == (ROWS, COLS, 0)


def test_merge_object_api(rng):
    """Twin of the reference's ``test_merge_object_api``."""
    g1 = rng.normal(size=100).astype(np.float32)
    g2 = rng.normal(size=100).astype(np.float32)
    merged = tsketch(g1) + tsketch(g2)
    np.testing.assert_allclose(merged.table.numpy(),
                               tsketch(g1 + g2).table.numpy(),
                               rtol=1e-5, atol=1e-5)
    want = (jcs.sketch_vector(jnp.asarray(g1), ROWS, COLS)
            + jcs.sketch_vector(jnp.asarray(g2), ROWS, COLS))
    np.testing.assert_allclose(merged.table.numpy(), np.asarray(want.table),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("other", [dict(rows=3, cols=64, key=1),
                                   dict(rows=4, cols=64, key=0),
                                   dict(rows=3, cols=128, key=0)],
                         ids=["key", "rows", "cols"])
def test_incompatible_merge_raises(other):
    """Twin of the reference's ``test_incompatible_merge_raises``, for
    each of the three parts of the hash identity, and for ``-``."""
    s1 = tcs.zeros(3, 64, key=0)
    s2 = tcs.zeros(**other)
    for op in (lambda: s1 + s2, lambda: s1 - s2):
        with pytest.raises(ValueError, match="hash identities differ"):
            op()
    j1, j2 = jcs.zeros(3, 64, key=0), jcs.zeros(**other)
    with pytest.raises(ValueError):
        _ = j1 + j2


def test_zeros_matches_the_reference():
    got = tcs.zeros(4, 96, key=7, dtype=torch.bfloat16, device="cpu")
    want = jcs.zeros(4, 96, key=7, dtype=jnp.bfloat16)
    assert (got.rows, got.cols, got.key) == (want.rows, want.cols, want.key)
    assert got.table.dtype == torch.bfloat16
    assert got.table.shape == want.table.shape
    assert not got.table.any()
    assert tcs.zeros(2, 8).table.device == torch.device("cpu")


@pytest.mark.parametrize("rows", [2, 4, 5])
def test_l2_estimate_matches_the_reference(rng, rows):
    """Even row counts take the midpoint of the two middle norms, as
    ``jnp.median`` does (``torch.median`` would take the lower one)."""
    g = rng.normal(size=4000).astype(np.float32)
    got = tsketch(g, rows=rows)
    want = jcs.sketch_vector(jnp.asarray(g), rows, COLS)
    np.testing.assert_allclose(float(got.l2_estimate()),
                               float(want.l2_estimate()), rtol=1e-6)
    np.testing.assert_allclose(float(tref.l2_estimate(got.table)),
                               float(jref.l2_estimate(want.table)),
                               rtol=1e-6)
    norms = torch.linalg.vector_norm(got.table, dim=1).sort().values
    if rows % 2 == 0:
        mid = (norms[rows // 2 - 1] + norms[rows // 2]) / 2
        assert float(got.l2_estimate()) == pytest.approx(float(mid),
                                                         rel=1e-6)


def test_l2_estimate_close_to_the_norm(rng):
    """Twin of the reference's ``test_l2_estimate``."""
    g = rng.normal(size=4000).astype(np.float32)
    s = tsketch(g)
    assert abs(float(s.l2_estimate()) - np.linalg.norm(g)) \
        < 0.25 * np.linalg.norm(g)


def test_heavy_hitters_recovered(rng):
    """Twin of the reference's ``test_heavy_hitters_recovered``."""
    g = rng.normal(scale=0.05, size=20000).astype(np.float32)
    hot = rng.choice(20000, size=20, replace=False)
    g[hot] = rng.choice([-1, 1], size=20) * 30.0
    s = tsketch(g)
    est = tcs.estimate(s, 0, 20000).numpy()
    np.testing.assert_allclose(est[hot], g[hot], rtol=0.05, atol=1.0)
    want = np.asarray(jcs.estimate(
        jcs.sketch_vector(jnp.asarray(g), ROWS, COLS), 0, 20000))
    np.testing.assert_allclose(est, want, rtol=1e-5, atol=1e-5)


def test_topk_of_estimates_matches_topk(rng):
    """Twin of the reference's ``test_topk_of_estimates_matches_topk``."""
    g = rng.normal(scale=0.01, size=8192).astype(np.float32)
    hot = rng.choice(8192, size=10, replace=False)
    g[hot] = np.linspace(5, 10, 10)
    est = tcs.estimate(tsketch(g), 0, 8192)
    assert set(torch.topk(est.abs(), 10).indices.tolist()) == set(hot)


@pytest.mark.parametrize("offset", [0, 2**32 - 250])
def test_hit_mask_chunk_matches_the_reference(rng, offset):
    active = rng.random(500) < 0.1
    got = tcs.hit_mask_chunk(offset, 500, ROWS, COLS, 2, t(active))
    want = jcs.hit_mask_chunk(offset, 500, ROWS, COLS, 2,
                              jnp.asarray(active))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    none = tcs.hit_mask_chunk(offset, 500, ROWS, COLS, 2,
                              torch.zeros(500, dtype=torch.bool))
    assert not none.any()


def test_hit_mask_zeroes_extracted(rng):
    """Twin of the reference's ``test_hit_mask_zeroes_extracted``, through
    ``hit_mask_chunk``: the zeroed cells leave the extracted ids'
    estimates near 0."""
    g = rng.normal(size=500).astype(np.float32)
    s = tsketch(g)
    idxs = np.arange(0, 500, 50)
    active = np.zeros(500, bool)
    active[idxs] = True
    mask = tcs.hit_mask_chunk(0, 500, ROWS, COLS, 0, t(active))
    z = tcs.CountSketch(torch.where(mask, 0.0, s.table), ROWS, COLS)
    est = tcs.estimate(z, 0, 500).numpy()
    assert np.abs(est[idxs]).max() < np.abs(g[idxs]).min() + 1e-5
    hi, lo = (x[idxs] for x in tcs.hashing.split64(0, 500))
    assert torch.equal(mask, tcs.hit_mask_ids(
        tcs.hashing.join_words(hi, lo), ROWS, COLS, 0))
