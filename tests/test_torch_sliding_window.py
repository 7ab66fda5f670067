"""Port parity for ``repro_torch.core.sliding_window`` against
``repro.core.sliding_window``: the same inserts, subtractions and
zeroings give bitwise the same tables and answers (the operations are
elementwise float32 adds and selections, so no tolerance), and the
window's purpose (signal spread over I gradients recovered, old noise
gone) holds with the port's own sketch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sliding_window as jsw
from repro_torch.core import count_sketch as cs
from repro_torch.core import sliding_window as sw

ROWS, COLS = 5, 2048


def sketch(v) -> torch.Tensor:
    return cs.sketch_chunk(torch.from_numpy(v), 0, ROWS, COLS, 0)


def tables(rng, n):
    return [rng.standard_normal((ROWS, COLS)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("window", [1, 3, 4])
def test_naive_window_matches_reference(window):
    rng = np.random.default_rng(window)
    s, js = sw.sw_init(window, ROWS, COLS), jsw.sw_init(window, ROWS, COLS)
    for t, tab in enumerate(tables(rng, 9)):
        prev, before = s, s.tables.clone()
        s, js = sw.sw_insert(s, torch.from_numpy(tab)), \
            jsw.sw_insert(js, jnp.asarray(tab))
        assert torch.equal(prev.tables, before)         # a new state
        assert s.t == int(js.t) == t + 1
        np.testing.assert_array_equal(s.tables.numpy(), np.asarray(js.tables))
        for length in range(1, min(window, t + 1) + 1):
            np.testing.assert_array_equal(
                sw.sw_suffix(s, length).numpy(),
                np.asarray(jsw.sw_suffix(js, jnp.asarray(length))))
    np.testing.assert_array_equal(sw.sw_union_mask(s, 2.5).numpy(),
                                  np.asarray(jsw.sw_union_mask(js, 2.5)))
    sub = tables(rng, 1)[0]
    s2, js2 = sw.sw_subtract(s, torch.from_numpy(sub)), \
        jsw.sw_subtract(js, jnp.asarray(sub))
    np.testing.assert_array_equal(s2.tables.numpy(), np.asarray(js2.tables))
    mask = rng.random((ROWS, COLS)) < 0.3
    s3, js3 = sw.sw_zero_cells(s2, torch.from_numpy(mask)), \
        jsw.sw_zero_cells(js2, jnp.asarray(mask))
    np.testing.assert_array_equal(s3.tables.numpy(), np.asarray(js3.tables))


@pytest.mark.parametrize("window", [1, 5, 8, 64])
def test_log_window_matches_reference(window):
    rng = np.random.default_rng(window)
    s, js = sw.lw_init(window, ROWS, COLS), jsw.lw_init(window, ROWS, COLS)
    assert s.tables.shape == js.tables.shape
    for tab in tables(rng, 11):
        s, js = sw.lw_insert(s, torch.from_numpy(tab)), \
            jsw.lw_insert(js, jnp.asarray(tab))
        assert s.t == int(js.t)
        np.testing.assert_array_equal(s.tables.numpy(), np.asarray(js.tables))
        for length in (1, 2, 3, window, 2 * window):
            np.testing.assert_array_equal(
                sw.lw_suffix(s, length).numpy(),
                np.asarray(jsw.lw_suffix(js, length)))


def test_signal_spread_over_window_recovered():
    """A coordinate whose mass is split over I gradients is small in each
    and heavy in the window sum; noise from before the window is gone."""
    rng = np.random.default_rng(0)
    window, pos = 4, 123
    s = sw.sw_init(window, ROWS, COLS)
    for _ in range(7):
        s = sw.sw_insert(s, sketch(rng.normal(size=512).astype(np.float32)))
    for _ in range(window):
        g = rng.normal(scale=0.01, size=512).astype(np.float32)
        g[pos] += 5.0
        s = sw.sw_insert(s, sketch(g))
    est = cs.estimate_chunk(sw.sw_suffix(s, window), 0, 512)
    assert int(est.abs().argmax()) == pos and float(est[pos]) > 15.0
