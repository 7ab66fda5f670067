"""Port parity: the per-chunk candidate selection of the server's top-k.

``kernels.ops.sketch_estimate_topk`` gives a chunk's kk largest |estimate|
ids and their estimates in one op; on the CPU it runs its plain twin
(``kernels.ref.sketch_estimate_topk``: the estimates, then ``torch.topk``),
held here to the reference's ``repro.kernels.ref.sketch_estimate`` followed
by ``jax.lax.top_k(|est|, kk)``, as ``repro.core.topk.topk_from_sketch``
takes them.  ``tests/test_torch_cuda.py`` holds the fused CUDA kernel to
the twin on the card.  Also ``topk_from_sketch`` of both packages on a
layout of more than 64 chunks, where ``_chunk_k`` caps a chunk's kk at 512.

Tolerances: none.  Both packages compute each estimate with the same
roundings, so values are compared exactly (NaN with NaN).  Ids are
compared as a set up to ties at the kk-th magnitude: ids that share a
median cell have equal estimates, and the two libraries may keep
different ones of a tie.  So the ids above the kk-th magnitude must be
the same set, and as many ids must sit at it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as JL
from repro.core import topk as JT
from repro.kernels import ref as jref
from repro_torch.core import layout as TL
from repro_torch.core import topk as TT
from repro_torch.kernels import count_sketch as cuda_cs
from repro_torch.kernels import ops

N = 3000
OFFSETS = [2**32 + 5, 2**41 + 99]


def magnitude(x):
    """|x| as both libraries' top-k order it, as an integer: the float32's
    bits without the sign (+0 = -0 < floats < +inf), every NaN above."""
    bits = np.asarray(x, np.float32).view(np.uint32) & np.uint32(0x7FFFFFFF)
    return np.where(bits > 0x7F800000, 0x7FC00000, bits).astype(np.int64)


def reference_select(tbl, offset, n, kk, key):
    est = jref.sketch_estimate(jnp.asarray(tbl), offset, n, key=key)
    _, idx = jax.lax.top_k(jnp.abs(est), kk)
    return np.asarray(est), np.asarray(idx).astype(np.int64)


def assert_same_up_to_ties(got_ids, got_vals, want_ids, want_vals):
    """The same ids above the k-th magnitude, as many at it, and each id's
    value exact."""
    got_ids, want_ids = np.asarray(got_ids), np.asarray(want_ids)
    assert got_ids.size == want_ids.size == np.unique(got_ids).size
    gm, wm = magnitude(got_vals), magnitude(want_vals)
    t = wm.min()
    assert gm.min() == t
    np.testing.assert_array_equal(np.sort(got_ids[gm > t]),
                                  np.sort(want_ids[wm > t]))
    assert (gm == t).sum() == (wm == t).sum()
    want = dict(zip(want_ids.tolist(), np.asarray(want_vals).tolist()))
    common = [i for i, g in enumerate(got_ids.tolist()) if g in want]
    np.testing.assert_array_equal(
        np.asarray(got_vals)[common],
        np.asarray([want[g] for g in got_ids[common].tolist()], np.float32))


def check_chunk(tbl, offset, n, kk, key=0):
    est, want_idx = reference_select(tbl, offset, n, kk, key)
    vals, idx = ops.sketch_estimate_topk(torch.from_numpy(tbl), offset, n,
                                         kk, key)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int64
    assert vals.shape == idx.shape == (kk,)
    np.testing.assert_array_equal(vals.numpy(), est[idx.numpy()])
    assert_same_up_to_ties(idx.numpy(), vals.numpy(), want_idx,
                           est[want_idx])


@pytest.mark.parametrize("rows", [1, 2, 4, 5])
@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("kk", [1, 64, N])
def test_twin_selects_as_the_reference(rng, rows, offset, kk):
    tbl = rng.normal(size=(rows, 1000)).astype(np.float32)
    check_chunk(tbl, offset, N, kk, key=2)


@pytest.mark.parametrize("kk", [1, 64, N])
def test_twin_on_an_all_zero_table(kk):
    """Every estimate ties at 0: any kk ids are right, and both give kk."""
    check_chunk(np.zeros((3, 256), np.float32), 2**32 + 5, N, kk)


@pytest.mark.parametrize("rows", [1, 4, 5])
@pytest.mark.parametrize("kk", [1, 64, N])
def test_twin_on_a_table_with_nan_cells(rng, rows, kk):
    """A NaN cell makes every id that reads it NaN, the largest magnitude
    in both libraries."""
    tbl = rng.normal(size=(rows, 500)).astype(np.float32)
    tbl[rng.random(size=tbl.shape) < 0.03] = np.nan
    est, _ = reference_select(tbl, 2**32 + 5, N, 1, 0)
    assert 64 < np.isnan(est).sum() < N
    check_chunk(tbl, 2**32 + 5, N, kk)


@pytest.mark.parametrize("kk", [1, 64, N])
def test_twin_on_integer_valued_tables(rng, kk):
    """Integer cells in -3..3: most estimates tie with many others."""
    tbl = rng.integers(-3, 4, size=(5, 700)).astype(np.float32)
    check_chunk(tbl, 2**41 + 99, N, kk, key=1)


def test_cpu_tensors_never_reach_the_fused_kernel():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cs.sketch_estimate_topk(torch.zeros(3, 128), 0, 10, 5)
    ops.reset_launch_counts()
    ops.sketch_estimate_topk(torch.ones(3, 128), 0, 10, 5)
    assert ops.launch_counts()["estimate"] == 0


def test_more_than_64_chunks_cap_each_chunk_at_512(rng):
    """71 chunks: 70 of 1,000 ids whose kk is capped at 512 < k = 600, and
    one of 37 that gives all its ids."""
    shapes = {"w": (700, 100), "b": (37,)}
    jl = JL.build_layout({k: jnp.zeros(s) for k, s in shapes.items()},
                         chunk_elems=1000)
    tl = TL.build_layout({k: torch.zeros(s) for k, s in shapes.items()},
                         chunk_elems=1000)
    assert tl.num_chunks == 71 > TT.EXACT_CHUNK_LIMIT
    assert TT._chunk_k(600, 1000, 71) == 512
    assert TT._chunk_k(600, 37, 71) == 37
    tbl = rng.normal(size=(5, 1 << 16)).astype(np.float32)
    jd = JT.topk_from_sketch(jnp.asarray(tbl), jl, 600, 3, impl="jnp")
    td = TT.topk_from_sketch(torch.from_numpy(tbl), tl, 600, 3)
    assert td.k == jd.k == 600
    jhi, jlo = JT.global_ids(jd, jl)
    jids = np.asarray(jhi, np.int64) << 32 | np.asarray(jlo, np.int64)
    assert_same_up_to_ties(TT.global_ids(td, tl).numpy(), td.values.numpy(),
                           jids, np.asarray(jd.values))
