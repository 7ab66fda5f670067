"""Port parity: the Count Sketch encode / estimate of repro_torch against
repro's jnp reference and its Pallas kernels (interpret mode).

On the CPU the port's dispatcher runs the plain twins of the CUDA kernels;
``tests/test_torch_cuda.py`` holds the kernels themselves against those
twins on the card.

Tolerances: integer-valued inputs make every sum exact in float32, so
those comparisons are exact whatever the order of summation.  Real-valued
sums are compared with rtol=atol=1e-5: the port's plain path sums in the
reference's order, but the reference's Pallas path and the CUDA atomics
do not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import count_sketch as jcs
from repro.core import hashing as jh
from repro.kernels import count_sketch as pk
from repro.kernels import ref as jref
from repro_torch.core import count_sketch as tcs
from repro_torch.kernels import count_sketch as cuda_cs
from repro_torch.kernels import ops, ref

# (rows, cols): the reference's edge tables (tests/test_kernels.py), cols
# that are not multiples of 128, and both even and odd row counts
TABLES = [(2, 384), (9, 640), (4, 1920), (3, 130), (4, 300), (5, 1000)]
OFFSETS = [0, 2**31 - 5, 2**32 - 3, 2**41 + 99]


def int_values(rng, n):
    return rng.integers(-8, 9, size=n).astype(np.float32)


def pallas_ok(cols):
    return cols % 128 == 0


@pytest.mark.parametrize("rows,cols", TABLES)
@pytest.mark.parametrize("n", [1, 127, 3000])
def test_encode_exact_on_integer_values(rng, rows, cols, n):
    v = int_values(rng, n)
    got = ops.sketch_encode(torch.from_numpy(v), 1234, rows, cols, key=1)
    want = jref.sketch_encode(jnp.asarray(v), 1234, rows, cols, key=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if pallas_ok(cols):
        pal = pk.sketch_encode(jnp.asarray(v), 1234, rows, cols, key=1,
                               interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


@pytest.mark.parametrize("offset", OFFSETS)
def test_encode_64bit_offsets(rng, offset):
    v = rng.normal(size=500).astype(np.float32)
    got = ops.sketch_encode(torch.from_numpy(v), offset, 3, 512)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.sketch_encode(jnp.asarray(v), offset,
                                                   3, 512)),
        rtol=1e-5, atol=1e-5)
    pal = pk.sketch_encode(jnp.asarray(v), offset, 3, 512, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=1e-5,
                               atol=1e-5)


def test_encode_bf16_and_accumulate_into_out(rng):
    v = rng.normal(size=700).astype(np.float32)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    want = jref.sketch_encode(jnp.asarray(v).astype(jnp.bfloat16), 99, 4,
                              256)
    out = torch.ones(4, 256)
    got = ops.sketch_encode(vb, 99, 4, 256, out=out)
    assert got is out
    np.testing.assert_allclose(got.numpy(), np.asarray(want) + 1.0,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows,cols", TABLES)
def test_estimate_exact(rng, rows, cols):
    n = 2000
    tbl = jref.sketch_encode(jnp.asarray(int_values(rng, n)), 77, rows, cols,
                             key=2)
    got = ops.sketch_estimate(torch.from_numpy(np.array(tbl)), 77, n, key=2)
    want = jref.sketch_estimate(tbl, 77, n, key=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if pallas_ok(cols):
        pal = pk.sketch_estimate(tbl, 77, n, key=2, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


@pytest.mark.parametrize("offset", OFFSETS)
def test_estimate_64bit_offsets(rng, offset):
    tbl = rng.normal(size=(5, 1024)).astype(np.float32)
    got = ops.sketch_estimate(torch.from_numpy(tbl), offset, 777)
    want = jcs.estimate_chunk(jnp.asarray(tbl), offset, 777, 5, 1024)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 10])
def test_median_rows_matches_jnp_median(rng, rows):
    x = rng.normal(size=(rows, 257)).astype(np.float32)
    x[:, :5] = np.round(x[:, :5])           # ties
    x[rows // 2, 7] = np.nan                # NaN propagates
    got = tcs.median_rows(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.median(x, axis=0)))


def test_sparse_sketch_and_hit_mask(rng):
    ids = np.unique(rng.integers(0, 2**42, size=300)).astype(np.int64)
    vals = int_values(rng, ids.size)
    hi = jnp.asarray(ids >> 32, jnp.uint32)
    lo = jnp.asarray(ids & 0xFFFFFFFF, jnp.uint32)
    t_ids = torch.from_numpy(ids)
    np.testing.assert_array_equal(
        tcs.sketch_sparse(t_ids, torch.from_numpy(vals), 4, 300, 5).numpy(),
        np.asarray(jcs.sketch_sparse(hi, lo, jnp.asarray(vals), 4, 300, 5)))
    np.testing.assert_array_equal(
        tcs.hit_mask_ids(t_ids, 4, 300, 5).numpy(),
        np.asarray(jcs.hit_mask_ids(hi, lo, 4, 300, 5)))


def test_sketch_chunk_is_linear_and_matches_the_split_ids(rng):
    """Chunks at consecutive offsets sum to the sketch of the whole."""
    v = int_values(rng, 1000)
    whole = tcs.sketch_chunk(torch.from_numpy(v), 2**32 - 300, 3, 384)
    parts = (tcs.sketch_chunk(torch.from_numpy(v[:300]), 2**32 - 300, 3, 384)
             + tcs.sketch_chunk(torch.from_numpy(v[300:]), 2**32, 3, 384))
    np.testing.assert_array_equal(whole.numpy(), parts.numpy())
    assert int(jh.split64(2**32, 1)[0][0]) == 1


def test_cpu_tensors_take_the_plain_twins_and_launch_nothing(rng):
    ops.reset_launch_counts()
    v = torch.from_numpy(rng.normal(size=100).astype(np.float32))
    np.testing.assert_array_equal(
        ops.sketch_encode(v, 5, 3, 128).numpy(),
        ref.sketch_encode(v, 5, 3, 128).numpy())
    assert ops.launch_counts() == {"encode": 0, "estimate": 0,
                                   "momentum_error": 0, "topk_mask": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the CUDA wrapper never runs the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cs.sketch_encode(torch.zeros(10), 0, 3, 128)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cs.sketch_estimate(torch.zeros(3, 128), 0, 10)


def test_dispatch_rejects_other_devices():
    with pytest.raises(ValueError, match="no sketch kernel"):
        ops.sketch_estimate(torch.zeros(3, 128, device="meta"), 0, 10)


# the geometry encode.cu compiles in (a card test reads it from the library)
BINS = cuda_cs.Bins(cols=1 << 15, max_bins=1024)


@pytest.mark.parametrize("n,cols", [(1, 7), (3, 130), (2**20 + 5, 7),
                                    (2**20 + 5, 1_000_003), (2**24, 2**20),
                                    (5000, 2**16)])
def test_bin_capacity_covers_the_expected_count(n, cols):
    """The binned encode's scratch: a multiple of 8 records a bin, at
    least 8 standard deviations over a full bin's expected count (or the
    whole chunk, which no bin can exceed), never more than the chunk."""
    cap = BINS.capacity(n, cols)
    mean = n * min(cols, BINS.cols) / cols
    assert cap % 8 == 0 and cap >= 8
    assert cap >= min(n, mean + 8 * mean**0.5)
    assert cap < n + 8


def test_encode_path_choice():
    """Binned from two elements per column of the table on; never for a
    table of more than max_bins bins or a chunk of 2**31 elements."""
    assert BINS.per_row(2**20) == 32
    assert BINS.per_row(1_000_003) == 31
    assert BINS.per_row(7) == 1
    assert BINS.use(2**24, 5, 2**20)
    assert BINS.use(2**21, 10, 2**20)
    assert not BINS.use(2**21 - 1, 5, 2**20)
    assert not BINS.use(9216, 5, 2**20)
    assert not BINS.use(2**24, 5, 2**25)
    assert not BINS.use(2**31, 5, 2**20)


def test_probe_sketch_bounds_needs_cuda(capsys, tmp_path):
    """The probe builds and times kernels on the card only: without CUDA
    it says so and exits 2, building nothing."""
    from repro_torch.launch import probe_sketch_bounds
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe would run")
    out = tmp_path / "probe.json"
    assert probe_sketch_bounds.main(["--out", str(out)]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
    assert not out.exists()
