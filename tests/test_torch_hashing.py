"""Port parity: repro_torch.core.hashing against repro.core.hashing.

The sketches of the two packages are only comparable if every bucket and
sign agrees bit for bit, across the 2**32 carry of the 64-bit ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro_torch.core import hashing as th
from repro_torch.kernels import count_sketch as cuda_cs

OFFSETS = [0, 2**31 - 5, 2**32 - 3, 2**41 + 99]


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("offset", OFFSETS)
def test_split64_bit_exact(offset):
    jhi, jlo = jh.split64(offset, 1000)
    thi, tlo = th.split64(offset, 1000)
    np.testing.assert_array_equal(_np(jhi), thi.numpy())
    np.testing.assert_array_equal(_np(jlo), tlo.numpy())


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("key", [0, 1, 7])
def test_bucket_and_sign_bit_exact(offset, key):
    jhi, jlo = jh.split64(offset, 1000)
    thi, tlo = th.split64(offset, 1000)
    for row in range(th.MAX_ROWS):
        for cols in (130, 1000, 1 << 20):
            np.testing.assert_array_equal(
                _np(jh.bucket_hash(jlo, jhi, row, cols, key)),
                th.bucket_hash(tlo, thi, row, cols, key).numpy())
        np.testing.assert_array_equal(
            np.asarray(jh.sign_hash(jlo, jhi, row, key)),
            th.sign_hash(tlo, thi, row, key).numpy())


def test_hash64_bit_exact_on_random_words(rng):
    lo = rng.integers(0, 2**32, size=5000, dtype=np.uint64)
    hi = rng.integers(0, 2**32, size=5000, dtype=np.uint64)
    for seed in (0, 1, 0x9E3779B9, 0xFFFFFFFF):
        want = jh.hash64(jnp.asarray(lo, jnp.uint32),
                         jnp.asarray(hi, jnp.uint32), seed)
        got = th.hash64(torch.from_numpy(lo.astype(np.int64)),
                        torch.from_numpy(hi.astype(np.int64)), seed)
        np.testing.assert_array_equal(_np(want), got.numpy())


def test_offset_words_and_split_ids():
    offs = [0, 5, 2**32 - 1, 2**32, 2**41 + 99]
    jlo, jhi = jh.offset_words(offs)
    tlo, thi = th.offset_words(offs)
    np.testing.assert_array_equal(_np(jlo), tlo.numpy())
    np.testing.assert_array_equal(_np(jhi), thi.numpy())
    hi, lo = th.split_ids(torch.tensor(offs, dtype=torch.int64))
    np.testing.assert_array_equal(lo.numpy(), tlo.numpy())
    np.testing.assert_array_equal(hi.numpy(), thi.numpy())


@pytest.mark.parametrize("key", [0, 3])
def test_row_seeds_match_reference_expressions(key):
    """The seeds the CUDA kernels receive are the ones the reference uses
    inside bucket_hash / sign_hash."""
    for row in range(th.MAX_ROWS):
        assert th.bucket_seed(row, key) == (
            int(jh._ROW_SEEDS[row]) ^ (key * 0x632BE59B & 0xFFFFFFFF))
        assert th.sign_seed(row, key) == (
            int(jh._ROW_SEEDS[(row + 3) % 10]) * 0x9E3779B9
            ^ (key * 0x85EBCA6B)) & 0xFFFFFFFF


FASTMOD_COLS = [1, 2, 3, 7, 130, 1000, 1_000_003, 1 << 20, 2**31 - 1]


def fastmod(h: int, m: int, cols: int) -> int:
    """The kernels' bucket (hash.cuh): ((m * h mod 2**64) * cols) >> 64."""
    return ((m * h) % 2**64 * cols) >> 64


def fastmod_split(h: int, m: int, cols: int) -> int:
    """The same product as hash.cuh writes it out: two 32 x 32 -> 64-bit
    multiplies, every intermediate below 2**64."""
    low = (m * h) % 2**64
    mid = (low >> 32) * cols + (((low & 0xFFFFFFFF) * cols) >> 32)
    assert mid < 2**64
    return mid >> 32


@pytest.mark.parametrize("cols", FASTMOD_COLS)
def test_fastmod_multiplier_gives_h_mod_cols(cols):
    m = cuda_cs.fastmod_multiplier(cols)
    assert 0 <= m < 2**64
    words = [0, 1, cols - 1, cols, 2**32 - 1]
    words += [int(w) for w in np.random.default_rng(cols).integers(
        0, 2**32, size=10_000, dtype=np.uint64)]
    for h in words:
        assert fastmod(h, m, cols) == h % cols, (h, cols)
        assert fastmod_split(h, m, cols) == h % cols, (h, cols)


def test_fastmod_multiplier_rejects_cols_outside_31_bits():
    for cols in (0, -3, 2**31):
        with pytest.raises(ValueError, match="cols"):
            cuda_cs.fastmod_multiplier(cols)


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("cols", [7, 130, 1000, 1_000_003, 1 << 20])
def test_fastmod_buckets_match_reference(offset, cols):
    """Buckets taken by fastmod from the port's hash words equal
    repro.core.hashing.bucket_hash, row by row, across the 2**32 carry."""
    m = cuda_cs.fastmod_multiplier(cols)
    jhi, jlo = jh.split64(offset, 1000)
    thi, tlo = th.split64(offset, 1000)
    for row in range(th.MAX_ROWS):
        words = th.hash64(tlo, thi, th.bucket_seed(row, 2)).tolist()
        got = [fastmod(h, m, cols) for h in words]
        want = _np(jh.bucket_hash(jlo, jhi, row, cols, 2))
        np.testing.assert_array_equal(np.asarray(got), want)
