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
