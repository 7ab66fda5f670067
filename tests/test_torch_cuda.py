"""The four CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device (Hopper, sm_90a) and skips without
one; the file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: integer-valued inputs keep every float32 sum exact, so the
atomics' order of summation cannot show and those comparisons are exact;
the estimate, momentum/error and zeroing kernels round like their twins
and are compared exactly; real-valued encodes, whose atomics sum in
another order, use rtol=1e-5, atol=1e-4.

The encode has two paths (one-pass atomics, and the binned partition +
accumulate pair); ``_bin_capacity`` forces either, and a small capacity
forces the binned path's overflow into the table.

The fused estimate + selection (``sketch_estimate_topk``) is held exactly
to its rule, computed from the estimate kernel's output (which is held to
its twin bit for bit above): the ids above the kk-th largest |estimate|,
then the lowest-index ids at it, in ascending order, with their estimates
bit for bit.  Its plain twin, ``torch.topk``, breaks ties its own way, so
it is held to the same ids above the kk-th magnitude and as many at it.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.core import fetchsgd as F
from repro_torch.core import layout as L
from repro_torch.core import topk as T
from repro_torch.kernels import count_sketch as cuda_cs
from repro_torch.kernels import ops, ref
from repro_torch.kernels import server_step as cuda_ss

pytestmark = pytest.mark.cuda

TABLES = [(2, 384), (9, 640), (4, 1920), (3, 130), (4, 300), (5, 1000),
          (10, 1 << 16), (1, 7), (5, 1_000_003)]
OFFSETS = [0, 2**31 - 5, 2**32 - 3, 2**41 + 99]
# cols under one bin (7, 130), not a multiple of the bin width
# (1,000,003), 1 and 10 rows, and the main path's table
PATH_TABLES = [(1, 7), (3, 130), (5, 1_000_003), (10, 1 << 16),
               (10, 1 << 20), (5, 1 << 20)]
LENGTHS = [1, 3, 2**20 + 5]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def ints(gen, shape, dev, lim=8):
    return torch.randint(-lim, lim + 1, shape, generator=gen,
                         dtype=torch.int32).float().to(dev)


@pytest.mark.parametrize("rows,cols", TABLES)
@pytest.mark.parametrize("offset", OFFSETS)
def test_encode_matches_plain(dev, rows, cols, offset):
    gen = torch.Generator().manual_seed(rows * cols)
    v = ints(gen, (5000,), dev)
    before = cuda_cs.LAUNCHES["encode"]
    got = cuda_cs.sketch_encode(v, offset, rows, cols, 3)
    assert cuda_cs.LAUNCHES["encode"] == before + 1
    torch.testing.assert_close(got, ref.sketch_encode(v, offset, rows, cols,
                                                      3), rtol=0, atol=0)
    r = torch.randn(5000, generator=gen).to(dev)
    torch.testing.assert_close(cuda_cs.sketch_encode(r, offset, rows, cols),
                               ref.sketch_encode(r, offset, rows, cols),
                               rtol=1e-5, atol=1e-4)
    out = torch.ones(rows, cols, device=dev)
    assert cuda_cs.sketch_encode(v.to(torch.bfloat16), offset, rows, cols, 3,
                                 out=out) is out
    torch.testing.assert_close(out, got + 1, rtol=0, atol=0)


def test_bin_geometry_comes_from_the_library(dev):
    """The wrapper sizes the binned encode's scratch by the geometry that
    encode.cu compiles in: 16-bit columns within a bin, and room for the
    main path's 5 x 2**20 table."""
    geo = cuda_cs.bins()
    assert geo.cols & (geo.cols - 1) == 0 and geo.cols <= 1 << 16
    assert 5 * geo.per_row(1 << 20) <= geo.max_bins
    assert geo.use(1 << 24, 5, 1 << 20)


def capacity(path, n, cols):
    return {"auto": None, "one_pass": 0,
            "binned": cuda_cs.bins().capacity(n, cols)}[path]


@pytest.mark.parametrize("rows,cols", PATH_TABLES)
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("path", ["auto", "one_pass", "binned"])
def test_encode_paths_match_plain(dev, rows, cols, n, path):
    """Both encode paths: exact on integers (dense, 90% zeros as in the
    embedding chunks, and bf16), allclose on reals."""
    gen = torch.Generator().manual_seed(n * 31 + cols)
    cap = capacity(path, n, cols)
    v = ints(gen, (n,), dev)
    sparse = v * (torch.rand(n, generator=gen) < 0.1).float().to(dev)
    for x in (v, sparse, v.to(torch.bfloat16)):
        got = cuda_cs.sketch_encode(x, 2**32 + 7, rows, cols, 1,
                                    _bin_capacity=cap)
        torch.testing.assert_close(
            got, ref.sketch_encode(x, 2**32 + 7, rows, cols, 1), rtol=0,
            atol=0)
    # reals at most 16 to a cell, as on the main path (2**24 values into
    # 2**20 columns): the error of another order of summation grows with
    # the count per cell, and 150,000 normals in one cell exceed rtol 1e-5
    # whatever the kernel
    nr = min(n, 16 * cols)
    r = torch.randn(nr, generator=gen).to(dev)
    cap_r = None if cap is None else capacity(path, nr, cols)
    torch.testing.assert_close(
        cuda_cs.sketch_encode(r, 99, rows, cols, _bin_capacity=cap_r),
        ref.sketch_encode(r, 99, rows, cols), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rows,cols", [(5, 1 << 20), (3, 130),
                                       (5, 1_000_003)])
@pytest.mark.parametrize("cap", [8, 4096])
def test_encode_bin_overflow_matches_plain(dev, rows, cols, cap):
    """Bins far below their expected count: most records take the
    overflow atomics into the table, the rest the bins."""
    n = 2**20 + 5
    assert cap < cuda_cs.bins().capacity(n, cols) // 2
    gen = torch.Generator().manual_seed(cap + cols)
    v = ints(gen, (n,), dev)
    out = ints(gen, (rows, cols), dev, 3)
    want = ref.sketch_encode(v, 2**33, rows, cols, out=out.clone())
    got = cuda_cs.sketch_encode(v, 2**33, rows, cols, out=out,
                                _bin_capacity=cap)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    r = torch.randn(min(n, 16 * cols), generator=gen).to(dev)
    torch.testing.assert_close(
        cuda_cs.sketch_encode(r, 5, rows, cols, _bin_capacity=cap),
        ref.sketch_encode(r, 5, rows, cols), rtol=1e-5, atol=1e-4)


def test_encode_unaligned_values_match_plain(dev):
    """A chunk that starts off a 16-byte boundary takes the scalar loads."""
    gen = torch.Generator().manual_seed(3)
    v = ints(gen, (2**20 + 9,), dev)[1:]
    assert v.data_ptr() % 16 != 0
    for x in (v, v.to(torch.bfloat16)[1:]):
        torch.testing.assert_close(
            cuda_cs.sketch_encode(x, 11, 5, 4096),
            ref.sketch_encode(x, 11, 5, 4096), rtol=0, atol=0)


@pytest.mark.parametrize("rows,cols", PATH_TABLES)
@pytest.mark.parametrize("n", LENGTHS)
def test_estimate_lengths_match_plain(dev, rows, cols, n):
    gen = torch.Generator().manual_seed(rows * cols + n)
    table = torch.randn(rows, cols, generator=gen).to(dev)
    table[-1, :3] = float("nan")
    got = cuda_cs.sketch_estimate(table, 2**32 + 1, n, 4)
    want = ref.sketch_estimate(table, 2**32 + 1, n, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("rows,cols", TABLES)
@pytest.mark.parametrize("offset", OFFSETS)
def test_estimate_matches_plain(dev, rows, cols, offset):
    gen = torch.Generator().manual_seed(rows + cols)
    table = torch.randn(rows, cols, generator=gen).to(dev)
    table[0, :7] = float("nan")
    got = cuda_cs.sketch_estimate(table, offset, 7777, 2)
    want = ref.sketch_estimate(table, offset, 7777, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


SELECT_COLS = [7, 130, 1_000_003]
SELECT_LENGTHS = [1, 3, 777, 2**20 + 5]
SELECT_KINDS = ["normal", "integer", "zero", "nan", "negzero"]


def select_table(kind, rows, cols, gen, dev):
    """normal; integer-valued in -3..3 (heavy ties); all zero; 3% NaN
    cells; half the cells -0.0 and the rest normal."""
    if kind == "zero":
        return torch.zeros(rows, cols, device=dev)
    if kind == "integer":
        return ints(gen, (rows, cols), dev, 3)
    t = torch.randn(rows, cols, generator=gen)
    if kind == "nan":
        t[torch.rand(rows, cols, generator=gen) < 0.03] = float("nan")
        t[0, :3] = float("nan")
    elif kind == "negzero":
        t[torch.rand(rows, cols, generator=gen) < 0.5] = -0.0
    return t.to(dev)


def magnitude_keys(est):
    """|est| as the fused kernel orders it: the float's bits without the
    sign (+0 = -0 < floats < +inf), every NaN one key above +inf."""
    k = est.view(torch.int32).to(torch.int64) & 0x7FFFFFFF
    return torch.where(k > 0x7F800000, 0x7FC00000, k)


def assert_selects(table, offset, n, kk, key):
    """The fused op against its rule and against its twin (module doc):
    with the compact candidate list as sized, with none (every tile from
    the scratch) and with one of 37 entries (both kinds of tile)."""
    est = cuda_cs.sketch_estimate(table, offset, n, key)
    keys = magnitude_keys(est)
    t = torch.topk(keys, kk).values[-1]
    above = torch.nonzero(keys > t).flatten()
    tied = torch.nonzero(keys == t).flatten()[:kk - above.numel()]
    want = torch.sort(torch.cat([above, tied])).values
    for capacity in (None, 0, 37):
        vals, idx = cuda_cs.sketch_estimate_topk(table, offset, n, kk, key,
                                                 _capacity=capacity)
        torch.testing.assert_close(idx, want, rtol=0, atol=0)
        assert torch.equal(vals.view(torch.int32),
                           est[idx].view(torch.int32))
    pv, pi = ref.sketch_estimate_topk(table, offset, n, kk, key)
    torch.testing.assert_close(pv, est[pi], rtol=0, atol=0, equal_nan=True)
    pk = keys[pi]
    torch.testing.assert_close(torch.sort(pi[pk > t]).values, above,
                               rtol=0, atol=0)
    assert int((pk == t).sum()) == tied.numel() and bool((pk >= t).all())


@pytest.mark.parametrize("rows", range(1, 11))
@pytest.mark.parametrize("cols", SELECT_COLS)
@pytest.mark.parametrize("n", SELECT_LENGTHS)
def test_estimate_topk_selects_by_its_rule(dev, rows, cols, n):
    gen = torch.Generator().manual_seed(rows * 1000 + cols + n)
    for kind in SELECT_KINDS:
        table = select_table(kind, rows, cols, gen, dev)
        for kk in sorted({min(kk, n) for kk in (1, 512, 25_000, n)}):
            assert_selects(table, 2**32 + 7, n, kk, 3)


@pytest.mark.parametrize("kind", SELECT_KINDS)
def test_estimate_topk_at_the_main_path_chunk(dev, kind):
    """2**24 ids of the 5 x 2**20 table at an offset above 2**32; a second
    call gives the same arrays."""
    gen = torch.Generator().manual_seed(24)
    table = select_table(kind, 5, 1 << 20, gen, dev)
    offset, n = 2**32 + 12_345, 1 << 24
    for kk in (1, 512, 25_000, n):
        assert_selects(table, offset, n, kk, 0)
    a = cuda_cs.sketch_estimate_topk(table, offset, n, 25_000)
    b = cuda_cs.sketch_estimate_topk(table, offset, n, 25_000)
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])


def test_estimate_topk_makes_no_host_sync(dev):
    """Under sync debug mode "error" PyTorch raises at any sync it makes;
    and the call returns while the card still sleeps through what was
    queued before it, so the C side waits for nothing either."""
    table = torch.randn(5, 1 << 20, device=dev)
    args = (table, 2**32 + 12_345, 1 << 24, 25_000)
    cuda_cs.sketch_estimate_topk(*args)         # builds; fills the allocator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.cuda._sleep(400_000_000)          # ~0.2 s of device time
        vals, idx = cuda_cs.sketch_estimate_topk(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert vals.shape == idx.shape == (25_000,)


def test_select_geometry_comes_from_the_library(dev):
    """The wrapper sizes the fused selection's scratch by what
    estimate_select.cu compiles in: a main-path chunk of 2**24 ids is 4,096
    tiles in 16 groups, and its zeroed words hold the state and 16 64-bit
    group counts."""
    geo = cuda_cs.select_geometry()
    assert geo.tile == 4096 and geo.group_tiles == 256
    assert geo.tiles(1 << 24) == 4096 and geo.tiles(1) == 1
    assert geo.work_words(1 << 24) == geo.state_words + 32
    assert geo.state_words % 2 == 0


def test_source_geometry_is_the_library_s(dev):
    """The dry-run sizes the kernels' scratch without a card from
    ``SOURCE_BINS`` / ``SOURCE_SELECT``: they are what the library
    compiles."""
    assert cuda_cs.bins() == cuda_cs.SOURCE_BINS
    assert cuda_cs.select_geometry() == cuda_cs.SOURCE_SELECT


def test_estimate_topk_rejects_what_it_does_not_take(dev):
    table = torch.randn(3, 128, device=dev)
    before = cuda_cs.LAUNCHES["estimate"]
    for kk in (0, 11):
        with pytest.raises(ValueError, match="kk"):
            cuda_cs.sketch_estimate_topk(table, 0, 10, kk)
    with pytest.raises(ValueError, match="ids"):
        cuda_cs.sketch_estimate_topk(table, 0, 0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cs.sketch_estimate_topk(table.cpu(), 0, 10, 5)
    with pytest.raises(ValueError, match="rows"):
        cuda_cs.sketch_estimate_topk(torch.zeros(11, 128, device=dev), 0, 10,
                                     5)
    assert cuda_cs.LAUNCHES["estimate"] == before


def test_dispatch_sends_the_fused_selection_to_its_kernel(dev):
    """One launch counted a call, under the span
    ``kernel.estimate[cuda:select]``."""
    from repro_torch import obs
    table = torch.randn(3, 256, device=dev)
    ops.reset_launch_counts()
    sink = obs.MemorySink()
    tele = obs.Telemetry([sink], trace=True)
    with obs.active(tele):
        vals, idx = ops.sketch_estimate_topk(table, 0, 1000, 64)
    tele.close()              # the span waits for its device time till here
    assert ops.launch_counts()["estimate"] == 1 and vals.is_cuda
    assert [e["name"] for e in sink.events if e["type"] == "span"] \
        == ["kernel.estimate[cuda:select]"]


@pytest.mark.parametrize("rows,cols", [(3, 130), (5, 1 << 20), (1, 7)])
def test_momentum_error_matches_plain_bitwise(dev, rows, cols):
    gen = torch.Generator().manual_seed(cols)
    agg, su, se = (torch.randn(rows, cols, generator=gen).to(dev)
                   for _ in range(3))
    lr = torch.tensor(0.07, device=dev)
    got = cuda_ss.momentum_error(agg, su, se, lr, 0.9)
    torch.testing.assert_close(got, ref.momentum_error(agg, su, se, lr, 0.9),
                               rtol=0, atol=0)


@pytest.mark.parametrize("rows,cols", TABLES)
@pytest.mark.parametrize("error_mode", ["zero", "subtract"])
@pytest.mark.parametrize("momentum_masking", [True, False])
def test_topk_mask_matches_plain(dev, rows, cols, error_mode,
                                 momentum_masking):
    gen = torch.Generator().manual_seed(rows * 7 + cols)
    su, se = ints(gen, (rows, cols), dev, 50), ints(gen, (rows, cols), dev, 50)
    ids = torch.unique(torch.randint(0, 2**42, (300,), generator=gen)).to(dev)
    vals = ints(gen, (ids.numel(),), dev, 20)
    kw = dict(error_mode=error_mode, momentum_masking=momentum_masking)
    got = cuda_ss.topk_mask(su.clone(), se.clone(), ids, vals, 1, **kw)
    want = ref.topk_mask(su.clone(), se.clone(), ids, vals, 1, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_topk_mask_with_no_ids_launches_nothing(dev):
    su, se = torch.randn(3, 384, device=dev), torch.randn(3, 384, device=dev)
    before = cuda_ss.LAUNCHES["topk_mask"]
    out = cuda_ss.topk_mask(su.clone(), se.clone(),
                            torch.zeros(0, dtype=torch.int64, device=dev),
                            torch.zeros(0, device=dev))
    torch.testing.assert_close(out, (su, se), rtol=0, atol=0)
    assert cuda_ss.LAUNCHES["topk_mask"] == before


def test_dispatch_sends_cuda_tensors_to_the_kernels(dev):
    ops.reset_launch_counts()
    v = torch.randn(1000, device=dev)
    table = ops.sketch_encode(v, 0, 3, 256)
    ops.sketch_estimate(table, 0, 1000)
    su, se = ops.momentum_error(table, table, table,
                                torch.tensor(0.1, device=dev), 0.9)
    ops.topk_mask(su, se, torch.arange(5, device=dev), torch.ones(5,
                                                                  device=dev))
    assert ops.launch_counts() == {"encode": 1, "estimate": 1,
                                   "momentum_error": 1, "topk_mask": 1}


@pytest.mark.parametrize("n,path", [(9_216, "one_pass"),
                                    (2**21 + 3, "binned")])
@pytest.mark.parametrize("offset", [0, 2**32 + 12_345])
def test_object_api_on_the_card_matches_the_cpu(dev, n, path, offset):
    """``sketch_vector`` / ``estimate`` launch the encode and estimate
    kernels on a CUDA tensor and equal their CPU twins (exact on integer
    values; the reals' atomics sum in another order); ``+`` and ``scale``
    are exact, ``l2_estimate`` within rtol 1e-5 of the float64 norms."""
    from repro_torch.core import count_sketch as cs

    rows, cols = 5, 1 << 20
    gen = torch.Generator().manual_seed(n)
    v = ints(gen, (n,), "cpu")
    ops.reset_launch_counts()
    before = cuda_cs.PATHS[path]
    got = cs.sketch_vector(v.to(dev), rows, cols, key=2, offset=offset)
    assert cuda_cs.PATHS[path] == before + 1
    want = cs.sketch_vector(v, rows, cols, key=2, offset=offset)
    assert (got.rows, got.cols, got.key) == (rows, cols, 2)
    assert torch.equal(got.table.cpu(), want.table)
    assert torch.equal(cs.estimate(got, offset, n).cpu(),
                       cs.estimate(want, offset, n))
    assert ops.launch_counts()["encode"] == 1
    assert ops.launch_counts()["estimate"] == 1
    w = ints(gen, (n,), "cpu")
    got_w = cs.sketch_vector(w.to(dev), rows, cols, key=2, offset=offset)
    both = got + got_w.scale(3.0)
    assert torch.equal(both.table.cpu(), (want + cs.sketch_vector(
        w, rows, cols, key=2, offset=offset).scale(3.0)).table)
    assert torch.equal(both.table, cs.sketch_vector(
        (v + 3 * w).to(dev), rows, cols, key=2, offset=offset).table)
    # the row norms' float32 sums of 2**20 squares round in another order
    # on each device: both against the float64 norms of the same table
    assert float(got.l2_estimate()) == pytest.approx(
        float(cs.l2_estimate(want.table.double())), rel=1e-5)
    reals = torch.randn(n, generator=gen)
    torch.testing.assert_close(
        cs.sketch_vector(reals.to(dev), rows, cols, offset=offset).table.cpu(),
        cs.sketch_vector(reals, rows, cols, offset=offset).table,
        rtol=1e-5, atol=1e-4)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_cs.sketch_encode(torch.zeros(10, dtype=torch.float16,
                                          device=dev), 0, 3, 128)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_cs.sketch_encode(torch.zeros(20, device=dev)[::2], 0, 3, 128)
    with pytest.raises(ValueError, match="rows"):
        cuda_cs.sketch_estimate(torch.zeros(11, 128, device=dev), 0, 10)
    with pytest.raises(ValueError, match="int64"):
        cuda_ss.topk_mask(torch.zeros(3, 128, device=dev),
                          torch.zeros(3, 128, device=dev),
                          torch.arange(4, dtype=torch.int32, device=dev),
                          torch.ones(4, device=dev))


@pytest.mark.parametrize("error_mode", ["zero", "subtract"])
def test_server_rounds_on_the_card_match_the_cpu(dev, error_mode):
    shapes = {"a": (64, 32), "b": (100,)}
    lay = L.build_layout({k: torch.zeros(s) for k, s in shapes.items()},
                         chunk_elems=500)
    cfg = F.FetchSGDConfig(rows=5, cols=1000, k=20, error_mode=error_mode)
    gen = torch.Generator().manual_seed(0)
    st_c, st_g = F.init_state(cfg), F.init_state(cfg, dev)
    for _ in range(3):
        g = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
        tc = F.sketch_grads(g, lay, cfg)
        tg = F.sketch_grads({k: x.to(dev) for k, x in g.items()}, lay, cfg)
        torch.testing.assert_close(tg.cpu(), tc, rtol=1e-5, atol=1e-5)
        dc, st_c = F.server_step(tc, st_c, 0.05, lay, cfg)
        dg, st_g = F.server_step(tc.to(dev), st_g, 0.05, lay, cfg)
        ic = np.sort(T.global_ids(dc, lay).numpy())
        ig = np.sort(T.global_ids(dg, lay).cpu().numpy())
        np.testing.assert_array_equal(ig, ic)
        torch.testing.assert_close(st_g.error_sketch.cpu(), st_c.error_sketch,
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(st_g.momentum_sketch.cpu(),
                                   st_c.momentum_sketch, rtol=1e-6,
                                   atol=1e-6)


def test_profile_round_times_the_three_parts_of_the_server_topk(dev):
    from repro_torch.launch import profile_round
    shapes = {"a": (64, 32), "b": (100,)}
    lay = L.build_layout({k: torch.zeros(s) for k, s in shapes.items()},
                         chunk_elems=500)
    table = torch.randn(5, 1000, device=dev)
    parts = profile_round.time_topk(table, lay, 20)
    assert parts["chunks"] == lay.num_chunks
    assert all(parts[k] > 0 for k in ("estimate_select", "estimate",
                                      "chunk_topk", "final_topk"))


@pytest.mark.parametrize("rows", range(1, 11))
@pytest.mark.parametrize("error_mode", ["zero", "subtract"])
@pytest.mark.parametrize("cols,k,repeat", [(7, 257, False),
                                           (130, 1003, True),
                                           (1 << 20, 25_000, True)])
def test_topk_mask_over_row_id_pairs_matches_plain(dev, rows, error_mode,
                                                   cols, k, repeat):
    """Every row count, k off the block size, ids repeated and ids that
    share cells (7 columns): bitwise in zero mode, exact on integers in
    subtract mode."""
    gen = torch.Generator().manual_seed(rows * k + cols)
    su, se = ints(gen, (rows, cols), dev, 50), ints(gen, (rows, cols), dev, 50)
    ids = torch.randint(0, 2**42, (k,), generator=gen)
    if repeat:
        ids[k // 2:] = ids[:k - k // 2].clone()
    ids, vals = ids.to(dev), ints(gen, (k,), dev, 20)
    for masking in (True, False):
        kw = dict(error_mode=error_mode, momentum_masking=masking)
        got = cuda_ss.topk_mask(su.clone(), se.clone(), ids, vals, 2, **kw)
        want = ref.topk_mask(su.clone(), se.clone(), ids, vals, 2, **kw)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("grads_on", ["card", "cpu"])
def test_orchestrator_on_the_card_matches_the_cpu(dev, grads_on):
    """A micro federated run (async, stragglers, dropout) on the card and
    on the CPU from the same weights: equal records and traffic, losses
    within 1e-3.  The card encodes with the kernel, the CPU with the gather
    plans; with gradients from the CPU on both sides (moved to the card)
    only the sketch and server kernels differ.

    The sketch has 2**16 columns, about 1.3 of the micro model's ids a
    cell: at 3 x 4096 about 20 ids share each cell, ids that share the
    median cell have equal estimates, and such a tie at the 64th |estimate|
    made the card and the CPU move different coordinates (63 of 64 in
    common), which moved round 1's loss by 3.2e-3.  The learning rate
    starts above 0, as in ``test_torch_orchestrator.py``: a first round at
    lr 0 makes Delta a top-k of ties."""
    from repro_torch import fed
    from repro_torch.launch import simulate
    from repro_torch.models import transformer
    from repro_torch.optim import linear_decay
    cfg = simulate.micro_cfg()
    init = dict(L.flatten(transformer.init_params(cfg, seed=0)))
    fs_cfg = F.FetchSGDConfig(rows=3, cols=1 << 16, k=64)
    fed_cfg = fed.FederationConfig(
        rounds=3, clients_per_round=4, aggregate="async", seed=3,
        straggler=fed.StragglerModel(straggle_prob=0.5, dropout_prob=0.1,
                                     max_delay=2))

    def cpu_grads(params, batch):
        on_cpu = L.tree_map(lambda x: x.cpu(), params)
        loss, g = transformer.value_and_grad(
            on_cpu, L.tree_map(lambda x: x.cpu(), batch), cfg)
        dev_of = next(iter(batch.values())).device
        return loss, L.tree_map(lambda x: x.to(dev_of), g)

    runs = {}
    for device in (dev, torch.device("cpu")):
        params = L.unflatten(list(init), [x.to(device, copy=True)
                                          for x in init.values()])
        runs[device.type] = fed.Orchestrator(
            cfg, fs_cfg, fed_cfg, simulate.micro_dataset(cfg), params=params,
            lr_fn=linear_decay(0.2, 3), device=device,
            grad_fn=cpu_grads if grads_on == "cpu" else None).run()
    card, cpu = runs["cuda"], runs["cpu"]

    def counts(res):
        return [{k: v for k, v in vars(r).items() if k != "loss"}
                for r in res.records]
    assert counts(card) == counts(cpu) and card.traffic == cpu.traffic
    assert sum(r.n_late for r in cpu.records) > 0
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-3)


@pytest.mark.parametrize("vectorized", [False, True],
                         ids=["per-object", "vectorized"])
@pytest.mark.parametrize("grads_on", ["card", "cpu"])
def test_event_clock_on_the_card_matches_the_cpu(dev, grads_on, vectorized):
    """A micro event-clock run, async with a quorum of 2 below the cohort
    of 5 (uploads stay in flight across updates, lazy events compute
    against their dispatch round's weights), on the card and on the CPU
    from the same weights: every record field but the loss equal (they
    are numpy's), losses within 1e-3.  The sketch has 2**16 columns for
    the reason given in ``test_orchestrator_on_the_card_matches_the_cpu``.
    """
    from repro_torch import fed
    from repro_torch.launch import simulate
    from repro_torch.models import transformer
    from repro_torch.optim import linear_decay
    cfg = simulate.micro_cfg()
    init = dict(L.flatten(transformer.init_params(cfg, seed=0)))
    fs_cfg = F.FetchSGDConfig(rows=3, cols=1 << 16, k=64)
    fed_cfg = fed.FederationConfig(
        rounds=3, clients_per_round=5, aggregate="async", seed=3,
        clock="event", vectorized=vectorized,
        simtime=fed.SimTimeConfig(quorum=2, heterogeneity=(
            fed.HeterogeneityConfig(bandwidth_median=1e5,
                                    bandwidth_sigma=2.0))),
        straggler=fed.StragglerModel(straggle_prob=0.25, max_delay=2))

    def cpu_grads(params, batch):
        on_cpu = L.tree_map(lambda x: x.cpu(), params)
        loss, g = transformer.value_and_grad(
            on_cpu, L.tree_map(lambda x: x.cpu(), batch), cfg)
        dev_of = next(iter(batch.values())).device
        return loss, L.tree_map(lambda x: x.to(dev_of), g)

    runs = {}
    for device in (dev, torch.device("cpu")):
        params = L.unflatten(list(init), [x.to(device, copy=True)
                                          for x in init.values()])
        runs[device.type] = fed.Orchestrator(
            cfg, fs_cfg, fed_cfg, simulate.micro_dataset(cfg), params=params,
            lr_fn=linear_decay(0.2, 3), device=device,
            grad_fn=cpu_grads if grads_on == "cpu" else None).run()
    card, cpu = runs["cuda"], runs["cpu"]

    def meta(res):
        return [{k: v for k, v in vars(r).items() if k != "loss"}
                for r in res.records]
    assert meta(card) == meta(cpu) and card.traffic == cpu.traffic
    assert card.extras["in_flight"] == cpu.extras["in_flight"] > 0
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-3)


def test_cpu_checkpoint_restores_onto_the_card_bitwise(dev, tmp_path):
    """A checkpoint written from CPU tensors restores onto the card (the
    templates' device), every tensor bitwise equal."""
    from repro_torch import fed
    from repro_torch.fed import checkpoint as ckpt
    gen = torch.Generator().manual_seed(0)
    cfg = F.FetchSGDConfig(rows=3, cols=1024, k=8)
    params = {"b": torch.randn(5, generator=gen),
              "a": {"w": torch.randn(4, 3, generator=gen)}}
    tabs = [torch.randn(3, 1024, generator=gen) for _ in range(4)]
    state = F.FetchSGDState(momentum_sketch=tabs[0], error_sketch=tabs[1],
                            step=5)
    ev = fed.Event(time=2.5, round_produced=1, slot=0, client=3,
                   produced=1.0, weight=0.5, loss=0.25, table=tabs[3])
    ckpt.save(str(tmp_path), params, state, 4,
              late_buffer=[dict(table=tabs[2], produced=1, arrival=3,
                                weight=1.0)],
              simtime={"now": 2.0, "events": [ev]})
    ck = ckpt.restore(str(tmp_path),
                      L.tree_map(lambda x: torch.zeros_like(x, device=dev),
                                 params), F.init_state(cfg, dev))
    got = [x for _, x in L.flatten(ck.params)] + [
        ck.opt_state.momentum_sketch, ck.opt_state.error_sketch,
        ck.late_buffer[0]["table"], ck.simtime["events"][0].table]
    want = [x for _, x in L.flatten(params)] + tabs
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)
    assert ck.opt_state.step == 5 and ck.round_idx == 4


def test_span_sync_waits_for_the_card(dev):
    """``Span.sync`` on a CUDA tensor ends the span after the card has run
    the work queued before it: here a ~100 ms device sleep."""
    from repro_torch import obs
    sink = obs.MemorySink()
    tele = obs.Telemetry([sink], trace=True)
    x = torch.ones(4, device=dev)
    torch.cuda.synchronize()
    with tele.span("synced") as sp:
        torch.cuda._sleep(200_000_000)       # clock cycles
        sp.sync({"out": [x + 1]})
    assert torch.cuda.current_stream().query()
    torch.cuda._sleep(200_000_000)
    with tele.span("unsynced"):
        pass
    unsynced_done = torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    tele.close()              # the unsynced span's device time is read here
    durs = {e["name"]: e["dur_s"] for e in sink.events if e["type"] == "span"}
    assert durs["synced"] > 0.03 > durs["unsynced"] and not unsynced_done


def _span_events(sink):
    return {e["name"]: e for e in sink.events if e["type"] == "span"}


def test_span_device_time_and_stamps_match_the_kernel(dev):
    """A span around a kernel and a sync: ``dev_s`` within 10% of the
    kernel's time between CUDA events, and the profiler's device interval
    of the kernel, and its host interval of the product, inside the span's
    ``t0_ns`` / ``t1_ns``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    x = torch.randn(4096, 4096, device=dev)
    (x @ x).sum()
    torch.cuda.synchronize()
    # each timing behind a queued device sleep: the host is ahead of the
    # card, so the events bracket the kernel and not its launch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    y = x @ x
    end.record()
    torch.cuda.synchronize()
    kernel_s = start.elapsed_time(end) * 1e-3
    sink = obs.MemorySink()
    tele = obs.Telemetry([sink], trace=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(50_000_000)
        t_sleep = time.time_ns()
        with tele.span("matmul") as sp:
            y = sp.sync(x @ x)
    ev = _span_events(sink)["matmul"]
    assert ev["dev_s"] == pytest.approx(kernel_s, rel=0.1)
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and e.duration_ns() > 0]
    assert kernels and y.shape == x.shape
    # the sleep was launched before the span: only its end lies inside
    for k in kernels:
        assert k.end_ns() <= ev["t1_ns"]
        if k.start_ns() > t_sleep:
            assert ev["t0_ns"] <= k.start_ns() < k.end_ns()
    matmul = [k for k in kernels if "sleep" not in k.name()
              and "spin" not in k.name()]
    assert matmul and all(ev["t0_ns"] <= k.start_ns() for k in matmul)
    (mm,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::mm"]
    assert ev["t0_ns"] <= mm.start_ns() < mm.end_ns() <= ev["t1_ns"]
    tele.close()


def test_span_counts_host_syncs_not_its_own(dev):
    """``.item()`` inside a span is one sync; a launch is none; the span's
    own wait for the device is not counted.  The check is armed only while
    a span is open."""
    from repro_torch import obs
    sink = obs.MemorySink()
    tele = obs.Telemetry([sink], trace=True)
    x = torch.ones(1000, device=dev)
    mode = torch.cuda.get_sync_debug_mode()
    with tele.span("item"):
        assert torch.cuda.get_sync_debug_mode() == 1
        x.sum().item()
    with tele.span("launch") as sp:
        sp.sync(x * 2)
    assert torch.cuda.get_sync_debug_mode() == mode
    tele.close()
    ev = _span_events(sink)
    assert (ev["item"]["syncs"], ev["launch"]["syncs"]) == (1, 0)
    assert ev["item"]["dev_s"] >= 0 and ev["launch"]["dev_s"] >= 0


def _micro_round(dev, tele, clients=3):
    """Round 0 of a micro flat federation of ``clients`` on the card."""
    from repro_torch import fed
    from repro_torch.launch import simulate
    cfg = simulate.micro_cfg()
    orch = fed.Orchestrator(
        cfg, F.FetchSGDConfig(rows=3, cols=1 << 12, k=64),
        fed.FederationConfig(rounds=2, clients_per_round=clients, seed=1),
        simulate.micro_dataset(cfg), device=dev, telemetry=tele,
        health_every=0)
    return orch.run_round(0)


def test_micro_round_syncs_are_the_codes(dev):
    """A micro round's ``fed.round`` counts four syncs, whatever its
    number of clients: the one read of its clients' losses
    (``torch.stack(losses).tolist()``, once the server update is
    enqueued) and three in the server update: the chunk tables that
    ``topk.global_ids`` (offsets) and ``topk.apply_delta`` (leaf, start)
    build with ``torch.tensor(list, device=...)``, each a pageable copy.
    No client's span counts one: ``federated.to_batch`` copies from pinned
    memory without blocking and the loss stays on the device, so the host
    dispatches the next client while the card runs this one's sketch.
    Each client's three spans carry its id."""
    from repro_torch import obs
    for n in (3, 6):
        sink = obs.MemorySink()
        tele = obs.Telemetry([sink], trace=True)
        rec = _micro_round(dev, tele, clients=n)
        tele.close()
        spans = [e for e in sink.events if e["type"] == "span"]
        (rnd,) = [e for e in spans if e["name"] == "fed.round"]
        assert len(rec.cohort) == n and rec.n_dropped == 0
        assert rnd["syncs"] == 1 + 3
        syncs = {e["name"]: e["syncs"] for e in spans if e["depth"] == 1}
        assert syncs == {"fed.clients": 0, "fed.aggregate": 0,
                         "fed.server_update": 3}
        for step in ("batch", "grad", "sketch"):
            got = [e for e in spans if e["name"] == f"fed.client.{step}"]
            assert [e["client"] for e in got] == rec.cohort
            assert all(e["syncs"] == 0 and e["dev_s"] >= 0 for e in got)
        (clients,) = [e for e in spans if e["name"] == "fed.clients"]
        assert sum(e["dev_s"] for e in spans if e["name"] in (
            "fed.client.grad", "fed.client.sketch")) <= clients["dur_s"]


def test_to_batch_copies_from_pinned_memory_without_a_sync(dev):
    """``federated.to_batch`` on the card makes no host-device sync and
    returns int64 tensors equal to its numpy input.  The batches, of
    several sizes (two alike), are built back to back behind a sleeping
    kernel, so every copy is still queued when the next batch is staged:
    staging handed out again before its copy landed would show as a wrong
    batch.  On the CPU it returns what it always has,
    ``torch.as_tensor(x, dtype=torch.int64)``."""
    from repro_torch.data import federated
    rng = np.random.default_rng(0)
    inputs = [{"tokens": rng.integers(0, 92544, (n, 32), dtype=np.int32),
               "labels": rng.integers(-1, 92544, (n, 32), dtype=np.int64)}
              for n in (4, 4, 1, 64, 7, 3)]
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.cuda._sleep(200_000_000)         # ~0.1 s of a busy stream
        got = [federated.to_batch(b, dev) for b in inputs]
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    for b, g in zip(inputs, got):
        for k in ("tokens", "labels"):
            assert g[k].device.type == "cuda" and g[k].dtype == torch.int64
            np.testing.assert_array_equal(g[k].cpu().numpy(), b[k])
    for b in inputs:
        cpu = federated.to_batch(b, torch.device("cpu"))
        for k in ("tokens", "labels"):
            want = torch.as_tensor(b[k], dtype=torch.int64)
            assert cpu[k].device.type == "cpu" and cpu[k].dtype == torch.int64
            assert torch.equal(cpu[k], want)


def test_untraced_round_records_no_event_and_arms_no_check(dev, monkeypatch):
    """With tracing off a round makes no CUDA event and never touches the
    sync check."""
    from repro_torch import obs

    def refuse(*a, **k):
        raise AssertionError("touched with tracing off")
    _micro_round(dev, None)                    # build and warm first
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", refuse)
    for tele in (None, obs.Telemetry([obs.MemorySink()])):
        assert _micro_round(dev, tele).n_fresh == 3


def test_recovery_error_on_the_card_matches_the_cpu(dev):
    """``sketch_health.recovery_error`` on the card (estimate kernel,
    ``torch.topk`` on the card) against the CPU on the same table: the
    estimates are exact, so the ids agree and the error to rounding."""
    from repro_torch.obs import sketch_health as sh
    gen = torch.Generator().manual_seed(1)
    shapes = {"a": (40, 50), "b": (1000,)}
    grads = {k: torch.randn(s, generator=gen) * 0.01
             for k, s in shapes.items()}
    grads["b"][torch.randperm(1000, generator=gen)[:64]] += 3.0
    cfg = F.FetchSGDConfig(rows=5, cols=4096, k=64)
    lay = L.build_layout(grads)
    table = F.sketch_grads(grads, lay, cfg)
    table += torch.randn(table.shape, generator=gen) * 1e-3
    out = {}
    for d in (dev, torch.device("cpu")):
        g = L.tree_map(lambda x: x.to(d), grads)
        out[d.type] = sh.recovery_error(table.to(d), sh.flatten_dense(g, lay),
                                        lay, cfg)
    assert out["cuda"]["heavy_hitter_overlap"] \
        == out["cpu"]["heavy_hitter_overlap"] > 0.5
    np.testing.assert_allclose(out["cuda"]["recovery_rel_err"],
                               out["cpu"]["recovery_rel_err"], rtol=1e-4)


@pytest.mark.parametrize("clock", ["round", "event"])
def test_resume_on_the_card_follows_the_contract(dev, tmp_path, clock):
    """A micro async run on the card, checkpointed after round 1 and
    resumed in a fresh orchestrator: every record field but the loss
    equals the uninterrupted card run's, losses within 1e-3 (the encode's
    atomics sum in no fixed order), and telemetry on the resumed run
    changes none of it.  2**16 columns for the reason given in
    ``test_orchestrator_on_the_card_matches_the_cpu``."""
    from repro_torch import fed, obs
    from repro_torch.launch import simulate
    from repro_torch.models import transformer
    from repro_torch.optim import linear_decay
    cfg = simulate.micro_cfg()
    init = dict(L.flatten(transformer.init_params(cfg, seed=0)))
    fs_cfg = F.FetchSGDConfig(rows=3, cols=1 << 16, k=64)

    def run(rounds, ckdir=None, tele=None):
        fed_cfg = fed.FederationConfig(
            rounds=rounds, clients_per_round=5, aggregate="async", seed=3,
            clock=clock, simtime=fed.SimTimeConfig(quorum=2),
            straggler=fed.StragglerModel(straggle_prob=0.5, max_delay=2),
            checkpoint_dir=ckdir, checkpoint_every=2)
        params = L.unflatten(list(init), [x.to(dev, copy=True)
                                          for x in init.values()])
        return fed.Orchestrator(cfg, fs_cfg, fed_cfg,
                                simulate.micro_dataset(cfg), params=params,
                                lr_fn=linear_decay(0.2, 4), device=dev,
                                telemetry=tele).run()
    full = run(4)
    run(2, str(tmp_path))
    sink = obs.MemorySink()
    resumed = run(4, str(tmp_path), obs.Telemetry([sink], trace=True))
    assert resumed.extras["start_round"] == 2
    meta = [{k: v for k, v in vars(r).items() if k != "loss"}
            for r in resumed.records]
    assert meta == [{k: v for k, v in vars(r).items() if k != "loss"}
                    for r in full.records[2:]]
    np.testing.assert_allclose(resumed.losses, full.losses[2:], rtol=1e-3)
    assert [e["round"] for e in sink.events if e["type"] == "round"] \
        == [2, 3]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "glm4-9b", "gpt2s-federated"])
def test_serve_on_the_card_matches_the_cpu(dev, arch):
    """The smoke config served on the card and on the CPU from the same
    weights: prefill logits within 1e-4 of the largest logit (float32 on
    both, TF32 off), and 12 teacher-forced decode steps within one bfloat16
    step (2**-8) of the largest logit, since the bfloat16 cache can round a
    key to its neighbour on one device only; the caches hold the same
    positions."""
    from repro_torch import configs
    from repro_torch.models import transformer as tt

    cfg = configs.get_smoke(arch)
    cpu = tt.init_params(cfg, seed=0)
    card = L.tree_map(lambda x: x.to(dev), cpu)
    toks = torch.randint(0, cfg.vocab, (2, 20),
                         generator=torch.Generator().manual_seed(3))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            caches = [tt.init_cache(cfg, 2, 24, device=d)
                      for d in ("cpu", dev)]
            outs = [tt.prefill(p, {"tokens": toks[:, :8].to(d)}, cfg, c)[0]
                    for p, c, d in zip((cpu, card), caches, ("cpu", dev))]
            scale = float(outs[0].abs().max())
            torch.testing.assert_close(outs[1].cpu(), outs[0], rtol=1e-4,
                                       atol=1e-4 * scale)
            for t in range(8, 20):
                outs = [tt.decode_step(p, toks[:, t:t + 1].to(d), cfg, c)[0]
                        for p, c, d in zip((cpu, card), caches,
                                           ("cpu", dev))]
                scale = float(outs[0].abs().max())
                torch.testing.assert_close(outs[1].cpu(), outs[0], rtol=0,
                                           atol=2 ** -8 * scale,
                                           msg=f"pos {t}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert torch.equal(caches[1]["attn"]["pos_arr"].cpu(),
                       caches[0]["attn"]["pos_arr"])
    assert int(caches[1]["pos"]) == int(caches[0]["pos"]) == 20


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b",
                                  "llama4-maverick-400b-a17b",
                                  "xlstm-350m", "jamba-v0.1-52b"])
def test_moe_and_recurrent_on_the_card_match_the_cpu(dev, arch):
    """The MoE and recurrent smoke configs on the card and on the CPU from
    the same weights, TF32 off: the loss (cross entropy plus the MoE aux
    term) within rtol 1e-4, as a float32 last bit may flip a bfloat16
    rounding of the residual stream; prefill logits within 1e-4 of the
    largest (float32 states on both); 12 teacher-forced decode steps
    within one bfloat16 step (2**-8) of the largest logit, as in
    ``test_serve_on_the_card_matches_the_cpu``; the recurrent states after
    the last step within 1e-3 of their largest value."""
    from repro_torch import configs
    from repro_torch.models import transformer as tt

    cfg = configs.get_smoke(arch)
    cpu = tt.init_params(cfg, seed=0)
    card = L.tree_map(lambda x: x.to(dev), cpu)
    toks = torch.randint(0, cfg.vocab, (2, 20),
                         generator=torch.Generator().manual_seed(3))
    labels = torch.randint(0, cfg.vocab, (2, 20),
                           generator=torch.Generator().manual_seed(4))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            losses = [tt.loss_fn(p, {"tokens": toks.to(d),
                                     "labels": labels.to(d)}, cfg)
                      for p, d in ((cpu, "cpu"), (card, dev))]
            np.testing.assert_allclose(float(losses[1][0]),
                                       float(losses[0][0]), rtol=1e-4)
            np.testing.assert_allclose(float(losses[1][1]["aux"]),
                                       float(losses[0][1]["aux"]), rtol=1e-4)
            caches = [tt.init_cache(cfg, 2, 24, device=d)
                      for d in ("cpu", dev)]
            outs = [tt.prefill(p, {"tokens": toks[:, :8].to(d)}, cfg, c)[0]
                    for p, c, d in zip((cpu, card), caches, ("cpu", dev))]
            scale = float(outs[0].abs().max())
            torch.testing.assert_close(outs[1].cpu(), outs[0], rtol=1e-4,
                                       atol=1e-4 * scale)
            for t in range(8, 20):
                outs = [tt.decode_step(p, toks[:, t:t + 1].to(d), cfg, c)[0]
                        for p, c, d in zip((cpu, card), caches,
                                           ("cpu", dev))]
                scale = float(outs[0].abs().max())
                torch.testing.assert_close(outs[1].cpu(), outs[0], rtol=0,
                                           atol=2 ** -8 * scale,
                                           msg=f"pos {t}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for kind in ("mamba", "mlstm", "slstm"):
        for part, want in caches[0].get(kind, {}).items():
            want = want[want.abs() < 1e8]         # sLSTM's m starts at -1e9
            got = caches[1][kind][part].cpu()
            got = got[got.abs() < 1e8]
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-3 * float(want.abs().max()),
                                       msg=f"{kind}.{part}")
    assert int(caches[1]["pos"]) == int(caches[0]["pos"]) == 20


@pytest.mark.parametrize("arch", ["whisper-small", "pixtral-12b"])
def test_encdec_and_frontends_on_the_card_match_the_cpu(dev, arch):
    """whisper-small (frames into the encoder, cross-attention in every
    decoder layer) and pixtral-12b (a patch prefix) at smoke size on the
    card and on the CPU from the same weights and inputs, TF32 off: the
    loss within rtol 1e-4 (a float32 last bit may flip a bfloat16
    rounding of the residual stream); prefill logits within 1e-4 of the
    largest; 12 teacher-forced decode steps within one bfloat16 step
    (2**-8) of the largest logit, as in
    ``test_serve_on_the_card_matches_the_cpu``; the cross-attention cache
    within one bfloat16 step of each value plus 1e-5 of the largest."""
    from repro_torch import configs
    from repro_torch.launch import serve_lm
    from repro_torch.models import transformer as tt

    cfg = configs.get_smoke(arch)
    cpu = tt.init_params(cfg, seed=0)
    card = L.tree_map(lambda x: x.to(dev), cpu)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (2, 20), generator=gen)
    labels = torch.randint(0, cfg.vocab, (2, 20), generator=gen)
    extra = serve_lm.frontend_inputs(cfg, 2, gen)
    prefix = cfg.n_patches if cfg.frontend == "vision" else 0
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False

    def on(d, **kw):
        return {k: v.to(d) for k, v in {**extra, **kw}.items()}

    try:
        with torch.no_grad():
            losses = [tt.loss_fn(p, on(d, tokens=toks, labels=labels), cfg)[0]
                      for p, d in ((cpu, "cpu"), (card, dev))]
            np.testing.assert_allclose(float(losses[1]), float(losses[0]),
                                       rtol=1e-4)
            caches = [tt.init_cache(cfg, 2, prefix + 24, device=d)
                      for d in ("cpu", dev)]
            outs = [tt.prefill(p, on(d, tokens=toks[:, :8]), cfg, c)[0]
                    for p, c, d in zip((cpu, card), caches, ("cpu", dev))]
            scale = float(outs[0].abs().max())
            torch.testing.assert_close(outs[1].cpu(), outs[0], rtol=1e-4,
                                       atol=1e-4 * scale)
            for t in range(8, 20):
                outs = [tt.decode_step(p, toks[:, t:t + 1].to(d), cfg, c)[0]
                        for p, c, d in zip((cpu, card), caches,
                                           ("cpu", dev))]
                scale = float(outs[0].abs().max())
                torch.testing.assert_close(outs[1].cpu(), outs[0], rtol=0,
                                           atol=2 ** -8 * scale,
                                           msg=f"pos {t}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for part, want in caches[0].get("xattn", {}).items():
        want = want.float()
        torch.testing.assert_close(caches[1]["xattn"][part].cpu().float(),
                                   want, rtol=2 ** -7,
                                   atol=1e-5 * float(want.abs().max()),
                                   msg=f"xattn.{part}")
    assert torch.equal(caches[1]["attn"]["pos_arr"].cpu(),
                       caches[0]["attn"]["pos_arr"])
    assert int(caches[1]["pos"]) == int(caches[0]["pos"]) == prefix + 20


# one smoke config of each decode kind the zoo serves: dense GQA, the
# sliding-window ring (a window of 8 under a call of 12 + 10), capacity
# MoE, mamba (jamba: mamba, attention and MoE), mLSTM/sLSTM, the
# encoder-decoder and the vision prefix
GRAPH_ARCHS = {"internlm2-1.8b": {}, "qwen3-0.6b": dict(sliding_window=8),
               "qwen2-moe-a2.7b": {}, "jamba-v0.1-52b": {}, "xlstm-350m": {},
               "whisper-small": {}, "pixtral-12b": {}}
GRAPH_PROMPT, GRAPH_TOKENS = 12, 10


def _graph_case(arch, dev):
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve_lm
    from repro_torch.models import transformer as tt

    cfg = dataclasses.replace(configs.get_smoke(arch), **GRAPH_ARCHS[arch])
    params = L.tree_map(lambda x: x.to(dev), tt.init_params(cfg, seed=0))
    gen = torch.Generator().manual_seed(7)
    prompts = torch.randint(0, cfg.vocab, (2, GRAPH_PROMPT), generator=gen)
    extra = serve_lm.frontend_inputs(cfg, 2, gen)
    prefix = cfg.n_patches if cfg.frontend == "vision" else 0
    return cfg, params, prompts, extra, prefix


@pytest.mark.parametrize("arch", list(GRAPH_ARCHS))
def test_serve_graph_replays_the_eager_decode(dev, arch):
    """``serve`` on the card runs one eager decode step and replays a
    captured one ``n_tokens - 2`` times, counted in ``DECODE_STEPS``; its
    tokens and last logits are exactly those of the same call stepped
    eagerly through ``decode_step`` on the card (the graph replays the
    eager step's kernels, TF32 off), its cache ends at ``prefix + S +
    n_tokens - 1``, and a second call with the same prompts gives the
    same tokens and logits (no state carried between calls)."""
    from repro_torch.launch import serve_lm
    from repro_torch.models import transformer as tt

    cfg, params, prompts, extra, prefix = _graph_case(arch, dev)
    on = {k: v.to(dev) for k, v in extra.items()}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            logits, cache = tt.prefill(
                params, {"tokens": prompts.to(dev), **on}, cfg,
                tt.init_cache(cfg, 2, prefix + GRAPH_PROMPT + GRAPH_TOKENS,
                              device=dev))
            out = [logits.argmax(-1, keepdim=True)]
            for _ in range(GRAPH_TOKENS - 1):
                logits, cache = tt.decode_step(params, out[-1], cfg, cache)
                out.append(logits.argmax(-1, keepdim=True))
        want = torch.cat(out, dim=1)
        before = dict(serve_lm.DECODE_STEPS)
        res = serve_lm.serve(cfg, params, prompts, GRAPH_TOKENS, dev, **extra)
        assert serve_lm.DECODE_STEPS == {
            "graph": before["graph"] + GRAPH_TOKENS - 2,
            "eager": before["eager"] + 1}
        again = serve_lm.serve(cfg, params, prompts, GRAPH_TOKENS, dev,
                               **extra)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    gap = float((res.logits - logits).abs().max() / logits.abs().max())
    assert torch.equal(res.tokens, want), (res.tokens, want)
    assert gap == 0.0, f"{arch}: logits off the eager step's by {gap:.3e}"
    assert int(res.cache["pos"]) == prefix + GRAPH_PROMPT + GRAPH_TOKENS - 1
    for key in ("k", "v", "pos_arr"):
        if "attn" in cache:
            assert torch.equal(res.cache["attn"][key], cache["attn"][key])
    assert torch.equal(again.tokens, res.tokens)
    assert torch.equal(again.logits, res.logits)


@pytest.mark.parametrize("arch", list(GRAPH_ARCHS))
def test_serve_graph_replays_make_no_host_sync(dev, arch):
    """The captured decode step's replays run under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    host sync, and each advances the cache's position by one and fills
    the next column of the tokens."""
    from repro_torch.launch import serve_lm
    from repro_torch.models import transformer as tt

    cfg, params, prompts, extra, prefix = _graph_case(arch, dev)
    first = prefix + GRAPH_PROMPT
    with torch.no_grad():
        logits, cache = tt.prefill(
            params, {"tokens": prompts.to(dev),
                     **{k: v.to(dev) for k, v in extra.items()}}, cfg,
            tt.init_cache(cfg, 2, first + GRAPH_TOKENS, device=dev))
        tok = logits.argmax(-1, keepdim=True)
        tokens = torch.full((2, GRAPH_TOKENS), -1, dtype=tok.dtype,
                            device=dev)
        tokens[:, :1] = tok
        graph, static = serve_lm.capture_decode(params, tok, cfg, cache,
                                                tokens, first)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(GRAPH_TOKENS - 2):
                graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    assert int(cache["pos"]) == first + GRAPH_TOKENS - 1
    assert bool((tokens >= 0).all())
    assert torch.equal(tokens[:, -1:], tok)
    assert torch.equal(static.argmax(-1, keepdim=True), tok)


def _mesh_world_of_1(rank: int) -> dict:
    """A world of 1 on the card (nccl): each policy's first step against
    the single-device ``F.step`` on the same weights and batch."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib, shapes, steps
    from repro_torch.models import transformer

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = configs.get_smoke("qwen3-0.6b")
    fs = F.FetchSGDConfig(rows=3, cols=1 << 16, k=256, momentum=0.9)
    mesh = mesh_lib.make_debug_mesh(1, 1, "cuda")
    init = transformer.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab, (4, 32), generator=gen).to(dev)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    lr = torch.full((), 0.1, device=dev)

    def clone():
        return L.tree_map(lambda t: t.clone(), init)

    single = clone()
    loss, grads = transformer.value_and_grad(single, batch, cfg)
    table = F.sketch_grads(grads, L.build_layout(single), fs)
    F.step(single, grads, F.init_state(fs, dev), lr, L.build_layout(single),
           fs)
    out = {"backend": dist.get_backend(), "loss": float(loss)}
    zeros = torch.zeros(3, 1 << 16, device=dev)
    for name, kw, extra in (("flat", {}, ()), ("tree", dict(aggregate="tree"),
                                               ()),
                            ("dense", dict(aggregate="dense"), ()),
                            ("async", dict(aggregate="async"),
                             (1.0, zeros, 0.0)),
                            ("model_local", dict(sketch_mode="model_local"),
                             ())):
        b = steps.make_train_step(cfg, shapes.ShapeSpec("t", "train", 32, 4),
                                  mesh, fs, **kw)
        p, _, m = b.fn(clone(), F.init_state(fs, dev), batch, lr, *extra)
        changed = {}
        for (path, a), (_, s), (_, w) in zip(L.flatten(p), L.flatten(single),
                                             L.flatten(init)):
            da, ds = (a - w).reshape(-1), (s - w).reshape(-1)
            ia, is_ = torch.nonzero(da).flatten(), torch.nonzero(ds).flatten()
            changed[path] = (ia.cpu().tolist(), is_.cpu().tolist(),
                             float((da - ds).abs().max()),
                             float(ds.abs().max()))
        out[name] = dict(loss=float(m["loss"]), changed=changed,
                         table_err=float((m["table"] - table).abs().max()),
                         table_max=float(table.abs().max()))
    return out


def test_mesh_step_world_of_1_matches_the_single_device_step(dev):
    """A world of 1 on the card (nccl), each policy against the
    single-device step: the loss exactly, the table within 1e-5 of its
    largest entry (the encode's float atomics), the updated ids equal and
    the updates within 1e-5 of the largest."""
    from repro_torch.launch import mesh as mesh_lib
    res = mesh_lib.spawn(_mesh_world_of_1, 1, device="cuda", timeout=300)[0]
    assert res["backend"] == "nccl"
    for name in ("flat", "tree", "dense", "async", "model_local"):
        r = res[name]
        assert r["loss"] == res["loss"], name
        assert r["table_err"] <= 1e-5 * r["table_max"], name
        n = sum(len(ia) for ia, _, _, _ in r["changed"].values())
        assert n == 256, (name, n)
        top = max(m for _, _, _, m in r["changed"].values())
        for path, (ia, is_, err, _) in r["changed"].items():
            assert ia == is_, (name, path)
            assert err <= 1e-5 * top, (name, path, err)
