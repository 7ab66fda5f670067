"""Port parity: the FetchSGD server step of repro_torch against repro.

Covers the two server-step kernels' plain twins (momentum/error and the
hit-cell update) against repro's jnp twins and its Pallas kernels in
interpret mode, the layout and top-k, and three consecutive server rounds
across error_mode x momentum_masking.

Tolerances: momentum/error and the hit-cell zeroing are elementwise with
the same roundings on both sides, so they are compared exactly with the
jnp twins (the compiled Pallas body may fuse an FMA: rtol=atol=1e-6); so
is the subtraction on integer values.  Server rounds on real-valued gradients
are compared with rtol=atol=1e-6 (float32 sums whose order XLA may pick),
and the extracted ids exactly as a set: the gradients are random reals,
but two ids that share a bucket can still tie in magnitude, and the two
libraries' top-k may order such ties differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fetchsgd as JF
from repro.core import layout as JL
from repro.core import topk as JT
from repro.kernels import server_step as jss
from repro_torch.core import fetchsgd as TF
from repro_torch.core import layout as TL
from repro_torch.core import topk as TT
from repro_torch.kernels import ops, ref
from repro_torch.kernels import server_step as cuda_ss

ROWS, COLS, K = 3, 384, 8
SHAPES = {"a": (32, 16), "b": (64,)}


def tables(rng, n=3, rows=ROWS, cols=COLS):
    return [rng.normal(size=(rows, cols)).astype(np.float32)
            for _ in range(n)]


def t(x):
    return torch.from_numpy(np.array(x))


def random_ids(rng, k, hi=2**42):
    return np.unique(rng.integers(0, hi, size=k)).astype(np.int64)


def jwords(ids):
    return (jnp.asarray(ids >> 32, jnp.uint32),
            jnp.asarray(ids & 0xFFFFFFFF, jnp.uint32))


@pytest.mark.parametrize("rows,cols", [(3, 384), (4, 300), (2, 1000)])
def test_momentum_error_exact(rng, rows, cols):
    agg, su, se = tables(rng, rows=rows, cols=cols)
    lr = np.float32(0.07)
    got = ops.momentum_error(t(agg), t(su), t(se), torch.tensor(lr), 0.9)
    want = jss.momentum_error_jnp(jnp.asarray(agg), jnp.asarray(su),
                                  jnp.asarray(se), jnp.float32(lr), 0.9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if cols % 128 == 0:
        # XLA compiles the interpreted kernel body and may contract the
        # multiply-add into an FMA: one rounding fewer, so not bitwise
        pal = jss.momentum_error(jnp.asarray(agg), jnp.asarray(su),
                                 jnp.asarray(se), jnp.float32(lr), 0.9,
                                 interpret=True)
        for g, w in zip(got, pal):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("error_mode", ["zero", "subtract"])
@pytest.mark.parametrize("momentum_masking", [True, False])
@pytest.mark.parametrize("rows,cols", [(2, 384), (9, 640), (4, 1920),
                                       (3, 130), (4, 300), (5, 1000)])
def test_topk_mask_matches_reference(rng, error_mode, momentum_masking, rows,
                                     cols):
    su = rng.integers(-9, 10, size=(rows, cols)).astype(np.float32)
    se = rng.integers(-9, 10, size=(rows, cols)).astype(np.float32)
    ids = random_ids(rng, 40)
    vals = rng.integers(-5, 6, size=ids.size).astype(np.float32)
    hi, lo = jwords(ids)
    kw = dict(error_mode=error_mode, momentum_masking=momentum_masking)
    # in place on copies
    got = ops.topk_mask(t(su), t(se), t(ids), t(vals), 3, **kw)
    want = jss.topk_mask_jnp(jnp.asarray(su), jnp.asarray(se), hi, lo,
                             jnp.asarray(vals), 3, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if cols % 128 == 0:
        pal = jss.topk_mask(jnp.asarray(su), jnp.asarray(se), hi, lo,
                            jnp.asarray(vals), 3, interpret=True, **kw)
        for g, w in zip(got, pal):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("error_mode", ["zero", "subtract"])
def test_topk_mask_with_no_ids_is_identity(rng, error_mode):
    su, se = (t(x) for x in tables(rng, 2))
    su0, se0 = su.clone(), se.clone()
    empty = torch.zeros(0, dtype=torch.int64)
    out = ops.topk_mask(su, se, empty, torch.zeros(0), error_mode=error_mode)
    torch.testing.assert_close(out, (su0, se0), rtol=0, atol=0)


def test_layout_matches_reference():
    jl = JL.build_layout({k: jnp.zeros(s) for k, s in SHAPES.items()},
                         chunk_elems=100)
    tl = TL.build_layout({k: torch.zeros(s) for k, s in SHAPES.items()},
                         chunk_elems=100)
    assert [(c.leaf, c.path, c.row_start, c.n_rows, c.row_len, c.offset)
            for c in jl.chunks] == [
        (c.leaf, c.path, c.row_start, c.n_rows, c.row_len, c.offset)
        for c in tl.chunks]
    assert [(g.leaf, g.n_rows, g.row_len, g.chunk_ids) for g in jl.groups] \
        == [(g.leaf, g.n_rows, g.row_len, g.chunk_ids) for g in tl.groups]
    assert jl.total == tl.total == 32 * 16 + 64


def test_topk_apply_and_densify_match_reference(rng):
    jl = JL.build_layout({k: jnp.zeros(s) for k, s in SHAPES.items()},
                         chunk_elems=100)
    tl = TL.build_layout({k: torch.zeros(s) for k, s in SHAPES.items()},
                         chunk_elems=100)
    tbl = rng.normal(size=(ROWS, COLS)).astype(np.float32)
    jd = JT.topk_from_sketch(jnp.asarray(tbl), jl, 20, 1, impl="jnp")
    td = TT.topk_from_sketch(t(tbl), tl, 20, 1)
    np.testing.assert_array_equal(td.chunk_id.numpy(), np.asarray(jd.chunk_id))
    np.testing.assert_array_equal(td.local_idx.numpy(),
                                  np.asarray(jd.local_idx))
    np.testing.assert_array_equal(td.values.numpy(), np.asarray(jd.values))
    np.testing.assert_array_equal(TT.densify(td, tl).numpy(),
                                  np.asarray(JT.densify(jd, jl)))
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    jp = JT.apply_delta({k: jnp.asarray(v) for k, v in params.items()}, jl,
                        jd, scale=0.5)
    tp = TT.apply_delta({k: t(v) for k, v in params.items()}, tl, td,
                        scale=0.5)
    for k in SHAPES:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def assert_same_delta(td, tl, jd, jl):
    """Same extracted ids with the same values, in any order.

    Two ids that share the median cell have estimates of equal magnitude,
    and ``torch.topk`` and ``lax.top_k`` may order such ties differently.
    """
    jids = np.asarray(JT.global_ids(jd, jl)[0], np.int64) << 32 | np.asarray(
        JT.global_ids(jd, jl)[1], np.int64)
    tids = TT.global_ids(td, tl).numpy()
    jo, to = np.argsort(jids), np.argsort(tids)
    np.testing.assert_array_equal(tids[to], jids[jo])
    np.testing.assert_allclose(td.values.numpy()[to],
                               np.asarray(jd.values)[jo], rtol=1e-6,
                               atol=1e-6)


def test_sketch_grads_matches_reference(rng):
    jcfg = JF.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, impl="jnp")
    tcfg = TF.FetchSGDConfig(rows=ROWS, cols=COLS, k=K)
    jl = JL.build_layout({k: jnp.zeros(s) for k, s in SHAPES.items()},
                         chunk_elems=100)
    tl = TL.build_layout({k: torch.zeros(s) for k, s in SHAPES.items()},
                         chunk_elems=100)
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    want = JF.sketch_grads({k: jnp.asarray(v) for k, v in g.items()}, jl,
                           jcfg)
    got = TF.sketch_grads({k: t(v) for k, v in g.items()}, tl, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("error_mode", ["zero", "subtract"])
@pytest.mark.parametrize("momentum_masking", [True, False])
def test_three_server_rounds_match_reference(rng, error_mode,
                                             momentum_masking):
    jcfg = JF.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, error_mode=error_mode,
                             momentum_masking=momentum_masking, impl="jnp")
    tcfg = TF.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, error_mode=error_mode,
                             momentum_masking=momentum_masking)
    jl = JL.build_layout({k: jnp.zeros(s) for k, s in SHAPES.items()})
    tl = TL.build_layout({k: torch.zeros(s) for k, s in SHAPES.items()})
    j_step = jax.jit(JF.server_step, static_argnames=("layout", "cfg"))
    jst, tst, rst = JF.init_state(jcfg), TF.init_state(tcfg), \
        TF.init_state(tcfg)
    for _ in range(3):
        agg = np.mean(tables(rng, 3), axis=0)     # the mean client sketch
        jd, jst = j_step(jnp.asarray(agg), jst, jnp.float32(0.05), layout=jl,
                         cfg=jcfg)
        td, tst = TF.server_step(t(agg), tst, torch.tensor(0.05), tl, tcfg)
        rd, rst = TF.server_step_reference(t(agg), rst, 0.05, tl, tcfg)
        assert_same_delta(td, tl, jd, jl)
        for a, b in ((tst.momentum_sketch, jst.momentum_sketch),
                     (tst.error_sketch, jst.error_sketch)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
        # the dispatched step and the unfused oracle agree bit for bit
        torch.testing.assert_close(td.values, rd.values, rtol=0, atol=0)
        torch.testing.assert_close(tst.error_sketch, rst.error_sketch,
                                   rtol=0, atol=0)
        torch.testing.assert_close(tst.momentum_sketch, rst.momentum_sketch,
                                   rtol=0, atol=0)
        assert tst.step == int(jst.step)


def test_step_and_views_match_reference(rng):
    """fetchsgd.step (sketch + server step + apply) and the leaf views."""
    jcfg = JF.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, impl="jnp")
    tcfg = TF.FetchSGDConfig(rows=ROWS, cols=COLS, k=K)
    jl = JL.build_layout({k: jnp.zeros(s) for k, s in SHAPES.items()})
    tl = TL.build_layout({k: torch.zeros(s) for k, s in SHAPES.items()})
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    jp, _, jd = JF.step({k: jnp.asarray(v) for k, v in p.items()},
                        {k: jnp.asarray(v) for k, v in g.items()},
                        JF.init_state(jcfg), jnp.float32(0.1), jl, jcfg)
    tparams = {k: t(v) for k, v in p.items()}
    tp, tst, td = TF.step(tparams, {k: t(v) for k, v in g.items()},
                          TF.init_state(tcfg), 0.1, tl, tcfg)
    assert tp is tparams and tst.step == 1      # updated in place
    assert_same_delta(td, tl, jd, jl)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)
    views = TL.leaf_views(tp, tl)
    assert [tuple(v.shape) for v in views] == [(32, 16), (64, 1)]
    back = TL.unview(views, tl)
    assert all(back[k].data_ptr() == tp[k].data_ptr() for k in SHAPES)


def test_server_step_leaves_the_input_state_unchanged(rng):
    cfg = TF.FetchSGDConfig(rows=ROWS, cols=COLS, k=K)
    lay = TL.build_layout({k: torch.zeros(s) for k, s in SHAPES.items()})
    st = TF.FetchSGDState(*(t(x) for x in tables(rng, 2)), step=0)
    before = (st.momentum_sketch.clone(), st.error_sketch.clone())
    TF.server_step(t(tables(rng, 1)[0]), st, 0.05, lay, cfg)
    torch.testing.assert_close((st.momentum_sketch, st.error_sketch), before,
                               rtol=0, atol=0)


def test_byte_accounting_matches_reference():
    for kw in ({}, {"rows": 7, "cols": 1 << 20, "k": 25_000}):
        jc, tc = JF.FetchSGDConfig(**kw), TF.FetchSGDConfig(**kw)
        assert TF.upload_bytes(tc) == JF.upload_bytes(jc)
        assert TF.download_bytes(tc) == JF.download_bytes(jc)
        for n in (0, 1, 5, 17):
            assert TF.tree_upload_bytes(tc, n, 3) == \
                JF.tree_upload_bytes(jc, n, 3)


def test_server_kernel_wrappers_refuse_cpu_tensors(rng):
    su, se = (t(x) for x in tables(rng, 2))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ss.momentum_error(su, su, se, torch.tensor(0.1), 0.9)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ss.topk_mask(su, se, torch.tensor([1]), torch.tensor([1.0]))
