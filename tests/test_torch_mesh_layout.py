"""Port parity for what the mesh step's numbers rest on: the 64-bit word
arithmetic of strided ids (``hashing.mul32x32``, ``ids_for_grid``), the
layout under view permutations and expert parallelism (``build_layout``
with ``view_perms``, ``data_shard_axis`` and ``ep``: chunks with owners
and local rows, local chunks with one offset a data shard, local shapes),
the sharding rules (``param_spec`` and ``layout_view_plan`` for every
arch of the zoo at 16 x 16 and 2 x 16 x 16, and the plans of the small
meshes of the tests), the sparse update written through a permutation,
and ``cohort_batch``.  All of it is exact: integers, shapes and specs.

The reference's sharding rules read only ``mesh.shape``; its
``layout_view_plan`` builds ``NamedSharding``s, which an ``AbstractMesh``
of the same axes serves without devices.  Parameter shapes come from the
reference's ``init_params`` under ``jax.eval_shape`` at smoke size, and
from the port's tree on the ``meta`` device at full size (the two trees
are held equal in ``test_torch_zoo.py``).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.core import hashing as JH
from repro.core import layout as JL
from repro.core import topk as JTK
from repro.data import federated as jfed
from repro.data import synthetic as jsyn
from repro.launch import steps as jsteps
from repro.models import sharding as JS
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.core import hashing as TH
from repro_torch.core import layout as TL
from repro_torch.core import topk as TTK
from repro_torch.data import federated as tfed
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import steps as tsteps
from repro_torch.models import sharding as TS
from repro_torch.models import transformer as tt

ARCHS = jconfigs.list_archs()


def spec_tuple(p) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in p)


def words(hi, lo) -> np.ndarray:
    return (np.asarray(hi, np.uint64) << np.uint64(32)) \
        | np.asarray(lo, np.uint64)


# -- 64-bit words -----------------------------------------------------------------

def test_mul32x32_matches_reference(rng):
    a = np.concatenate([rng.integers(0, 2**32, size=500, dtype=np.uint64),
                        np.asarray([0, 1, 2**32 - 1, 2**31, 0xFFFF0000],
                                   np.uint64)]).astype(np.uint32)
    for b in [1, 0xFFFF, 0x10000, 2**31 - 1] + \
            [int(x) for x in rng.integers(1, 2**31, size=8)]:
        jhi, jlo = JH.mul32x32(jnp.asarray(a), b)
        thi, tlo = TH.mul32x32(torch.from_numpy(a.astype(np.int64)), b)
        np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi, np.int64))
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo, np.int64))
        np.testing.assert_array_equal(words(thi.numpy(), tlo.numpy()),
                                      a.astype(np.uint64) * np.uint64(b))


@pytest.mark.parametrize("base,row0,stride,col0", [
    ((5 << 32) + 999, 7, 4096, 100),
    (2**32 - 50, 0, 1, 0),                      # the low word carries
    ((3 << 32) - 7, 2**20 + 3, 2**31 - 1, 5),  # rows * stride above 2**32
    (2**40 + 12345, 123, 4864, 4000),
])
def test_ids_for_grid_matches_reference(base, row0, stride, col0):
    n_rows, n_cols = 9, 13
    jhi, jlo = JH.ids_for_grid(jnp.uint32(base & 0xFFFFFFFF),
                               jnp.uint32(base >> 32), jnp.uint32(row0),
                               n_rows, stride, jnp.uint32(col0), n_cols)
    thi, tlo = TH.ids_for_grid(base & 0xFFFFFFFF, base >> 32, row0, n_rows,
                               stride, col0, n_cols)
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi, np.int64))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo, np.int64))
    want = [base + (row0 + r) * stride + col0 + c
            for r in range(n_rows) for c in range(n_cols)]
    np.testing.assert_array_equal(
        TH.join_words(thi, tlo).numpy(), np.asarray(want, np.int64))


# -- layouts ----------------------------------------------------------------------

def assert_layouts_equal(t: TL.ParamLayout, j: JL.ParamLayout) -> None:
    def chunk(c):
        return (c.leaf, c.path, c.row_start, c.n_rows, c.row_len, c.offset,
                c.owner, c.local_row_start, c.lrs)
    assert [chunk(c) for c in t.chunks] == [chunk(c) for c in j.chunks]
    assert [dataclasses.astuple(g) for g in t.groups] == \
        [dataclasses.astuple(g) for g in j.groups]
    assert [dataclasses.astuple(c) for c in t.local_chunks] == \
        [dataclasses.astuple(c) for c in j.local_chunks]
    assert t.leaf_shapes == j.leaf_shapes
    assert t.leaf_local_shapes == j.leaf_local_shapes
    assert t.leaf_perms == j.leaf_perms
    assert (t.total, t.ep, t.has_ep, t.num_chunks) == \
        (j.total, j.ep, j.has_ep, j.num_chunks)
    assert TL.describe(t) == JL.describe(j)


HAND = [
    # (shapes, chunk_elems, data_shard_axis, ep, view_perms)
    ({"w": (3, 4, 5)}, 1 << 24, None, 1, {"w": (0, 2, 1)}),
    ({"w_down": (2, 4, 8, 6)}, 64, {"w_down": 1}, 2, {"w_down": (0, 1, 3, 2)}),
    ({"a": (8, 64), "emb": (32, 16), "n": (48,)}, 256, None, 1, None),
    ({"moe": {"w_up": (2, 8, 6, 10), "w_down": (2, 8, 10, 6)},
      "norm": (6,), "s": ()}, 40, {"moe/w_up": 1, "moe/w_down": 1}, 4,
     {"moe/w_down": (0, 1, 3, 2)}),
    ({"x": (4, 6, 3)}, 7, {"x": 0}, 2, None),
]


def _tree(shapes, make):
    return {k: _tree(v, make) if isinstance(v, dict) else make(v)
            for k, v in shapes.items()}


@pytest.mark.parametrize("case", range(len(HAND)))
def test_build_layout_matches_reference_by_hand(case):
    shapes, ce, dsa, ep, perms = HAND[case]
    jl = JL.build_layout(_tree(shapes, lambda s: jax.ShapeDtypeStruct(
        s, jnp.float32)), chunk_elems=ce, data_shard_axis=dsa, ep=ep,
        view_perms=perms)
    tl = TL.build_layout(_tree(shapes, lambda s: torch.empty(
        s, device="meta")), chunk_elems=ce, data_shard_axis=dsa, ep=ep,
        view_perms=perms)
    assert_layouts_equal(tl, jl)


def test_build_layout_refuses_what_the_reference_refuses():
    for ax in (0, 2):        # 3 rows do not split 2 ways; the last dim
        tree = {"x": (3, 6, 4)}
        with pytest.raises(ValueError):
            JL.build_layout(_tree(tree, lambda s: jax.ShapeDtypeStruct(
                s, jnp.float32)), data_shard_axis={"x": ax}, ep=2)
        with pytest.raises(ValueError):
            TL.build_layout(_tree(tree, lambda s: torch.empty(
                s, device="meta")), data_shard_axis={"x": ax}, ep=2)


def _ref_mesh_layout(cfg, mesh):
    """The reference's make_train_step layout, on an abstract mesh."""
    structs = jax.eval_shape(functools.partial(jt.init_params, cfg),
                             jax.random.PRNGKey(0))
    shardings = JS.params_sharding(structs, cfg, mesh)
    has_ep, ds = jsteps._ep_info(cfg, shardings, mesh)
    perms, _, _, _ = JS.layout_view_plan(structs, cfg, mesh)
    return JL.build_layout(structs, data_shard_axis=ds, view_perms=perms,
                           ep=mesh.shape["data"] if has_ep else 1)


@pytest.mark.parametrize("dm", [(2, 2), (4, 1)])
def test_mesh_layouts_match_reference_for_every_smoke_arch(dm):
    mesh = AbstractMesh(dm, ("data", "model"))
    tmesh = types.SimpleNamespace(shape=dict(mesh.shape))
    n_ep = 0
    for arch in ARCHS:
        for ep in (False, True):
            jcfg = jconfigs.get_smoke(arch)
            if ep and not jcfg.n_experts:
                continue
            jcfg = dataclasses.replace(jcfg, shard_experts_data=ep)
            tcfg = dataclasses.replace(tconfigs.get_smoke(arch),
                                       shard_experts_data=ep)
            tl = tsteps.build_layout(tcfg, tmesh)
            assert_layouts_equal(tl, _ref_mesh_layout(jcfg, mesh))
            n_ep += tl.has_ep
    assert n_ep == 3       # qwen2-moe, llama4, jamba shard their experts


def _meta_structs(cfg):
    """The port's tree at full size (meta) and its jax twin."""
    tree = tt.init_params(cfg, device="meta")
    return tree, TL.tree_map(
        lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32), tree)


@pytest.mark.parametrize("sizes,axes", [
    ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
    ((2, 2), ("data", "model")),
    ((1, 2), ("data", "model")),
])
def test_sharding_rules_match_reference_for_every_arch(sizes, axes):
    mesh = AbstractMesh(sizes, axes)
    tmesh = {a: s for a, s in zip(axes, sizes)}
    n_perm = 0
    for arch in ARCHS:
        cfg_t, cfg_j = tconfigs.get_config(arch), jconfigs.get_config(arch)
        ttree, jtree = _meta_structs(cfg_t)
        for path, leaf in TL.flatten(ttree):
            shape = tuple(leaf.shape)
            assert TS.param_spec(path, shape, cfg_t, tmesh) == spec_tuple(
                JS.param_spec(path, shape, cfg_j, mesh)), (arch, path)
        tperms, tmodes, tspecs = TS.layout_view_plan(ttree, cfg_t, tmesh)
        jperms, _, jmodes, jspecs = JS.layout_view_plan(jtree, cfg_j, mesh)
        assert tperms == jperms, arch
        assert tmodes == jmodes, arch
        assert tspecs == [spec_tuple(s) for s in jspecs], arch
        n_perm += len(tperms)
        assert TS.data_shard_axes(ttree, cfg_t, tmesh) == \
            jsteps._ep_info(cfg_j, JS.params_sharding(jtree, cfg_j, mesh),
                            mesh)[1], arch
    assert n_perm > 0 or sizes[-1] == 1


@pytest.mark.parametrize("sizes,axes", [
    ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
    ((2, 2), ("data", "model")), ((4, 1), ("data", "model"))])
def test_batch_and_cache_specs_match_reference(sizes, axes):
    mesh = AbstractMesh(sizes, axes)
    tmesh = {a: s for a, s in zip(axes, sizes)}
    for shape in [(), (1,), (3, 5), (4, 32), (64, 128, 7), (512, 2)]:
        assert TS.batch_spec(shape, tmesh) == spec_tuple(
            JS.batch_spec(shape, mesh)), shape
    for arch in ARCHS:
        cfg_t, cfg_j = tconfigs.get_smoke(arch), jconfigs.get_smoke(arch)
        for B in (1, 4, 64):
            cache = tt.init_cache(cfg_t, B, 32, device="meta")
            for path, leaf in TL.flatten(cache):
                shape = tuple(leaf.shape)
                assert TS.cache_spec(path, shape, cfg_t, tmesh) == \
                    spec_tuple(JS.cache_spec(path, shape, cfg_j, mesh)), \
                    (arch, path)


# -- the sparse update under a permutation ----------------------------------------

def test_apply_then_densify_under_a_permutation(rng):
    """The port's twin of the reference's ``test_perm_layout_roundtrip``:
    the update lands on the elements the permuted ids name."""
    w = rng.normal(size=(3, 4, 5)).astype(np.float32)
    perm = {"w": (0, 2, 1)}
    jl = JL.build_layout({"w": jnp.zeros((3, 4, 5))}, view_perms=perm)
    tl = TL.build_layout({"w": torch.zeros(3, 4, 5)}, view_perms=perm)
    views = TL.leaf_views({"w": torch.from_numpy(w)}, tl)
    assert views[0].shape == (3 * 5, 4)
    delta = TTK.topk_dense(views, tl, 6)
    jdelta = JTK.topk_dense(JL.leaf_views({"w": jnp.asarray(w)}, jl), jl, 6)
    np.testing.assert_array_equal(np.sort(np.asarray(
        JTK.densify(jdelta, jl))), np.sort(TTK.densify(delta, tl).numpy()))
    applied = TTK.apply_delta({"w": torch.zeros(3, 4, 5)}, tl, delta)
    dense = TTK.densify(delta, tl).numpy()
    np.testing.assert_array_equal(
        applied["w"].permute(0, 2, 1).reshape(-1).numpy(), -dense)
    ref = JTK.apply_delta({"w": jnp.zeros((3, 4, 5))}, jl, jdelta)
    np.testing.assert_array_equal(applied["w"].numpy(), np.asarray(ref["w"]))
    back = TL.unview(TL.leaf_views({"w": torch.from_numpy(w)}, tl), tl)
    np.testing.assert_array_equal(back["w"].numpy(), w)


def test_apply_delta_owner_masked_into_local_slices(rng):
    """Expert-parallel + permuted: each data shard applies only the chunks
    it owns into its local slice, and the slices put back together equal
    the reference's update of the whole leaf."""
    shape, ep = (2, 4, 8, 6), 2
    kw = dict(chunk_elems=64, data_shard_axis={"w_down": 1}, ep=ep,
              view_perms={"w_down": (0, 1, 3, 2)})
    jl = JL.build_layout({"w_down": jnp.zeros(shape)}, **kw)
    tl = TL.build_layout({"w_down": torch.zeros(shape)}, **kw)
    n = 40
    cid = rng.integers(0, tl.num_chunks, size=n)
    lidx = np.asarray([rng.integers(0, tl.chunks[c].size) for c in cid])
    key = cid * 1000 + lidx
    _, first = np.unique(key, return_index=True)
    cid, lidx = cid[first], lidx[first]
    vals = rng.normal(size=len(cid)).astype(np.float32)
    tdelta = TTK.SparseDelta(torch.from_numpy(cid), torch.from_numpy(lidx),
                             torch.from_numpy(vals), len(cid))
    jdelta = JTK.SparseDelta(jnp.asarray(cid, jnp.int32),
                             jnp.asarray(lidx, jnp.int32), jnp.asarray(vals),
                             len(cid))
    w = rng.normal(size=shape).astype(np.float32)
    parts = []
    for s in range(ep):
        local = {"w_down": torch.from_numpy(
            w[:, s * 2:(s + 1) * 2].copy())}
        parts.append(TTK.apply_delta(local, tl, tdelta, shard_idx=s,
                                     local=True)["w_down"])
        jlocal = JTK.apply_delta({"w_down": jnp.asarray(w[:, s * 2:
                                                          (s + 1) * 2])},
                                 jl, jdelta, shard_idx=s, local=True)
        np.testing.assert_array_equal(parts[-1].numpy(),
                                      np.asarray(jlocal["w_down"]))
    whole = JL.build_layout({"w_down": jnp.zeros(shape)}, chunk_elems=64,
                            view_perms={"w_down": (0, 1, 3, 2)})
    assert [c.offset for c in whole.chunks] != [c.offset for c in jl.chunks]
    gids = np.asarray([tl.chunks[c].offset for c in cid]) + lidx
    flat = w.transpose(0, 1, 3, 2).reshape(-1).copy()
    np.subtract.at(flat, gids, vals)
    want = flat.reshape(2, 4, 6, 8).transpose(0, 1, 3, 2)
    np.testing.assert_array_equal(torch.cat(parts, 1).numpy(), want)


# -- cohort batches ----------------------------------------------------------------

@pytest.mark.parametrize("clients,pad_to", [
    ([0, 1], None), ([0, 1], 10), ([0, 1], 6), ([0, 1, 2], 4),
    ([5, 2, 9], 20), ([3], 1)])
def test_cohort_batch_matches_reference(clients, pad_to):
    kw = dict(vocab=64, seq_len=8, samples_per_client=3)
    want = jfed.cohort_batch(jsyn.ClassShardLM(**kw), clients, pad_to=pad_to)
    got = tfed.cohort_batch(tsyn.ClassShardLM(**kw), clients, pad_to=pad_to)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
