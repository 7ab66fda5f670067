"""Port parity for the model-local sketch (``core/model_local.py``): the
plan (``build_plan``) field by field against the reference's, for trees
made by hand and for the zoo's smoke configs under the plans of (1, 2),
(2, 2) and (1, 4) meshes; and each (data, model) shard's partial sketch
(``sketch_grads``) against the reference's at tp 2 and 4, in the
expert-parallel + permuted case, and for a zoo arch (qwen2-moe smoke on
a (2, 2) mesh: permuted views, strided column chunks, experts over data),
with the sum over the model shards equal to the sketch of the whole
(data-local) gradient.

Tolerances.  Integer-valued gradients make every table entry a sum of
small integers, exact in float32 in any order: those tables are held
exactly.  With normal gradients the port and the reference add the same
terms in another order, so tables are held to rtol 1e-5 with an absolute
floor of 1e-5 of the table's largest entry (a cell whose terms cancel).
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
from repro.core import fetchsgd as JF
from repro.core import layout as JL
from repro.core import model_local as JML
from repro.launch import steps as jsteps
from repro.models import sharding as JS
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.core import fetchsgd as TF
from repro_torch.core import layout as TL
from repro_torch.core import model_local as TML
from repro_torch.launch import steps as tsteps
from repro_torch.models import sharding as TS


def assert_plans_equal(t, j):
    assert [dataclasses.astuple(c) for c in t.chunks] == \
        [dataclasses.astuple(c) for c in j.chunks]
    assert t.view_dims == j.view_dims and t.tp == j.tp


def assert_tables_close(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def leaf_modes(shapes, modes):
    return [modes[p] for p, _ in TL.flatten(shapes)]


def draw(rng, shape, exact):
    if exact:
        return rng.integers(-8, 9, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The smoke models' ops are small: one intra-op thread does not
    oversubscribe the cores when test files run in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- hand-made trees (the reference's own cases) ----------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("exact", [True, False])
def test_model_local_sketch_matches_reference(rng, tp, exact):
    shapes = {"a": (8, 64), "emb": (32, 16), "n": (48,)}
    modes = leaf_modes(shapes, {"a": "cols", "emb": "rows", "n": None})
    jl = JL.build_layout({k: jnp.zeros(s) for k, s in shapes.items()},
                         chunk_elems=256)
    tl = TL.build_layout({k: torch.zeros(s) for k, s in shapes.items()},
                         chunk_elems=256)
    jplan = JML.build_plan(jl, modes, tp=tp, chunk_elems=256)
    tplan = TML.build_plan(tl, modes, tp=tp, chunk_elems=256)
    assert_plans_equal(tplan, jplan)
    cfg = JF.FetchSGDConfig(rows=3, cols=2048, k=8)
    tcfg = TF.FetchSGDConfig(rows=3, cols=2048, k=8)
    g = {k: draw(rng, s, exact) for k, s in shapes.items()}
    total = torch.zeros(3, 2048)
    for s_m in range(tp):
        loc = {"a": g["a"][:, s_m * (64 // tp):(s_m + 1) * (64 // tp)],
               "emb": g["emb"][s_m * (32 // tp):(s_m + 1) * (32 // tp)],
               "n": g["n"]}
        want = JML.sketch_grads({k: jnp.asarray(v) for k, v in loc.items()},
                                jl, jplan, cfg, None, jnp.asarray(s_m))
        got = TML.sketch_grads({k: torch.from_numpy(np.ascontiguousarray(v))
                                for k, v in loc.items()}, tl, tplan, tcfg,
                               None, s_m)
        assert_tables_close(got, want, exact)
        sliced = TML.model_slice({k: torch.from_numpy(v) for k, v in
                                  g.items()}, tl, tplan, s_m)
        assert_tables_close(TML.sketch_grads(sliced, tl, tplan, tcfg, None,
                                             s_m), got, True)
        total += got
    whole = TF.sketch_grads({k: torch.from_numpy(v) for k, v in g.items()},
                            tl, tcfg)
    assert_tables_close(total, whole, exact)


@pytest.mark.parametrize("exact", [True, False])
def test_model_local_with_ep_and_perm_matches_reference(rng, exact):
    """EP on the expert dim (data), model on ffe (a mid dim: permuted)."""
    shape, perm, ep, tp = (2, 4, 8, 6), {"w_down": (0, 1, 3, 2)}, 2, 2
    kw = dict(chunk_elems=64, data_shard_axis={"w_down": 1}, ep=ep,
              view_perms=perm)
    jl = JL.build_layout({"w_down": jnp.zeros(shape)}, **kw)
    tl = TL.build_layout({"w_down": torch.zeros(shape)}, **kw)
    jplan = JML.build_plan(jl, ["cols"], tp=tp, chunk_elems=64)
    tplan = TML.build_plan(tl, ["cols"], tp=tp, chunk_elems=64)
    assert_plans_equal(tplan, jplan)
    cfg = JF.FetchSGDConfig(rows=3, cols=1024, k=4)
    tcfg = TF.FetchSGDConfig(rows=3, cols=1024, k=4)
    g = draw(rng, shape, exact)
    total = torch.zeros(3, 1024)
    for s_d in range(ep):
        for s_m in range(tp):
            loc = g[:, s_d * 2:(s_d + 1) * 2, s_m * 4:(s_m + 1) * 4, :]
            want = JML.sketch_grads({"w_down": jnp.asarray(loc)}, jl, jplan,
                                    cfg, jnp.asarray(s_d), jnp.asarray(s_m))
            got = TML.sketch_grads(
                {"w_down": torch.from_numpy(np.ascontiguousarray(loc))}, tl,
                tplan, tcfg, s_d, s_m)
            assert_tables_close(got, want, exact)
            total += got
    whole_l = TL.build_layout({"w_down": torch.zeros(shape)},
                              chunk_elems=64, view_perms=perm)
    whole = TF.sketch_grads({"w_down": torch.from_numpy(g)}, whole_l, tcfg)
    assert_tables_close(total, whole, exact)


# -- the zoo ----------------------------------------------------------------------

def _ref_plan(cfg, mesh):
    structs = jax.eval_shape(functools.partial(jt.init_params, cfg),
                             jax.random.PRNGKey(0))
    has_ep, ds = jsteps._ep_info(cfg, JS.params_sharding(structs, cfg, mesh),
                                 mesh)
    perms, _, modes, _ = JS.layout_view_plan(structs, cfg, mesh)
    lay = JL.build_layout(structs, data_shard_axis=ds, view_perms=perms,
                          ep=mesh.shape["data"] if has_ep else 1)
    return lay, JML.build_plan(lay, modes, tp=mesh.shape["model"])


def _port_plan(cfg, shape):
    lay = tsteps.build_layout(cfg, types.SimpleNamespace(shape=shape))
    _, modes, _ = TS.layout_view_plan(tsteps.param_structs(cfg), cfg, shape)
    return lay, TML.build_plan(lay, modes, tp=shape["model"])


@pytest.mark.parametrize("dm", [(1, 2), (2, 2), (1, 4)])
def test_plans_match_reference_for_every_smoke_arch(dm):
    mesh = AbstractMesh(dm, ("data", "model"))
    n_cols = 0
    for arch in jconfigs.list_archs():
        ep = bool(jconfigs.get_smoke(arch).n_experts)
        jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                                   shard_experts_data=ep)
        tcfg = dataclasses.replace(tconfigs.get_smoke(arch),
                                   shard_experts_data=ep)
        _, jplan = _ref_plan(jcfg, mesh)
        _, tplan = _port_plan(tcfg, dict(mesh.shape))
        assert_plans_equal(tplan, jplan)
        n_cols += sum(c.mode == "cols" and c.n_cols < c.row_stride
                      for c in tplan.chunks)
    assert n_cols > 0


def _shard(x: np.ndarray, spec: tuple, sizes: dict, idx: dict) -> np.ndarray:
    """The (data, model) shard's slice of a full leaf under its spec."""
    for dim, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        for ax in ("data", "model"):
            if ax in names:
                n = x.shape[dim] // sizes[ax]
                x = np.take(x, range(idx[ax] * n, (idx[ax] + 1) * n),
                            axis=dim)
    return np.ascontiguousarray(x)


@pytest.mark.parametrize("arch,dm", [("qwen2-moe-a2.7b", (2, 2))])
def test_zoo_shard_sketches_match_reference(rng, arch, dm):
    """Every (data, model) shard's partial sketch of a smoke arch's
    integer-valued gradient equals the reference's, and the sum over a
    data shard's model shards equals the sketch of that shard's whole
    (data-local) gradient, what the gathered step sketches (qwen2-moe
    with its experts over data)."""
    mesh = AbstractMesh(dm, ("data", "model"))
    shape = dict(mesh.shape)
    ep = arch == "qwen2-moe-a2.7b"
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch),
                               shard_experts_data=ep)
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                               shard_experts_data=ep)
    jl, jplan = _ref_plan(jcfg, mesh)
    tl, tplan = _port_plan(tcfg, shape)
    assert tl.has_ep == ep and any(q for q in tl.leaf_perms)
    fs_j = JF.FetchSGDConfig(rows=3, cols=4096, k=64)
    fs_t = TF.FetchSGDConfig(rows=3, cols=4096, k=64)
    g = {p: draw(rng, tuple(x.shape), True)
         for p, x in TL.flatten(tsteps.param_structs(tcfg))}
    paths = list(g)
    for s_d in range(dm[0]):
        total = torch.zeros(3, 4096)
        for s_m in range(dm[1]):
            idx = {"data": s_d, "model": s_m}
            loc = [_shard(v, TS.param_spec(p, v.shape, tcfg, shape),
                          shape, idx) for p, v in g.items()]
            want = JML.sketch_grads(
                TL.unflatten(paths, [jnp.asarray(v) for v in loc]),
                jl, jplan, fs_j, jnp.asarray(s_d), jnp.asarray(s_m))
            got = TML.sketch_grads(
                TL.unflatten(paths, [torch.from_numpy(v) for v in loc]),
                tl, tplan, fs_t, s_d, s_m)
            assert_tables_close(got, want, True)
            total += got
        local = [_shard(v, TS.param_spec(p, v.shape, tcfg, {"data": dm[0]}),
                        shape, {"data": s_d}) for p, v in g.items()]
        gathered = TF.sketch_grads(
            TL.unflatten(paths, [torch.from_numpy(v) for v in local]), tl,
            fs_t, shard_idx=s_d, local=True)
        assert_tables_close(total, gathered, True)
