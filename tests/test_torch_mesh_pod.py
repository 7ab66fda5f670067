"""Port parity for the mesh train step on a mesh with a ``pod`` axis:
(pod 2, data 2, model 1), a ``gloo`` world of 4 ranks on 127.0.0.1.

``make_train_step`` for internlm2-1.8b smoke (a 3 x 4096 sketch, k 64,
seq 32, a global batch of 4: one row a client rank) in ``flat`` (one mean
over both client axes) and ``tree`` (over ``data``, then over ``pod``)
against the reference's ``make_train_step`` on the same mesh, weights and
batch.  The reference runs in a subprocess with 4 forced host devices on
an ``Auto``-axis mesh, as in ``test_torch_mesh_step.py``, whose
tolerances hold here: the loss to rtol 1e-4, Delta as a set of ids up to
ties at the k-th within 1e-2 and the common values to rtol 1e-2 (the
packages' bfloat16 roundings).
"""

import numpy as np
import pytest
import torch

import test_torch_mesh_step as base
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import fetchsgd as TF
from repro_torch.core import layout as TL
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import steps as tsteps

MODES = ("flat:gathered", "tree:gathered")
MESH_2x2 = '''jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))'''
MESH_POD = '''jax.make_mesh((2, 2, 1), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)'''


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pod_world(rank: int, npz_path: str) -> dict:
    init, batch = base._setup(npz_path)
    mesh = tmesh.make_mesh((2, 2, 1), ("pod", "data", "model"))
    cfg = tconfigs.get_smoke(base.ARCH)
    fs = TF.FetchSGDConfig(rows=base.ROWS, cols=base.COLS, k=base.K,
                           momentum=0.9)
    shape = tshapes.ShapeSpec("t", "train", base.SEQ, base.BATCH)
    out = {"coords": mesh.coords, "client": mesh.client_index}
    for agg in ("flat", "tree"):
        params = tsteps.local_params(params_from_numpy(TL.unflatten(
            list(init), list(init.values()))), cfg, mesh)
        b = tsteps.make_train_step(cfg, shape, mesh, fs, aggregate=agg)
        p, opt, m = b.fn(params, TF.init_state(fs), batch, base.LR)
        out[agg] = (float(m["loss"]), base.flat_np(p))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module):
    tmp = tmp_path_factory.mktemp("mesh_pod")
    inputs = base.write_inputs(tmp / "in.npz")
    assert MESH_2x2 in base.REF
    monkeypatch_module.setattr(base, "REF", base.REF.replace(MESH_2x2,
                                                             MESH_POD))
    proc = base.start_reference(tmp / "in.npz", tmp / "ref.npz", MODES)
    try:
        port = tmesh.spawn(pod_world, 4, (str(tmp / "in.npz"),),
                           timeout=600, threads=base.THREADS)
        ref = base.finish_reference(proc, tmp / "ref.npz")
    finally:
        proc.kill()
    return {**inputs, **ref}, port


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("agg", ["flat", "tree"])
def test_pod_mesh_step_matches_reference(runs, agg):
    ref, port = runs
    init = {k[5:]: v for k, v in ref.items() if k.startswith("init/")}
    want = {p: v for p, v in TL.flatten(base.tree_of(ref, agg
                                                     + ":gathered"))}
    for r in range(4):
        loss, got = port[r][agg]
        np.testing.assert_allclose(loss, float(ref[agg + ":gathered/loss"]),
                                   rtol=1e-4)
        base.assert_delta_matches(base.delta_of(got, init),
                                  base.delta_of(want, init))


def test_pod_mesh_lays_ranks_out_row_major(runs):
    _, port = runs
    assert [p["coords"] for p in port] == [
        {"pod": i // 2, "data": i % 2, "model": 0} for i in range(4)]
    assert [p["client"] for p in port] == [0, 1, 2, 3]
