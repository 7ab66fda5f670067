"""Port parity for the mesh step's tensor parallelism over ``model``
(``models/tp.py`` and the model-parallel forms of ``models/layers.py``,
``attention.py``, ``moe.py``, ``ssm.py``, ``xlstm.py`` and
``transformer.py``), in ``gloo`` worlds on 127.0.0.1.

* The rank's loss and gradient from the step's ``grad_fn`` (its
  parameters cut by ``local_params``, the forward and backward
  tensor-parallel with ``remat``), the shards joined by
  ``assemble_params``, against the single-device ``value_and_grad``:
  at 1 x 2 for qwen3 (qk-norm, kv heads split), internlm2, gpt2s with
  tied embeddings (the unembedding is the table's shard, transposed),
  qwen2-moe (experts' width and the shared expert split), jamba (the
  Megatron mamba over ``d_inner``: ``in_proj``'s output regrouped to the
  rank's channels, ``x_proj`` and ``out_proj`` row-parallel; MoE; and
  with ``ssm_remat``, whose checkpointed scan chunks sum ``x_proj``'s
  partials in each chunk) and
  xlstm (the Megatron mLSTM over its heads, the sLSTM replicated); at
  1 x 4 for glm4 (kv 2: K/V split over head_dim, gathered at use), qwen3
  with ``n_kv_heads=2`` (K/V kept whole under qk-norm, their gradients
  summed over the group), jamba, xlstm, and xlstm with ``n_heads=2``
  (the mLSTM split over ``dh``: partial scores, reads and normalizers
  summed over the group); at 2 x 2 for qwen2-moe with its experts split
  over ``data`` too (EP).
  The comparison runs with a float32 residual
  (``transformer.RESIDUAL_DTYPE``) to rtol 1e-5 (atol 1e-5 of a leaf's
  largest gradient, for the elements that cancel): the two differ only by
  the order of summation.
  With the train path's bfloat16 residual a float32 difference in the
  last bit flips a bfloat16 rounding now and then (2**-8 relative), so
  there the loss is held to rtol 5e-5 and each leaf to 1e-2 of its
  largest gradient, ``test_torch_zoo.py``'s rule.  The xlstm cases are
  held to their own floor: moving every float32 weight of the smoke
  model by one step moves a leaf's gradient by up to 7.4e-5 of its
  largest (1.2e-4 with ``n_heads=2``; qwen3 2.3e-6, jamba 1.9e-5) with
  the float32 residual and 4.5e-2 with bfloat16, so there a leaf is held
  to 2e-4 of its largest (float32) and to ``test_torch_xlstm.py``'s
  5e-2 (bfloat16).
* Each rank's recorded collectives of every case equal
  ``analysis.model_collective_calls``, with either residual.
* A full step at 1 x 2, gathered and model_local, against the
  replicated step (the single-device gradient through ``F.step`` in the
  mesh's layout), float32 residual: each table cell within 1e-6 of the
  largest or rtol 1e-5 (a cell sums some 150 gradient entries, each
  within about 1.5e-6 of its leaf's largest), Delta as a set of ids, the
  parameters after the round (the shards gathered) within 1e-6.
* ``local_params`` / ``assemble_params`` invert each other at (2, 2)
  with EP, ``init_params(shard=)`` draws each rank's ``local_params``,
  and a rank holds exactly the ``param_spec`` shard sum of the
  full configs at 16 x 16 (llama4 3.82 GiB, jamba 1.09, pixtral 2.86,
  qwen3 0.38), which the dry-run reports.

The step at (data 2, model 2) against the reference's on an ``Auto``-axis
mesh is ``test_torch_mesh_step.py`` (flat, tree, dense) and
``test_torch_mesh_ep.py`` (async, model_local): since the port's step is
tensor-parallel, those hold it to the reference's GSPMD partitioning.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import fetchsgd as TF
from repro_torch.core import layout as TL
from repro_torch.launch import analysis as tanalysis
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import steps as tsteps
from repro_torch.models import sharding as tsharding
from repro_torch.models import transformer as tt

SEQ, ROWS, COLS, K, LR = 32, 3, 4096, 64, 0.1
CASES_2 = ("qwen3-0.6b", "internlm2-1.8b", "gpt2s-tied", "qwen2-moe-a2.7b",
           "jamba-v0.1-52b", "jamba-ssm-remat", "xlstm-350m")
CASES_4 = ("glm4-9b", "qwen3-kv2", "qwen2-moe-ep", "jamba-1x4", "xlstm-1x4",
           "xlstm-h2")
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5      # float32 residual: of a leaf's max
# the xlstm cases' floor, of a leaf's max (module docstring)
XLSTM_ATOL = {"f32": 2e-4, "bf16": 5e-2}


def cfg_of(name: str):
    if name == "gpt2s-tied":
        return dataclasses.replace(tconfigs.get_smoke("gpt2s-federated"),
                                   tie_embeddings=True)
    if name == "qwen3-kv2":
        return dataclasses.replace(tconfigs.get_smoke("qwen3-0.6b"),
                                   n_kv_heads=2)
    if name.endswith("-1x4"):          # a 1 x 2 case on four ranks
        return cfg_of({"jamba-1x4": "jamba-v0.1-52b",
                       "xlstm-1x4": "xlstm-350m"}[name])
    if name == "jamba-ssm-remat":      # x_proj's sum in each scan chunk
        return dataclasses.replace(tconfigs.get_smoke("jamba-v0.1-52b"),
                                   ssm_remat=True)
    if name == "xlstm-h2":
        return dataclasses.replace(tconfigs.get_smoke("xlstm-350m"),
                                   n_heads=2, n_kv_heads=2)
    if name == "qwen2-moe-ep":
        return dataclasses.replace(tconfigs.get_smoke("qwen2-moe-a2.7b"),
                                   shard_experts_data=True)
    return tconfigs.get_smoke(name)


def mesh_of(name: str, world: int) -> tuple[int, int]:
    return (1, 2) if world == 2 else (2, 2) if name.endswith("-ep") \
        else (1, 4)


def batch_of(cfg, n: int) -> dict:
    rng = np.random.default_rng(7)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (n, SEQ)))
    return {"tokens": tok, "labels": tok.roll(-1, 1)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the worlds (one process a rank; must be importable) --------------------------

def _grads(name: str, world: int, residual) -> tuple:
    """(loss, gradients, the recorded collectives, the formula's)."""
    cfg = cfg_of(name)
    data, model = mesh_of(name, world)
    mesh = tmesh.make_debug_mesh(data, model)
    fs = TF.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, momentum=0.9)
    shape = tshapes.ShapeSpec("t", "train", SEQ, 2 * data)
    bundle = tsteps.make_train_step(cfg, shape, mesh, fs)
    local = tsteps.local_params(tt.init_params(cfg, seed=1), cfg, mesh)
    tt.RESIDUAL_DTYPE = residual
    try:
        with tanalysis.CollectiveRecorder() as rec:
            loss, g = bundle.grad_fn(local, tsteps.local_batch(
                batch_of(cfg, 2 * data), mesh))
        want = tanalysis._coll_dict(tanalysis.model_collective_calls(
            cfg, shape, mesh.shape))
    finally:
        tt.RESIDUAL_DTYPE = torch.bfloat16
    return (float(loss), {p: v.numpy() for p, v in TL.flatten(g)},
            rec.bytes(), want)


def _full_step(mode: str) -> dict:
    cfg = cfg_of("qwen3-0.6b")
    mesh = tmesh.make_debug_mesh(1, 2)
    fs = TF.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, momentum=0.9)
    bundle = tsteps.make_train_step(cfg, tshapes.ShapeSpec(
        "t", "train", SEQ, 2), mesh, fs, sketch_mode=mode)
    params = tsteps.local_params(tt.init_params(cfg, seed=1), cfg, mesh)
    tt.RESIDUAL_DTYPE = torch.float32
    try:
        params, _, m = bundle.fn(params, TF.init_state(fs),
                                 batch_of(cfg, 2), LR)
    finally:
        tt.RESIDUAL_DTYPE = torch.bfloat16
    return {"table": m["table"].numpy(), "loss": float(m["loss"]),
            "params": {p: v.numpy() for p, v in TL.flatten(
                tsteps.gather_params(params, cfg, mesh))}}


def world(rank: int, size: int) -> dict:
    out = {}
    for name in (CASES_2 if size == 2 else CASES_4):
        for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            out[name, label] = _grads(name, size, dt)
    if size == 2:
        out["step"] = {mode: _full_step(mode)
                       for mode in ("gathered", "model_local")}
    return out


@pytest.fixture(scope="module")
def worlds():
    return {n: tmesh.spawn(world, n, (n,), timeout=600, threads=1)
            for n in (2, 4)}


# -- the single-device side ---------------------------------------------------------

def single(name: str, data_shard: int, n_data: int, residual):
    cfg = cfg_of(name)
    b = batch_of(cfg, 2 * n_data)
    b = {k: v[2 * data_shard:2 * data_shard + 2] for k, v in b.items()}
    tt.RESIDUAL_DTYPE = residual
    try:
        return tt.value_and_grad(tt.init_params(cfg, seed=1), b, cfg)
    finally:
        tt.RESIDUAL_DTYPE = torch.bfloat16


def assembled(parts: list[dict], cfg, mesh: dict) -> dict:
    trees = [TL.unflatten(list(p), [torch.from_numpy(v) for v in p.values()])
             for p in parts]
    return {p: v.numpy() for p, v in TL.flatten(
        tsteps.assemble_params(trees, cfg, mesh))}


@pytest.mark.parametrize("label", ["f32", "bf16"])
@pytest.mark.parametrize("name", CASES_2 + CASES_4)
def test_tensor_parallel_loss_and_grads_match_the_single_device(
        worlds, name, label):
    size = 2 if name in CASES_2 else 4
    res = worlds[size]
    cfg = cfg_of(name)
    data, model = mesh_of(name, size)
    residual = torch.float32 if label == "f32" else torch.bfloat16
    loss_rtol = 1e-5 if label == "f32" else 5e-5
    xlstm = cfg.arch_type == "ssm"
    _, ds_axes = tsteps.ep_info(cfg, {"data": data, "model": model})
    singles = [single(name, d, data, residual) for d in range(data)]
    got = assembled([r[name, label][1] for r in res], cfg,
                    {"data": data, "model": model})
    for d in range(data):
        np.testing.assert_allclose(res[d * model][name, label][0],
                                   float(singles[d][0]), rtol=loss_rtol)
    # EP leaves: the owner's gradient sums every data rank's tokens
    want = {}
    for p, w in TL.flatten(singles[0][1]):
        w = w.numpy()
        if p in ds_axes:
            w = sum(dict(TL.flatten(s[1]))[p].numpy() for s in singles)
        want[p] = w
    for d in range(data):
        part = assembled([r[name, label][1] for r in
                          res[d * model:(d + 1) * model]], cfg,
                         {"data": 1, "model": model})
        for p, w in TL.flatten(singles[d][1]):
            if p not in ds_axes:
                _check(part[p], w.numpy(), label, p, xlstm)
    for p in ds_axes:
        _check(got[p], want[p], label, p, xlstm)
    assert got.keys() == want.keys()


@pytest.mark.parametrize("name", CASES_2 + CASES_4)
def test_recorded_collectives_equal_model_collective_calls(worlds, name):
    """Each rank's forward and backward moves what the formula says, with
    either residual (the Megatron mamba and mLSTM forms included)."""
    for r in worlds[2 if name in CASES_2 else 4]:
        for label in ("f32", "bf16"):
            _, _, got, want = r[name, label]
            assert got == want, (label, got, want)


def _check(got, want, label, path, xlstm: bool = False):
    if label == "f32":
        atol = XLSTM_ATOL[label] if xlstm else GRAD_ATOL
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=atol * np.abs(want).max(),
                                   err_msg=path)
    else:
        atol = XLSTM_ATOL[label] if xlstm else 1e-2
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=atol * np.abs(want).max(),
                                   err_msg=path)


def test_each_rank_holds_its_shards_and_the_sketch_sees_the_whole(worlds):
    """qwen3 at 1 x 2: every tensor-parallel leaf's gradient is half the
    leaf, the rest whole."""
    cfg = cfg_of("qwen3-0.6b")
    full = dict(TL.flatten(tt.init_params(cfg, device="meta")))
    axes = tsharding.model_shard_axes(tt.init_params(cfg, device="meta"),
                                      cfg, {"data": 1, "model": 2})
    assert {"embed/table", "units/m0/attn/wq", "units/m0/attn/wo",
            "units/m0/mlp/w_down", "unembed/w"} <= set(axes)
    for p, g in worlds[2][0]["qwen3-0.6b", "f32"][1].items():
        want = list(full[p].shape)
        if p in axes:
            want[axes[p]] //= 2
        assert list(g.shape) == want, p


@pytest.mark.parametrize("mode", ["gathered", "model_local"])
def test_full_step_matches_the_replicated_step(worlds, mode):
    cfg = cfg_of("qwen3-0.6b")
    r0, r1 = (w["step"][mode] for w in worlds[2])
    fs = TF.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, momentum=0.9)
    lay = tsteps.build_layout(cfg, {"data": 1, "model": 2})
    assert any(lay.leaf_perms)
    loss, grads = single("qwen3-0.6b", 0, 1, torch.float32)
    params = tt.init_params(cfg, seed=1)
    init = {p: v.numpy().copy() for p, v in TL.flatten(params)}
    table = TF.sketch_grads(grads, lay, fs).numpy()
    want, _, _ = TF.step(params, grads, TF.init_state(fs), LR, lay, fs)
    want = {p: v.numpy() for p, v in TL.flatten(want)}
    for r in (r0, r1):
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(r["table"], table, rtol=1e-5,
                                   atol=1e-6 * np.abs(table).max())
        delta = {p: np.flatnonzero(r["params"][p] != init[p]) for p in init}
        wdelta = {p: np.flatnonzero(want[p] != init[p]) for p in init}
        assert sum(len(v) for v in wdelta.values()) == K
        for p in init:
            assert set(delta[p]) == set(wdelta[p]), p
            np.testing.assert_allclose(r["params"][p], want[p], rtol=0,
                                       atol=1e-6, err_msg=p)
    for p in init:
        np.testing.assert_array_equal(r0["params"][p], r1["params"][p])


def test_local_params_and_assemble_params_invert_each_other():
    cfg = cfg_of("qwen2-moe-ep")
    mesh = {"data": 2, "model": 2}
    full = tt.init_params(cfg, seed=4)
    parts = [tsteps.local_params(full, cfg, mesh, data_index=d,
                                 model_index=m)
             for d in range(2) for m in range(2)]
    ds_axes, ms_axes = tsteps._shard_axes(cfg, mesh)
    assert set(ds_axes) & set(ms_axes)            # experts: both axes
    back = tsteps.assemble_params(parts, cfg, mesh)
    for (p, a), (_, b) in zip(TL.flatten(full), TL.flatten(back)):
        assert torch.equal(a, b), p


@pytest.mark.parametrize("name", ["qwen2-moe-ep", "jamba-v0.1-52b",
                                  "whisper-small", "xlstm-350m"])
def test_init_params_with_a_shard_draws_the_rank_s_local_params(name):
    """``init_params(shard=param_shard(...))`` draws the same numbers as
    ``local_params`` of the whole tree, rank by rank, at (2, 2)."""
    cfg = cfg_of(name)
    mesh = {"data": 2, "model": 2}
    full = tt.init_params(cfg, seed=3)
    for d in range(2):
        for m in range(2):
            want = TL.flatten(tsteps.local_params(full, cfg, mesh, d, m))
            got = TL.flatten(tt.init_params(cfg, seed=3, shard=tsteps.
                                            param_shard(cfg, mesh, d, m)))
            assert [p for p, _ in got] == [p for p, _ in want]
            for (p, g), (_, w) in zip(got, want):
                assert torch.equal(g, w), (d, m, p)


# the per-rank parameters of the full configs at 16 x 16 by param_spec, in
# GiB to two places (ROADMAP.md's hand sums)
SPEC_GIB = {"llama4-maverick-400b-a17b": 3.82, "jamba-v0.1-52b": 1.09,
            "pixtral-12b": 2.86, "qwen3-0.6b": 0.38}


def _spec_bytes(cfg, mesh: dict) -> int:
    """Each leaf's bytes over the mesh axes its ``param_spec`` names."""
    total = 0
    for path, t in TL.flatten(tt.init_params(cfg, device="meta")):
        n = t.numel() * t.element_size()
        for entry in tsharding.param_spec(path, tuple(t.shape), cfg, mesh):
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    n //= mesh[ax]
        total += n
    return total


@pytest.mark.parametrize("arch", list(SPEC_GIB))
def test_a_rank_holds_the_param_spec_shard_sum_at_16x16(arch):
    cfg = tconfigs.get_config(arch)
    mesh = {"data": 16, "model": 16}
    local = tsteps.local_params(tsteps.param_structs(cfg), cfg, mesh,
                                data_index=0, model_index=0)
    got = sum(t.numel() * t.element_size() for _, t in TL.flatten(local))
    assert got == _spec_bytes(cfg, mesh)
    assert round(got / 2 ** 30, 2) == SPEC_GIB[arch]


def test_the_dry_run_reports_the_shard_sum():
    cfg = tshapes.adapt_config(tconfigs.get_config("qwen3-0.6b"),
                               tshapes.SHAPES["train_4k"])
    roof, _, _ = tdryrun.run_one("qwen3-0.6b", "train_4k", verbose=False)
    assert roof.mem_detail["params"] == _spec_bytes(
        cfg, {"data": 16, "model": 16})
    assert roof.mem_detail["grads"] == roof.mem_detail["params"]
    assert roof.n_devices == 256
    assert roof.peak_mem_bytes < 80 * 2 ** 30
