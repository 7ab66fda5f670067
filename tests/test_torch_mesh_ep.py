"""Port parity for the rest of the mesh step (``launch/steps.py``): the
``async`` policy and the model-local sketch against the reference, the
async contract, expert parallelism (``moe.moe_apply_ep`` and the EP train
step) and the serve steps, in ``gloo`` worlds on 127.0.0.1.  (The
``flat``, ``tree`` and ``dense`` policies are in ``test_torch_mesh_step.py``;
the reference compiles each policy for some 12 s, so its five policies
are split over the two files.)

* ``make_train_step`` for internlm2-1.8b smoke at (data 2, model 2) in
  ``async`` (an empty buffer, ``fresh_w`` 1) and with
  ``sketch_mode='model_local'``, against the reference's on the same mesh,
  weights and batch (its subprocess runs while the port's world does), by
  ``test_torch_mesh_step.py``'s rules: the loss to rtol 1e-4, Delta as a
  set up to ties at the k-th within 1e-2 and the common values to rtol
  1e-2 (the packages' bfloat16 roundings; the measurement is in that
  file's docstring).
* The async contract, exactly: an empty buffer with ``fresh_w`` 1 is the
  ``flat`` step bit for bit, and a round of total weight 0 changes neither
  the parameters nor the server state.  The model-local step equals the
  gathered one on the same mesh up to the order of summation (rtol 1e-5).
* ``moe_apply_ep`` at (data 4, model 1) and over the data ranks of the
  (2, 2) mesh, with jamba smoke (no token drops, as in the reference's own
  test): against the
  reference's ``_moe_apply_local`` (relative error < 2e-2, the reference's
  bound) and the port's ``moe_apply`` (rtol 1e-5), and its gradients
  against ``moe_apply``'s (rtol 1e-4 of each tensor's largest).
* The EP train step (jamba smoke with ``shard_experts_data``, no-drop
  capacity, at (data 2, model 1)) against the port's single-device step on
  the mean of the two shards' gradients: the expert stacks are split over
  the ranks, routed by ``all_to_all``, sketched at their shard's offsets
  and updated only by their owner.  The loss to rtol 1e-5; Delta by the
  rule above (rtol 1e-2): a rank process runs its matmuls on fewer
  threads than the test's, another order of summation, which flips
  bfloat16 roundings as between the packages (without EP the two differ
  by up to 3.3e-3 of a leaf's largest gradient, with it 2.6e-3).
* Prefill and two decode steps of glm4-9b smoke at (data 2, model 2),
  tensor-parallel (each rank its parameter shard and its cache's kv
  heads), against single-device ``prefill`` / ``decode_step`` (rtol 1e-5
  of the largest logit: another batch size, another summation order).
"""

import dataclasses

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
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt

REF_MODES = ("async:gathered", "flat:model_local")


def _jamba_ep():
    cfg = tconfigs.get_smoke("jamba-v0.1-52b")
    return dataclasses.replace(cfg, shard_experts_data=True,
                               capacity_factor=cfg.n_experts
                               / cfg.expert_top_k)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The smoke models' ops are small: one intra-op thread does not
    oversubscribe the cores when test files run in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the worlds (one process a rank; must be importable) --------------------------

def policies(mesh, npz_path) -> dict:
    init, batch = base._setup(npz_path)
    cfg = tconfigs.get_smoke(base.ARCH)
    fs = TF.FetchSGDConfig(rows=base.ROWS, cols=base.COLS, k=base.K,
                           momentum=0.9)
    shape = tshapes.ShapeSpec("t", "train", base.SEQ, base.BATCH)
    zeros = torch.zeros(base.ROWS, base.COLS)

    def fresh():
        return tsteps.local_params(params_from_numpy(TL.unflatten(
            list(init), list(init.values()))), cfg, mesh)

    def run(**kw):
        b = tsteps.make_train_step(cfg, shape, mesh, fs, **kw)
        return b.fn(fresh(), TF.init_state(fs), batch, base.LR)

    def whole(p):          # the model shards gathered
        return base.flat_np(tsteps.gather_params(p, cfg, mesh))

    out = {}
    p, _, m = run(aggregate="flat")
    out["flat"] = (float(m["loss"]), whole(p), m["table"].numpy())
    p, _, m = run(aggregate="flat", sketch_mode="model_local")
    out["model_local"] = (float(m["loss"]), whole(p), m["table"].numpy())
    b = tsteps.make_train_step(cfg, shape, mesh, fs, aggregate="async")
    p, opt, m = b.fn(fresh(), TF.init_state(fs), batch, base.LR, 1.0, zeros,
                     0.0)
    out["async"] = (float(m["loss"]), whole(p), m["table"].numpy())
    params, state = fresh(), TF.init_state(fs)
    p, opt, m = b.fn(params, state, batch, base.LR, 0.0, zeros, 0.0)
    out["async-zero"] = (whole(p), opt is state, opt.step,
                         float(opt.error_sketch.abs().sum()),
                         m["table"].numpy())
    return out


def moe_ep(mesh, npz_path) -> dict:
    data = np.load(npz_path)
    cfg = _jamba_ep()
    p = params_from_numpy({k[4:]: data[k] for k in data.files
                           if k.startswith("moe/")})
    n = mesh.shape["data"]
    E_loc, b = cfg.n_experts // n, data["x"].shape[0] // n
    d = mesh.index("data")
    local = {k: (v[d * E_loc:(d + 1) * E_loc] if k.startswith("w_") else v)
             .clone().requires_grad_(True) for k, v in p.items()}
    x = torch.from_numpy(data["x"][d * b:(d + 1) * b]).requires_grad_(True)
    y, _ = tmoe.moe_apply_ep(local, x, cfg, mesh.group(("data",)))
    cot = torch.from_numpy(data["cot"][d * b:(d + 1) * b])
    grads = torch.autograd.grad((y * cot).sum(), [x] + list(local.values()))
    with tmoe.expert_parallel(mesh.group(("data",))):
        y2, _ = tmoe.moe_apply(local, x, cfg)
    assert torch.equal(y, y2)     # the context routes moe_apply to EP
    return {"y": y.detach().numpy(),
            "grads": dict(zip(["x"] + list(local), (g.numpy()
                                                    for g in grads)))}


def serve(mesh, npz_path) -> dict:
    data = np.load(npz_path)
    cfg = tconfigs.get_smoke("glm4-9b")
    params = tt.init_params(cfg, seed=3)
    B, S = data["prompt"].shape
    pre = tsteps.make_prefill_step(cfg, tshapes.ShapeSpec(
        "p", "prefill", S + 2, B), mesh)
    dec = tsteps.make_decode_step(cfg, tshapes.ShapeSpec(
        "d", "decode", S + 2, B), mesh)
    # the rank's param_spec shard and cache_spec slice: the serve steps
    # run tensor-parallel over the model group
    params = tsteps.local_params(params, cfg, mesh)
    cache = tt.init_cache(cfg, tsteps.local_batch_size(B, mesh), S + 2,
                          dtype=torch.float32, model=mesh.shape["model"])
    logits = [pre.fn(params, {"tokens": torch.from_numpy(
        data["prompt"]).long()}, cache)[0]]
    for t in data["next"]:
        logits.append(dec.fn(params, torch.from_numpy(t).long(), cache)[0])
    return [lg.numpy() for lg in logits]


def world_of_4(rank: int, npz_path: str, moe_path: str,
               serve_path: str) -> dict:
    mesh22 = tmesh.make_debug_mesh(2, 2)
    mesh41 = tmesh.make_debug_mesh(4, 1)
    out = {"policies": policies(mesh22, npz_path),
           "moe41": moe_ep(mesh41, moe_path),
           "moe22": moe_ep(mesh22, moe_path),
           "serve": serve(mesh22, serve_path)}
    return out if rank == 0 else {k: out[k] for k in ("moe41", "moe22")}


def ep_step(rank: int, npz_path: str) -> dict:
    data = np.load(npz_path)
    mesh = tmesh.make_debug_mesh(2, 1)
    cfg = _jamba_ep()
    fs = TF.FetchSGDConfig(rows=base.ROWS, cols=base.COLS, k=base.K,
                           momentum=0.9)
    full = tt.init_params(cfg, seed=1)
    params = tsteps.local_params(full, cfg, mesh)
    tok = torch.from_numpy(data["tokens"]).long()
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    bundle = tsteps.make_train_step(
        cfg, tshapes.ShapeSpec("t", "train", tok.shape[1], tok.shape[0]),
        mesh, fs)
    assert bundle.layout.has_ep
    p, _, m = bundle.fn(params, TF.init_state(fs), batch, base.LR)
    return {"loss": float(m["loss"]), "params": base.flat_np(p)}


# -- fixtures ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ep")
    inputs = base.write_inputs(tmp / "in.npz")
    rng = np.random.default_rng(7)
    cfg = _jamba_ep()
    import jax
    from repro import configs as jconfigs
    from repro.models import moe as jmoe
    jcfg = dataclasses.replace(jconfigs.get_smoke("jamba-v0.1-52b"),
                               shard_experts_data=True, capacity_factor=4.0)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    x = rng.normal(size=(4, 8, cfg.d_model)).astype(np.float32)
    np.savez(tmp / "moe.npz", x=x, cot=rng.normal(size=x.shape).astype(
        np.float32), **{"moe/" + k: np.asarray(v) for k, v in jp.items()})
    ref_moe, _ = jmoe._moe_apply_local(jp, x, jcfg)
    np.savez(tmp / "serve.npz", prompt=rng.integers(0, 512, (4, 6)),
             next=rng.integers(0, 512, (2, 4, 1)))
    np.savez(tmp / "ep.npz", tokens=rng.integers(0, cfg.vocab, (4, 16)))
    proc = base.start_reference(tmp / "in.npz", tmp / "ref.npz", REF_MODES)
    try:
        four = tmesh.spawn(world_of_4, 4, (str(tmp / "in.npz"),
                                           str(tmp / "moe.npz"),
                                           str(tmp / "serve.npz")),
                           threads=base.THREADS)
        two = tmesh.spawn(ep_step, 2, (str(tmp / "ep.npz"),),
                          threads=base.THREADS)
        ref = base.finish_reference(proc, tmp / "ref.npz")
    finally:
        proc.kill()
    return dict(ref={**inputs, **ref}, four=four, two=two, tmp=tmp,
                ref_moe=np.asarray(ref_moe))


@pytest.mark.parametrize("mode,ref_mode", [("async", "async:gathered"),
                                           ("model_local",
                                            "flat:model_local")])
def test_policy_matches_reference(runs, mode, ref_mode):
    ref = runs["ref"]
    init = {k[5:]: v for k, v in ref.items() if k.startswith("init/")}
    loss, got, _ = runs["four"][0]["policies"][mode]
    want = {p: v for p, v in TL.flatten(base.tree_of(ref, ref_mode))}
    np.testing.assert_allclose(loss, float(ref[ref_mode + "/loss"]),
                               rtol=1e-4)
    base.assert_delta_matches(base.delta_of(got, init),
                              base.delta_of(want, init))


def test_async_with_an_empty_buffer_is_the_flat_step(runs):
    pol = runs["four"][0]["policies"]
    for p in pol["flat"][1]:
        np.testing.assert_array_equal(pol["async"][1][p], pol["flat"][1][p])
    np.testing.assert_array_equal(pol["async"][2], pol["flat"][2])
    assert pol["async"][0] == pol["flat"][0]


def test_a_round_of_total_weight_zero_changes_nothing(runs):
    pol = runs["four"][0]["policies"]
    params, same_state, step, err, table = pol["async-zero"]
    init = {k[5:]: v for k, v in runs["ref"].items()
            if k.startswith("init/")}
    for p in init:
        np.testing.assert_array_equal(params[p], init[p])
    assert same_state and step == 0 and err == 0.0
    np.testing.assert_array_equal(table, pol["flat"][2])


def test_model_local_equals_gathered_on_the_same_mesh(runs):
    pol = runs["four"][0]["policies"]
    init = {k[5:]: v for k, v in runs["ref"].items()
            if k.startswith("init/")}
    np.testing.assert_allclose(pol["model_local"][2], pol["flat"][2],
                               rtol=1e-5, atol=1e-5 * np.abs(
                                   pol["flat"][2]).max())
    base.assert_delta_matches(base.delta_of(pol["model_local"][1], init),
                              base.delta_of(pol["flat"][1], init), rtol=1e-5)


@pytest.mark.parametrize("key,ranks", [("moe41", (0, 1, 2, 3)),
                                       ("moe22", (0, 2))])
def test_moe_apply_ep_matches_reference_and_moe_apply(runs, key, ranks):
    """Over 4 data ranks (one expert each) and over the 2 data ranks of a
    (2, 2) mesh (two experts each: the buffers' expert dim is then a real
    permutation, whose gradient arrives with permuted strides)."""
    data = np.load(runs["tmp"] / "moe.npz")
    res = [runs["four"][r][key] for r in ranks]
    y = np.concatenate([r["y"] for r in res])
    ref = runs["ref_moe"]
    err = np.abs(y - ref).max() / (np.abs(ref).max() + 1e-6)
    assert err < 2e-2, err
    cfg = _jamba_ep()
    p = {k: v.requires_grad_(True) for k, v in params_from_numpy(
        {k[4:]: data[k] for k in data.files if k.startswith("moe/")}).items()}
    x = torch.from_numpy(data["x"]).requires_grad_(True)
    want, _ = tmoe.moe_apply(p, x, cfg)
    np.testing.assert_allclose(y, want.detach().numpy(), rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    grads = torch.autograd.grad((want * torch.from_numpy(data["cot"])).sum(),
                                [x] + list(p.values()))
    want_g = dict(zip(["x"] + list(p), (g.numpy() for g in grads)))
    E_loc = cfg.n_experts // len(ranks)
    for name, w in want_g.items():
        parts = [r["grads"][name] for r in res]
        if name == "x":
            got = np.concatenate(parts)
        elif name.startswith("w_"):
            got = np.concatenate(parts)
            assert parts[0].shape[0] == E_loc
        else:                       # the router (and shared experts) sum
            got = np.sum(parts, axis=0)
        np.testing.assert_allclose(got, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_ep_train_step_matches_the_single_device_step(runs):
    two = runs["two"]
    cfg = _jamba_ep()
    tok = torch.from_numpy(np.load(runs["tmp"] / "ep.npz")["tokens"]).long()
    labels = torch.roll(tok, -1, 1)
    params = tt.init_params(cfg, seed=1)
    init = base.flat_np(params)
    losses, grads = [], []
    for i in range(2):
        loss, g = tt.value_and_grad(params, {"tokens": tok[2 * i:2 * i + 2],
                                             "labels": labels[2 * i:2 * i + 2]},
                                    cfg)
        losses.append(float(loss))
        grads.append(g)
    np.testing.assert_allclose(two[0]["loss"], np.mean(losses), rtol=1e-5)
    gmean = TL.tree_map(lambda a, b: (a + b) / 2, *grads)
    fs = TF.FetchSGDConfig(rows=base.ROWS, cols=base.COLS, k=base.K,
                           momentum=0.9)
    want, _, _ = TF.step(params, gmean, TF.init_state(fs), base.LR,
                         TL.build_layout(params), fs)
    mesh = types_mesh(2, 1)
    got = tsteps.assemble_params(
        [TL.unflatten(list(r["params"]), [torch.from_numpy(v) for v in
                                          r["params"].values()])
         for r in two], cfg, mesh)
    base.assert_delta_matches(base.delta_of(base.flat_np(got), init),
                              base.delta_of(base.flat_np(want), init))
    _, ds_axes = tsteps.ep_info(cfg, mesh)
    assert ds_axes and all(two[0]["params"][p].shape[ax] * 2
                           == init[p].shape[ax] for p, ax in ds_axes.items())


def types_mesh(data: int, model: int):
    import types
    return types.SimpleNamespace(shape={"data": data, "model": model})


def test_prefill_and_decode_match_the_single_device_serve(runs):
    data = np.load(runs["tmp"] / "serve.npz")
    got = runs["four"][0]["serve"]
    cfg = tconfigs.get_smoke("glm4-9b")
    params = tt.init_params(cfg, seed=3)
    B, S = data["prompt"].shape
    cache = tt.init_cache(cfg, B, S + 2, dtype=torch.float32)
    want = [tt.prefill(params, {"tokens": torch.from_numpy(
        data["prompt"]).long()}, cfg, cache)[0]]
    for t in data["next"]:
        want.append(tt.decode_step(params, torch.from_numpy(t).long(), cfg,
                                   cache)[0])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == (B, cfg.vocab)
        w = w.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
