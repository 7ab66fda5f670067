"""Port parity for tensor-parallel serving on the mesh: the prefill and
decode steps (``launch.steps.make_prefill_step`` / ``make_decode_step``)
run over the model group with each rank holding its ``param_spec`` shard
of the parameters and its ``cache_spec`` slice of the cache, in ``gloo``
worlds on 127.0.0.1 (one process a rank, one intra-op thread).

* A prompt of 8 and 6 greedy-free (teacher-forced) decode steps against
  the world-of-1 ``prefill`` / ``decode_step`` on the same weights, with
  float32 parameters and a float32 cache (the serve path's residual is
  the parameters' dtype): the logits within rtol 1e-5 (atol 1e-5 of the
  largest, for the logits that cancel), and each rank's cache after the
  last step equal to the world-of-1 cache's ``local_cache`` slice within
  the same tolerance (the two differ only by the order of summation;
  positions exactly).  xlstm's atol is 5e-5 of the largest: its smoke
  model moves its logits by up to 2.2e-5 of the largest when every
  float32 weight moves by one step (qwen3 2.0e-6, jamba 5.5e-6), so no
  other order of summation holds it to 1e-5.  The cases cover each split ``cache_spec`` makes:
  at 1 x 2 qwen3 (kv heads split, qk-norm), jamba (mamba's ``d_inner``,
  attention's kv heads, MoE), xlstm (the mLSTM over heads, the sLSTM's
  state over its last dim) and whisper (``xattn`` and the encoder); at
  1 x 4 glm4 (kv 2: K/V over head_dim, partial scores summed), xlstm
  (H 4: heads) and xlstm with ``n_heads=2`` (the mLSTM over ``dh``); at
  2 x 2 qwen2-moe with its experts over ``data`` (EP) and no-drop
  capacity (each data rank routes only its rows).
* ``assemble_cache(local_cache(c)) == c`` exactly for each case.
* For every arch at 16 x 16 on ``meta``, the rank's decode cache from
  ``steps.cache_structs`` holds exactly the ``cache_spec`` shard sum, its
  parameters (``local_params``, which the serve steps take) exactly the
  ``param_spec`` shard sum, and the dry-run's decode_32k peak fits an 80
  GiB rank.
* The port's 1 x 2 serve step against the reference's
  ``make_prefill_step`` / ``make_decode_step`` on an ``Auto``-axis
  (data 1, model 2) mesh in a subprocess with 2 host devices, qwen3 on
  the same weights (``test_torch_serve.logit_tol``'s float32 rule: rtol
  1e-4 and 1e-4 of the largest logit).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import layout as TL
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models import sharding as tsharding
from repro_torch.models import transformer as tt

ROOT = Path(__file__).resolve().parent.parent
B, PROMPT, STEPS = 2, 8, 6
CASES_2 = ("qwen3-0.6b", "jamba-v0.1-52b", "xlstm-350m", "whisper-small")
CASES_4 = ("glm4-9b", "xlstm-350m", "xlstm-h2", "qwen2-moe-ep")
RTOL = 1e-5
# of the largest value; xlstm's float32 floor (module docstring)
ATOL = {"xlstm-350m": 5e-5, "xlstm-h2": 5e-5}


def cfg_of(name: str):
    if name == "xlstm-h2":
        cfg = dataclasses.replace(tconfigs.get_smoke("xlstm-350m"),
                                  n_heads=2, n_kv_heads=2)
    elif name == "qwen2-moe-ep":
        cfg = tmoe.no_drop(dataclasses.replace(
            tconfigs.get_smoke("qwen2-moe-a2.7b"), shard_experts_data=True))
    else:
        cfg = tconfigs.get_smoke(name)
    return dataclasses.replace(cfg, param_dtype="float32")


def mesh_of(name: str, world: int) -> tuple[int, int]:
    return (1, 2) if world == 2 else (2, 2) if name.endswith("-ep") \
        else (1, 4)


def inputs(cfg) -> dict:
    rng = np.random.default_rng(11)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, PROMPT + STEPS))}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def batch_of(cfg, data: dict) -> dict:
    b = {"tokens": torch.from_numpy(data["tokens"][:, :PROMPT])}
    if "frames" in data:
        b["frames"] = torch.from_numpy(data["frames"])
    return b


def nps(tree) -> dict:
    return {p: v.numpy().copy() for p, v in TL.flatten(tree)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the worlds (one process a rank; must be importable) --------------------------

def _serve(name: str, world: int) -> dict:
    cfg = cfg_of(name)
    data, model = mesh_of(name, world)
    mesh = tmesh.make_debug_mesh(data, model)
    seq = PROMPT + STEPS
    pre = tsteps.make_prefill_step(cfg, tshapes.ShapeSpec(
        "p", "prefill", seq, B), mesh)
    dec = tsteps.make_decode_step(cfg, tshapes.ShapeSpec(
        "d", "decode", seq, B), mesh)
    params = tsteps.local_params(tt.init_params(cfg, seed=2), cfg, mesh)
    cache = tt.init_cache(cfg, tsteps.local_batch_size(B, mesh), seq,
                          torch.float32, model=model)
    d = inputs(cfg)
    logits = [pre.fn(params, batch_of(cfg, d), cache)[0]]
    for t in range(PROMPT, PROMPT + STEPS):
        logits.append(dec.fn(params, torch.from_numpy(
            d["tokens"][:, t:t + 1]), cache)[0])
    return {"logits": [lg.numpy() for lg in logits], "cache": nps(cache)}


def world(rank: int, size: int) -> dict:
    return {name: _serve(name, size)
            for name in (CASES_2 if size == 2 else CASES_4)}


# the reference's serve steps on an Auto-axis (data 1, model 2) mesh
REF = r'''
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, os.path.join(sys.argv[1], "src"))
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import configs
from repro.launch import shapes, steps
from repro.models import transformer
in_path, out_path = sys.argv[2], sys.argv[3]
cfg = dataclasses.replace(configs.get_smoke("qwen3-0.6b"),
                          param_dtype="float32")
mesh = jax.make_mesh((1, 2), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
data = np.load(in_path)
params = {}
for key in data.files:
    if key.startswith("init/"):
        node = params
        *parents, last = key[5:].split("/")
        for q in parents:
            node = node.setdefault(q, {})
        node[last] = jnp.asarray(data[key])
tok = data["tokens"]
B, S = tok.shape
P = int(data["prompt"])
pre = steps.make_prefill_step(cfg, shapes.ShapeSpec("p", "prefill", S, B),
                              mesh)
dec = steps.make_decode_step(cfg, shapes.ShapeSpec("d", "decode", S, B),
                             mesh)
cache = transformer.init_cache(cfg, B, S, jnp.float32)
out = {}
with mesh:
    lg, cache = pre.fn(params, {"tokens": jnp.asarray(tok[:, :P],
                                                      jnp.int32)}, cache)
    out["l0"] = np.asarray(lg)
    for t in range(P, S):
        lg, cache = dec.fn(params, jnp.asarray(tok[:, t:t + 1], jnp.int32),
                           cache)
        out[f"l{t - P + 1}"] = np.asarray(lg)
np.savez(out_path, **out)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    cfg = cfg_of("qwen3-0.6b")
    np.savez(tmp / "in.npz", tokens=inputs(cfg)["tokens"], prompt=PROMPT,
             **{"init/" + p: v for p, v in nps(tt.init_params(
                 cfg, seed=2)).items()})
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF), str(ROOT),
         str(tmp / "in.npz"), str(tmp / "out.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    try:
        out = {n: tmesh.spawn(world, n, (n,), timeout=600, threads=1)
               for n in (2, 4)}
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    ref = np.load(tmp / "out.npz")
    out["reference"] = [ref[f"l{i}"] for i in range(STEPS + 1)]
    return out


# -- the single-device side ---------------------------------------------------------

def single(name: str):
    cfg = cfg_of(name)
    params = tt.init_params(cfg, seed=2)
    cache = tt.init_cache(cfg, B, PROMPT + STEPS, torch.float32)
    d = inputs(cfg)
    logits = [tt.prefill(params, batch_of(cfg, d), cfg, cache)[0]]
    for t in range(PROMPT, PROMPT + STEPS):
        logits.append(tt.decode_step(params, torch.from_numpy(
            d["tokens"][:, t:t + 1]), cfg, cache)[0])
    return [lg.numpy() for lg in logits], cache


@pytest.mark.parametrize("name,size", [(n, 2) for n in CASES_2]
                         + [(n, 4) for n in CASES_4])
def test_tensor_parallel_serve_matches_the_world_of_1(runs, name, size):
    cfg = cfg_of(name)
    data, model = mesh_of(name, size)
    mesh = {"data": data, "model": model}
    atol = ATOL.get(name, RTOL)
    want, cache = single(name)
    for rank, res in enumerate(runs[size]):
        got = res[name]
        assert len(got["logits"]) == len(want) == STEPS + 1
        for i, (g, w) in enumerate(zip(got["logits"], want)):
            assert g.shape == (B, cfg.vocab)
            np.testing.assert_allclose(g, w, rtol=RTOL,
                                       atol=atol * np.abs(w).max(),
                                       err_msg=f"rank {rank} step {i}")
        local = nps(tsteps.local_cache(cache, cfg, mesh,
                                       client_index=rank // model,
                                       model_index=rank % model))
        assert local.keys() == got["cache"].keys()
        for p, w in local.items():
            g = got["cache"][p]
            assert g.shape == w.shape, p
            if w.dtype.kind == "i":
                np.testing.assert_array_equal(g, w, err_msg=p)
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL,
                                           atol=atol * np.abs(w).max(),
                                           err_msg=f"rank {rank} {p}")
    full = dict(TL.flatten(cache))
    parts = [tsteps.local_cache(cache, cfg, mesh, client_index=r // model,
                                model_index=r % model)
             for r in range(size)]
    back = dict(TL.flatten(tsteps.assemble_cache(parts, cfg, mesh)))
    assert back.keys() == full.keys()
    for p, t in full.items():
        assert torch.equal(back[p], t), p


def test_every_split_is_exercised():
    """The cases split the cache as the module docstring says."""
    def model_dims(name, size):
        cfg = cfg_of(name)
        data, model = mesh_of(name, size)
        c = tt.init_cache(cfg, B, PROMPT + STEPS, device="meta")
        return {p: a["model"] for p, a in tsharding.cache_shard_axes(
            c, cfg, {"data": data, "model": model}).items()
            if "model" in a}
    assert model_dims("qwen3-0.6b", 2) == {"attn/k": 4, "attn/v": 4}
    assert model_dims("glm4-9b", 4) == {"attn/k": 5, "attn/v": 5}
    assert model_dims("xlstm-h2", 4)["mlstm/C"] == 4
    assert model_dims("xlstm-350m", 4)["mlstm/C"] == 3
    assert model_dims("xlstm-350m", 2)["slstm/h"] == 4
    assert model_dims("jamba-v0.1-52b", 2)["mamba/ssm"] == 3
    assert model_dims("whisper-small", 2)["xattn/k"] == 4


def test_the_port_matches_the_reference_mesh_serve(runs):
    from test_torch_serve import logit_tol
    cfg = cfg_of("qwen3-0.6b")
    for g, w in zip(runs[2][0]["qwen3-0.6b"]["logits"], runs["reference"]):
        np.testing.assert_allclose(g, w, **logit_tol(
            w, cfg, torch.float32))


# the rank's cache at decode_32k / long_500k on the 16 x 16 mesh, in GiB
# to two places: the cache_spec shard sums (long_500k with the dense
# archs' 16,384-token window, as shapes.adapt_config sets it)
CACHE_GIB = {
    "deepseek-7b": (7.50, 0.47), "qwen2-moe-a2.7b": (3.00, 0.19),
    "llama4-maverick-400b-a17b": (3.01, 0.19), "pixtral-12b": (2.50, 0.16),
    "glm4-9b": (0.63, 0.04), "qwen3-0.6b": (1.75, 0.11),
    "jamba-v0.1-52b": (0.26, 0.51), "xlstm-350m": (0.04, 0.01),
    "whisper-small": (0.59, None)}
MESH16 = {"data": 16, "model": 16}


def _spec_bytes(cfg, shape) -> int:
    """The global cache's leaves, each over the mesh axes its
    ``cache_spec`` names."""
    glob = tt.init_cache(cfg, shape.global_batch, shape.seq_len,
                         tsteps.CACHE_DTYPE, device="meta")
    total = 0
    for path, t in TL.flatten(glob):
        b = t.numel() * t.element_size()
        for entry in tsharding.cache_spec(path, tuple(t.shape), cfg, MESH16):
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    b //= MESH16[ax]
        total += b
    return total


@pytest.mark.parametrize("arch", list(tconfigs.ARCHS))
def test_a_rank_holds_the_cache_spec_shard_sum_at_16x16(arch):
    for shape_name in ("decode_32k", "long_500k"):
        shape = tshapes.SHAPES[shape_name]
        try:
            cfg = tshapes.adapt_config(tconfigs.get_config(arch), shape)
        except tshapes.SkipShape:
            continue
        local, _ = tsteps.cache_structs(cfg, shape, MESH16)
        got = sum(t.numel() * t.element_size()
                  for _, t in TL.flatten(local))
        assert got == _spec_bytes(cfg, shape), (arch, shape_name)
        if arch in CACHE_GIB:
            want = CACHE_GIB[arch][shape_name == "long_500k"]
            assert round(got / 2 ** 30, 2) == want, (arch, shape_name)


@pytest.mark.parametrize("arch", list(tconfigs.ARCHS))
def test_a_serving_rank_holds_the_param_spec_shard_and_fits(arch):
    from repro_torch.launch import dryrun as tdryrun
    cfg = tconfigs.get_config(arch)
    full = tsteps.param_structs(cfg)
    local = tsteps.local_params(full, cfg, MESH16, data_index=3,
                                model_index=5)
    got = sum(t.numel() * t.element_size() for _, t in TL.flatten(local))
    want = 0
    for path, t in TL.flatten(full):
        b = t.numel() * t.element_size()
        for entry in tsharding.param_spec(path, tuple(t.shape), cfg,
                                          MESH16):
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    b //= MESH16[ax]
        want += b
    assert got == want
    roof, _, _ = tdryrun.run_one(arch, "decode_32k", verbose=False)
    assert roof.mem_detail["params"] == got
    assert roof.peak_mem_bytes < 80 * 2 ** 30
