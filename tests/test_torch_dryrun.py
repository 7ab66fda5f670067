"""Port parity for the dry-run (``launch/dryrun.py``), its input structs
(``steps.batch_structs`` / ``cache_structs``), ``report_roofline`` and
``hillclimb``.

* Fake worlds of 256 and 512 ranks build the production meshes on the
  ``meta`` device, which ``make_mesh`` takes by itself under the ``fake``
  backend, and no CUDA context is made.
* ``n_params`` of every arch equals the reference's count from
  ``jax.eval_shape(init_params)``; the global shapes of ``batch_structs``
  and ``cache_structs`` equal the reference's for every arch and shape
  (the dict its ``batch_structs`` builds, read with the sharding step
  stubbed; ``jax.eval_shape`` of its ``init_cache``; no mesh, no compile);
  the ``SkipShape`` set equals the reference's.
* A rank's parameter bytes in ``run_one`` equal ``steps.local_params``'s
  (llama4's experts split over ``data``), and its cache is the whole
  batch where ``batch_spec`` does not split it (long_500k).
* The CLI on a full-width combo that counts in a few seconds, for its
  lines, its ``--json`` keys and its telemetry (the ``dryrun`` event, the
  spans ``dryrun.build_step`` / ``count_flops`` / ``count_memory``); a
  second run resumes from the JSON; ``report_roofline`` renders it;
  ``hillclimb --list``.
* The kernels' geometry that sizes their scratch in the dry-run
  (``SOURCE_BINS``, ``SOURCE_SELECT``) is what ``csrc/`` compiles.
"""

import json
import re
from pathlib import Path

import jax
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import shapes as rshapes
from repro.launch import steps as rsteps
from repro.models import transformer as rt
from repro_torch import configs as tconfigs
from repro_torch.core import layout as TL
from repro_torch.kernels import count_sketch as tcs
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import hillclimb as thill
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import report_roofline as treport
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as tt
from repro_torch.obs import schema as tschema

ARCHS = tconfigs.list_archs()
CSRC = Path(tcs.__file__).with_name("csrc")


def _ref_flat(tree) -> dict:
    return {"/".join(str(getattr(q, "key", q)) for q in kp): tuple(v.shape)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- the world -----------------------------------------------------------------

@pytest.mark.parametrize("world,rank", [(256, 37), (512, 300)])
def test_fake_worlds_build_the_production_meshes_on_meta(world, rank):
    with tdryrun.fake_world(world, rank):
        mesh = tmesh.make_production_mesh(multi_pod=world == 512)
        assert mesh.device == torch.device("meta")
        assert mesh.backend == "fake"
        assert mesh.rank == rank
        if world == 256:
            assert mesh.shape == {"data": 16, "model": 16}
            assert mesh.coords == {"data": 2, "model": 5}
        else:
            assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
            assert mesh.coords == {"pod": 1, "data": 2, "model": 12}
            assert mesh.n_clients == 32 and mesh.client_index == 18
        assert set(mesh.groups) == set(tmesh._axis_sets(mesh.axis_names))
    assert not torch.cuda.is_initialized()


def test_run_one_refuses_another_world():
    with tdryrun.fake_world(4):
        with pytest.raises(RuntimeError, match="fake world of 256"):
            tdryrun.run_one("qwen3-0.6b", "decode_32k", verbose=False)


# -- parity with the reference -------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_equals_the_reference(arch):
    structs = jax.eval_shape(lambda k: rt.init_params(
        rconfigs.get_config(arch), k), jax.random.PRNGKey(0))
    want = sum(int(x.size) for x in jax.tree.leaves(structs))
    assert tt.param_count(tsteps.param_structs(
        tconfigs.get_config(arch))) == want


@pytest.fixture
def ref_structs(monkeypatch):
    """The reference's ``batch_structs`` / ``cache_structs`` with the
    sharding step stubbed: the dicts they build, without a mesh."""
    monkeypatch.setattr(rsteps.sharding, "batch_sharding",
                        lambda b, mesh: None)
    monkeypatch.setattr(rsteps.sharding, "cache_sharding",
                        lambda s, cfg, mesh: None)
    monkeypatch.setattr(rsteps, "_sds", lambda structs, sh: structs)
    return rsteps


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_shapes_equal_the_reference(ref_structs, arch):
    mesh = {"data": 16, "model": 16}
    for name in tshapes.SHAPES:
        try:
            rcfg = rshapes.adapt_config(rconfigs.get_config(arch),
                                        rshapes.SHAPES[name])
        except rshapes.SkipShape:
            continue
        tcfg = tshapes.adapt_config(tconfigs.get_config(arch),
                                    tshapes.SHAPES[name])
        shape = tshapes.SHAPES[name]
        want, _ = ref_structs.batch_structs(rcfg, rshapes.SHAPES[name], None)
        local, glob = tsteps.batch_structs(tcfg, shape, mesh)
        assert {k: s for k, (s, _) in glob.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        for k, (s, dt) in glob.items():
            assert dt.is_floating_point == \
                jax.numpy.issubdtype(want[k].dtype, jax.numpy.floating)
            b = tsteps.local_batch_size(shape.global_batch, mesh)
            assert tuple(local[k].shape) == (b,) + s[1:]
            assert local[k].device.type == "meta"
        if shape.kind == "train":
            continue
        want, _ = ref_structs.cache_structs(rcfg, rshapes.SHAPES[name], None)
        cache, cglob = tsteps.cache_structs(tcfg, shape, mesh)
        assert cglob == _ref_flat(want)
        assert {p for p, _ in TL.flatten(cache)} == set(cglob)


def test_skip_set_equals_the_reference():
    def skips(cfgs, shp):
        out = set()
        for arch in ARCHS:
            for name, shape in shp.SHAPES.items():
                try:
                    shp.adapt_config(cfgs.get_config(arch), shape)
                except shp.SkipShape:
                    out.add((arch, name))
        return out

    assert skips(tconfigs, tshapes) == skips(rconfigs, rshapes) == {
        ("whisper-small", "long_500k")}


# -- run_one -------------------------------------------------------------------

def test_rank_params_are_local_params_and_the_cache_its_batch():
    cfg = tshapes.adapt_config(tconfigs.get_config(
        "llama4-maverick-400b-a17b"), tshapes.SHAPES["decode_32k"])
    mesh = {"data": 16, "model": 16}
    with tdryrun.fake_world(256, 19):
        roof, _, n = tdryrun.run_one("llama4-maverick-400b-a17b",
                                     "decode_32k", verbose=False, rank=19)
        m = tmesh.make_production_mesh()
        local = tsteps.local_params(tsteps.param_structs(cfg), cfg, m)
    want = sum(t.numel() * t.element_size() for _, t in TL.flatten(local))
    assert roof.mem_detail["params"] == want
    assert want < n * 2 / 4          # the experts split over 16 data ranks
    cache, _ = tsteps.cache_structs(cfg, tshapes.SHAPES["decode_32k"], mesh)
    cache_bytes = sum(t.numel() * t.element_size()
                      for _, t in TL.flatten(cache))
    assert roof.mem_detail["inputs"] == cache_bytes + 8 * 8
    assert roof.coll_detail["all-to-all"] > 0          # EP in the forward
    assert roof.coll_detail["all-gather"] > 0          # the logits
    assert roof.n_devices == 16
    # long_500k: a batch of 1 stays whole on every rank
    long_cache, _ = tsteps.cache_structs(
        tshapes.adapt_config(tconfigs.get_config("qwen3-0.6b"),
                             tshapes.SHAPES["long_500k"]),
        tshapes.SHAPES["long_500k"], mesh)
    assert next(v for p, v in TL.flatten(long_cache)
                if p == "attn/k").shape[2] == 1


# -- the CLI -------------------------------------------------------------------

COMBO = ["--arch", "qwen3-0.6b", "--shape", "decode_32k"]
KEYS = {"arch", "shape", "mesh", "aggregate", "sketch_mode", "flops",
        "hbm_bytes", "coll_bytes", "coll_detail", "peak_mem", "mem_detail",
        "model_flops", "step_flops", "params", "compile_s", "t_compute",
        "t_memory", "t_collective", "bottleneck", "useful"}


def test_cli_lines_json_resume_and_report(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    metrics = tmp_path / "run.jsonl"
    assert tdryrun.main(COMBO + ["--json", str(out), "--metrics",
                                 str(metrics), "--trace"]) == 0
    text = capsys.readouterr().out
    lines = text.splitlines()
    assert lines[0].startswith("== qwen3-0.6b x decode_32k x 16x16 "
                               "(aggregate=-) counted in ")
    assert lines[1] == "   params: 0.752B (active 0.752B)"
    assert re.match(r"   memory/rank: params=2\.80G grads=0\.00G "
                    r"sketch state=0\.00G activations peak=[\d.]+G "
                    r"peak~[\d.]+G$", lines[2])
    assert re.match(r"   cost/rank: flops=\S+ step_flops/rank=\S+ "
                    r"bytes=\S+ coll_bytes=\S+$", lines[3])
    assert lines[4].startswith("   collectives: {'all-gather': ")
    assert re.match(r"   roofline\(ms\): compute=[\d.]+ \(counted [\d.]+\) "
                    r"memory=[\d.]+ collective=[\d.]+ -> \w+-bound  "
                    r"useful=[\d.]+$", lines[5])
    assert "1 counted, 0 failures" in text
    rec = json.loads(out.read_text())
    assert set(rec) == KEYS
    assert rec["params"] == 751_632_384
    assert rec["coll_detail"]["all-gather"] == 128 * 151_936 * 4
    assert not torch.cuda.is_initialized()
    # the telemetry: the dryrun event and its three spans, valid
    assert tschema.validate_jsonl(str(metrics)) == []
    events = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [e["name"] for e in events if e["type"] == "span"] == [
        "dryrun.build_step", "dryrun.count_flops", "dryrun.count_memory"]
    (ev,) = [e for e in events if e["type"] == "dryrun"]
    assert (ev["arch"], ev["shape"], ev["mesh"]) == ("qwen3-0.6b",
                                                     "decode_32k", "16x16")

    assert tdryrun.main(COMBO + ["--json", str(out)]) == 0
    assert "already in" in capsys.readouterr().out
    assert len(out.read_text().splitlines()) == 1

    assert treport.main([str(out)]) == 0
    table = capsys.readouterr().out.splitlines()
    assert table[0].startswith("| arch | shape | mesh | agg | t_comp(ms)")
    assert table[2].startswith("| qwen3-0.6b | decode_32k | 16x16 | sketch |")


def test_hillclimb_lists_its_variants(capsys):
    assert thill.main(["--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(thill.VARIANTS) == 13
    assert lines[0].startswith("A0_baseline: llama4-maverick-400b-a17b x "
                               "train_4k")
    assert not any("donate" in line for line in lines)


# -- the kernels' geometry -----------------------------------------------------

def test_source_geometry_is_what_csrc_compiles():
    enc = (CSRC / "encode.cu").read_text()
    sel = (CSRC / "estimate_select.cu").read_text()
    shift = int(re.search(r"kBinShift = (\d+);", enc).group(1))
    assert tcs.SOURCE_BINS == tcs.Bins(
        1 << shift, int(re.search(r"kMaxBins = (\d+);", enc).group(1)))
    assert tcs.SOURCE_SELECT.tile == int(
        re.search(r"constexpr int kTile = (\d+);", sel).group(1))
    assert tcs.SOURCE_SELECT.group_tiles == int(
        re.search(r"constexpr int kTileThreads = (\d+);", sel).group(1))
    bits = [int(b) for b in re.findall(r"kBits\d = (\d+)", sel)]
    state = re.search(r"struct SelectState \{(.*?)\n\};", sel, re.S).group(1)
    words = sum(1 << b for b in bits) + 3 + len(re.findall(
        r"^\s*unsigned (?!hist|arrived)\w+;", state, re.M))
    assert "arrived[3]" in state
    assert tcs.SOURCE_SELECT.state_words == words
