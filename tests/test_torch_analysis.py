"""Port parity for the roofline analysis (``launch/analysis.py``).

* ``model_flops_estimate``, ``step_flops_estimate`` (with and without a
  sketch config and a layout's total) and ``active_params`` equal the
  reference's exactly, as floats, for every arch and every shape; the
  reference's own ``tests/test_analysis.py`` estimate cases as twins (its
  HLO-parsing cases have no counterpart: the port has no HLO).
* ``Roofline``'s terms against the H100's constants and ``row()``'s
  format, the reference's.
* The counters: ``count_flops`` on ``meta`` equals ``FlopCounterMode`` on
  the CPU for the same model; ``count_bytes`` of one matmul is its
  operands' and result's bytes; ``peak_live_bytes`` equals
  ``MemTracker``'s peak less the parameters it sees first (within 1 KiB
  of some 10 MB), and an exact
  count on a sequence of known tensors.
* The engine's gradient sums under a dispatch mode: out of place, where a
  plain run adds in place (the count's one known bias above the card).
* The pins on the private modules the dry-run uses:
  ``torch.testing._internal.distributed.fake_pg`` (a ``fake`` world takes
  ``meta`` tensors in every collective the port runs) and
  ``torch.distributed._tools.mem_tracker.MemTracker``.
* ``CollectiveRecorder`` against ``step_collective_bytes``, to the byte,
  on every rank of ``gloo`` worlds of 4 on 127.0.0.1: flat, tree, dense
  and weighted flat / tree at (data 2, model 2), model_local at
  (data 1, model 4), and the EP step of a smoke qwen2-moe (its experts
  split over ``data``) at (2, 2).
"""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as rconfigs
from repro.core import fetchsgd as RF
from repro.launch import analysis as ranalysis
from repro.launch import shapes as rshapes
from repro_torch import configs as tconfigs
from repro_torch.core import fetchsgd as TF
from repro_torch.core import layout as TL
from repro_torch.launch import analysis as tanalysis
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as tt

ARCHS = tconfigs.list_archs()
SEQ, BATCH, LR, ROWS, COLS, K = 32, 4, 0.1, 3, 4096, 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the estimates -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_estimates_equal_the_reference_for_every_shape(arch):
    n = tt.param_count(tt.init_params(tconfigs.get_config(arch),
                                      device="meta"))
    rfs = RF.FetchSGDConfig(rows=5, cols=1 << 20, k=50_000)
    tfs = TF.FetchSGDConfig(rows=5, cols=1 << 20, k=50_000)
    for name in tshapes.SHAPES:
        rshape, tshape = rshapes.SHAPES[name], tshapes.SHAPES[name]
        try:
            rcfg = rshapes.adapt_config(rconfigs.get_config(arch), rshape)
        except rshapes.SkipShape:
            with pytest.raises(tshapes.SkipShape):
                tshapes.adapt_config(tconfigs.get_config(arch), tshape)
            continue
        tcfg = tshapes.adapt_config(tconfigs.get_config(arch), tshape)
        ra, ta = (ranalysis.active_params(rcfg, n),
                  tanalysis.active_params(tcfg, n))
        assert ta == ra and type(ta) is type(ra)
        assert tanalysis.model_flops_estimate(tcfg, tshape, ta) == \
            ranalysis.model_flops_estimate(rcfg, rshape, ra)
        assert tanalysis.step_flops_estimate(tcfg, tshape, ta) == \
            ranalysis.step_flops_estimate(rcfg, rshape, ra)
        for total in (None, n, 751_632_384):
            assert tanalysis.step_flops_estimate(
                tcfg, tshape, ta, fs_cfg=tfs, layout_total=total) == \
                ranalysis.step_flops_estimate(rcfg, rshape, ra, fs_cfg=rfs,
                                              layout_total=total)


def test_model_flops_train_vs_decode():
    cfg = tconfigs.get_config("qwen3-0.6b")
    n = 750e6
    train = tanalysis.model_flops_estimate(cfg, tshapes.SHAPES["train_4k"], n)
    dec = tanalysis.model_flops_estimate(cfg, tshapes.SHAPES["decode_32k"], n)
    assert train == 6 * n * 256 * 4096
    assert dec == 2 * n * 128


def test_active_params_moe():
    cfg = tconfigs.get_config("llama4-maverick-400b-a17b")
    active = tanalysis.active_params(cfg, 394.7e9)
    assert 8e9 < active < 20e9          # ~17B-class active


def test_step_flops_exceeds_model_flops():
    cfg = tconfigs.get_config("deepseek-7b")
    shape = tshapes.SHAPES["prefill_32k"]
    assert tanalysis.step_flops_estimate(cfg, shape, 7e9) > \
        tanalysis.model_flops_estimate(cfg, shape, 7e9)


# -- Roofline ----------------------------------------------------------------------

def _roof(**kw):
    base = dict(arch="a", shape="s", mesh="16x16", flops=2e12,
                hbm_bytes=6.7e9, coll_bytes=1.8e9, coll_detail={},
                peak_mem_bytes=3 * 2**30, model_flops=6e12,
                step_flops=8e12, n_devices=16)
    base.update(kw)
    return base


def test_roofline_terms_use_the_h100_constants():
    r = tanalysis.Roofline(**_roof())
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.NVLINK_BW,
            tmesh.PEAK_FLOPS_F32) == (989e12, 3.35e12, 450e9, 67e12)
    assert r.t_compute == 8e12 / 16 / 989e12
    assert r.t_compute_hlo == 2e12 / 989e12
    assert r.t_memory == 6.7e9 / 3.35e12
    assert r.t_collective == 1.8e9 / 450e9
    assert r.bottleneck == "collective"
    assert r.useful_ratio == 6e12 / 8e12
    assert tanalysis.Roofline(**_roof(step_flops=0)).useful_ratio == 0.0


def test_roofline_row_has_the_reference_format():
    t = tanalysis.Roofline(**_roof())
    r = ranalysis.Roofline(**_roof())
    assert t.row() == (f"| a | s | 16x16 | {t.t_compute*1e3:.2f} "
                       f"| {t.t_memory*1e3:.2f} | {t.t_collective*1e3:.2f} "
                       f"| collective | 0.750 | 3.00 |")
    # the same cells as the reference's, whose constants are the TPU's
    assert t.row().split("|")[1:4] + t.row().split("|")[7:] == \
        r.row().split("|")[1:4] + r.row().split("|")[7:]
    assert {f.name for f in dataclasses.fields(r)} <= \
        {f.name for f in dataclasses.fields(t)}


# -- the counters ------------------------------------------------------------------

def _smoke_batch(cfg, device):
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab, (2, 32), generator=g)
    return {"tokens": tok.to(device), "labels": tok.roll(-1, 1).to(device)}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b",
                                  "jamba-v0.1-52b"])
def test_count_flops_on_meta_equals_flop_counter_on_cpu(arch):
    cfg = tconfigs.get_smoke(arch)

    def fn(p, b):
        return tt.value_and_grad(p, b, cfg)

    cpu = tt.init_params(cfg)
    with FlopCounterMode(display=False) as fc:
        fn(cpu, _smoke_batch(cfg, "cpu"))
    want = fc.get_total_flops()
    meta = tt.init_params(cfg, device="meta")
    got = tanalysis.count_flops(fn, meta, _smoke_batch(cfg, "meta"))
    assert got == want > 0
    assert tanalysis.count(fn, meta, _smoke_batch(cfg, "meta")).flops == want


def test_count_bytes_of_one_matmul():
    a = torch.empty(4, 8, device="meta")
    b = torch.empty(8, 16, dtype=torch.float32, device="meta")
    assert tanalysis.count_bytes(torch.mm, a, b) == (32 + 128 + 64) * 4
    assert tanalysis.count_flops(torch.mm, a, b) == 2 * 4 * 8 * 16


def test_peak_live_bytes_of_a_known_sequence():
    """Forward: y = exp(x) (saved as the output), y2 = 2y (saved by sin),
    z = sin(y2), s = sum(z); the backward's peak holds y, y2, z, s, the
    scalar gradient and cos(y2) with its product: 5 x 4000 + 8 bytes."""
    def f(x):
        y = x.exp()
        z = (y * 2).sin()
        del y
        return torch.autograd.grad(z.sum(), x)[0]

    for dev in ("cpu", "meta"):
        x = torch.ones(1000, device=dev, requires_grad=True)
        assert tanalysis.peak_live_bytes(f, x) == 5 * 4000 + 8


def _two_contributions(x, ptrs=None):
    """y feeds exp and sin, so the engine adds two 4000-byte gradient
    contributions for y; ``ptrs`` records where each and the sum live."""
    y = x * 2
    a, b = y.exp(), y.sin()
    if ptrs is not None:
        a.grad_fn.register_hook(
            lambda gi, go: ptrs.__setitem__("exp", gi[0].data_ptr()))
        b.grad_fn.register_hook(
            lambda gi, go: ptrs.__setitem__("sin", gi[0].data_ptr()))
        y.register_hook(lambda g: ptrs.__setitem__("sum", g.data_ptr()))
    return torch.autograd.grad(a.sum() + b.sum(), x)[0]


def test_dispatch_modes_make_the_engine_sum_gradients_out_of_place():
    """Why the count lies above a plain run where two large gradient
    contributions meet (the logits feed logsumexp and gather): plain, the
    autograd engine adds the second contribution into the first in place;
    under any Python dispatch mode (the counters, ``FlopCounterMode``) it
    sums them into a new tensor, which the count then holds."""
    x = torch.randn(1000, requires_grad=True)
    plain = {}
    _two_contributions(x, plain)
    assert plain["sum"] in (plain["exp"], plain["sin"])
    for mode in (FlopCounterMode(display=False), tanalysis._OpCounter()):
        ptrs = {}
        with mode:
            _two_contributions(x, ptrs)
        assert ptrs["sum"] not in (ptrs["exp"], ptrs["sin"])


def test_peak_live_bytes_equals_mem_tracker_less_the_parameters():
    """MemTracker sees the parameters' storages (through ``detach``) for
    the first time inside the pass and counts them; the port's counter
    holds its inputs as given."""
    from torch.distributed._tools.mem_tracker import MemTracker
    cfg = tconfigs.get_smoke("qwen3-0.6b")
    params = tt.init_params(cfg, device="meta")
    batch = _smoke_batch(cfg, "meta")

    def fn(p, b):
        return tt.value_and_grad(p, b, cfg)

    mine = tanalysis.peak_live_bytes(fn, params, batch)
    mt = MemTracker()
    with mt:
        fn(params, batch)
    peak = mt.get_tracker_snapshot("peak")[torch.device("meta")]
    p_bytes = sum(t.numel() * t.element_size()
                  for _, t in TL.flatten(params))
    # within 1 KiB: the two count the batch's small tensors differently
    assert abs(peak["Total"] - p_bytes - mine) <= 1024, (peak, p_bytes, mine)
    assert mine > 1_000_000


def test_fake_pg_takes_meta_tensors_in_every_collective_of_the_port():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert issubclass(FakeStore, torch.distributed.Store)
    with tdryrun.fake_world(8, rank=5):
        assert torch.distributed.get_backend() == "fake"
        mesh = tmesh.make_debug_mesh(4, 2)
        assert mesh.device.type == "meta" and mesh.coords == {
            "data": 2, "model": 1}
        t = torch.empty(3, 5, device="meta")
        assert mesh.all_mean(t, ("data",)) is t
        assert len(mesh.all_gather(t, ("data",))) == 4
        out = torch.empty(4, 2, device="meta")
        torch.distributed.all_to_all_single(out, torch.empty_like(out),
                                            group=mesh.group(("data",)))
    assert not torch.distributed.is_initialized()


# -- the recorder against the formula ----------------------------------------------

def _qwen2_moe_ep():
    return dataclasses.replace(tconfigs.get_smoke("qwen2-moe-a2.7b"),
                               shard_experts_data=True)


def recorder_world(rank: int) -> dict:
    """One rank: each policy's recorded bytes beside the formula's."""
    from repro_torch.launch import analysis as a
    shape = tshapes.ShapeSpec("t", "train", SEQ, BATCH)
    fs = TF.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, momentum=0.9)
    tok = torch.randint(0, 512, (BATCH, SEQ),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
    cases = [("2x2", "internlm2-1.8b", agg, "gathered", w)
             for agg in ("flat", "tree", "dense") for w in (False,)] + \
        [("2x2", "internlm2-1.8b", agg, "gathered", True)
         for agg in ("flat", "tree")] + \
        [("1x4", "internlm2-1.8b", "flat", "model_local", False),
         ("2x2", "qwen2-moe-ep", "flat", "gathered", False)]
    meshes = {"2x2": tmesh.make_debug_mesh(2, 2),
              "1x4": tmesh.make_debug_mesh(1, 4)}
    out = {}
    for mesh_name, arch, agg, mode, weighted in cases:
        mesh = meshes[mesh_name]
        cfg = _qwen2_moe_ep() if arch == "qwen2-moe-ep" else \
            tconfigs.get_smoke(arch)
        b = batch if cfg.vocab >= 512 else {
            k: v % cfg.vocab for k, v in batch.items()}
        bundle = tsteps.make_train_step(cfg, shape, mesh, fs, aggregate=agg,
                                        sketch_mode=mode, weighted=weighted)
        params = tsteps.local_params(tt.init_params(cfg), cfg, mesh)
        extra = ((0.5, 2.5),) if weighted else ()
        with a.CollectiveRecorder() as rec:
            bundle.fn(params, TF.init_state(fs), b, LR, *extra)
        want = a.step_collective_bytes(cfg, shape, mesh.shape, fs,
                                       bundle.layout, aggregate=agg,
                                       sketch_mode=mode, weighted=weighted)
        key = f"{mesh_name}:{arch}:{agg}:{mode}:{'w' if weighted else '-'}"
        out[key] = (rec.bytes(), want, rec.counts())
    return out


@pytest.fixture(scope="module")
def recorded():
    return tmesh.spawn(recorder_world, 4, timeout=600, threads=1)


CASES = ["2x2:internlm2-1.8b:flat:gathered:-",
         "2x2:internlm2-1.8b:tree:gathered:-",
         "2x2:internlm2-1.8b:dense:gathered:-",
         "2x2:internlm2-1.8b:flat:gathered:w",
         "2x2:internlm2-1.8b:tree:gathered:w",
         "1x4:internlm2-1.8b:flat:model_local:-",
         "2x2:qwen2-moe-ep:flat:gathered:-"]


@pytest.mark.parametrize("case", CASES)
def test_recorder_equals_step_collective_bytes(recorded, case):
    table = ROWS * COLS * 4
    for rank in range(4):
        got, want, counts = recorded[rank][case]
        assert got == want, (rank, got, want)
    got, _, counts = recorded[0][case]
    if ":tree:" in case:
        assert got["all-reduce"] == table + 4 + (4 if ":w" in case else 0)
    if "model_local" in case:
        assert got["all-reduce"] == table           # the sum over model
    if "qwen2-moe-ep" in case:
        cfg = _qwen2_moe_ep()
        n_moe = cfg.n_units
        assert counts["all-to-all"] == 4 * n_moe
        assert got["all-to-all"] == 4 * n_moe * tanalysis.exchange_bytes(
            cfg, BATCH // 2 * SEQ, 2)
