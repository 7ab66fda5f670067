"""Port parity for the telemetry layer: ``repro_torch.obs`` and the
orchestrator's, aggregators' and kernel dispatcher's hooks, against
``repro.obs`` and the reference's hooks.

* The port's metrics, sinks and schema give the reference's snapshots,
  quantiles, summaries and validation verdicts on the same inputs.
* A port run's JSONL stream passes the reference's validator and renders
  in ``scripts/report_run.py``.
* Instrumented and uninstrumented port runs give byte-identical
  ``RoundRecord``s (the port's counterpart of ``tests/test_obs.py``'s
  determinism test), on both clocks and on the vectorized event path.
* The port's ``round`` events and final counters and histograms equal the
  reference's for the same configuration from the same weights, but for
  ``t``, the loss and what the wall clock measures.
* ``state_norms`` and ``recovery_error`` match the reference on the same
  table and gradient (rtol 1e-5; continuous random inputs, so that no two
  estimates tie at the k-th magnitude).
"""

import argparse
import dataclasses
import importlib.util
import io
import json
import math
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fed as jfed
from repro import obs as jobs
from repro.core import fetchsgd as JF
from repro.core import layout as JL
from repro.launch import simulate as jsim
from repro.models import transformer as jt
from repro.obs import sketch_health as jsh
from repro.optim import linear_decay as j_linear_decay
from repro_torch import fed as tfed
from repro_torch import obs
from repro_torch.convert import params_from_numpy
from repro_torch.core import fetchsgd as TF
from repro_torch.core import layout as TL
from repro_torch.kernels import ops
from repro_torch.launch import simulate as tsim
from repro_torch.obs import sketch_health as tsh
from repro_torch.optim import linear_decay as t_linear_decay

ROOT = Path(__file__).resolve().parents[1]
SKETCH = dict(rows=3, cols=1 << 12, k=64)
ROUNDS, LR = 3, 0.2
HET = dict(bandwidth_sigma=1.5)
CASES = {
    "round-async": dict(clients_per_round=4, aggregate="async", seed=3,
                        straggler=dict(straggle_prob=0.5, dropout_prob=0.1,
                                       max_delay=2)),
    "event-async": dict(clients_per_round=4, aggregate="async", seed=7,
                        clock="event", straggler=dict(straggle_prob=0.25),
                        sim=dict(quorum=2)),
    "vectorized-event-tree": dict(clients_per_round=8, aggregate="tree",
                                  tree_fanout=2, seed=1, clock="event",
                                  vectorized=True, n_clients=1000),
}
# the reference's sketch-health sample runs its estimates eagerly, which
# dominates this file's time on the CPU: it samples round 0 of one case
REF_HEALTH = "round-async"
# round-event fields that read the wall clock or the model's loss
UNSTABLE = {"t", "loss", "virtual_wall_ratio"}
UNSTABLE_GAUGES = {"fed.loss", "event.virtual_wall_ratio",
                   "sketch.error_norm", "sketch.momentum_norm",
                   "sketch.recovery_rel_err", "sketch.heavy_hitter_overlap"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The micro model's ops are tiny: one intra-op thread is as fast
    alone and does not oversubscribe the cores when test files run in
    parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ metrics, sinks, schema

def test_default_buckets_match_reference():
    for kw in ({}, dict(lo=1e-3, hi=1e3, per_decade=3),
               dict(lo=0.5, hi=50, per_decade=2), dict(per_decade=4)):
        assert obs.default_buckets(**kw) == jobs.default_buckets(**kw)


@pytest.mark.parametrize("batched", [False, True])
def test_histogram_matches_reference(batched):
    data = np.random.default_rng(0).lognormal(0.0, 2.0, size=2000)
    hists = []
    for mod in (obs, jobs):
        h = mod.Histogram()
        if batched:
            h.observe_many(data)
        else:
            for v in data:
                h.observe(v)
        hists.append(h)
    port, ref = hists
    assert port.snapshot() == ref.snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert port.quantile(q) == ref.quantile(q)
    snap = json.loads(json.dumps(port.snapshot()))
    assert (obs.quantile_from_snapshot(snap, 0.5)
            == jobs.quantile_from_snapshot(snap, 0.5))
    assert math.isnan(obs.Histogram().quantile(0.5))
    with pytest.raises(ValueError):
        port.quantile(1.5)


def test_registry_snapshot_matches_reference():
    snaps = []
    for mod in (obs, jobs):
        reg = mod.MetricsRegistry()
        reg.counter("n").inc(2)
        reg.counter("a").inc(0.5)
        reg.gauge("x").set(7)
        reg.gauge("unset")
        reg.histogram("h").observe(0.5)
        reg.histogram("edges", (1.0, 10.0)).observe(3.0)
        assert len(reg) == 6
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
    with pytest.raises(ValueError):
        obs.Counter().inc(-1)


GOOD_ROUND = {"type": "round", "t": 0.1, "round": 0, "loss": 1.0,
              "cohort_size": 4, "n_fresh": 3, "n_late": 0,
              "n_dropped": 1, "n_straggling": 0, "upload_bytes": 100,
              "download_bytes": 50, "dense_equiv_upload_bytes": 4000,
              "dense_equiv_download_bytes": 4000,
              "upload_compression_x": 40.0, "total_compression_x": 53.3}
EVENTS = [
    GOOD_ROUND, dict(GOOD_ROUND, queue_depth=3, policy="async"),
    {k: v for k, v in GOOD_ROUND.items() if k != "upload_bytes"},
    dict(GOOD_ROUND, n_fresh="three"), dict(GOOD_ROUND, loss=None),
    {"type": "mystery", "t": 0.0}, {"type": "meta", "env": {}},
    {"type": "span", "t": 1.0, "name": "s", "dur_s": 0.5, "depth": 0,
     "parent": None},
    {"type": "sketch_health", "t": 1.0, "round": 0, "error_sketch_norm": 1,
     "momentum_sketch_norm": 2.0, "agg_table_norm": 3.0,
     "recovery_rel_err": None, "heavy_hitter_overlap": 0.5},
    {"type": "metrics", "t": 2.0, "counters": {}, "gauges": {},
     "histograms": []}, "not an event", {"t": 0.0}]


def test_schema_verdicts_match_reference():
    assert obs.EVENT_SCHEMAS == jobs.EVENT_SCHEMAS
    for i, ev in enumerate(EVENTS):
        assert obs.validate_event(ev, i) == jobs.validate_event(ev, i)
    assert obs.validate_events(EVENTS) == jobs.validate_events(EVENTS)
    assert obs.validate_events([]) == jobs.validate_events([]) != []


def test_sinks_match_reference(tmp_path):
    events = [{"type": "round", "t": 0.0},
              {"type": "span", "t": 0.1, "name": "s", "dur_s": 0.5,
               "depth": 0, "parent": None},
              {"type": "span", "t": 0.2, "name": "k", "dur_s": 0.25,
               "depth": 1, "parent": "s"},
              {"type": "metrics", "t": 0.3, "counters": {"c": 3},
               "gauges": {}, "histograms": {}}]
    outs, files = [], []
    for name, mod in (("port", obs), ("ref", jobs)):
        buf = io.StringIO()
        summary = mod.StdoutSummarySink(buf)
        path = str(tmp_path / f"{name}.jsonl")
        jsonl = mod.JsonlSink(path)
        for ev in events + [{"type": "meta", "t": 0.4,
                             "env": {"x": np.float32(1.5)}}]:
            summary.emit(ev)
            jsonl.emit(ev)
        summary.close()
        jsonl.close()
        jsonl.close()                                  # idempotent
        with pytest.raises(ValueError):
            jsonl.emit(events[0])
        outs.append(buf.getvalue())
        files.append(Path(path).read_text())
    assert outs[0] == outs[1] and "2 spans" in outs[0]
    assert files[0] == files[1]
    assert obs.parse_jsonl(str(tmp_path / "port.jsonl"))[-1]["env"] \
        == {"x": 1.5}
    sink = obs.JsonlSink(str(tmp_path / "tensor.jsonl"))
    sink.emit({"type": "meta", "t": 0.0, "env": {"v": torch.tensor(2.5)}})
    sink.close()
    assert obs.parse_jsonl(sink.path)[0]["env"]["v"] == 2.5


def test_noop_and_spans():
    t = obs.NOOP
    assert t.enabled is False and t.trace_enabled is False
    assert t.counter("a") is t.histogram("b") is t.gauge("c")
    assert t.span("s") is obs.NULL_SPAN
    x = torch.ones(3)
    with obs.NULL_SPAN as sp:
        assert sp.sync(x) is x
    assert obs.Telemetry([obs.MemorySink()]).span("x") is obs.NULL_SPAN
    sink = obs.MemorySink()
    tele = obs.Telemetry([sink], trace=True)
    with tele.span("outer", round=2):
        with tele.span("inner") as sp:
            assert sp.sync({"a": [x, (x,)]})["a"][0] is x
    with pytest.raises(RuntimeError):
        with tele.span("boom"):
            raise RuntimeError("x")
    assert tele._span_stack == []
    tele.close()
    tele.close()
    spans = {e["name"]: e for e in sink.events if e["type"] == "span"}
    assert spans["outer"]["depth"] == 0 and spans["outer"]["round"] == 2
    assert spans["inner"]["parent"] == "outer" and spans["inner"]["depth"] \
        == 1
    assert spans["boom"]["error"] == "RuntimeError"
    assert [e["type"] for e in sink.events].count("metrics") == 1
    assert obs.trace.cuda_device({"a": [x, (x, 1)], "b": None}) is None


def test_span_stamps_hold_the_profilers_interval():
    """``t0_ns`` / ``t1_ns`` are on the clock of the profiler's events: they
    hold the interval of an aten op run inside the span.  A CPU run's span
    carries no ``dev_s`` or ``syncs``."""
    from torch.profiler import ProfilerActivity, profile
    sink = obs.MemorySink()
    tele = obs.Telemetry([sink], trace=True)
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tele.span("mm"):
            x @ x
    (ev,) = sink.events
    (op,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::mm"]
    assert ev["t0_ns"] <= op.start_ns() < op.end_ns() <= ev["t1_ns"]
    assert ev["t1_ns"] - ev["t0_ns"] >= 1e9 * ev["dur_s"] / 2
    assert "dev_s" not in ev and "syncs" not in ev
    assert obs.validate_events(sink.events) == []


class _FakeCard:
    """Stands in for ``torch.cuda`` in the span machinery: events stamped
    1 ms apart in record order, done once the card has been synchronised
    past them; the sync check's mode recorded, and each sync (the
    telemetry's own included) raising torch's warning."""

    def __init__(self, monkeypatch):
        card = self
        self.recorded, self.done, self.modes = 0, 0, [0]

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                self.at = None

            def record(self):
                card.recorded += 1
                self.at = card.recorded

            def query(self):
                return self.at <= card.done

            def synchronize(self):
                card.done = max(card.done, self.at)

            def elapsed_time(self, end):
                assert self.query() and end.query(), "not done"
                return float(end.at - self.at)

        for name, fn in dict(
                is_initialized=lambda: True, Event=Event,
                synchronize=lambda dev=None: self.sync(),
                get_sync_debug_mode=lambda: self.modes[-1],
                set_sync_debug_mode=self.modes.append).items():
            monkeypatch.setattr(torch.cuda, name, fn)
        monkeypatch.setattr(obs.trace, "cuda_device",
                            lambda x: "cuda:0" if x is self else None)

    def sync(self):
        warnings.warn(f"{obs.trace.SYNC_WARNING} (Triggered internally)")
        self.done = self.recorded


def test_device_time_waits_for_a_sync_and_syncs_are_counted(monkeypatch):
    """On a CUDA run a span's device time is read at the exit of the next
    span that waits for the device, or at ``close()``, and never forces a
    sync; each span counts the syncs made inside it, not the telemetry's
    own; the check is armed only while an outermost span is open."""
    card = _FakeCard(monkeypatch)
    sink = obs.MemorySink()
    tele = obs.Telemetry([sink], trace=True)
    names = lambda: [e["name"] for e in sink.events]    # noqa: E731
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        with tele.span("round", round=4):
            assert card.modes[-1] == "warn"
            with tele.span("clients") as sp:
                with tele.span("grad", client=7):
                    card.sync()                 # the program's: counted
                    card.sync()
                assert names() == []            # waits for its events
                with tele.span("sketch", client=7):
                    pass
                sp.sync(card)                   # the telemetry's own
            assert names() == ["grad", "sketch", "clients"]
            warnings.warn("another warning")
        assert card.modes[-1] == 0
        assert [str(w.message) for w in shown] == ["another warning"]
    # the outermost span's end is not done at its exit: it waits, and so
    # does a later one, until close()
    with tele.span("late"):
        pass
    assert names() == ["grad", "sketch", "clients"]
    assert card.done < card.recorded
    tele.close()
    assert [e.get("name", e["type"]) for e in sink.events] == [
        "grad", "sketch", "clients", "round", "late", "metrics"]
    ev = {e["name"]: e for e in sink.events if e["type"] == "span"}
    assert [ev[n]["syncs"] for n in ("grad", "sketch", "clients", "round")] \
        == [2, 0, 2, 2]
    assert ev["grad"]["client"] == 7 and ev["round"]["round"] == 4
    # records 1 ms apart: round, clients, grad x2, sketch x2, clients, round
    assert ev["grad"]["dev_s"] == ev["sketch"]["dev_s"] == 1e-3
    assert (ev["clients"]["dev_s"], ev["round"]["dev_s"]) == (5e-3, 7e-3)
    assert ev["grad"]["t"] < ev["sketch"]["t"] < ev["clients"]["t"] \
        < ev["round"]["t"] < ev["late"]["t"]
    assert obs.validate_events(sink.events) == []


def test_profile_round_puts_idle_time_down_to_the_innermost_span():
    """Idle device time inside a span's stamps and outside its children's
    counts for the span; outside every span, for ``(no span)``."""
    from repro_torch.launch import profile_round as pr

    def sp(name, depth, t0, t1):
        return dict(name=name, depth=depth, t0_ns=t0, t1_ns=t1)
    spans = [sp("fed.client.grad", 2, 10, 40),
             sp("fed.client.sketch", 2, 40, 60),
             sp("fed.clients", 1, 10, 60), sp("fed.round", 0, 0, 100)]
    busy = [[15, 30], [45, 50], [70, 80]]
    idle = pr.idle_by_span(spans, busy, 0, 120)
    want = {"fed.client.grad": 15, "fed.client.sketch": 15,
            "fed.clients": 0, "fed.round": 40, "(no span)": 20}
    assert idle == pytest.approx({k: v * 1e-9 for k, v in want.items()})
    assert pr.idle_s(busy, 0, 120) == pytest.approx(90e-9)


def _dispatch():
    table = ops.sketch_encode(torch.ones(10), 0, 3, 64)
    ops.sketch_estimate(table, 0, 10)


@pytest.mark.parametrize("case", ["noop", "quiet", "tracing", "nested"])
def test_kernel_spans_only_when_tracing(case):
    """A dispatch opens its span on the innermost ``obs.active`` telemetry,
    and only when that traces (the shared null span otherwise); a nested
    ``obs.active`` gives the outer one back on exit and after an
    exception inside it."""
    sink = obs.MemorySink()
    tele = {"noop": obs.NOOP, "quiet": obs.Telemetry([sink])}.get(
        case, obs.Telemetry([sink], trace=True))
    inner = obs.MemorySink()
    with obs.active(tele):
        if case == "nested":
            with obs.active(obs.Telemetry([inner], trace=True)):
                _dispatch()
            assert obs.current() is tele
            with pytest.raises(RuntimeError), obs.active(obs.NOOP):
                raise RuntimeError
        assert obs.current() is tele
        if not tele.trace_enabled:
            assert ops._span("estimate", torch.ones(1)) is obs.NULL_SPAN
        _dispatch()
    assert obs.current() is obs.NOOP
    want = ["kernel.encode[torch:eager]", "kernel.estimate[torch:eager]"]
    assert [e["name"] for e in sink.events] == (
        want if tele.trace_enabled else [])
    assert [e["name"] for e in inner.events] == (
        want if case == "nested" else [])


def test_cli_flags_and_fingerprint(tmp_path):
    ap = argparse.ArgumentParser()
    obs.add_cli_flags(ap)
    assert obs.from_args(ap.parse_args([])) is obs.NOOP
    path = str(tmp_path / "m.jsonl")
    tele = obs.from_args(ap.parse_args(["--metrics", path, "--trace"]),
                         run="test")
    assert tele.trace_enabled
    tele.close()
    events = obs.parse_jsonl(path)
    assert jobs.validate_events(events) == []
    assert events[0]["run"] == "test"
    env = events[0]["env"]
    assert env["torch"] == torch.__version__ and "jax" not in env
    assert env["backend"] == ("cuda" if torch.cuda.is_available()
                              else "cpu")


# ------------------------------------------------------- sketch health

@pytest.fixture(scope="module")
def health_inputs():
    """A 3,000-element tree, a gradient with 64 heavy hitters over
    continuous noise, and its 5 x 4096 sketch (about 0.7 ids a cell)."""
    rng = np.random.default_rng(1)
    shapes = {"a": (40, 50), "b": (1000,)}
    grads = {k: rng.standard_normal(s).astype(np.float32) * 0.01
             for k, s in shapes.items()}
    flat = grads["b"]
    flat[rng.choice(1000, 64, replace=False)] += rng.uniform(
        1, 5, 64).astype(np.float32) * rng.choice([-1, 1], 64)
    cfg = JF.FetchSGDConfig(rows=5, cols=4096, k=64)
    jlay = JL.build_layout({k: jnp.zeros(s) for k, s in shapes.items()})
    table = np.asarray(JF.sketch_grads(
        {k: jnp.asarray(v) for k, v in grads.items()}, jlay, cfg))
    table = table + rng.standard_normal(table.shape).astype(np.float32) \
        * 1e-3
    return shapes, grads, table, cfg


def test_sketch_health_matches_reference(health_inputs):
    shapes, grads, table, jcfg = health_inputs
    tcfg = TF.FetchSGDConfig(rows=5, cols=4096, k=64)
    jlay = JL.build_layout({k: jnp.zeros(s) for k, s in shapes.items()})
    tlay = TL.build_layout({k: torch.zeros(s) for k, s in shapes.items()})
    jdense = jsh.flatten_dense({k: jnp.asarray(v) for k, v in grads.items()},
                               jlay)
    tdense = tsh.flatten_dense({k: torch.from_numpy(v)
                                for k, v in grads.items()}, tlay)
    assert np.array_equal(tdense.numpy(), np.asarray(jdense))
    want = jsh.recovery_error(jnp.asarray(table), jdense, jlay, jcfg)
    got = tsh.recovery_error(torch.from_numpy(table), tdense, tlay, tcfg)
    assert 0 < want["recovery_rel_err"] < 1
    assert got["heavy_hitter_overlap"] == want["heavy_hitter_overlap"] > 0.5
    np.testing.assert_allclose(got["recovery_rel_err"],
                               want["recovery_rel_err"], rtol=1e-5)
    rng = np.random.default_rng(2)
    su, se, agg = (rng.standard_normal((5, 4096)).astype(np.float32)
                   for _ in range(3))
    want = jsh.state_norms(JF.FetchSGDState(
        momentum_sketch=jnp.asarray(su), error_sketch=jnp.asarray(se),
        step=jnp.zeros((), jnp.int32)), jnp.asarray(agg))
    got = tsh.state_norms(TF.FetchSGDState(
        momentum_sketch=torch.from_numpy(su),
        error_sketch=torch.from_numpy(se), step=0), torch.from_numpy(agg))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


# ------------------------------------------------- instrumented runs

def fed_cfg(mod, case):
    kw = dict(CASES[case])
    kw.pop("n_clients", None)
    sm = mod.StragglerModel(**kw.pop("straggler", {}))
    sim = mod.SimTimeConfig(heterogeneity=mod.HeterogeneityConfig(**HET),
                            **kw.pop("sim", {}))
    return mod.FederationConfig(rounds=ROUNDS, straggler=sm, simtime=sim,
                                **kw)


@pytest.fixture(scope="module")
def micro():
    cfg = jsim.micro_cfg()
    jp = jax.tree_util.tree_map(np.asarray,
                                jt.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, tsim.micro_cfg(), jp


def dataset(micro, case):
    return jsim.micro_dataset(micro[0],
                              n_clients=CASES[case].get("n_clients", 64))


def port_run(micro, case, telemetry=None):
    _, tcfg, jp = micro
    return tfed.Orchestrator(
        tcfg, TF.FetchSGDConfig(**SKETCH), fed_cfg(tfed, case),
        dataset(micro, case), params=params_from_numpy(jp, "cpu"),
        lr_fn=t_linear_decay(LR, ROUNDS), device="cpu",
        telemetry=telemetry, health_every=1).run()


@pytest.fixture(scope="module")
def runs(micro, tmp_path_factory):
    """Each case through the reference and the port with telemetry (the
    port's kernel dispatch traced too, into a JSONL file; a health sample
    every round), and through the port without."""
    cfg, _, jp = micro
    grad_fn = jfed.orchestrator.make_grad_fn(cfg)
    out = {}
    for case in CASES:
        jsink = jobs.MemorySink()
        jtele = jobs.Telemetry([jsink], trace=True)
        jfed.Orchestrator(
            cfg, JF.FetchSGDConfig(**SKETCH), fed_cfg(jfed, case),
            dataset(micro, case),
            params=jax.tree_util.tree_map(jnp.asarray, jp),
            lr_fn=j_linear_decay(LR, ROUNDS), grad_fn=grad_fn,
            telemetry=jtele,
            health_every=ROUNDS if case == REF_HEALTH else 0).run()
        jtele.close()
        path = str(tmp_path_factory.mktemp(case) / "run.jsonl")
        sink = obs.MemorySink()
        tele = obs.Telemetry([obs.JsonlSink(path), sink], trace=True)
        tele.emit_meta(run="test", case=case)
        try:
            with obs.active(tele):
                inst = port_run(micro, case, tele)
        finally:
            tele.close()
        out[case] = dict(ref=jsink.events, events=sink.events, path=path,
                         inst=inst, base=port_run(micro, case))
    return out


def of_type(events, t):
    return [e for e in events if e["type"] == t]


@pytest.mark.parametrize("case", list(CASES))
def test_instrumented_records_identical(runs, case):
    """Telemetry draws from no RNG and changes no order."""
    base, inst = runs[case]["base"], runs[case]["inst"]
    assert [dataclasses.asdict(r) for r in inst.records] \
        == [dataclasses.asdict(r) for r in base.records]
    assert inst.losses == base.losses
    assert inst.traffic == base.traffic
    for (p, a), (_, b) in zip(TL.flatten(inst.params),
                              TL.flatten(base.params)):
        assert torch.equal(a, b), p


@pytest.mark.parametrize("case", list(CASES))
def test_round_events_follow_the_reference(runs, case):
    got, want = runs[case]["events"], runs[case]["ref"]
    rounds = [{k: v for k, v in e.items() if k not in UNSTABLE}
              for e in of_type(got, "round")]
    assert len(rounds) == ROUNDS
    assert rounds == [{k: v for k, v in e.items() if k not in UNSTABLE}
                      for e in of_type(want, "round")]
    for e, rec in zip(of_type(got, "round"), runs[case]["inst"].records):
        assert e["loss"] == rec.loss
    (snap,), (ref_snap,) = of_type(got, "metrics"), of_type(want, "metrics")
    assert snap["counters"] == ref_snap["counters"]
    assert snap["histograms"] == ref_snap["histograms"]
    gauges = {k: v for k, v in snap["gauges"].items()
              if k not in UNSTABLE_GAUGES}
    assert gauges == {k: v for k, v in ref_snap["gauges"].items()
                      if k not in UNSTABLE_GAUGES}
    assert any(k.startswith("agg.") for k in snap["counters"])


@pytest.mark.parametrize("case", list(CASES))
def test_spans_and_health(micro, runs, case):
    events = runs[case]["events"]
    health = of_type(events, "sketch_health")
    if case == REF_HEALTH:
        (ref_health,) = of_type(runs[case]["ref"], "sketch_health")
        assert health[0].keys() == ref_health.keys()
        assert health[0]["round"] == ref_health["round"] == 0
        assert (health[0]["recovery_rel_err"] is None) \
            == (ref_health["recovery_rel_err"] is None)
    # the vectorized event path dispatches lazy events: no health sample
    assert len(health) == (0 if CASES[case].get("vectorized") else ROUNDS)
    for h in health:
        assert all(math.isfinite(h[k]) for k in (
            "error_sketch_norm", "momentum_sketch_norm", "agg_table_norm"))
        if h["recovery_rel_err"] is not None:
            assert math.isfinite(h["recovery_rel_err"])
            assert 0.0 <= h["heavy_hitter_overlap"] <= 1.0
    spans = of_type(events, "span")
    names = [e["name"] for e in spans]
    port_only = ("kernel.", "fed.client.")
    ref_names = [e["name"] for e in of_type(runs[case]["ref"], "span")
                 if not e["name"].startswith(port_only)]
    assert [n for n in names if not n.startswith(port_only)] == ref_names
    # one batch, gradient and sketch span a computing client, in that
    # order, sharing its id: every client not dropped at dispatch is
    # computed within the run (async on the round clock, or the event
    # clock's full drain under tree)
    steps = [e for e in spans if e["name"].startswith("fed.client.")]
    recs = runs[case]["inst"].records
    assert len(steps) == 3 * sum(len(r.cohort) - r.n_dropped for r in recs)
    cohorts = {c for r in recs for c in r.cohort}
    for i in range(0, len(steps), 3):
        part = steps[i:i + 3]
        assert [e["name"] for e in part] == [
            "fed.client.batch", "fed.client.grad", "fed.client.sketch"]
        assert part[0]["client"] == part[1]["client"] \
            == part[2]["client"] in cohorts
        assert all("dev_s" not in e and "syncs" not in e for e in part)
    # the CPU dispatches to the plain twins: one estimate a chunk for each
    # server update and each health sample that compared a table
    n_chunks = TL.build_layout(params_from_numpy(micro[2], "cpu")).num_chunks
    updates = sum(r.n_fresh + r.n_late > 0
                  for r in runs[case]["inst"].records)
    samples = sum(h["recovery_rel_err"] is not None for h in health)
    assert names.count("kernel.estimate[torch:eager]") \
        == n_chunks * (updates + samples)
    assert names.count("kernel.momentum_error[torch:eager]") == updates
    assert names.count("kernel.topk_mask[torch:eager]") == updates
    parents = {e["parent"] for e in of_type(events, "span")
               if e["name"] == "fed.aggregate"}
    assert parents == {"fed.round"}


def test_stream_reads_in_the_reference_tools(runs, capsys):
    """The port's JSONL passes both validators and ``report_run.py``."""
    from repro.obs import schema as jschema
    from repro_torch.obs import schema as tschema
    spec = importlib.util.spec_from_file_location(
        "report_run", ROOT / "scripts" / "report_run.py")
    report_run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report_run)
    paths = [r["path"] for r in runs.values()]
    for path in paths:
        assert jobs.validate_jsonl(path) == [] == obs.validate_jsonl(path)
    assert tschema.main(paths) == 0 and jschema.main(paths) == 0
    assert report_run.main(paths) == 0
    out = capsys.readouterr().out
    assert "per-round (3 rounds)" in out and "sketch health" in out
    assert "kernel.estimate[torch:eager]" in out


def test_simulate_command_line_stream_validates(tmp_path):
    from repro.obs import schema as jschema
    path = str(tmp_path / "run.jsonl")
    lines: list[str] = []
    tsim.main(["--device", "cpu", "--clock", "event", "--population",
               "2000", "--rounds", "2", "--clients-per-round", "8",
               "--metrics", path, "--trace", "--obs-summary"],
              log=lines.append)
    assert lines[0] == f"telemetry: {path}"
    assert jschema.main([path]) == 0
    events = obs.parse_jsonl(path)
    assert len(of_type(events, "round")) == 2
    assert of_type(events, "meta")[0]["run"] == "simulate"
    assert obs.current() is obs.NOOP
