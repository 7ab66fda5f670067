"""Port parity for checkpoints and resume: ``repro_torch.fed.checkpoint``
against ``repro.fed.checkpoint``, and the orchestrator's resume.

The two packages share one on-disk format, so the cross-package cases are
exact: a checkpoint that either package writes restores bitwise in the
other, and both write the same members and sidecar for the same content.
The port's resumed runs are held to its uninterrupted runs byte for byte
on the CPU (records, losses, weights and server state), on both clocks
and on the vectorized event path at a population of 1,000: the
counterparts of ``tests/test_fed_runtime.py`` and
``tests/test_population.py``'s checkpoint tests.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fetchsgd as JF
from repro.fed import checkpoint as jckpt
from repro.fed import simtime as jsimtime
from repro_torch import fed
from repro_torch.core import fetchsgd as F
from repro_torch.core import layout as L
from repro_torch.fed import checkpoint as ckpt
from repro_torch.launch import simulate as tsim
from repro_torch.optim import triangular

CFG = F.FetchSGDConfig(rows=3, cols=1 << 10, k=64)
SKEWED = fed.HeterogeneityConfig(compute_median=1.0, compute_sigma=0.5,
                                 bandwidth_median=1e5, bandwidth_sigma=2.0)
SKEWED_LEGACY = dataclasses.replace(SKEWED, profile_stream="legacy")
EVENT_META = [dict(time=4.5, round_produced=1, slot=0, client=9,
                   produced=2.0, weight=1.5, loss=0.25),
              dict(time=6.0, round_produced=2, slot=1, client=4,
                   produced=3.0, weight=1.0, loss=0.5),
              dict(time=7.25, round_produced=2, slot=3, client=11,
                   produced=3.0, weight=0.75, loss=1.125)]
LATE_META = [dict(produced=1, arrival=3, weight=1.0),
             dict(produced=2, arrival=4, weight=0.5)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The micro model's ops are tiny: one intra-op thread is as fast
    alone and does not oversubscribe the cores when test files run in
    parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def content():
    """A checkpoint's content as numpy arrays: a nested params tree, both
    sketches, the step, a late buffer and in-flight event tables."""
    rng = np.random.default_rng(0)
    params = {"b": rng.standard_normal(5).astype(np.float32),
              "a": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                    "u": rng.standard_normal((2, 2, 2)).astype(np.float32)}}
    tables = rng.standard_normal((2 + len(LATE_META) + len(EVENT_META),
                                  CFG.rows, CFG.cols)).astype(np.float32)
    return params, tables


def torch_tree(tree):
    return L.tree_map(lambda a: torch.from_numpy(a.copy()), tree)


def jax_tree(tree):
    return L.tree_map(jnp.asarray, tree)


def save_port(d, content, round_idx=3, **kw):
    params, tables = content
    state = F.FetchSGDState(momentum_sketch=torch.from_numpy(tables[0]),
                            error_sketch=torch.from_numpy(tables[1]), step=7)
    late = [dict(table=torch.from_numpy(t), **m)
            for t, m in zip(tables[2:4], LATE_META)]
    evs = [fed.Event(table=torch.from_numpy(t), **m)
           for t, m in zip(tables[4:], EVENT_META)]
    return ckpt.save(d, torch_tree(params), state, round_idx,
                     extra={"aggregate": "async", "clock": "event"},
                     late_buffer=late, simtime={"now": 5.5, "events": evs},
                     **kw)


def save_reference(d, content, round_idx=3):
    params, tables = content
    state = JF.FetchSGDState(momentum_sketch=jnp.asarray(tables[0]),
                             error_sketch=jnp.asarray(tables[1]),
                             step=jnp.asarray(7, jnp.int32))
    late = [dict(table=jnp.asarray(t), **m)
            for t, m in zip(tables[2:4], LATE_META)]
    evs = [jsimtime.Event(table=jnp.asarray(t), **m)
           for t, m in zip(tables[4:], EVENT_META)]
    return jckpt.save(d, jax_tree(params), state, round_idx,
                      extra={"aggregate": "async", "clock": "event"},
                      late_buffer=late, simtime={"now": 5.5, "events": evs})


def assert_restored(ck, content, to_np):
    """Every tensor of ``ck`` bitwise equal to ``content``, every sidecar
    field as saved."""
    params, tables = content
    got = dict(L.flatten(ck.params))
    for path, want in L.flatten(params):
        a = to_np(got[path])
        assert a.dtype == want.dtype and np.array_equal(a, want), path
    assert np.array_equal(to_np(ck.opt_state.momentum_sketch), tables[0])
    assert np.array_equal(to_np(ck.opt_state.error_sketch), tables[1])
    assert int(ck.opt_state.step) == 7 and ck.round_idx == 3
    assert ck.extra == {"aggregate": "async", "clock": "event"}
    for e, t, m in zip(ck.late_buffer, tables[2:4], LATE_META):
        assert np.array_equal(to_np(e["table"]), t)
        assert {k: e[k] for k in m} == m
    assert ck.simtime["now"] == 5.5
    assert len(ck.simtime["events"]) == len(EVENT_META)
    for ev, t, m in zip(ck.simtime["events"], tables[4:], EVENT_META):
        assert ev.meta() == m
        assert np.array_equal(to_np(ev.table), t)


def port_templates(content):
    params, _ = content
    return (torch_tree(L.tree_map(np.zeros_like, params)),
            F.init_state(CFG, "cpu"))


def test_round_trip_is_bitwise(tmp_path, content):
    save_port(str(tmp_path), content)
    ck = ckpt.restore(str(tmp_path), *port_templates(content))
    assert_restored(ck, content, lambda t: t.numpy())
    assert ck.opt_state.momentum_sketch.device.type == "cpu"


def test_reference_checkpoint_restores_in_the_port(tmp_path, content):
    save_reference(str(tmp_path), content)
    ck = ckpt.restore(str(tmp_path), *port_templates(content))
    assert_restored(ck, content, lambda t: t.numpy())


def test_port_checkpoint_restores_in_the_reference(tmp_path, content):
    save_port(str(tmp_path), content)
    params, _ = content
    ck = jckpt.restore(str(tmp_path),
                       jax_tree(L.tree_map(np.zeros_like, params)),
                       JF.init_state(JF.FetchSGDConfig(
                           rows=CFG.rows, cols=CFG.cols, k=CFG.k)))
    assert_restored(ck, content, np.asarray)


def test_both_packages_write_the_same_files(tmp_path, content):
    d1, d2 = str(tmp_path / "ref"), str(tmp_path / "port")
    save_reference(d1, content)
    save_port(d2, content)
    assert sorted(os.listdir(d1)) == sorted(os.listdir(d2))
    for name in os.listdir(d1):
        p1, p2 = os.path.join(d1, name), os.path.join(d2, name)
        if name.endswith(".json"):
            with open(p1) as f1, open(p2) as f2:
                assert json.load(f1) == json.load(f2)
        else:
            with np.load(p1) as a, np.load(p2) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    assert a[k].dtype == b[k].dtype, k
                    assert np.array_equal(a[k], b[k]), k


def test_restore_empty_dir_is_none(tmp_path):
    assert ckpt.restore(str(tmp_path), {}, F.init_state(CFG)) is None
    assert ckpt.latest_round(str(tmp_path / "missing")) is None


def test_shape_mismatch_fails_loudly(tmp_path):
    state = F.init_state(CFG)
    ckpt.save(str(tmp_path), {"w": torch.zeros(4)}, state, 0)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(5)}, state)
    with pytest.raises(ValueError, match="param leaves"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(4),
                                     "v": torch.zeros(1)}, state)
    with pytest.raises(ValueError, match="FetchSGDConfig"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(4)},
                     F.init_state(dataclasses.replace(CFG, cols=512)))


def test_prune_keeps_newest(tmp_path):
    state = F.init_state(CFG)
    for r in range(5):
        ckpt.save(str(tmp_path), {"w": torch.zeros(2)}, state, r, keep=2)
    assert ckpt.latest_round(str(tmp_path)) == 4
    assert len(os.listdir(tmp_path)) == 4
    assert ckpt.restore(str(tmp_path), {"w": torch.zeros(2)}, state,
                        round_idx=0) is None


def test_legacy_per_event_checkpoint_migrates(tmp_path, content):
    """The pre-columnar format: one ``event_%05d`` member per in-flight
    event and the events' fields in the sidecar."""
    params, tables = content
    d = str(tmp_path)
    path = ckpt.save(d, torch_tree(params), F.init_state(CFG), 3)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    for i, t in enumerate(tables[4:]):
        arrays[f"event_{i:05d}"] = t
    np.savez(path, **arrays)
    meta_path = path[:-len(".npz")] + ".json"
    with open(meta_path) as f:
        info = json.load(f)
    info["simtime"] = {"now": 4.0, "events": EVENT_META}   # no n_events
    with open(meta_path, "w") as f:
        json.dump(info, f)
    ck = ckpt.restore(d, *port_templates(content))
    assert ck.simtime["now"] == 4.0
    for ev, m, t in zip(ck.simtime["events"], EVENT_META, tables[4:]):
        assert ev.meta() == m
        assert np.array_equal(ev.table.numpy(), t)


def test_checkpoint_rejects_lazy_events(tmp_path):
    lazy = fed.Event(time=2.0, round_produced=0, slot=0, client=0,
                     produced=0.0, weight=1.0, loss=None, table=None)
    with pytest.raises(ValueError, match="lazy event"):
        ckpt.save(str(tmp_path), {"w": torch.zeros(2)}, F.init_state(CFG),
                  0, simtime={"now": 1.0, "events": [lazy]})


# ---------------------------------------------------------------- resume

@pytest.fixture(scope="module")
def micro():
    cfg = tsim.micro_cfg()
    return cfg, tsim.micro_dataset(cfg)


def orch(micro, *, rounds, vectorized=False, aggregate="async",
         clock="event", population=None, ckdir=None, every=0,
         total_rounds=None, het=SKEWED, straggle_prob=0.25):
    cfg, ds = micro
    if population is not None:
        ds = tsim.micro_dataset(cfg, n_clients=population)
    fed_cfg = fed.FederationConfig(
        rounds=rounds, clients_per_round=6, aggregate=aggregate,
        clock=clock, vectorized=vectorized, seed=0,
        simtime=fed.SimTimeConfig(
            heterogeneity=het,
            quorum=3 if (aggregate == "async" and clock == "event")
            else None),
        straggler=fed.StragglerModel(dropout_prob=0.15,
                                     straggle_prob=straggle_prob,
                                     max_delay=2),
        checkpoint_dir=ckdir, checkpoint_every=every)
    return fed.Orchestrator(cfg, CFG, fed_cfg, ds, device="cpu",
                            lr_fn=triangular(0.2, total_rounds or rounds))


def assert_same_run(full, resumed, start):
    assert [dataclasses.asdict(r) for r in full.records][start:] \
        == [dataclasses.asdict(r) for r in resumed.records]
    assert full.losses[start:] == resumed.losses
    for (p, a), (_, b) in zip(L.flatten(full.params),
                              L.flatten(resumed.params)):
        assert torch.equal(a, b), p
    for k in ("momentum_sketch", "error_sketch"):
        assert torch.equal(getattr(full.opt_state, k),
                           getattr(resumed.opt_state, k))
    assert full.opt_state.step == resumed.opt_state.step
    for k in ("pending_late", "in_flight", "t_virtual"):
        assert full.extras[k] == resumed.extras[k], k


@pytest.mark.parametrize("clock,vectorized,population", [
    ("round", False, None), ("event", False, None), ("event", True, 1000)],
    ids=["round-async", "event-async", "vectorized-event-1k"])
def test_resume_is_byte_identical(micro, tmp_path, clock, vectorized,
                                  population):
    """Rounds 2-3 of a run resumed from its round-1 checkpoint equal the
    uninterrupted run's: the late buffer (round clock), the event queue
    and virtual clock (event clock; lazy in-flight events computed for the
    save on the vectorized path) all come back."""
    kw = dict(clock=clock, vectorized=vectorized, population=population,
              total_rounds=4, straggle_prob=0.5 if clock == "round" else 0.25)
    full = orch(micro, rounds=4, **kw).run()
    d = str(tmp_path / "ck")
    first = orch(micro, rounds=2, ckdir=d, every=1, **kw).run()
    assert first.extras["start_round"] == 0
    resumed = orch(micro, rounds=4, ckdir=d, every=1, **kw)
    assert resumed.start_round == 2
    res = resumed.run()
    assert res.extras["start_round"] == 2
    assert_same_run(full, res, 2)
    # the checkpoint carried what the resumed run needed
    with open(os.path.join(d, "ckpt_00000001.json")) as f:
        info = json.load(f)
    if clock == "round":
        assert info["late"] and info["simtime"] is None
    else:
        assert info["simtime"]["n_events"] > 0


def test_vectorized_checkpoints_content_identical(micro, tmp_path):
    d1, d2 = str(tmp_path / "obj"), str(tmp_path / "vec")
    orch(micro, rounds=4, aggregate="flat", ckdir=d1, every=2).run()
    orch(micro, rounds=4, aggregate="flat", vectorized=True, ckdir=d2,
         every=2).run()
    names = sorted(os.listdir(d1))
    assert names == sorted(os.listdir(d2)) and names
    for name in names:
        p1, p2 = os.path.join(d1, name), os.path.join(d2, name)
        if name.endswith(".json"):
            with open(p1) as f1, open(p2) as f2:
                assert json.load(f1) == json.load(f2), name
        else:
            with np.load(p1) as a, np.load(p2) as b:
                assert sorted(a.files) == sorted(b.files), name
                for k in a.files:
                    assert np.array_equal(a[k], b[k]), (name, k)


@pytest.mark.parametrize("stream", ["counter", "legacy"])
def test_checkpoint_persists_profile_stream(micro, tmp_path, stream):
    het = dataclasses.replace(SKEWED, profile_stream=stream)
    d = str(tmp_path)
    orch(micro, rounds=2, aggregate="flat", vectorized=True, ckdir=d,
         every=1, het=het).run()
    sidecars = sorted(f for f in os.listdir(d) if f.endswith(".json"))
    assert sidecars
    for name in sidecars:
        with open(os.path.join(d, name)) as f:
            assert json.load(f)["extra"]["profile_stream"] == stream, name
    # a same-stream resume is accepted
    assert orch(micro, rounds=2, aggregate="flat", vectorized=True,
                ckdir=d, het=het).start_round == 2


def test_checkpoint_refuses_mismatched_profile_stream(micro, tmp_path):
    d = str(tmp_path)
    orch(micro, rounds=2, aggregate="flat", vectorized=True, ckdir=d,
         every=1, het=SKEWED).run()
    with pytest.raises(ValueError, match="profile_stream"):
        orch(micro, rounds=2, aggregate="flat", vectorized=True, ckdir=d,
             het=SKEWED_LEGACY)


def test_checkpoint_missing_stream_key_means_legacy(micro, tmp_path):
    """Checkpoints from before the knob carry no ``profile_stream``: a
    legacy resume loads them and a counter resume is refused."""
    d = str(tmp_path)
    orch(micro, rounds=2, aggregate="flat", vectorized=True, ckdir=d,
         every=1, het=SKEWED_LEGACY).run()
    for name in os.listdir(d):
        if not name.endswith(".json"):
            continue
        p = os.path.join(d, name)
        with open(p) as f:
            info = json.load(f)
        info["extra"].pop("profile_stream")
        with open(p, "w") as f:
            json.dump(info, f)
    orch(micro, rounds=2, aggregate="flat", vectorized=True, ckdir=d,
         het=SKEWED_LEGACY)
    with pytest.raises(ValueError, match="profile_stream"):
        orch(micro, rounds=2, aggregate="flat", vectorized=True, ckdir=d,
             het=SKEWED)


def test_command_line_resumes_an_interrupted_run(tmp_path, monkeypatch):
    """``simulate --checkpoint-dir D --checkpoint-every 3``, stopped in
    round 4 and run again, resumes at round 3 and prints what the
    uninterrupted run prints for rounds 3-5; once more, it has nothing to
    do."""
    argv = ["--device", "cpu", "--aggregate", "async", "--straggle-prob",
            "0.5", "--rounds", "6", "--checkpoint-every", "3",
            "--checkpoint-dir", str(tmp_path)]
    whole: list[str] = []
    tsim.main(argv[:-2], log=whole.append)

    run_round = fed.Orchestrator.run_round

    def stop_in_round_4(self, r):
        if r == 4:
            raise KeyboardInterrupt
        return run_round(self, r)
    monkeypatch.setattr(fed.Orchestrator, "run_round", stop_in_round_4)
    with pytest.raises(KeyboardInterrupt):
        tsim.main(argv, log=lambda *_: None)
    monkeypatch.undo()
    assert ckpt.latest_round(str(tmp_path)) == 2
    resumed: list[str] = []
    tsim.main(argv, log=resumed.append)
    rounds = [ln for ln in resumed if ln.startswith("round ")]
    assert rounds == [ln for ln in whole
                      if ln.startswith(("round 3", "round 4", "round 5"))]
    again: list[str] = []
    tsim.main(argv, log=again.append)
    assert again[-1] == (f"nothing to do: checkpoint in {tmp_path} already "
                         f"covers all 6 rounds")
