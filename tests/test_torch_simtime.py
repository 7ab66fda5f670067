"""Port parity for the event clock's primitives:
``repro_torch.fed.profile_rng`` and ``repro_torch.fed.simtime`` against
``repro.fed``'s.

Both are numpy in both packages, so every comparison is exact: the
Philox words and uniforms bit for bit, profiles field for field, event
times (float64, the reference's operations in its order) with ``==``, and
queues by the sequence of keys they pop.
"""

import dataclasses
import math

import numpy as np
import pytest

from repro.fed import profile_rng as jpr
from repro.fed import simtime as jst
from repro_torch.fed import profile_rng as tpr
from repro_torch.fed import simtime as tst

# Random123 reference vectors for philox4x32 with 10 rounds
# (Salmon et al., SC'11, kat_vectors): (counter, key) -> output words,
# as in tests/test_profile_rng.py.
KATS = [
    (((0x00000000, 0x00000000, 0x00000000, 0x00000000),
      (0x00000000, 0x00000000)),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    (((0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff),
      (0xffffffff, 0xffffffff)),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    (((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
      (0xa4093822, 0x299f31d0)),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]

WINDOWED = dict(compute_median=1.0, compute_sigma=0.5,
                bandwidth_median=1e5, bandwidth_sigma=2.0, weight_sigma=0.3,
                avail_period=50.0, avail_duty_min=0.4, avail_duty_max=0.9)
SKEWED = dict(compute_median=1.0, compute_sigma=0.5, bandwidth_median=1e5,
              bandwidth_sigma=2.0)
HETS = {f"{name}-{stream}": dict(kw, profile_stream=stream)
        for name, kw in (("windowed", WINDOWED), ("skewed", SKEWED))
        for stream in ("counter", "legacy")}
# both sides of the default 4096-id block, a 16-id block's edges, and the
# top of a 10^6 population
IDS = [0, 1, 15, 16, 17, 255, 4095, 4096, 4097, 12345, 10**6 - 1]


def het_pair(name):
    return (jst.HeterogeneityConfig(**HETS[name]),
            tst.HeterogeneityConfig(**HETS[name]))


# ------------------------------------------------------------ profile rng


def test_the_port_keeps_its_own_copy():
    assert tpr.__name__ == "repro_torch.fed.profile_rng"
    assert tst.profile_rng is tpr
    assert (tpr.PROFILE_STREAM, tpr.COLS) == (jpr.PROFILE_STREAM, jpr.COLS)


@pytest.mark.parametrize("inputs,expected", KATS,
                         ids=["zeros", "ones", "pi"])
def test_philox_known_answer_vectors(inputs, expected):
    counter, key = inputs
    out = tpr.philox4x32(key, tuple(np.asarray([c], np.uint64)
                                    for c in counter))
    assert tuple(int(w[0]) for w in out) == expected


def test_philox_words_match_the_reference():
    rng = np.random.default_rng(0)
    ctr = tuple(rng.integers(0, 1 << 32, size=257, dtype=np.uint64)
                for _ in range(4))
    for key in ((12345, 67890), (0, 0xFFFFFFFF)):
        for rounds in (7, 10):
            for got, want in zip(tpr.philox4x32(key, ctr, rounds),
                                 jpr.philox4x32(key, ctr, rounds)):
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3, (1 << 40) + 7])
def test_uniforms_and_normals_match_the_reference_bitwise(seed):
    ids = np.concatenate([np.arange(4096), [1 << 32, (1 << 33) + 5]])
    for col in range(len(tpr.COLS)):
        u = tpr.uniforms(seed, ids, col)
        np.testing.assert_array_equal(u.view(np.uint64),
                                      jpr.uniforms(seed, ids, col)
                                      .view(np.uint64))
    u = np.concatenate([np.linspace(1e-4, 1 - 1e-4, 1001),
                        [1e-6, 1e-9, 2e-13, 1 - 1e-6, 1 - 1e-9, 0.5]])
    np.testing.assert_array_equal(tpr.normal_icdf(u).view(np.uint64),
                                  jpr.normal_icdf(u).view(np.uint64))


@pytest.mark.parametrize("name", ["windowed-counter", "skewed-counter"])
@pytest.mark.parametrize("seed", [0, 5])
def test_profile_columns_match_the_reference_bitwise(name, seed):
    jcfg, tcfg = het_pair(name)
    ids = np.arange(5000, dtype=np.int64) * 199
    got = tpr.profile_columns(tcfg, seed, ids)
    want = jpr.profile_columns(jcfg, seed, ids)
    assert list(got) == list(want) == list(tpr.COLS)
    for col in tpr.COLS:
        np.testing.assert_array_equal(got[col].view(np.uint64),
                                      want[col].view(np.uint64))


def test_negative_ids_raise():
    with pytest.raises(ValueError, match=">= 0"):
        tpr.uniforms(0, np.asarray([1, -2]), 0)
    with pytest.raises(ValueError, match=">= 0"):
        tst.PopulationModel(het_pair("skewed-counter")[1]).columns(
            np.asarray([3, -1]))


# ---------------------------------------------------------------- profiles


@pytest.mark.parametrize("name", list(HETS))
@pytest.mark.parametrize("seed", [0, 3])
def test_profiles_match_the_reference_in_both_streams(name, seed):
    """Scalar and vectorized samplers, port and reference: four views of
    one stream, field for field."""
    jcfg, tcfg = het_pair(name)
    jh, th = jst.HeterogeneityModel(jcfg, seed), tst.HeterogeneityModel(
        tcfg, seed)
    tp = tst.PopulationModel(tcfg, seed, block=16)
    jp = jst.PopulationModel(jcfg, seed, block=16)
    for i in IDS:
        want = dataclasses.asdict(jh.profile(i))
        assert dataclasses.asdict(th.profile(i)) == want, i
        assert dataclasses.asdict(tp.profile(i)) == want, i
    got, want = tp.columns(np.asarray(IDS)), jp.columns(np.asarray(IDS))
    for col in tst.PopulationModel.COLS:
        np.testing.assert_array_equal(got[col], want[col])


def test_population_block_cache_is_a_bounded_lru():
    tcfg = het_pair("skewed-counter")[1]
    pop = tst.PopulationModel(tcfg, seed=0, block=16, max_cached_blocks=3)
    first = pop.columns(np.arange(16))
    pop.columns(np.arange(128))
    assert pop.cache_blocks == 3
    again = pop.columns(np.arange(16))
    for col in pop.COLS:
        np.testing.assert_array_equal(first[col], again[col])


@pytest.mark.parametrize("name", ["windowed-counter", "windowed-legacy"])
def test_finish_times_equal_the_scalar_path(name):
    jcfg, tcfg = het_pair(name)
    pop = tst.PopulationModel(tcfg, seed=1)
    scalar = tst.HeterogeneityModel(tcfg, seed=1)
    jpop = jst.PopulationModel(jcfg, seed=1)
    ids = np.arange(64)
    cols, jcols = pop.columns(ids), jpop.columns(ids)
    scale = 1.0 + (ids % 3)
    for t in (0.0, 13.7, 49.9, 1234.5):
        nxt = pop.next_available(cols, t)
        fin = pop.finish_times(cols, t, 12288, compute_scale=scale)
        np.testing.assert_array_equal(fin, jpop.finish_times(
            jcols, t, 12288, compute_scale=scale))
        for j, i in enumerate(ids):
            p = scalar.profile(int(i))
            assert nxt[j] == p.next_available(t)
            assert fin[j] == p.finish_time(t, 12288,
                                           compute_scale=float(scale[j]))


def test_client_profile_matches_the_reference():
    kw = dict(compute_seconds=1.3, bandwidth=7e4, avail_period=10.0,
              avail_duty=0.35, avail_offset=2.5)
    tp, jp = tst.ClientProfile(**kw), jst.ClientProfile(**kw)
    for t in np.linspace(0.0, 31.0, 125):
        assert tp.next_available(t) == jp.next_available(t)
        assert tp.finish_time(t, 49152, compute_scale=2.0) \
            == jp.finish_time(t, 49152, compute_scale=2.0)
    assert tp.upload_seconds(49152) == jp.upload_seconds(49152)


# ------------------------------------------------------------------ queues


def schedule(rng, n_ops):
    """Pushes (some in the past, some at tied whole seconds) and pops."""
    ops, t_hi, slot = [], 0.0, 0
    for _ in range(n_ops):
        if rng.random() < 0.55:
            if rng.random() < 0.25 and ops:
                t = rng.uniform(0.0, t_hi)
            else:
                t = t_hi = t_hi + rng.exponential(2.0)
            if rng.random() < 0.3:
                t = math.floor(t)
            ops.append(("push", float(t), int(rng.integers(0, 4)), slot))
            slot += 1
        else:
            ops.append(("pop",))
    return ops


def event(mod, t, r, slot):
    return mod.Event(time=t, round_produced=r, slot=slot, client=slot,
                     produced=0.0, weight=1.0, loss=None, table=None)


def drive(mod, queue, ops):
    """Pop keys (or 'empty'), queue lengths and peeked times."""
    trace = []
    for op in ops:
        if op[0] == "push":
            queue.push(event(mod, *op[1:]))
        elif len(queue):
            trace.append(queue.pop().key())
        else:
            with pytest.raises(ValueError, match="no client upload"):
                queue.pop()
            trace.append("empty")
        trace.append((len(queue), queue.peek_time()))
    return trace


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind,bucket_s", [("heap", None), ("bucketed", 0.1),
                                           ("bucketed", 3.7)])
def test_queues_pop_as_the_reference(seed, kind, bucket_s):
    ops = schedule(np.random.default_rng(seed), 150)

    def make(mod):
        return (mod.EventQueue() if kind == "heap"
                else mod.BucketedEventQueue(bucket_s=bucket_s))
    want = drive(jst, make(jst), ops)
    assert drive(tst, make(tst), ops) == want
    # the bucketed queue pops as the heap does
    assert drive(tst, tst.EventQueue(), ops) == want


@pytest.mark.parametrize("kind", ["heap", "bucketed"])
def test_queue_state_round_trips_as_the_reference(kind):
    rng = np.random.default_rng(11)
    times = rng.uniform(0, 40, 60)

    def run(mod):
        q = (mod.EventQueue() if kind == "heap"
             else mod.BucketedEventQueue(bucket_s=2.0))
        for i, t in enumerate(times):
            q.push(event(mod, float(math.floor(t) if i % 4 == 0 else t),
                         i % 3, i))
        popped = [q.pop().key() for _ in range(17)]
        saved = [e.key() for e in q.state()]
        q2 = type(q)() if kind == "heap" else type(q)(bucket_s=2.0)
        q2.load_state(q.state())
        rest = [q2.pop().key() for _ in range(len(q2))]
        assert rest == [q.pop().key() for _ in range(len(q))]
        return popped, saved, rest
    assert run(tst) == run(jst)


def test_tied_times_pop_in_key_order():
    q = tst.BucketedEventQueue(bucket_s=10.0)
    keys = [(5.0, 1, 2), (5.0, 0, 7), (5.0, 0, 3), (5.0, 1, 0)]
    q.push_batch(event(tst, *k) for k in keys)
    assert [q.pop().key() for _ in keys] == sorted(keys)


# --------------------------------------------------------------- configs


@pytest.mark.parametrize("mod_kw", [
    ("HeterogeneityConfig", dict(profile_stream="quantum")),
    ("HeterogeneityConfig", dict(bandwidth_median=0.0)),
    ("HeterogeneityConfig", dict(avail_duty_min=0.9, avail_duty_max=0.4)),
    ("SimTimeConfig", dict(quorum=0)),
    ("SimTimeConfig", dict(staleness_lambda=-0.1)),
    ("SimTimeConfig", dict(queue_bucket_s=0.0)),
    ("ClientProfile", dict(compute_seconds=1.0, bandwidth=0.0)),
    ("ClientProfile", dict(compute_seconds=1.0, bandwidth=1.0,
                           avail_duty=0.0)),
])
def test_bad_knobs_raise_as_in_the_reference(mod_kw):
    name, kw = mod_kw
    for mod in (jst, tst):
        with pytest.raises(ValueError):
            getattr(mod, name)(**kw)
    with pytest.raises(ValueError, match="bucket_s"):
        tst.BucketedEventQueue(bucket_s=0.0)
    with pytest.raises(ValueError, match="finite"):
        tst.BucketedEventQueue().push(event(tst, float("inf"), 0, 0))
