"""Port parity for the aggregation policies: ``repro_torch.fed.aggregator``
against ``repro.fed.aggregator`` on the same numpy tables.

Tables hold small integers and weights are binary fractions, so every
float32 sum, product and the final division round alike in both packages
whatever the framework: the merged tables are compared bit for bit, and
the stats field for field (``dataclasses.asdict``).  The cases are those
of ``tests/test_fed_runtime.py`` (linearity, the async buffer, bytes) and
of the event clock in ``tests/test_simtime.py`` and
``tests/test_population.py`` (per-edge seconds, the timed buffer).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fetchsgd as JF
from repro.fed import aggregator as JA
from repro_torch.core import fetchsgd as TF
from repro_torch.fed import aggregator as TA

SKETCH = dict(rows=3, cols=1 << 10, k=64)
JCFG, TCFG = JF.FetchSGDConfig(**SKETCH), TF.FetchSGDConfig(**SKETCH)


def tables(seed: int, n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(-50, 51, (3, 1 << 10)).astype(np.float32)
            for _ in range(n)]


def make(policy: str, **kw):
    return (JA.make_aggregator(policy, JCFG, **kw),
            TA.make_aggregator(policy, TCFG, **kw))


def fields(stats) -> dict:
    """The stats as a dict, the per-edge seconds and critical path too."""
    return dict(dataclasses.asdict(stats),
                critical_path_s=stats.critical_path_s)


def assert_same(ref, port):
    (jt, js), (tt, ts) = ref, port
    np.testing.assert_array_equal(np.asarray(jt).view(np.uint32),
                                  tt.numpy().view(np.uint32))
    assert fields(js) == fields(ts)
    assert (js.upload_bytes, js.root_ingress_tables) \
        == (ts.upload_bytes, ts.root_ingress_tables)


def both(agg_pair, ts, method="aggregate", **kw):
    ja, ta = agg_pair
    jts, tts = [jnp.asarray(t) for t in ts], [torch.from_numpy(t) for t in ts]
    if method == "aggregate_stream":
        w = kw.pop("weights", None) or [1.0] * len(ts)
        return (ja.aggregate_stream(zip(jts, w), **kw),
                ta.aggregate_stream(zip(tts, w), **kw))
    return ja.aggregate(jts, **kw), ta.aggregate(tts, **kw)


@pytest.mark.parametrize("method", ["aggregate", "aggregate_stream"])
@pytest.mark.parametrize("policy,kw", [("flat", {}), ("tree", {"fanout": 2}),
                                       ("tree", {"fanout": 3}),
                                       ("tree", {"fanout": 8}),
                                       ("async", {})])
@pytest.mark.parametrize("n", [0, 1, 2, 5, 16, 23])
def test_merges_match_the_reference(method, policy, kw, n):
    ts = tables(n, n)
    assert_same(*both(make(policy, **kw), ts, method))
    # tree equals flat and async without staleness equals flat, bitwise on
    # integer tables, in the port as in the reference
    flat = TA.FlatAggregator(TCFG).aggregate([torch.from_numpy(t)
                                              for t in ts])[0]
    got = both(make(policy, **kw), ts, method)[1][0]
    assert torch.equal(got, flat)


@pytest.mark.parametrize("policy,kw", [("flat", {}), ("tree", {"fanout": 2}),
                                       ("async", {})])
@pytest.mark.parametrize("method", ["aggregate", "aggregate_stream"])
def test_weighted_merges_match_the_reference(policy, kw, method):
    ts = tables(7, 7)
    w = [0.5, 2.0, 1.0, 1.5, 0.75, 1.25, 3.0]
    assert_same(*both(make(policy, **kw), ts, method, weights=w))


def test_weighted_total_is_the_references_sum():
    # real weights: ``aggregate`` sums them as the reference does (Python's
    # compensated ``sum``), ``aggregate_stream`` one by one as the
    # reference's stream does
    rng = np.random.default_rng(37)
    w = rng.uniform(0.5, 2.0, size=37).tolist()
    ts = tables(3, 37)
    for method in ("aggregate", "aggregate_stream"):
        (_, js), (_, tts) = both(make("flat"), ts, method, weights=list(w))
        assert js.total_weight == tts.total_weight


def test_staleness_discounted_merge_matches_the_reference():
    t = tables(1, 3)
    ja, ta = make("async", discount=0.5)
    ja.submit(jnp.asarray(t[0]), produced_round=0, arrival_round=2)
    ta.submit(torch.from_numpy(t[0]), produced_round=0, arrival_round=2)
    ref, port = both((ja, ta), t[1:], round_idx=2)
    assert_same(ref, port)
    assert port[1].n_late == 1 and port[1].max_staleness == 2
    assert port[1].total_weight == 2.25
    np.testing.assert_array_equal(
        port[0].numpy(), (t[1] + t[2] + np.float32(0.25) * t[0]) / 2.25)


def test_late_entries_weights_and_drops_match_the_reference():
    t = tables(2, 6)
    ja, ta = make("async", discount=0.9, max_staleness=2)
    plan = [(0, 5, 1.0), (0, 1, 2.0), (1, 2, 0.5), (0, 2, 1.0)]
    for i, (p, a, w) in enumerate(plan):
        ja.submit(jnp.asarray(t[i]), produced_round=p, arrival_round=a,
                  weight=w)
        ta.submit(torch.from_numpy(t[i]), produced_round=p, arrival_round=a,
                  weight=w)
    # round 3: (0, 1) and (0, 2) are 3 rounds stale (> 2): dropped;
    # (1, 2) merges with 0.5 * 0.9**2; (0, 5) has not arrived
    ref, port = both((ja, ta), t[4:], round_idx=3)
    assert_same(ref, port)
    assert port[1].n_late == 1 and ta.pending() == ja.pending() == 1
    assert [(e["produced"], e["arrival"], e["weight"]) for e in ta.state()] \
        == [(e["produced"], e["arrival"], e["weight"]) for e in ja.state()]
    ta2 = TA.AsyncBufferedAggregator(TCFG)
    ta2.load_state(ta.state())
    assert ta2.pending() == 1


def test_not_yet_arrived_stays_buffered():
    t = tables(3, 2)
    ja, ta = make("async")
    ja.submit(jnp.asarray(t[0]), produced_round=0, arrival_round=5)
    ta.submit(torch.from_numpy(t[0]), produced_round=0, arrival_round=5)
    ref, port = both((ja, ta), t[1:], round_idx=1)
    assert_same(ref, port)
    assert port[1].n_late == 0 and ta.pending() == 1


def test_too_stale_is_dropped():
    t = tables(4, 2)
    ja, ta = make("async", max_staleness=2)
    ja.submit(jnp.asarray(t[0]), produced_round=0, arrival_round=1)
    ta.submit(torch.from_numpy(t[0]), produced_round=0, arrival_round=1)
    ref, port = both((ja, ta), t[1:], round_idx=10)
    assert_same(ref, port)
    assert port[1].n_late == 0 and ta.pending() == 0
    np.testing.assert_array_equal(port[0].numpy(), t[1])


@pytest.mark.parametrize("policy,kw", [("flat", {}), ("tree", {"fanout": 2}),
                                       ("async", {})])
def test_empty_round_has_no_levels_and_zero_weight(policy, kw):
    ref, port = both(make(policy, **kw), [])
    assert_same(ref, port)
    assert port[1].levels == () and port[1].total_weight == 0
    assert not port[0].any()


def test_late_only_round_counts_its_messages():
    t = tables(5, 1)
    ja, ta = make("async")
    ja.submit(jnp.asarray(t[0]), produced_round=0, arrival_round=1)
    ta.submit(torch.from_numpy(t[0]), produced_round=0, arrival_round=1)
    ref, port = both((ja, ta), [], round_idx=1)
    assert_same(ref, port)
    assert port[1].upload_bytes == TF.upload_bytes(TCFG)


@pytest.mark.parametrize("n,fanout", [(1, 4), (6, 2), (23, 4), (37, 3)])
def test_byte_accounting_matches_the_reference(n, fanout):
    assert fields(TA.AggregationStats("tree", n, 0, n, TA.tree_levels(
        n, fanout, 100))) == fields(JA.AggregationStats(
            "tree", n, 0, n, JA.tree_levels(n, fanout, 100)))
    zeros = [np.zeros((3, 1 << 10), np.float32)] * n
    ref, port = both(make("tree", fanout=fanout), zeros)
    assert_same(ref, port)
    assert [(lv.n_messages, lv.bytes_on_wire) for lv in port[1].levels] \
        == TF.tree_upload_bytes(TCFG, n, fanout)
    assert port[1].root_ingress_tables <= max(fanout, 1)
    ref, port = both(make("flat"), zeros)
    assert_same(ref, port)
    assert port[1].upload_bytes == n * TF.upload_bytes(TCFG)


def test_bad_arguments_raise_as_in_the_reference():
    with pytest.raises(ValueError):
        TA.make_aggregator("gossip", TCFG)
    with pytest.raises(ValueError):
        TA.TreeAggregator(TCFG, fanout=1)
    with pytest.raises(ValueError):
        TA.AsyncBufferedAggregator(TCFG, discount=0.0)
    with pytest.raises(ValueError):
        TA.AsyncBufferedAggregator(TCFG).submit(
            torch.zeros(3, 1 << 10), produced_round=2, arrival_round=2)
    with pytest.raises(ValueError, match="weights"):
        TA.FlatAggregator(TCFG).aggregate([torch.zeros(3, 1 << 10)],
                                          weights=[1.0, 2.0])


# -- the event clock's arguments ----------------------------------------------


def timed_arrivals(seed: int, n: int) -> list[tuple]:
    """(table, produced, arrival, weight) with virtual-second times, as in
    ``tests/test_population.py``."""
    rng = np.random.default_rng(seed)
    out = []
    for p in rng.uniform(0.0, 20.0, size=n):
        out.append((rng.integers(-50, 51, (3, 1 << 10)).astype(np.float32),
                    float(p), float(p) + float(rng.uniform(0.5, 30.0)),
                    float(rng.uniform(0.5, 2.0))))
    return out


BWS = [3e4, 1e5, 7.5e3, 2e6, 5e5]


@pytest.mark.parametrize("method", ["aggregate", "aggregate_stream"])
@pytest.mark.parametrize("policy,kw", [("flat", {}),
                                       ("tree", {"fanout": 2}),
                                       ("tree", {"fanout": 2,
                                                 "link_bandwidth": 1e6}),
                                       ("async", {})])
def test_per_edge_seconds_match_the_reference(method, policy, kw):
    ts = tables(9, len(BWS))
    ref, port = both(make(policy, **kw), ts, method, bandwidths=BWS)
    assert_same(ref, port)
    tb = TF.upload_bytes(TCFG)
    assert port[1].levels[0].max_edge_seconds == tb / min(BWS)
    internal = (tb / kw["link_bandwidth"] if "link_bandwidth" in kw
                else 0.0) * (len(port[1].levels) - 1)
    assert port[1].critical_path_s == tb / min(BWS) + internal


@pytest.mark.parametrize("lam", [0.0, 0.05, 0.3])
@pytest.mark.parametrize("now,max_age", [(25.0, None), (25.0, 20.0),
                                         (25.0, 12.0), (40.0, 30.0)])
def test_timed_async_merge_matches_the_reference(lam, max_age, now):
    """Staleness in virtual seconds: weight ``w * exp(-lambda * age)``,
    ``max_age`` drops; the buffer's end state too."""
    arr = timed_arrivals(7, 12)
    ja, ta = make("async", staleness_lambda=lam, max_age=max_age)
    assert ta.timed and ja.timed
    for t, p, a, w in arr:
        ja.submit(jnp.asarray(t), produced_round=p, arrival_round=a,
                  weight=w)
        ta.submit(torch.from_numpy(t), produced_round=p, arrival_round=a,
                  weight=w)
    ref, port = both((ja, ta), [], round_idx=now, bandwidths=BWS)
    assert_same(ref, port)
    assert [(e["produced"], e["arrival"], e["weight"]) for e in ta.state()] \
        == [(e["produced"], e["arrival"], e["weight"]) for e in ja.state()]
    # some entries merge, some wait, and max_age drops some
    assert 0 < port[1].n_late and ta.pending() > 0
    assert (port[1].n_late + ta.pending() < len(arr)) == (max_age is not None)


@pytest.mark.parametrize("max_age", [None, 20.0])
def test_timed_stream_matches_submit_then_drain(max_age):
    """``merge_timed_stream`` is bitwise ``submit`` + ``aggregate([])`` in
    the port, and equals the reference's stream."""
    arr = timed_arrivals(7, 12)
    old = timed_arrivals(8, 4)
    kw = dict(staleness_lambda=0.05, max_age=max_age)
    batch, stream = TA.make_aggregator("async", TCFG, **kw), \
        TA.make_aggregator("async", TCFG, **kw)
    jstream = JA.make_aggregator("async", JCFG, **kw)
    for agg, conv in ((batch, torch.from_numpy), (stream, torch.from_numpy),
                      (jstream, jnp.asarray)):
        for t, p, a, w in old:       # already buffered before the merge
            agg.submit(conv(t), produced_round=p, arrival_round=a, weight=w)
    for t, p, a, w in arr:
        batch.submit(torch.from_numpy(t), produced_round=p, arrival_round=a,
                     weight=w)
    want = batch.aggregate([], round_idx=25.0, bandwidths=BWS)
    got = stream.merge_timed_stream(
        ((torch.from_numpy(t), p, a, w) for t, p, a, w in arr), now=25.0,
        bandwidths=BWS)
    ref = jstream.merge_timed_stream(
        ((jnp.asarray(t), p, a, w) for t, p, a, w in arr), now=25.0,
        bandwidths=BWS)
    assert torch.equal(got[0], want[0]) and fields(got[1]) == fields(want[1])
    assert_same(ref, got)
    assert [e["arrival"] for e in stream.state()] \
        == [e["arrival"] for e in batch.state()] \
        == [e["arrival"] for e in jstream.state()]
    with pytest.raises(ValueError):
        stream.merge_timed_stream(iter([(torch.from_numpy(arr[0][0]), 3.0,
                                         3.0, 1.0)]), now=5.0)


def test_timed_load_state_keeps_float_times():
    ta = TA.AsyncBufferedAggregator(TCFG, staleness_lambda=0.1)
    ta.load_state([dict(table=torch.zeros(3, 1 << 10), produced=1.25,
                        arrival=2.5, weight=1)])
    assert [(e["produced"], e["arrival"]) for e in ta.state()] \
        == [(1.25, 2.5)]


def test_event_clock_arguments_raise_as_in_the_reference():
    for mod, cfg in ((JA, JCFG), (TA, TCFG)):
        with pytest.raises(ValueError):
            mod.AsyncBufferedAggregator(cfg, staleness_lambda=-1.0)
        with pytest.raises(ValueError):
            mod.TreeAggregator(cfg, link_bandwidth=0.0)
