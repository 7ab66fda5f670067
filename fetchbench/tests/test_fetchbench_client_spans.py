"""The readers of the program's client spans and sync count: their
arithmetic on a hand-built run, and what a CPU run leaves out."""

import json
import types

import pytest
import torch

from fetchbench import harness
from fetchbench import run as run_mod

NAMES = ("fed.client_batch_ms", "fed.client_grad_ms",
         "fed.client_sketch_ms", "fed.host_syncs")


def span(name, dur_s, **fields):
    return dict(type="span", name=name, dur_s=dur_s, depth=2,
                parent="fed.clients", **fields)


def ctx(spans, rounds):
    return types.SimpleNamespace(spans=spans, rounds=rounds)


def read(name, c):
    return harness.metric_reader(name)(c)


def test_the_readers_arithmetic():
    """Two rounds of two clients: the batch span's host time, the gradient
    and sketch spans' device time, each summed and over the rounds; the
    sync count the mean over the ``fed.round`` spans present."""
    spans = []
    for r in range(2):
        for c in range(2):
            spans += [span("fed.client.batch", 0.001 * (c + 1), client=c,
                           dev_s=9.0, syncs=2),
                      span("fed.client.grad", 9.0, client=c,
                           dev_s=0.010 + 0.001 * r, syncs=0),
                      span("fed.client.sketch", 9.0, client=c, dev_s=0.002,
                           syncs=0)]
        spans.append(span("fed.clients", 0.05, dev_s=0.04, syncs=6))
        spans.append(dict(span("fed.round", 0.06, dev_s=0.05,
                               syncs=6 + r), depth=0, parent=None, round=r))
    c = ctx(spans, rounds=2)
    assert read("fed.client_batch_ms", c) == pytest.approx(3.0)
    assert read("fed.client_grad_ms", c) == pytest.approx(21.0)
    assert read("fed.client_sketch_ms", c) == pytest.approx(4.0)
    assert read("fed.host_syncs", c) == pytest.approx(6.5)
    # the last round's ``fed.round`` may still wait for its device time:
    # the mean is over the spans there
    assert read("fed.host_syncs", ctx(spans[:-1], rounds=2)) == 6.0


@pytest.mark.parametrize("name", NAMES)
def test_a_run_without_the_spans_reads_nothing(name):
    assert read(name, ctx([], rounds=3)) is None
    other = [span("fed.clients", 0.05, dev_s=0.04, syncs=6)]
    assert read(name, ctx(other, rounds=3)) is None


def test_a_cpu_run_has_host_time_alone():
    """Spans of a CPU run carry neither ``dev_s`` nor ``syncs``: only the
    batch's host time is read."""
    spans = [span("fed.client.batch", 0.002, client=0),
             span("fed.client.grad", 0.5, client=0),
             span("fed.client.sketch", 0.1, client=0),
             dict(span("fed.round", 0.7), depth=0, parent=None, round=0)]
    c = ctx(spans, rounds=1)
    assert read("fed.client_batch_ms", c) == pytest.approx(2.0)
    assert [read(n, c) for n in NAMES[1:]] == [None] * 3


@pytest.mark.parametrize("name", NAMES)
def test_each_training_cell_lists_the_metric(name):
    man = harness.manifest()
    (m,) = [m for m in man["per_layer"] if m["name"] == name]
    assert m["moves"] == "round_s"
    assert m["workloads"] == ["gpt2s-fed.persona256",
                              "internlm2-fed.short32"]
    assert m["source"] == ("program_counter" if name == "fed.host_syncs"
                           else "program_span")


def test_a_traced_micro_cell_on_the_cpu(micro_root):
    """The program's own client spans reach the result line: the batch's
    host time; the device time and the sync count are left out on the
    CPU."""
    root, mirrors = micro_root
    cell = next(c for c, r in mirrors.items() if r == "gpt2s-fed.persona256")
    args = types.SimpleNamespace(workload=cell, seed=2**31 + 5,
                                 seconds=0.3, trace=1)
    out = run_mod.run(args, device=torch.device("cpu"), root=root,
                      log=open("/dev/null", "w"))
    line = json.loads(harness.result_line(**out))
    assert line["correct"] is True
    metrics = line["metrics"]
    assert metrics["fed.client_batch_ms"]["value"] > 0
    assert metrics["fed.client_batch_ms"]["unit"] == "ms/round"
    assert not set(NAMES[1:]) & set(metrics)
    assert {"fed.clients_ms", "fed.server_update_ms"} <= set(metrics)
