"""The port's ``simulate`` command line on the event clock and with
``--population``, against ``repro.launch.simulate``'s: the same flags
print the same lines, losses aside (the two packages draw their initial
weights from their own generators; ``test_torch_event_clock.py`` and
``test_torch_population.py`` hold the losses from common weights)."""

import re

import pytest
import torch

from repro.launch import simulate as jsim
from repro_torch.launch import simulate as tsim


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The micro model's ops are tiny: one intra-op thread is as fast
    alone and does not oversubscribe the cores when test files run in
    parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def loss_free(lines: list[str]) -> list[str]:
    return [re.sub(r"loss \S+", "loss -", ln) for ln in lines]


@pytest.mark.parametrize("argv", [
    ["--clock", "event", "--population", "2000", "--aggregate", "async",
     "--quorum", "4", "--rounds", "2", "--bw-sigma", "2.0"],
    ["--clock", "round", "--population", "500", "--rounds", "2",
     "--weight-by", "profile", "--profile-stream", "legacy",
     "--dropout-prob", "0.2"]], ids=["event-population", "round-population"])
def test_command_line_prints_the_references_records(argv, capsys):
    jsim.main(argv)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if not ln.startswith("telemetry")]
    got: list[str] = []
    tsim.main(argv + ["--device", "cpu"], log=got.append)
    assert loss_free(got) == loss_free(want)
    assert any("t=" in ln for ln in want) == ("event" in argv)
