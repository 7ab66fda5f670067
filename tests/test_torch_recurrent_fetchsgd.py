"""FetchSGD on a recurrent family: a micro xlstm (one mLSTM and one sLSTM
block at the micro widths of ``launch/simulate``)
through the port's ``run_simulation`` and orchestrator against the
reference's orchestrator, from the reference's weights.

One reference run stands for both: ``run_simulation`` hands its traffic
and losses through from the orchestrator, and round 0's loss does not
depend on the learning rate.  The reference compiles one program per
chunk of the layout, about a second each (over 100 s for the micro
config's 16 layers), so the model is cut to one unit of one block of
each kind.
Losses within rtol 1e-3 and the traffic equal, Delta as a set of ids, as
``tests/test_torch_zoo_fetchsgd.py`` holds qwen3's.
"""

import dataclasses

from repro import configs as jconfigs
from repro.launch import simulate as jsim
from repro_torch import configs as tconfigs
from repro_torch.launch import simulate as tsim

from test_torch_moe import assert_fetchsgd_follows_reference


def test_run_simulation_follows_the_reference_on_xlstm():
    jcfg, tcfg = (dataclasses.replace(
        m.micro_cfg("xlstm-350m"), n_layers=2,
        unit_pattern=(c.unit_pattern[0], c.unit_pattern[-1]))
        for m, c in ((jsim, jconfigs.get_config("xlstm-350m")),
                     (tsim, tconfigs.get_config("xlstm-350m"))))
    assert [(s.kind, s.ffn) for s in tcfg.unit_pattern] == \
        [("mlstm", False), ("slstm", False)]
    assert_fetchsgd_follows_reference(jcfg, tcfg)
