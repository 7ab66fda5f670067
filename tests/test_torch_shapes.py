"""Port parity for the shape matrix (``launch/shapes.py``): ``SHAPES``,
``LONG_CONTEXT_WINDOW`` and ``adapt_config`` of ``repro_torch`` against
``repro``'s, field by field, for every arch and shape; whisper-small
skips ``long_500k`` in both packages."""

import dataclasses

import pytest

from repro import configs as jconfigs
from repro.launch import shapes as jshapes
from repro_torch import configs as tconfigs
from repro_torch.launch import shapes as tshapes

from test_torch_zoo import port_fields


def test_shapes_match_reference():
    assert tshapes.LONG_CONTEXT_WINDOW == jshapes.LONG_CONTEXT_WINDOW == 16384
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, spec in tshapes.SHAPES.items():
        assert dataclasses.asdict(spec) == \
            dataclasses.asdict(jshapes.SHAPES[name])
    assert [f.name for f in dataclasses.fields(tshapes.ShapeSpec)] == \
        [f.name for f in dataclasses.fields(jshapes.ShapeSpec)]


@pytest.mark.parametrize("arch", tconfigs.list_archs())
@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
def test_adapt_config_matches_reference(arch, shape):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    try:
        want = jshapes.adapt_config(jcfg, jshapes.SHAPES[shape])
    except jshapes.SkipShape as e:
        with pytest.raises(tshapes.SkipShape, match="long_500k skipped"):
            tshapes.adapt_config(tcfg, tshapes.SHAPES[shape])
        assert (arch, shape) == ("whisper-small", "long_500k"), str(e)
        return
    got = tshapes.adapt_config(tcfg, tshapes.SHAPES[shape])
    assert port_fields(got) == port_fields(want)
    window = 16384 if shape == "long_500k" and tcfg.arch_type in (
        "dense", "moe", "vlm") else tcfg.sliding_window
    assert got.sliding_window == window


def test_pixtral_long_context_takes_the_window():
    cfg = tshapes.adapt_config(tconfigs.get_config("pixtral-12b"),
                               tshapes.SHAPES["long_500k"])
    assert cfg.sliding_window == tshapes.LONG_CONTEXT_WINDOW
    assert tshapes.adapt_config(tconfigs.get_config("pixtral-12b"),
                                tshapes.SHAPES["decode_32k"]) \
        .sliding_window == 0
