"""A configuration's plain reference is the module its ``family`` names,
and the program's ArchConfig is built from every field its file states."""

import dataclasses
import json

import pytest

from fetchbench import harness, reference
from fetchbench.reference import dense_lm
from fetchbench.tests.util import ROOT
from repro_torch import configs
from repro_torch.core import layout
from repro_torch.models import transformer

CONFIGS = json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]
INTERFACE = ("param_spec", "n_params", "init_flat", "leaves", "leaf_spans",
             "loss_and_grad", "cache_dtype", "serve_logits")
# the files of the two configurations accepted before the harness took
# every field, and the keys it handed the program then
ACCEPTED = ("gpt2s-federated", "internlm2-1.8b")
OLD_ARCH_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                 "vocab", "act", "rope_theta", "norm_eps", "tie_embeddings",
                 "param_dtype")


@pytest.mark.parametrize("name", ["no_such_family", "sketch", "federated",
                                  "__init__", "../reference/dense_lm", None])
def test_a_module_that_is_no_family_is_refused(name):
    with pytest.raises(ValueError, match=repr(name).replace(".", r"\.")):
        reference.family({"family": name})


@pytest.mark.parametrize("entry", CONFIGS, ids=lambda c: c["name"])
def test_each_configuration_resolves_to_its_family_module(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    fam = reference.family(cfg)
    assert fam.__file__ == str(ROOT / "fetchbench" / "reference"
                               / f"{cfg['family']}.py")
    assert all(callable(getattr(fam, f)) for f in INTERFACE)
    assert isinstance(fam.READS, tuple) and isinstance(fam.MICRO, dict)


@pytest.mark.parametrize("name", ACCEPTED)
def test_arch_config_of_an_accepted_file_is_the_old_rules(name):
    cfg = json.loads((ROOT / "fetchbench" / "configs" / f"{name}.json")
                     .read_text())
    old = dataclasses.replace(configs.get_config(cfg["arch"]),
                              **{k: cfg[k] for k in OLD_ARCH_KEYS},
                              head_dim=cfg["head_dim"])
    new = harness.arch_config(cfg, reference.family(cfg))
    for f in dataclasses.fields(old):
        assert getattr(new, f.name) == getattr(old, f.name), f.name
    assert new == old


def _micro_moe(**extra):
    return {"arch": "qwen2-moe-a2.7b", "family": "dense_lm",
            **dense_lm.MICRO, "n_experts": 8, "moe_d_ff": 96, **extra}


def test_a_stated_field_reaches_the_program():
    mcfg = harness.arch_config(_micro_moe(), dense_lm)
    assert (mcfg.n_experts, mcfg.moe_d_ff, mcfg.d_model) == (8, 96, 64)
    shapes = dict((p, tuple(t.shape)) for p, t in layout.flatten(
        transformer.init_params(mcfg, device="meta")))
    assert shapes["units/m0/moe/w_up"] == (2, 8, 64, 96)


@pytest.mark.parametrize("key", ["n_expert", "moe_dff", "normalization"])
def test_a_key_neither_side_reads_is_refused(key):
    with pytest.raises(ValueError, match=key):
        harness.arch_config(_micro_moe(**{key: 4}), dense_lm)


@pytest.mark.parametrize("key", dense_lm.READS + harness.DESCRIPTIVE)
def test_keys_the_family_reads_or_that_describe_pass(key):
    cfg = _micro_moe()
    cfg.setdefault(key, "x")
    assert harness.arch_config(cfg, dense_lm).n_experts == 8
