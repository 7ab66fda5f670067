"""Port parity for the model zoo: configs, parameter trees, layouts and
parameter counts of every arch (the dense zoo, gpt2s-federated, the MoE
and recurrent archs: qwen2-moe-a2.7b, llama4-maverick, xlstm-350m,
jamba-v0.1-52b, and the encoder-decoder and vision archs: whisper-small,
pixtral-12b), and the train path (loss and gradients) of ``repro_torch``
against ``repro`` for qwen3-0.6b, internlm2-1.8b, deepseek-7b and
glm4-9b (the other archs' train paths are in ``test_torch_moe.py``,
``test_torch_recurrent.py``, ``test_torch_xlstm.py``,
``test_torch_encdec.py`` and ``test_torch_frontends.py``).

Both packages start from identical weights (``params_from_numpy`` of the
reference's init) on the smoke configs, plus one case whose ``head_dim``
is not ``d_model / n_heads`` (qwen3's full config has 128 against 64,
which the smoke config loses).

Tolerances.  The train path rounds the residual stream to bfloat16 at
every unit boundary, so a float32 difference in the last bit (another
summation order in a matmul) can flip one bfloat16 rounding (2**-8
relative).  At micro width the loss agrees to rtol 1e-5
(``test_torch_model.py``); at smoke width (d = 256, 2 units, 2 x 24
tokens) the gap over 6 batches and 3 archs reached 1.8e-5, with either
sign, so the loss is held to rtol 5e-5.  Gradients are compared per leaf
with an absolute tolerance of 1e-2 times the leaf's largest gradient, as
in ``test_torch_model.py``.

The reference is compiled with ``xla_allow_excess_precision`` off
(:data:`EXACT_ROUNDING`).  By default XLA's CPU compiler may drop a
bfloat16 rounding that the program states: inside the reference's
compiled unit (its ``lax.scan`` body) the residual's gradient then
differs from the same unit run op by op in about one element in ten,
by one bfloat16 step, and the rmsnorm of the embedding (rms ~0.02)
amplifies that into the table's gradient (whisper-small seed 0:
1.09e-2 of the leaf's largest with it, 5.4e-3 without).  The port rounds
where the reference's program says, as the reference run op by op does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import layout as JL
from repro.models import config as jmc
from repro.models import layers as jly
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import layout as TL
from repro_torch.models import config as tmc
from repro_torch.models import layers as tly
from repro_torch.models import transformer as tt

ARCHS = ("qwen3-0.6b", "internlm2-1.8b", "deepseek-7b", "glm4-9b",
         "gpt2s-federated", "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b",
         "xlstm-350m", "jamba-v0.1-52b", "whisper-small", "pixtral-12b")
DENSE = ARCHS[:4]
LOSS_RTOL = 5e-5
# XLA may otherwise skip a bfloat16 rounding the reference's program states
EXACT_ROUNDING = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Smoke-size ops are small: two intra-op threads are as fast and do
    not oversubscribe the cores when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cfg_pair(arch: str, **overrides):
    """The (reference, port) smoke configs of ``arch``, with overrides."""
    j, t = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    return dataclasses.replace(j, **overrides), \
        dataclasses.replace(t, **overrides)


def hd128_pair():
    """qwen3 reduced as the smoke config is, but with the full config's
    head_dim of 128 against d_model / n_heads = 64."""
    return (jmc.reduce_for_smoke(jconfigs.get_config("qwen3-0.6b"),
                                 name="qwen3-hd128", head_dim=128),
            tmc.reduce_for_smoke(tconfigs.get_config("qwen3-0.6b"),
                                 name="qwen3-hd128", head_dim=128))


def reference_params(jcfg, seed: int = 0):
    return jax.tree_util.tree_map(
        np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(seed)))


def shapes(tree):
    return [(p, tuple(x.shape)) for p, x in TL.flatten(tree)]


def port_fields(cfg) -> dict:
    """``cfg``'s value of every field of the port's ArchConfig (either
    package's config), the layer specs as tuples.  A field the port adds
    (latent attention, leading dense layers, the sigmoid router) reads as
    its default on the reference's config, so a zoo arch must leave it
    there."""
    out = {f.name: getattr(cfg, f.name, f.default)
           for f in dataclasses.fields(tmc.ArchConfig)}
    out["unit_pattern"] = [(s.kind, s.moe, s.ffn) for s in cfg.unit_pattern]
    out["hd"], out["n_units"] = cfg.hd, cfg.n_units
    out["is_encdec"] = cfg.is_encdec
    return out


# -- structure ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    assert tconfigs.list_archs() == tuple(
        a for a in jconfigs.list_archs() if a in ARCHS)
    for get in ("get_config", "get_smoke"):
        assert port_fields(getattr(tconfigs, get)(arch)) == \
            port_fields(getattr(jconfigs, get)(arch)), get


def test_act_default_matches_reference():
    kw = dict(name="x", arch_type="dense", n_layers=2, d_model=8, n_heads=2,
              n_kv_heads=2, d_ff=16, vocab=32)
    assert tmc.ArchConfig(**kw).act == jmc.ArchConfig(**kw).act == "swiglu"
    assert port_fields(tmc.ArchConfig(**kw)) == \
        port_fields(jmc.ArchConfig(**kw))
    smoke = tmc.reduce_for_smoke(dataclasses.replace(
        tmc.ArchConfig(**kw), sliding_window=4096, param_dtype="bfloat16"))
    assert (smoke.sliding_window, smoke.param_dtype) == (64, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_keeps_the_reference_tree(arch):
    jcfg, tcfg = cfg_pair(arch)
    jp = reference_params(jcfg)
    tp = tt.init_params(tcfg, seed=0)
    assert shapes(tp) == shapes(jp)
    assert all(x.dtype == torch.float32 for _, x in TL.flatten(tp))
    jl, tl = JL.build_layout(jp), TL.build_layout(tp)
    assert tl.total == jl.total
    assert [(c.path, c.row_start, c.n_rows, c.row_len, c.offset)
            for c in tl.chunks] == \
        [(c.path, c.row_start, c.n_rows, c.row_len, c.offset)
         for c in jl.chunks]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_match_reference_counts_and_layouts(arch):
    """Each full config's parameter count equals the reference's exactly
    (the port's tree built on the ``meta`` device, the reference's by
    ``jax.eval_shape``), and so do its chunks and groups: the sketch ids
    of the full-width model agree."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jshapes = jax.eval_shape(lambda: jt.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    tp = tt.init_params(tcfg, device="meta")
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jshapes))
    assert tt.param_count(tp) == n
    jl, tl = JL.build_layout(jshapes), TL.build_layout(tp)
    assert [(c.path, c.row_start, c.n_rows, c.offset) for c in tl.chunks] \
        == [(c.path, c.row_start, c.n_rows, c.offset) for c in jl.chunks]
    assert [g.chunk_ids for g in tl.groups] == \
        [g.chunk_ids for g in jl.groups]
    if arch in FULL_COUNTS:
        assert n == FULL_COUNTS[arch]
    if arch in CHIP_RUNS:        # the chip's FetchSGD runs on new families
        assert (n, tl.num_chunks, len(tl.groups)) == CHIP_RUNS[arch]


# the reference's parameter counts (jax.eval_shape) of the full configs
FULL_COUNTS = {"qwen2-moe-a2.7b": 14_315_587_584,
               "llama4-maverick-400b-a17b": 394_672_051_200,
               "xlstm-350m": 518_640_808,
               "jamba-v0.1-52b": 51_570_315_264,
               "whisper-small": 278_482_944,
               "pixtral-12b": 12_273_996_800}
# (d, chunks, groups) of the models the chip runs FetchSGD on, and of
# full pixtral-12b (the chip trains 8 of its 40 layers)
CHIP_RUNS = {"qwen3-0.6b": (751_632_384, 55, 23),
             "xlstm-350m": (518_640_808, 70, 66),
             "whisper-small": (278_482_944, 34, 32),
             "pixtral-12b": (12_273_996_800, 741, 21)}


def test_qwen2_moe_cut_for_the_chip_matches_reference():
    """qwen2-moe-a2.7b at 8 of its 24 layers, as the chip trains it with
    FetchSGD (weights and gradients of 24 layers take 107 GiB): the
    count, chunks and groups equal the reference's."""
    jcfg, tcfg = (dataclasses.replace(get("qwen2-moe-a2.7b"), n_layers=8)
                  for get in (jconfigs.get_config, tconfigs.get_config))
    jshapes = jax.eval_shape(lambda: jt.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    jl = JL.build_layout(jshapes)
    tl = TL.build_layout(tt.init_params(tcfg, device="meta"))
    assert (tl.total, tl.num_chunks, len(tl.groups)) == \
        (jl.total, jl.num_chunks, len(jl.groups)) == \
        (5_186_750_464, 317, 24)
    assert [(c.path, c.row_start, c.n_rows, c.offset) for c in tl.chunks] \
        == [(c.path, c.row_start, c.n_rows, c.offset) for c in jl.chunks]


def test_pixtral_cut_for_the_chip_matches_reference():
    """pixtral-12b at 8 of its 40 layers, as the chip trains it with
    FetchSGD (weights and gradients of 40 layers take 91 GiB): the count,
    chunks and groups equal the reference's."""
    jcfg, tcfg = (dataclasses.replace(get("pixtral-12b"), n_layers=8)
                  for get in (jconfigs.get_config, tconfigs.get_config))
    jshapes = jax.eval_shape(lambda: jt.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    jl = JL.build_layout(jshapes)
    tl = TL.build_layout(tt.init_params(tcfg, device="meta"))
    assert (tl.total, tl.num_chunks, len(tl.groups)) == \
        (jl.total, jl.num_chunks, len(jl.groups)) == \
        (3_549_516_800, 221, 21)
    assert [(c.path, c.row_start, c.n_rows, c.offset) for c in tl.chunks] \
        == [(c.path, c.row_start, c.n_rows, c.offset) for c in jl.chunks]


@pytest.mark.parametrize("kind", ["conv", "rwkv"])
@pytest.mark.parametrize("entry", ["init_params", "init_cache"])
def test_unknown_unit_kind_raises(kind, entry):
    """A unit kind the zoo does not have raises ``ValueError``, as the
    reference's ``_member_init`` does."""
    _, tcfg = cfg_pair("qwen3-0.6b")
    bad = dataclasses.replace(tcfg, unit_pattern=(tmc.LayerSpec(kind),))
    call = {"init_params": lambda: tt.init_params(bad),
            "init_cache": lambda: tt.init_cache(bad, 1, 8)}[entry]
    with pytest.raises(ValueError, match=kind):
        call()


# -- numerics: the train path -------------------------------------------------

def batch(vocab: int, seed: int = 0, B: int = 2, S: int = 24) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(-1, vocab, (B, S)).astype(np.int32)}


def assert_loss_and_grads_match(jcfg, tcfg, seed: int = 0,
                                loss_rtol: float = LOSS_RTOL,
                                grad_tol: float = 1e-2, extra=None):
    """``extra``: more of the batch (numpy ``frames`` or ``patches``)."""
    jp = reference_params(jcfg)
    b = {**batch(jcfg.vocab, seed), **(extra or {})}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, {k: jnp.asarray(v) for k, v in b.items()},
                             jcfg, remat=False), has_aux=True),
        compiler_options=EXACT_ROUNDING)(
        jax.tree_util.tree_map(jnp.asarray, jp))
    tloss, tg = tt.value_and_grad(
        params_from_numpy(jp),
        {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
         else torch.from_numpy(v) for k, v in b.items()}, tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=loss_rtol)
    want = dict(TL.flatten(jax.tree_util.tree_map(
        lambda g: np.asarray(g, np.float32), jg)))
    got = dict(TL.flatten(tg))
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = want[path]
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=grad_tol * np.abs(w).max(),
                                   err_msg=path)


@pytest.mark.parametrize("arch", DENSE + ("qwen3-hd128",))
def test_loss_and_grads_match_reference(arch):
    pair = hd128_pair() if arch == "qwen3-hd128" else cfg_pair(arch)
    assert_loss_and_grads_match(*pair)


VARIANTS = {
    "attn-bf16": ("internlm2-1.8b", dict(attn_compute_dtype="bfloat16")),
    "param-bf16": ("qwen3-0.6b", dict(param_dtype="bfloat16")),
    "tied": ("glm4-9b", dict(tie_embeddings=True)),
    "window": ("deepseek-7b", dict(sliding_window=8)),
}
# bfloat16 parameters make every matmul's output bfloat16, in both
# packages, so flips of its rounding are everywhere: over 3 archs x 2
# batches the loss differed by up to 3.6e-4 relative (the gap between the
# reference's own bf16 and float32 runs is of the same size) and a leaf's
# gradients by up to 2.0e-2 of its largest.  Held to one bf16 step (2**-8)
# on the loss and 5e-2 on the gradients.
BF16_PARAM_TOL = dict(loss_rtol=2 ** -8, grad_tol=5e-2)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_loss_and_grads_match_reference(variant):
    arch, kw = VARIANTS[variant]
    jcfg, tcfg = cfg_pair(arch, **kw)
    tp = tt.init_params(tcfg)
    assert ("unembed" in tp) == (not tcfg.tie_embeddings)
    assert all(x.dtype == getattr(torch, tcfg.param_dtype)
               for _, x in TL.flatten(tp))
    assert_loss_and_grads_match(
        jcfg, tcfg, **(BF16_PARAM_TOL if variant == "param-bf16" else {}))


def test_swiglu_mlp_matches_reference(rng):
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    p = {"w_up": rng.normal(size=(32, 48)).astype(np.float32),
         "w_gate": rng.normal(size=(32, 48)).astype(np.float32),
         "w_down": rng.normal(size=(48, 32)).astype(np.float32)}
    want = np.asarray(jly.mlp({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), "swiglu"))
    got = tly.mlp(params_from_numpy(p), torch.from_numpy(x), "swiglu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="relu"):
        tly.mlp(params_from_numpy(p), torch.from_numpy(x), "relu")
