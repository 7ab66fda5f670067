"""Port parity for the mamba block (``models/ssm.py``) of ``repro_torch``
against ``repro``'s, jamba-v0.1-52b built on it, the reference's fault
on a prompt shorter than the causal conv, and the reference's arch smoke
tests as twins for the archs of this slice.  The xLSTM blocks are in
``test_torch_xlstm.py``.

Tolerances.  The scan runs in float32 but sums in another order than the
reference's (doubling passes in place of ``associative_scan``, another
einsum order), so the block's outputs, states and gradients are held to
rtol 1e-4 of the largest value (measured at most 1.1e-6).  jamba's loss
follows ``test_torch_zoo.py``'s ``LOSS_RTOL`` (5e-5) and its gradients the
per-leaf rule (1e-2 of each leaf's largest).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import layout as TL
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt

LOSS_RTOL = 5e-5
SCAN_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Smoke-size ops are small: two intra-op threads are as fast and do
    not oversubscribe the cores when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cfg_pair(arch: str, **overrides):
    return (dataclasses.replace(jconfigs.get_smoke(arch), **overrides),
            dataclasses.replace(tconfigs.get_smoke(arch), **overrides))


@pytest.fixture(scope="module")
def jamba():
    jcfg, tcfg = cfg_pair("jamba-v0.1-52b")
    return jcfg, tcfg, reference_params(jcfg)


def reference_params(jcfg, seed: int = 0):
    return jax.tree_util.tree_map(
        np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(seed)))


def block(jp: dict, member: str, kind: str) -> dict:
    """The first unit's ``kind`` parameters of ``member``."""
    return jax.tree_util.tree_map(lambda a: a[0], jp["units"][member][kind])


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def close(got, want, rtol=SCAN_RTOL, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=msg)


def assert_block_grads_match(jf, tf, p: dict, x: np.ndarray, seed: int = 1):
    """Gradients of a weighted sum of the block's output with respect to
    every weight and the input, within ``SCAN_RTOL`` of each leaf's
    largest."""
    w = np.random.default_rng(seed).normal(size=x.shape).astype(np.float32)
    jg = jax.grad(lambda p, x: jnp.sum(jf(p, x) * w), argnums=(0, 1))(
        to_jax(p), jnp.asarray(x))
    flat = TL.flatten(params_from_numpy(p))
    leaves = [t.requires_grad_(True) for _, t in flat]
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tf(TL.unflatten([k for k, _ in flat], leaves), tx)
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                             leaves + [tx])
    want = [g for _, g in TL.flatten(jg[0])] + [jg[1]]
    for (path, _), g, wg in zip(flat + [("x", None)], tg, want):
        close(g, wg, msg=path)


# -- mamba --------------------------------------------------------------------

@pytest.mark.parametrize("S", [100, 128, 200])
def test_mamba_matches_reference(jamba, rng, S):
    """``mamba_forward`` and ``mamba_prefill`` (output, conv state, scan
    state) at one chunk cut short (100), one whole chunk (128) and a
    padded second chunk (200)."""
    jcfg, tcfg, jp = jamba
    p = block(jp, "m0", "mamba")
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    want = jssm.mamba_forward(to_jax(p), jnp.asarray(x), jcfg)
    tp, tx = params_from_numpy(p), torch.from_numpy(x)
    close(tssm.mamba_forward(tp, tx, tcfg), want)
    wo, wconv, wssm = jssm.mamba_prefill(to_jax(p), jnp.asarray(x), jcfg)
    go, gconv, gssm = tssm.mamba_prefill(tp, tx, tcfg)
    close(go, wo)
    close(gconv, wconv, msg="conv state")
    close(gssm, wssm, msg="scan state")


@pytest.mark.parametrize("remat", [False, True])
def test_mamba_gradients_match_reference(jamba, rng, remat):
    """The block's gradients, on the plain path and on the ``ssm_remat``
    path (each chunk checkpointed, its selective params recomputed in
    backward), against the reference's of the same setting, over a padded
    second chunk."""
    jcfg, tcfg, jp = jamba
    jcfg, tcfg = (dataclasses.replace(c, ssm_remat=remat)
                  for c in (jcfg, tcfg))
    x = rng.normal(size=(1, 140, jcfg.d_model)).astype(np.float32)
    assert_block_grads_match(
        lambda p, x: jssm.mamba_forward(p, x, jcfg),
        lambda p, x: tssm.mamba_forward(p, x, tcfg),
        block(jp, "m0", "mamba"), x)


def test_doubling_scan_matches_a_loop():
    """``_scan_pairs`` over 128 steps against the plain recurrence
    ``h_t = a_t h_{t-1} + b_t``, with decays as small as ``dt * exp(A)``
    makes them (down to e**-16 a step, where a cumulative product
    underflows float32 within a chunk)."""
    gen = torch.Generator().manual_seed(0)
    decay = torch.exp(-16 * torch.rand(2, 128, 3, 4, generator=gen))
    drive = torch.randn(2, 128, 3, 4, generator=gen)
    dec, drv = tssm._scan_pairs(decay, drive)
    h, a = torch.zeros(2, 3, 4), torch.ones(2, 3, 4)
    for t in range(128):
        h = decay[:, t] * h + drive[:, t]
        a = decay[:, t] * a
        torch.testing.assert_close(drv[:, t], h, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(dec[:, t], a, rtol=1e-5, atol=1e-30)
    assert torch.isfinite(dec).all() and (dec[:, -1] == 0).any()


def test_jamba_loss_and_grads_match_reference(jamba):
    """jamba smoke (mamba, attention, dense and MoE FFNs in one unit):
    the loss with its aux term, and every leaf's gradients; the
    ``ssm_remat`` path gives the port the same loss and gradients."""
    jcfg, tcfg, jp = jamba
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32),
         "labels": rng.integers(-1, jcfg.vocab, (2, 24)).astype(np.int32)}
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jt.loss_fn(p, {k: jnp.asarray(v) for k, v in b.items()},
                             jcfg, remat=False), has_aux=True)(to_jax(jp))
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    tloss, tg = tt.value_and_grad(params_from_numpy(jp), tb, tcfg)
    assert float(jm["aux"]) > 0
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    want = dict(TL.flatten(jg))
    got = dict(TL.flatten(tg))
    assert got.keys() == want.keys()
    for path, g in got.items():
        close(g, want[path], rtol=1e-2, msg=path)
    # the remat path computes (dt, B, C) a chunk at a time, whose float32
    # last bits can flip the residual stream's bfloat16 roundings: the
    # same rule as against the reference
    rloss, rg = tt.value_and_grad(
        params_from_numpy(jp), tb, dataclasses.replace(tcfg, ssm_remat=True))
    np.testing.assert_allclose(float(rloss), float(jloss), rtol=LOSS_RTOL)
    for path, g in TL.flatten(rg):
        close(g, want[path], rtol=1e-2, msg=path)


# -- the reference's fault, as a test of the port alone ----------------------

def test_mamba_prompt_shorter_than_the_conv_decodes(jamba):
    """jamba smoke with a prompt of 2 (shorter than ``ssm_conv - 1`` = 3),
    then one decode step: the logits equal the reference's prefill of the
    3 tokens (whose own prefill of 2 raises).  Both run under no-drop
    capacity (``n_experts / expert_top_k``): at 1.25 the reference's
    3-token prefill may drop a token that a decode keeps."""
    jcfg, tcfg, jp = jamba
    nodrop = jcfg.n_experts / jcfg.expert_top_k
    jcfg, tcfg = (dataclasses.replace(c, capacity_factor=nodrop)
                  for c in (jcfg, tcfg))
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 3)).astype(
        np.int32)
    want, _ = jt.prefill(to_jax(jp), {"tokens": jnp.asarray(toks)}, jcfg,
                         jt.init_cache(jcfg, 2, 3, jnp.float32))
    tp = params_from_numpy(jp)
    with torch.no_grad():
        cache = tt.init_cache(tcfg, 2, 3, torch.float32)
        _, cache = tt.prefill(tp, {"tokens": torch.from_numpy(toks[:, :2])},
                              tcfg, cache)
        conv = cache["mamba"]["conv"]
        assert conv.shape[3] == 3 and float(conv[:, :, :, 0].abs().max()) == 0
        got, cache = tt.decode_step(tp, torch.from_numpy(toks[:, 2:]), tcfg,
                                    cache)
    close(got, want, rtol=1e-4)


# -- the reference's arch smoke tests, as twins -----------------------------

@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "xlstm-350m",
                                  "llama4-maverick-400b-a17b",
                                  "jamba-v0.1-52b"])
def test_arch_smoke_train_step_and_prefill_decode(arch):
    """Twin of the reference's ``TestArchSmoke`` for the archs of this
    slice: a finite loss and a nonzero finite gradient norm; prefill of 32
    tokens and 2 decode steps with finite logits of the vocabulary's
    width, at position 34."""
    cfg = tconfigs.get_smoke(arch)
    params = tt.init_params(cfg, seed=0)
    batch = {"tokens": torch.full((2, 32), 3),
             "labels": torch.full((2, 32), 5)}
    loss, grads = tt.value_and_grad(params, batch, cfg)
    gnorm = sum(float((g.float() ** 2).sum()) for _, g in TL.flatten(grads))
    assert np.isfinite(float(loss)) and np.isfinite(gnorm) and gnorm > 0
    with torch.no_grad():
        cache = tt.init_cache(cfg, 2, 64)
        logits, cache = tt.prefill(params, {"tokens": batch["tokens"]}, cfg,
                                   cache)
        assert logits.shape == (2, cfg.vocab)
        assert torch.isfinite(logits).all()
        for _ in range(2):
            logits, cache = tt.decode_step(
                params, torch.ones((2, 1), dtype=torch.long), cfg, cache)
    assert logits.shape == (2, cfg.vocab) and torch.isfinite(logits).all()
    assert int(cache["pos"]) == 32 + 2


def test_mixed_dtype_params_and_caches_convert_both_ways():
    """jamba as published keeps its routers in float32 beside bfloat16
    experts and mamba weights: the port's tree has the reference's dtype
    at every leaf, and ``numpy_from_tensors`` and ``params_from_numpy``
    carry every leaf across with its dtype and bits; so does a decode
    cache of every kind (bfloat16 k and v, float32 states)."""
    from repro_torch.convert import numpy_from_tensors
    jcfg, tcfg = cfg_pair("jamba-v0.1-52b", param_dtype="bfloat16")
    jshapes = jax.eval_shape(lambda: jt.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    tp = tt.init_params(tcfg, seed=0)
    dtypes = {p: str(t.dtype).removeprefix("torch.")
              for p, t in TL.flatten(tp)}
    assert dtypes == {p: str(x.dtype) for p, x in TL.flatten(jshapes)}
    assert (dtypes["units/m1/moe/router"], dtypes["units/m1/moe/w_gate"],
            dtypes["units/m0/mamba/in_proj"]) == \
        ("float32", "bfloat16", "bfloat16")
    rng = np.random.default_rng(0)
    jc = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(a.dtype) if a.ndim else a,
        jax.tree_util.tree_map(np.asarray, jt.init_cache(jcfg, 2, 8)))
    assert set(jc) == {"pos", "attn", "mamba"}
    for want in (numpy_from_tensors(tp), jc):
        back = numpy_from_tensors(params_from_numpy(want))
        for (path, w), (_, g) in zip(TL.flatten(want), TL.flatten(back)):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            np.testing.assert_array_equal(np.atleast_1d(g).view(np.uint8),
                                          np.atleast_1d(w).view(np.uint8),
                                          err_msg=path)
    for path, t in TL.flatten(params_from_numpy(numpy_from_tensors(tp))):
        assert torch.equal(t.view(torch.uint8),
                           dict(TL.flatten(tp))[path].view(torch.uint8))
