"""Port parity for the xLSTM blocks (``models/xlstm.py``: mLSTM, sLSTM) of
``repro_torch`` against ``repro``'s, xlstm-350m built on them, and the
reference's fault on a prompt longer than the mLSTM's chunk.

Tolerances.  The scans run in float32 but sum in another order than the
reference's, so the blocks' outputs, states and gradients are held to
rtol 1e-4 of the largest value (measured at most 1.4e-6).  The model's
loss follows ``test_torch_zoo.py``'s ``LOSS_RTOL`` (5e-5).  Its gradients
are held to 5e-2 of each leaf's largest, not the zoo's 1e-2: besides the
residual stream, the first mLSTM of each unit rounds its output to
bfloat16 (the reference's ``y.astype(x.dtype)`` of a bfloat16 input), and
over 4 seeds a leaf's gradients differed by up to 1.64e-2 of its largest
(``b_if``, ``wk``; the blocks alone agree to 1.4e-6), as a float32 last
bit flips a bfloat16 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jt
from repro.models import xlstm as jxl
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import layout as TL
from repro_torch.models import transformer as tt
from repro_torch.models import xlstm as txl

from test_torch_recurrent import (LOSS_RTOL, assert_block_grads_match, block,
                                  cfg_pair, close, reference_params, to_jax,
                                  torch_threads)  # noqa: F401


@pytest.fixture(scope="module")
def xlstm_smoke():
    jcfg, tcfg = cfg_pair("xlstm-350m")
    return jcfg, tcfg, reference_params(jcfg)


@pytest.mark.parametrize("S", [24, 128, 200])
def test_mlstm_and_slstm_match_reference(xlstm_smoke, rng, S):
    """mLSTM output and state, sLSTM output and state.  At 200 (a padded
    second chunk) the reference's mLSTM state is wiped by its padding, so
    the port's state is held to a run of 128 steps and then 72 instead."""
    jcfg, tcfg, jp = xlstm_smoke
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x)
    pm = block(jp, "m0", "mlstm")
    wo, (wC, wn) = jxl.mlstm_forward(to_jax(pm), jnp.asarray(x), jcfg,
                                     return_state=True)
    go, (gC, gn) = txl.mlstm_forward(params_from_numpy(pm), tx, tcfg,
                                     return_state=True)
    close(go, wo)
    if S > 128:
        _, st = jxl.mlstm_forward(to_jax(pm), jnp.asarray(x[:, :128]), jcfg,
                                  return_state=True)
        _, (wC, wn) = jxl.mlstm_forward(to_jax(pm), jnp.asarray(x[:, 128:]),
                                        jcfg, state=st, return_state=True)
    close(gC, wC, msg="C")
    close(gn, wn, msg="n")
    ps = block(jp, "m7", "slstm")
    wo, wst = jxl.slstm_forward(to_jax(ps), jnp.asarray(x), jcfg,
                                return_state=True)
    go, gst = txl.slstm_forward(params_from_numpy(ps), tx, tcfg,
                                return_state=True)
    close(go, wo)
    for name, g, w in zip("hcnm", gst, wst):
        close(g, w, msg=name)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_block_gradients_match_reference(xlstm_smoke, rng, kind):
    jcfg, tcfg, jp = xlstm_smoke
    jf = {"mlstm": jxl.mlstm_forward, "slstm": jxl.slstm_forward}[kind]
    tf = {"mlstm": txl.mlstm_forward, "slstm": txl.slstm_forward}[kind]
    x = rng.normal(size=(2, 40, jcfg.d_model)).astype(np.float32)
    assert_block_grads_match(lambda p, x: jf(p, x, jcfg),
                             lambda p, x: tf(p, x, tcfg),
                             block(jp, "m7" if kind == "slstm" else "m0",
                                   kind), x)


def test_xlstm_loss_and_grads_match_reference(xlstm_smoke):
    jcfg, tcfg, jp = xlstm_smoke
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32),
         "labels": rng.integers(-1, jcfg.vocab, (2, 24)).astype(np.int32)}
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jt.loss_fn(p, {k: jnp.asarray(v) for k, v in b.items()},
                             jcfg, remat=False), has_aux=True)(to_jax(jp))
    tloss, tm = tt.loss_fn(params_from_numpy(jp),
                           {k: torch.from_numpy(v).long()
                            for k, v in b.items()}, tcfg)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    vloss, tg = tt.value_and_grad(
        params_from_numpy(jp),
        {k: torch.from_numpy(v).long() for k, v in b.items()}, tcfg)
    assert float(vloss) == float(tloss)
    want = dict(TL.flatten(jg))
    got = dict(TL.flatten(tg))
    assert got.keys() == want.keys()
    for path, g in got.items():
        close(g, want[path], rtol=5e-2, msg=path)



# -- the reference's fault, as a test of the port alone ----------------------

def test_xlstm_prompt_longer_than_a_chunk_decodes_as_a_fresh_prefill():
    """xlstm smoke, a prompt of 136 (longer than the mLSTM's chunk of 128
    and not a multiple of it), then 8 teacher-forced decode steps: each
    step's logits equal a fresh prefill of the same tokens (float32
    states on both sides: rtol 1e-4).  The reference's padded forget gate
    of 0 wipes its state here, and its decode is off by about 4."""
    cfg = tconfigs.get_smoke("xlstm-350m")
    params = tt.init_params(cfg, seed=0)
    toks = torch.randint(0, cfg.vocab, (2, 144),
                         generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        cache = tt.init_cache(cfg, 2, 144)
        _, cache = tt.prefill(params, {"tokens": toks[:, :136]}, cfg, cache)
        assert float(cache["mlstm"]["C"].abs().max()) > 0.1
        for t in range(136, 144):
            got, cache = tt.decode_step(params, toks[:, t:t + 1], cfg, cache)
            fresh, _ = tt.prefill(params, {"tokens": toks[:, :t + 1]}, cfg,
                                  tt.init_cache(cfg, 2, t + 1))
            torch.testing.assert_close(got, fresh, rtol=1e-4,
                                       atol=1e-4 * float(fresh.abs().max()),
                                       msg=f"pos {t}")
