"""FetchSGD on the dense zoo's new family: a micro qwen3 (swiglu and
qk-norm at the micro widths of ``test_torch_model.py``) through
``run_simulation`` and the orchestrator of ``repro_torch`` against
``repro``'s, from the reference's weights (``params_from_numpy``).

Losses are held to rtol 1e-3 and the traffic is equal, as
``test_torch_baselines.py`` holds them (gradients agree to about one
bfloat16 step); Delta is compared as a set of ids (``torch.topk`` and
``lax.top_k`` may order ties differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import fed as jfed
from repro.core import fetchsgd as JF
from repro.launch import simulate as jsim
from repro.models import transformer as jt
from repro.optim import linear_decay as j_linear_decay
from repro_torch import fed as tfed
from repro_torch.convert import params_from_numpy
from repro_torch.core import fetchsgd as TF
from repro_torch.core import layout as TL
from repro_torch.launch import simulate as tsim
from repro_torch.optim import linear_decay as t_linear_decay

SKETCH = dict(rows=3, cols=1 << 12, k=64)


@pytest.fixture(scope="module")
def qwen3_micro():
    cfg = jsim.micro_cfg("qwen3-0.6b")
    jp = jax.tree_util.tree_map(np.asarray,
                                jt.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, tsim.micro_cfg("qwen3-0.6b"), jp, jsim.micro_dataset(cfg)


def test_micro_qwen3_is_the_new_family(qwen3_micro):
    jcfg, tcfg, jp, _ = qwen3_micro
    assert (tcfg.act, tcfg.qk_norm) == (jcfg.act, jcfg.qk_norm) \
        == ("swiglu", True)
    assert "w_gate" in jp["units"]["m0"]["mlp"]
    assert "q_norm" in jp["units"]["m0"]["attn"]


def test_run_simulation_follows_the_reference_on_qwen3(qwen3_micro):
    """One round of FetchSGD through ``run_simulation``: the loss within
    rtol 1e-3 and the traffic equal, as ``test_torch_baselines.py`` holds
    them."""
    jcfg, tcfg, jp, ds = qwen3_micro
    want = jsim.run_simulation(jcfg, method="fetchsgd", rounds=1,
                               dataset=ds,
                               fs_cfg=JF.FetchSGDConfig(**SKETCH))
    got = tsim.run_simulation(tcfg, method="fetchsgd", rounds=1, dataset=ds,
                              fs_cfg=TF.FetchSGDConfig(**SKETCH),
                              params=params_from_numpy(jp), device="cpu")
    assert got.traffic == want.traffic
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-3)


def test_fetchsgd_round_moves_the_references_ids_on_qwen3(qwen3_micro):
    """One orchestrator round with a nonzero learning rate (``linear_decay``;
    the default schedule's round 0 has lr 0, a top-k of ties): the
    coordinates the update moved are Delta's ids, compared as a set."""
    jcfg, tcfg, jp, ds = qwen3_micro
    fed_kw = dict(rounds=1, clients_per_round=4, aggregate="flat")
    want = jfed.Orchestrator(
        jcfg, JF.FetchSGDConfig(**SKETCH), jfed.FederationConfig(**fed_kw),
        ds, params=jax.tree_util.tree_map(jnp.asarray, jp),
        lr_fn=j_linear_decay(0.2, 1)).run()
    got = tfed.Orchestrator(
        tcfg, TF.FetchSGDConfig(**SKETCH), tfed.FederationConfig(**fed_kw),
        ds, params=params_from_numpy(jp), lr_fn=t_linear_decay(0.2, 1),
        device="cpu").run()
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-3)

    init = np.concatenate([x.ravel() for _, x in TL.flatten(jp)])

    def moved(params):
        now = np.concatenate([np.asarray(x).ravel()
                              for _, x in TL.flatten(params)])
        return set(np.flatnonzero(now != init).tolist())

    ids = moved(got.params)
    assert len(ids) == SKETCH["k"]
    assert ids == moved(want.params)
