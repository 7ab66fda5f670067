"""Port parity for the mixture-of-experts FFN: ``models/moe.py`` and the
MoE archs (qwen2-moe-a2.7b, llama4-maverick-400b-a17b) of ``repro_torch``
against ``repro``'s, from the reference's weights (``params_from_numpy``).

Tolerances.  ``moe_apply`` is float32 but its dispatch buffers, which
have the input's dtype; the same inputs give outputs within rtol 1e-5
(measured 8e-7 of the largest value) and the same aux loss, with bfloat16
inputs too, and at a capacity factor of 0.5, where tokens drop: which
ones drop is fixed by the token-major order of the position cumsum, so a
different order would move whole rows, far beyond the tolerance.  The
model's loss and gradients follow ``test_torch_zoo.py``'s rule: the loss
to ``LOSS_RTOL`` (5e-5; bfloat16 roundings of the residual stream flip on
float32 last bits) and each leaf's gradients within 1e-2 of its largest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import fetchsgd as JF
from repro.launch import simulate as jsim
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import fetchsgd as TF
from repro_torch.core import layout as TL
from repro_torch.launch import simulate as tsim
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt

MOE_ARCHS = ("qwen2-moe-a2.7b", "llama4-maverick-400b-a17b")
LOSS_RTOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Smoke-size ops are small: two intra-op threads are as fast and do
    not oversubscribe the cores when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cfg_pair(arch: str = "qwen2-moe-a2.7b", **overrides):
    return (dataclasses.replace(jconfigs.get_smoke(arch), **overrides),
            dataclasses.replace(tconfigs.get_smoke(arch), **overrides))


def reference_params(jcfg, seed: int = 0):
    return jax.tree_util.tree_map(
        np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(seed)))


def moe_leaf(jp: dict, member: str = "m0") -> dict:
    """The first unit's MoE parameters of ``member``."""
    return jax.tree_util.tree_map(lambda a: a[0], jp["units"][member]["moe"])


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# -- the module ---------------------------------------------------------------

CASES = {
    "f32-shared": (np.float32, True, 1.25),
    "f32-routed": (np.float32, False, 1.25),
    "bf16-shared": ("bfloat16", True, 1.25),
    "f32-drop": (np.float32, True, 0.5),
    "bf16-drop": ("bfloat16", False, 0.5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_reference(case, rng):
    """Output within rtol 1e-5 and aux equal, with and without the shared
    experts, float32 and bfloat16 inputs, and with tokens dropped."""
    dtype, shared, cf = CASES[case]
    jcfg, tcfg = cfg_pair(capacity_factor=cf)
    p = moe_leaf(reference_params(jcfg))
    if not shared:
        p = {k: v for k, v in p.items() if k != "shared"}
    x = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = params_from_numpy(np.asarray(jx))
    want, jaux = jmoe.moe_apply(to_jax(p), jx, jcfg)
    got, taux = tmoe.moe_apply(params_from_numpy(p), tx, tcfg)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    T, K, E = 48, jcfg.expert_top_k, jcfg.n_experts
    cap = tmoe.capacity(tcfg, T)
    assert cap == min(int(max(K, round(T * K / E * cf))), T)
    if cf < 1:       # some expert gets more than its slots: tokens drop
        eidx = torch.topk(torch.softmax(
            tx.reshape(T, -1).float() @ torch.tensor(p["router"]), -1),
            K).indices
        assert int(torch.bincount(eidx.reshape(-1), minlength=E).max()) > cap


def test_moe_gradients_match_reference(rng):
    """Gradients of a weighted sum of the output (and of the aux loss)
    with respect to every MoE weight and the input, rtol 1e-5 of each
    leaf's largest, with tokens dropped."""
    jcfg, tcfg = cfg_pair(capacity_factor=0.5)
    p = moe_leaf(reference_params(jcfg))
    x = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, x, jcfg)
        return jnp.sum(y * w) + aux
    jg = jax.grad(jloss, argnums=(0, 1))(to_jax(p), jnp.asarray(x))
    flat = TL.flatten(params_from_numpy(p))
    leaves = [t.requires_grad_(True) for _, t in flat]
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_apply(TL.unflatten([k for k, _ in flat], leaves), tx,
                            tcfg)
    tg = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux,
                             leaves + [tx])
    want = [np.asarray(g) for _, g in TL.flatten(jg[0])] + [np.asarray(jg[1])]
    for (path, _), g, wg in zip(flat + [("x", None)], tg, want):
        np.testing.assert_allclose(g.numpy(), wg, rtol=0,
                                   atol=1e-5 * np.abs(wg).max(),
                                   err_msg=path)


# -- the model ----------------------------------------------------------------

def batch(vocab: int, seed: int = 0, B: int = 2, S: int = 24) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(-1, vocab, (B, S)).astype(np.int32)}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_loss_metrics_and_grads_match_reference(arch):
    """The loss with the aux term, its two metrics, and every leaf's
    gradients."""
    jcfg, tcfg = cfg_pair(arch)
    jp = reference_params(jcfg)
    b = batch(jcfg.vocab)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jt.loss_fn(p, {k: jnp.asarray(v) for k, v in b.items()},
                             jcfg, remat=False), has_aux=True)(to_jax(jp))
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    tp = params_from_numpy(jp)
    tloss, tm = tt.loss_fn(tp, tb, tcfg)
    assert float(tm["aux"]) > 0 and tm["aux"].dtype == torch.float32
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["xent"]), float(jm["xent"]),
                               rtol=LOSS_RTOL)
    assert float(tloss) == float(tm["xent"] + tm["aux"])
    vloss, tg = tt.value_and_grad(tp, tb, tcfg)
    assert float(vloss) == float(tloss)
    np.testing.assert_allclose(float(vloss), float(jloss), rtol=LOSS_RTOL)
    want = dict(TL.flatten(jax.tree_util.tree_map(np.asarray, jg)))
    got = dict(TL.flatten(tg))
    assert got.keys() == want.keys()
    assert any("/moe/router" in k for k in got)
    for path, g in got.items():
        w = want[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-2 * np.abs(w).max(), err_msg=path)


def test_moe_router_balance_loss_positive():
    """Twin of the reference's test of the same name."""
    cfg = tconfigs.get_smoke("qwen2-moe-a2.7b")
    params = tt.init_params(cfg, seed=0)
    b = {"tokens": torch.full((2, 32), 3), "labels": torch.full((2, 32), 5)}
    loss, metrics = tt.loss_fn(params, b, cfg)
    assert float(metrics["aux"]) > 0
    assert torch.isfinite(loss)


def test_dense_loss_has_no_aux_term():
    """A model without MoE: aux is 0 and the loss is the cross entropy
    bit for bit."""
    cfg = tconfigs.get_smoke("qwen3-0.6b")
    params = tt.init_params(cfg, seed=0)
    b = {k: torch.from_numpy(v).long() for k, v in batch(cfg.vocab).items()}
    loss, metrics = tt.loss_fn(params, b, cfg)
    assert float(metrics["aux"]) == 0.0
    assert torch.equal(loss, metrics["xent"])


# -- FetchSGD on a micro MoE --------------------------------------------------

def test_run_simulation_follows_the_reference_on_qwen2_moe():
    """A micro qwen2-moe (4 experts top-2 and a shared expert at the micro
    widths) through the port's ``run_simulation`` and one orchestrator
    round against the reference's orchestrator round, with a nonzero
    learning rate (``linear_decay``: the default schedule's round 0 has lr
    0, a top-k of ties).  ``run_simulation`` hands its traffic and losses
    through from the orchestrator, and round 0's loss does not depend on
    the learning rate, so one reference run stands for both.  The loss
    (with its aux term) within rtol 1e-3 and the traffic equal, as
    ``test_torch_zoo_fetchsgd.py`` holds qwen3's; the coordinates the
    update moved are Delta's ids, compared as a set."""
    assert_fetchsgd_follows_reference(jsim.micro_cfg("qwen2-moe-a2.7b"),
                                      tsim.micro_cfg("qwen2-moe-a2.7b"))


def assert_fetchsgd_follows_reference(jcfg, tcfg):
    from repro import fed as jfed
    from repro.optim import linear_decay as j_linear_decay
    from repro_torch import fed as tfed
    from repro_torch.optim import linear_decay as t_linear_decay

    sketch = dict(rows=3, cols=1 << 12, k=64)
    jp = reference_params(jcfg)
    ds = jsim.micro_dataset(jcfg)
    fed_kw = dict(rounds=1, clients_per_round=4, aggregate="flat")
    want = jfed.Orchestrator(
        jcfg, JF.FetchSGDConfig(**sketch), jfed.FederationConfig(**fed_kw),
        ds, params=to_jax(jp), lr_fn=j_linear_decay(0.2, 1)).run()
    sim = tsim.run_simulation(tcfg, method="fetchsgd", rounds=1, dataset=ds,
                              fs_cfg=TF.FetchSGDConfig(**sketch),
                              params=params_from_numpy(jp), device="cpu")
    assert sim.traffic == want.traffic
    np.testing.assert_allclose(sim.losses, want.losses, rtol=1e-3)
    got = tfed.Orchestrator(
        tcfg, TF.FetchSGDConfig(**sketch), tfed.FederationConfig(**fed_kw),
        ds, params=params_from_numpy(jp), lr_fn=t_linear_decay(0.2, 1),
        device="cpu").run()
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-3)
    init = np.concatenate([x.ravel() for _, x in TL.flatten(jp)])

    def update(params):
        return np.concatenate([np.asarray(x).ravel()
                               for _, x in TL.flatten(params)]) - init

    up_got, up_want = update(got.params), update(want.params)
    ids, want_ids = set(np.flatnonzero(up_got).tolist()), \
        set(np.flatnonzero(up_want).tolist())
    assert len(ids) == len(want_ids) == sketch["k"]
    # Delta is a top-k of estimates, and the gradients agree to about one
    # bfloat16 step (the estimates measured within 0.6%): an id may trade
    # places only with one whose estimate ties the k-th to within 1e-2
    for mine, theirs, other in ((ids - want_ids, up_got, up_want),
                                (want_ids - ids, up_want, up_got)):
        kth = np.abs(other[np.flatnonzero(other)]).min()
        for i in mine:
            np.testing.assert_allclose(abs(theirs[i]), kth, rtol=1e-2)
    assert len(ids ^ want_ids) <= 2
    common = sorted(ids & want_ids)
    np.testing.assert_allclose(up_got[common], up_want[common], rtol=1e-2)
