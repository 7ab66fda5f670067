"""Port parity for the slice as a whole: FetchSGD training rounds of the
micro gpt2s-federated model, the port's driver against the reference's
loop (``examples/train_federated_lm.py``) from identical weights and
identical client batches.

Tolerances: round 0 runs before any update, so its loss agrees as the
model's loss does (rtol=1e-5).  Later rounds apply a top-k of sketch
estimates built from gradients that agree only to bfloat16 roundings
(see ``test_torch_model.py``), so an id at the edge of the top-k can
differ; their losses are compared with rtol=1e-3, and at most 5% of the
coordinates the reference moved may move differently in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import fetchsgd as JF
from repro.core import layout as JL
from repro.data import federated, synthetic
from repro.models import config as jmc
from repro.models import transformer as jt
from repro.optim import linear_decay
import repro_torch
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import fetchsgd as TF
from repro_torch.core import layout as TL
from repro_torch.launch import train_lm
from repro_torch.models import config as tmc

MICRO = dict(d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128,
             vocab=128, attn_chunk=32, loss_chunk=32)
ROUNDS, CLIENTS, LR = 3, 4, 0.16
SKETCH = dict(rows=5, cols=4096, k=256, momentum=0.9)


def reference_rounds(cfg, params, dataset, fs_cfg):
    """The reference's round loop (train_federated_lm.py), jitted."""
    lay = JL.build_layout(params)
    lr_fn = linear_decay(LR, ROUNDS)
    opt = JF.init_state(fs_cfg)

    @jax.jit
    def grads_of(params, batch):
        (loss, _), g = jax.value_and_grad(
            lambda p: jt.loss_fn(p, batch, cfg, remat=False),
            has_aux=True)(params)
        return loss, g

    sketch = jax.jit(JF.sketch_grads, static_argnames=("layout", "cfg"))
    server = jax.jit(JF.server_step, static_argnames=("layout", "cfg"))
    apply = jax.jit(JF.apply_delta, static_argnames=("layout",))
    losses = []
    for r in range(ROUNDS):
        clients = federated.sample_clients(dataset.n_clients, CLIENTS, r)
        tables, loss_sum = [], 0.0
        for c in clients:
            cb = dataset.client_batch(int(c))
            loss, g = grads_of(params, {k: jnp.asarray(v)
                                        for k, v in cb.items()})
            tables.append(sketch(g, layout=lay, cfg=fs_cfg))
            loss_sum += float(loss)
        agg = sum(tables) / len(tables)
        delta, opt = server(agg, opt, lr_fn(r), layout=lay, cfg=fs_cfg)
        params = apply(params, layout=lay, delta=delta)
        losses.append(loss_sum / len(clients))
    return losses, params


def test_three_micro_rounds_follow_the_reference():
    jcfg = jmc.reduce_for_smoke(jconfigs.get_config("gpt2s-federated"),
                                name="micro", **MICRO)
    tcfg = tmc.reduce_for_smoke(tconfigs.get_config("gpt2s-federated"),
                                name="micro", **MICRO)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    dataset = synthetic.PersonaLM(vocab=128, seq_len=16,
                                  n_clients=ROUNDS * CLIENTS)
    init = {p: x.clone() for p, x in TL.flatten(tp)}
    want, jp_end = reference_rounds(jcfg, jp, dataset,
                                      JF.FetchSGDConfig(**SKETCH))
    tcfg_fs = TF.FetchSGDConfig(**SKETCH)
    records, meter = train_lm.train(
        tcfg, tcfg_fs, tp, dataset, rounds=ROUNDS, clients_per_round=CLIENTS,
        peak_lr=LR, device="cpu", log=lambda *_: None)
    got = [r.loss for r in records]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert want[-1] < want[0] and got[-1] < got[0]
    assert all(r.delta_size == r.delta_unique == SKETCH["k"]
               for r in records)
    assert meter.rounds == ROUNDS
    # the driver updated ``tp`` in place; its updates and the reference's
    # move the same coordinates by the same amounts
    j_end = dict(TL.flatten(jax.tree_util.tree_map(np.asarray, jp_end)))
    moved = differ = 0
    for path, x in TL.flatten(tp):
        step_t = x.numpy() - init[path].numpy()
        step_j = j_end[path] - init[path].numpy()
        moved += np.count_nonzero(step_j)
        differ += np.count_nonzero(~np.isclose(step_t, step_j, rtol=1e-2,
                                               atol=1e-6))
    assert moved > 0 and differ <= 0.05 * moved


def test_data_schedules_and_accounting_match_reference():
    from repro.core import compression as jcomp
    from repro.optim import triangular
    from repro_torch.core import compression as tcomp
    from repro_torch.data import federated as tfed
    from repro_torch.data import synthetic as tsyn
    from repro_torch.optim import linear_decay as t_linear
    from repro_torch.optim import triangular as t_tri
    for jd, td in ((synthetic.PersonaLM(vocab=300, seq_len=20),
                    tsyn.PersonaLM(vocab=300, seq_len=20)),
                   (synthetic.ClassShardLM(vocab=300, seq_len=20),
                    tsyn.ClassShardLM(vocab=300, seq_len=20))):
        for c in (0, 7, 999):
            a, b = jd.client_batch(c), td.client_batch(c)
            for key in ("tokens", "labels"):
                np.testing.assert_array_equal(a[key], b[key])
    for r in range(5):
        np.testing.assert_array_equal(federated.sample_clients(100, 4, r),
                                      tfed.sample_clients(100, 4, r))
    for j, t in ((linear_decay(0.16, 7), t_linear(0.16, 7)),
                 (triangular(0.2, 10), t_tri(0.2, 10))):
        for step in range(12):
            assert np.float32(j(step)) == t(step)
    for fn, args, kw in (("fetchsgd_round", (5, 1 << 20, 25_000),
                          {"d": 10**6, "staleness": 3}),
                         ("local_topk_round", (100, 4000), {"staleness": 2}),
                         ("fedavg_round", (1234,), {}),
                         ("uncompressed_round", (1234,), {})):
        got, want = (getattr(m, fn)(*args, **kw) for m in (tcomp, jcomp))
        assert (got.upload, got.download) == (want.upload, want.download)
    jm, tm = jcomp.TrafficMeter(d=10**6), tcomp.TrafficMeter(d=10**6)
    for m, mod in ((jm, jcomp), (tm, tcomp)):
        m.record(mod.fetchsgd_round(5, 4096, 100, d=10**6), 4)
    assert jm.compression(4) == tm.compression(4)


def test_driver_cli_runs_on_the_cpu(capsys):
    records, _ = train_lm.main(["--rounds", "2", "--device", "cpu",
                                "--cols", "4096", "--k", "64",
                                "--seq-len", "16", "--clients-per-round",
                                "2"])
    out = capsys.readouterr().out
    assert "round    1" in out and "total traffic" in out
    assert [r.delta_size for r in records] == [64, 64]
    assert all(np.isfinite(r.loss) for r in records)


def test_entry_points_need_cuda_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.resolve_device(None)
    assert repro_torch.resolve_device("cpu").type == "cpu"
