"""Port parity: the gpt2s-federated train path of repro_torch against repro.

Both packages start from identical weights (``params_from_numpy`` of the
reference's init) on the micro config the reference's simulator uses
(2 layers, d=64, vocab 128), with a sequence long enough that attention
and the cross entropy each take two chunks.

Tolerances: the loss agrees to rtol=1e-5.  The residual stream is rounded
to bfloat16 at every unit boundary, in the forward pass and in the
backward pass, so a float32 difference in the last bit (another
summation order in a matmul) can flip one bfloat16 rounding: one bf16
step is 2**-8 relative.  Gradients are compared per leaf with an absolute
tolerance of 1e-2 times the leaf's largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.core import layout as JL
from repro.data import synthetic
from repro.models import config as jmc
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import layout as TL
from repro_torch.models import attention as ta
from repro_torch.models import config as tmc
from repro_torch.models import layers as tly
from repro_torch.models import transformer as tt

MICRO = dict(d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128,
             vocab=128, attn_chunk=32, loss_chunk=32)


def micro_cfgs():
    return (jmc.reduce_for_smoke(jconfigs.get_config("gpt2s-federated"),
                                 name="micro", **MICRO),
            tmc.reduce_for_smoke(tconfigs.get_config("gpt2s-federated"),
                                 name="micro", **MICRO))


def shapes(tree):
    return [(p, tuple(x.shape)) for p, x in TL.flatten(tree)]


def test_configs_match_reference():
    j, t = jconfigs.get_config("gpt2s-federated"), \
        tconfigs.get_config("gpt2s-federated")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
              "act", "rope_theta", "norm_eps", "attn_chunk", "loss_chunk",
              "hd", "n_units"):
        assert getattr(j, f) == getattr(t, f), f
    js, ts = jconfigs.get_smoke("gpt2s-federated"), \
        tconfigs.get_smoke("gpt2s-federated")
    for f in ("n_layers", "d_model", "n_heads", "d_ff", "vocab", "hd",
              "attn_chunk", "loss_chunk"):
        assert getattr(js, f) == getattr(ts, f), f


def test_init_params_keeps_the_reference_tree():
    jcfg, tcfg = micro_cfgs()
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tt.init_params(tcfg, seed=0)
    assert shapes(tp) == [(p, tuple(x.shape)) for p, x in
                          TL.flatten(jax.tree_util.tree_map(np.asarray, jp))]
    assert all(x.dtype == torch.float32 for _, x in TL.flatten(tp))


def test_full_width_layout_matches_reference():
    """gpt2s-federated at full width: d = 162,148,608 in 17 chunks / 15
    groups, the largest 16,776,960 elements — the same chunks as JAX's."""
    cfg = jconfigs.get_config("gpt2s-federated")
    jl = JL.build_layout(jax.eval_shape(
        lambda: jt.init_params(cfg, jax.random.PRNGKey(0))))
    tl = TL.build_layout(tt.init_params(tconfigs.get_config(
        "gpt2s-federated")))
    assert tl.total == jl.total == 162_148_608
    assert (tl.num_chunks, len(tl.groups)) == (17, 15)
    assert max(c.size for c in tl.chunks) == 16_776_960
    assert [(c.path, c.row_start, c.n_rows, c.offset) for c in tl.chunks] == \
        [(c.path, c.row_start, c.n_rows, c.offset) for c in jl.chunks]


def test_loss_and_grads_match_reference():
    jcfg, tcfg = micro_cfgs()
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    batch = synthetic.ClassShardLM(vocab=128, seq_len=48, n_classes=4,
                                   n_clients=8).client_batch(1)
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jt.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                             jcfg, remat=False), has_aux=True)(jp)
    tloss, tg = tt.value_and_grad(
        tp, {k: torch.as_tensor(v, dtype=torch.int64)
             for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = dict(TL.flatten(jax.tree_util.tree_map(np.asarray, jg)))
    for path, g in TL.flatten(tg):
        w = want[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-2 * np.abs(w).max(),
                                   err_msg=path)


def test_layers_match_reference(rng):
    from repro.models import attention as ja
    from repro.models import layers as jly
    x = rng.normal(size=(2, 40, 2, 32)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    np.testing.assert_allclose(
        ta.rope(torch.from_numpy(x), torch.from_numpy(pos)[None].long(),
                1e4).numpy(),
        np.asarray(ja.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        rtol=1e-5, atol=1e-5)
    h = rng.normal(size=(2, 40, 64)).astype(np.float32)
    scale = rng.normal(size=64).astype(np.float32)
    np.testing.assert_allclose(
        tly.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(h),
                    1e-5).numpy(),
        np.asarray(jly.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(h),
                               1e-5)), rtol=1e-5, atol=1e-5)
    w = rng.normal(size=(64, 50)).astype(np.float32)
    labels = rng.integers(-1, 50, size=(2, 40)).astype(np.int32)
    np.testing.assert_allclose(
        float(tly.xent_loss({"w": torch.from_numpy(w)}, torch.from_numpy(h),
                            torch.from_numpy(labels).long(), 16)),
        float(jly.xent_loss({"w": jnp.asarray(w)}, jnp.asarray(h),
                            jnp.asarray(labels), 16)), rtol=1e-5)
    q, k, v = (rng.normal(size=(2, 40, 2, 32)).astype(np.float32)
               for _ in range(3))
    posb = np.broadcast_to(pos, (2, 40))
    tpos = torch.from_numpy(posb.copy()).long()
    np.testing.assert_allclose(
        ta._attend(*(torch.from_numpy(a) for a in (q, k, v)), tpos, tpos,
                   causal=True, window=0, chunk=16).numpy(),
        np.asarray(ja._attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(posb), jnp.asarray(posb),
                              causal=True, window=0, chunk=16)),
        rtol=1e-5, atol=1e-5)


def test_mixed_dtype_matmul_promotes_like_jnp(rng):
    a = rng.normal(size=(3, 8)).astype(np.float32)
    b = rng.normal(size=(8, 5)).astype(np.float32)
    got = tly.matmul(torch.from_numpy(a).to(torch.bfloat16),
                     torch.from_numpy(b))
    want = jnp.asarray(a).astype(jnp.bfloat16) @ jnp.asarray(b)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
