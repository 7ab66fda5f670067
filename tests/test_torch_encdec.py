"""Port parity for the encoder-decoder (whisper-small): the sinusoidal
positions, the encoder, cross-attention, the train path (loss and
gradients, ``enc.*`` and ``frontend_proj`` included), the decode cache
with its cross-attention keys and values, prefill and decode, and the
cache's conversion between the packages, of ``repro_torch`` against
``repro`` on the smoke config (d 256, 2 + 2 layers, 64 frames).

Both packages start from identical weights (``params_from_numpy`` of the
reference's init); frames and tokens come from numpy seeds.

Tolerances.  The encoder is float32 throughout (its residual is not
rounded to bfloat16), so it agrees to rtol 1e-4 (measured: 5.9e-7 of the
largest value over 3 seeds) and one cross-attention to rtol 1e-5
(measured: 6.1e-7 of the largest).  The train path
rounds the decoder's residual to bfloat16 at every unit boundary, so the
loss and gradients are held as ``test_torch_zoo.py`` holds the dense
zoo's (loss rtol 5e-5, a leaf's gradients within 1e-2 of its largest).
Prefill and decode are held to ``test_torch_serve.logit_tol``: rtol 1e-4
with a float32 cache, 2**-8 of the largest logit with the bfloat16 one
(whose cross-attention keys and values are rounded to bfloat16 too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.convert import numpy_from_tensors, params_from_numpy
from repro_torch.launch import serve_lm
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt

from test_torch_serve import BF16_ULP, jitted, logit_tol, to_np, tokens
from test_torch_zoo import assert_loss_and_grads_match, reference_params

ARCH = "whisper-small"


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Smoke-size ops are small: two intra-op threads are as fast and do
    not oversubscribe the cores when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jp = reference_params(jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jp)


def frames(cfg, B: int = 2, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + 100).standard_normal(
        (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def test_smoke_config_is_an_encoder_decoder():
    cfg = tconfigs.get_smoke(ARCH)
    assert (cfg.is_encdec, cfg.enc_layers, cfg.enc_seq, cfg.frontend) == \
        (True, 2, 64, "audio")
    full = tconfigs.get_config(ARCH)
    assert (full.enc_layers, full.enc_seq, full.n_patches) == (12, 1500, 0)


@pytest.mark.parametrize("seq,d", [(64, 256), (1500, 768), (7, 10)])
def test_sinusoid_matches_reference(seq, d):
    """Within one float32 step of the largest angle (``seq - 1`` radians):
    ``10000 ** (dim / d)`` may round to its neighbour in either package,
    which moves an angle near 1500 by 1.2e-4 (measured gap at 1500 x 768:
    3.1e-5)."""
    want = np.asarray(jt._sinusoid(seq, d))
    got = tt._sinusoid(seq, d)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=np.spacing(np.float32(seq - 1)))


def test_encoder_matches_reference(setup):
    jcfg, tcfg, jp, tp = setup
    f = frames(tcfg)
    want = np.asarray(jt._encoder(jax.tree_util.tree_map(jnp.asarray, jp),
                                  jnp.asarray(f), jcfg))
    got = tt._encoder(tp, torch.from_numpy(f), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 64, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("S", [1, 9, 100])
def test_cross_attention_matches_reference(setup, S):
    """Queries of 1 (a decode step), 9 and 100 positions (two query
    chunks of 64) over the 64 encoder positions, every slot visible."""
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 256)).astype(np.float32)
    enc = rng.standard_normal((2, 64, 256)).astype(np.float32)
    jx = jax.tree_util.tree_map(lambda a: jnp.asarray(a[1]),
                                jp["units"]["m0"]["xattn"])
    tx = {k: v[1] for k, v in tp["units"]["m0"]["xattn"].items()}
    assert sorted(tx) == ["wk", "wo", "wq", "wv"]      # no q/k norm
    want = np.asarray(jattn.cross_attn_forward(jx, jnp.asarray(x),
                                               jnp.asarray(enc), jcfg))
    got = tattn.cross_attn_forward(tx, torch.from_numpy(x),
                                   torch.from_numpy(enc), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_encoder_is_bidirectional_without_rope(setup):
    """The encoder sees every frame from every position: changing the
    last frame moves the first position's output; and it has no RoPE
    (its attention is the same for any ``rope_theta``)."""
    import dataclasses
    _, tcfg, _, tp = setup
    f = torch.from_numpy(frames(tcfg))
    g = f.clone()
    g[:, -1] += 1.0
    a, b = (tt._encoder(tp, x, tcfg) for x in (f, g))
    assert not torch.allclose(a[:, 0], b[:, 0], atol=1e-4)
    other = dataclasses.replace(tcfg, rope_theta=3.0)
    torch.testing.assert_close(tt._encoder(tp, f, other), a, rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_grads_match_reference(setup, seed):
    jcfg, tcfg, _, _ = setup
    assert_loss_and_grads_match(jcfg, tcfg, seed=seed,
                                extra={"frames": frames(tcfg, seed=seed)})


def test_init_params_has_the_encoder_and_the_cross_members(setup):
    _, tcfg, jp, _ = setup
    tp = tt.init_params(tcfg, seed=0)
    assert sorted(tp) == sorted(jp) == ["embed", "enc", "final_norm",
                                        "frontend_proj", "unembed", "units"]
    assert sorted(tp["units"]["m0"]) == ["attn", "mlp", "norm1", "norm2",
                                         "xattn", "xnorm"]
    assert sorted(tp["enc"]["units"]["m0"]["attn"]) == ["wk", "wo", "wq",
                                                        "wv"]
    assert tp["enc"]["units"]["m0"]["attn"]["wq"].shape == (2, 256, 4, 64)
    assert tp["frontend_proj"].shape == (256, 256)


@pytest.mark.parametrize("jdt,tdt", [(jnp.bfloat16, torch.bfloat16),
                                     (jnp.float32, torch.float32)])
def test_init_cache_keeps_the_reference_tree(setup, jdt, tdt):
    jcfg, tcfg, _, _ = setup
    want = jax.tree_util.tree_map(np.asarray, jt.init_cache(jcfg, 2, 24, jdt))
    got = numpy_from_tensors(tt.init_cache(tcfg, 2, 24, tdt))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(want)[0]):
        assert (g.shape, g.dtype) == (w.shape, w.dtype), path
        np.testing.assert_array_equal(g.astype(np.float32),
                                      w.astype(np.float32))
    assert got["xattn"]["k"].shape == (2, 1, 2, 64, 4, 64)


def test_prefill_and_decode_match_reference(setup):
    """Prefill 8 tokens over 64 frames, then 12 teacher-forced decode
    steps, with the bfloat16 cache and with a float32 one: the logits,
    and the cache after prefill (positions exact; self- and
    cross-attention k and v within one bfloat16 step plus 1e-5 of the
    largest value).  Then the reference's cache after prefill, converted,
    carries the port's decode as it carries the reference's."""
    jcfg, tcfg, jp, tp = setup
    toks = tokens(jcfg.vocab)
    f = frames(tcfg)
    jpre, jdec = jitted(jcfg)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        jl, jc = jpre(jp, {"tokens": jnp.asarray(toks[:, :8]),
                           "frames": jnp.asarray(f)},
                      jt.init_cache(jcfg, 2, 24, jdt))
        tl, tc = tt.prefill(tp, {"tokens": torch.from_numpy(toks[:, :8]),
                                 "frames": torch.from_numpy(f)}, tcfg,
                            tt.init_cache(tcfg, 2, 24, tdt))
        np.testing.assert_allclose(to_np(tl), to_np(jl),
                                   **logit_tol(jl, tcfg, torch.float32))
        want, got = jax.tree_util.tree_map(np.asarray, jc), \
            numpy_from_tensors(tc)
        assert int(got["pos"]) == int(want["pos"]) == 8
        np.testing.assert_array_equal(got["attn"]["pos_arr"],
                                      want["attn"]["pos_arr"])
        for kind in ("attn", "xattn"):
            for kv in ("k", "v"):
                w = want[kind][kv].astype(np.float32)
                assert got[kind][kv].dtype == want[kind][kv].dtype
                np.testing.assert_allclose(
                    got[kind][kv].astype(np.float32), w, rtol=BF16_ULP,
                    atol=1e-5 * np.abs(w).max(), err_msg=f"{kind}.{kv}")
        crossed = params_from_numpy(want)
        for t in range(8, 20):
            step = toks[:, t:t + 1]
            jl, jc = jdec(jp, jnp.asarray(step), jc)
            tl, tc = tt.decode_step(tp, torch.from_numpy(step), tcfg, tc)
            xl, crossed = tt.decode_step(tp, torch.from_numpy(step), tcfg,
                                         crossed)
            for out in (tl, xl):
                np.testing.assert_allclose(
                    to_np(out), to_np(jl), **logit_tol(jl, tcfg, tdt),
                    err_msg=f"{tdt} pos {t}")
        assert int(tc["pos"]) == int(jc["pos"]) == 20


def test_caches_convert_both_ways(setup):
    """A reference cache after prefill through ``params_from_numpy`` and
    back is bitwise the same tree, the cross-attention's keys and values
    included."""
    jcfg, _, jp, _ = setup
    jpre, _ = jitted(jcfg)
    _, jc = jpre(jp, {"tokens": jnp.asarray(tokens(jcfg.vocab)[:, :5]),
                      "frames": jnp.asarray(frames(jcfg))},
                 jt.init_cache(jcfg, 2, 8))
    want = jax.tree_util.tree_map(np.asarray, jc)
    tc = params_from_numpy(want)
    assert tc["xattn"]["k"].dtype == torch.bfloat16
    back = numpy_from_tensors(tc)
    for kind, parts in (("attn", ("k", "v", "pos_arr")),
                        ("xattn", ("k", "v"))):
        for part in parts:
            assert back[kind][part].dtype == want[kind][part].dtype
            np.testing.assert_array_equal(
                back[kind][part].view(np.uint8),
                want[kind][part].view(np.uint8))
    assert float(np.abs(want["xattn"]["k"].astype(np.float32)).max()) > 0
    assert int(back["pos"]) == 5


def test_cli_serves_whisper():
    """``serve_lm --arch whisper-small`` draws frames and serves the smoke
    config in the reference CLI's format (the cache holds no prefix)."""
    got: list[str] = []
    res = serve_lm.main(["--device", "cpu", "--arch", ARCH, "--tokens", "3",
                         "--prompt-len", "5"], log=got.append)
    assert got[0].startswith(f"{ARCH}: prefilled 2x5 in ")
    assert got[0].endswith("s (cache pos 5)")
    assert res.tokens.shape == (2, 3) and int(res.cache["pos"]) == 5 + 2
    assert float(res.cache["xattn"]["k"].float().abs().max()) > 0
