"""Port parity for the vision frontend (pixtral-12b): the projected patch
prefix and its positions, the loss on text positions only, the train
path's loss and gradients (``frontend_proj`` included), prefill and
decode with the cache sized with the prefix, and ``serve_lm`` sizing the
cache so, of ``repro_torch`` against ``repro`` on the smoke config (d
256, 2 layers, 16 patches).

Both packages start from identical weights (``params_from_numpy`` of the
reference's init); patches and tokens come from numpy seeds.  Tolerances
are those of ``test_torch_zoo.py`` (loss rtol 5e-5, a leaf's gradients
within 1e-2 of its largest) and ``test_torch_serve.logit_tol``.

The reference's serving example sizes the cache as ``prompt + tokens``
and leaves the 16 patches out: prefill then keeps only the last
``prompt + tokens`` positions and decode overwrites live slots.  With
2 x 12 prompt tokens and 4 decode steps the reference's last logits are
2.986 off a fresh prefill, for logits up to 2.960; sized with the prefix,
3.9e-6 off (``test_reference_example_sizing_drops_the_prefix``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.convert import numpy_from_tensors, params_from_numpy
from repro_torch.launch import serve_lm
from repro_torch.models import layers as tly
from repro_torch.models import transformer as tt

from test_torch_serve import BF16_ULP, jitted, logit_tol, to_np, tokens
from test_torch_zoo import (assert_loss_and_grads_match, batch,
                            reference_params)

ARCH = "pixtral-12b"
P = 16                     # the smoke config's patches


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


def patches(cfg, B: int = 2, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + 200).standard_normal(
        (B, cfg.n_patches, cfg.d_model)).astype(np.float32)


def test_smoke_config_has_a_patch_prefix():
    cfg = tconfigs.get_smoke(ARCH)
    assert (cfg.frontend, cfg.n_patches, cfg.is_encdec) == \
        ("vision", P, False)
    assert tconfigs.get_config(ARCH).n_patches == 1024


def test_patch_prefix_and_positions_match_reference(setup):
    """The projected patches come first, then the token embeddings; the
    positions run over both."""
    jcfg, tcfg, jp, tp = setup
    toks, pat = tokens(jcfg.vocab, S=8), patches(tcfg)
    jx, jpos, jenc = jt._embed_inputs(
        jax.tree_util.tree_map(jnp.asarray, jp),
        {"tokens": jnp.asarray(toks), "patches": jnp.asarray(pat)}, jcfg)
    x, pos, enc = tt._embed_inputs(
        tp, {"tokens": torch.from_numpy(toks).long(),
             "patches": torch.from_numpy(pat)}, tcfg)
    assert enc is None and jenc is None
    assert x.shape == (2, P + 8, 256)
    np.testing.assert_array_equal(pos.reshape(-1).numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(pos.reshape(-1).numpy(), np.arange(P + 8))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(x[:, :P], torch.from_numpy(pat)
                               @ tp["frontend_proj"])
    torch.testing.assert_close(x[:, P:], tp["embed"]["table"][toks],
                               rtol=0, atol=0)


def test_loss_is_on_text_positions_only(setup):
    """The loss is the cross entropy of the text positions' hidden states
    (the last S of P + S): with every label masked but one, it is that
    one position's; the patches are context, so other patches move the
    loss, but they add no label."""
    _, tcfg, _, tp = setup
    b = batch(tcfg.vocab, seed=3)
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    tb["patches"] = torch.from_numpy(patches(tcfg))
    S = tb["tokens"].shape[1]
    with torch.no_grad():
        loss, m = tt.loss_fn(tp, tb, tcfg)
        h, _ = tt._backbone_train(tp, tb, tcfg)
        assert h.shape[1] == P + S
        want = tly.xent_loss(tp["unembed"], h[:, P:], tb["labels"],
                             tcfg.loss_chunk)
        torch.testing.assert_close(loss, want, rtol=0, atol=0)
        one = torch.full_like(tb["labels"], -1)
        one[1, 5] = 7
        l1, _ = tt.loss_fn(tp, {**tb, "labels": one}, tcfg)
        logits = tly.unembed(tp["unembed"], h[1, P + 5]).float()
        torch.testing.assert_close(
            l1, torch.logsumexp(logits, -1) - logits[7], rtol=1e-6,
            atol=1e-6)
        other = torch.from_numpy(patches(tcfg, seed=1))
        l2, _ = tt.loss_fn(tp, {**tb, "patches": other}, tcfg)
    assert float(m["aux"]) == 0.0
    assert not torch.isclose(l2, loss, rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_grads_match_reference(setup, seed):
    jcfg, tcfg, _, _ = setup
    assert_loss_and_grads_match(jcfg, tcfg, seed=seed,
                                extra={"patches": patches(tcfg, seed=seed)})


def test_prefill_and_decode_match_reference(setup):
    """Prefill 16 patches and 8 tokens into a cache sized with the prefix
    (16 + 20 positions), then 12 teacher-forced decode steps, with the
    bfloat16 cache and with a float32 one: the logits, and the cache
    after prefill (its positions exact; k and v within one bfloat16 step
    plus 1e-5 of the largest value)."""
    jcfg, tcfg, jp, tp = setup
    toks, pat = tokens(jcfg.vocab), patches(tcfg)
    jpre, jdec = jitted(jcfg)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        jl, jc = jpre(jp, {"tokens": jnp.asarray(toks[:, :8]),
                           "patches": jnp.asarray(pat)},
                      jt.init_cache(jcfg, 2, P + 20, jdt))
        tl, tc = tt.prefill(tp, {"tokens": torch.from_numpy(toks[:, :8]),
                                 "patches": torch.from_numpy(pat)}, tcfg,
                            tt.init_cache(tcfg, 2, P + 20, tdt))
        np.testing.assert_allclose(to_np(tl), to_np(jl),
                                   **logit_tol(jl, tcfg, torch.float32))
        want, got = jax.tree_util.tree_map(np.asarray, jc), \
            numpy_from_tensors(tc)
        assert int(got["pos"]) == int(want["pos"]) == P + 8
        np.testing.assert_array_equal(got["attn"]["pos_arr"],
                                      want["attn"]["pos_arr"])
        np.testing.assert_array_equal(got["attn"]["pos_arr"][0, 0, :P + 8],
                                      np.arange(P + 8))
        for kv in ("k", "v"):
            w = want["attn"][kv].astype(np.float32)
            np.testing.assert_allclose(got["attn"][kv].astype(np.float32), w,
                                       rtol=BF16_ULP,
                                       atol=1e-5 * np.abs(w).max())
        for t in range(8, 20):
            step = toks[:, t:t + 1]
            jl, jc = jdec(jp, jnp.asarray(step), jc)
            tl, tc = tt.decode_step(tp, torch.from_numpy(step), tcfg, tc)
            np.testing.assert_allclose(to_np(tl), to_np(jl),
                                       **logit_tol(jl, tcfg, tdt),
                                       err_msg=f"{tdt} pos {t}")
        assert int(tc["pos"]) == int(jc["pos"]) == P + 20


def probe(jp, jcfg, size: int) -> tuple[float, float]:
    """The reference's decode after 2 x 12 prompt tokens and 4 steps in a
    float32 cache of ``size`` positions: (its last logits' distance from
    a fresh prefill of the 16 tokens, the largest fresh logit)."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    pat = rng.standard_normal((2, P, jcfg.d_model)).astype(np.float32)
    jpre, jdec = jitted(jcfg)
    logits, c = jpre(jp, {"tokens": toks[:, :12], "patches": pat},
                     jt.init_cache(jcfg, 2, size, jnp.float32))
    for t in range(12, 16):
        logits, c = jdec(jp, toks[:, t:t + 1], c)
    fresh, _ = jpre(jp, {"tokens": toks, "patches": pat},
                    jt.init_cache(jcfg, 2, P + 16, jnp.float32))
    fresh = np.asarray(fresh)
    return float(np.abs(np.asarray(logits) - fresh).max()), \
        float(np.abs(fresh).max())


def test_reference_example_sizing_drops_the_prefix():
    """The reference's own decode, in a cache of ``prompt + tokens`` as
    its serving example sizes it, against a cache sized with the patch
    prefix (params from ``PRNGKey(0)``)."""
    jcfg = jconfigs.get_smoke(ARCH)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    short, scale = probe(jp, jcfg, 12 + 4)
    sized, _ = probe(jp, jcfg, P + 12 + 4)
    assert short > 0.5 * scale and short > 1.0
    assert sized < 1e-4 * scale


@pytest.mark.parametrize("cache_dtype,tol", [(torch.float32, 1e-4),
                                             (torch.bfloat16, 1e-2)])
def test_serve_sizes_the_cache_with_the_prefix(cache_dtype, tol):
    """``serve_lm.serve`` sizes the cache as patches + prompt + tokens:
    its last decode step matches a fresh prefill of the whole sequence
    (float32 cache: 1e-4 of the largest logit; bfloat16: 1e-2, as
    ``test_serve_continues_as_a_fresh_prefill_would``), argmax equal,
    where the reference example's sizing is off by about 3
    (``test_reference_example_sizing_drops_the_prefix``)."""
    cfg = tconfigs.get_smoke(ARCH)
    params = tt.init_params(cfg, seed=0)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
    extra = serve_lm.frontend_inputs(cfg, 2, gen)
    assert extra["patches"].shape == (2, P, 256) and "frames" not in extra
    res = serve_lm.serve(cfg, params, prompts, 5, device="cpu",
                         cache_dtype=cache_dtype, **extra)
    assert res.cache["attn"]["k"].shape[3] == P + 12 + 5
    assert int(res.cache["pos"]) == P + 12 + 4
    seq = torch.cat([prompts, res.tokens[:, :-1]], dim=1)
    with torch.no_grad():
        fresh, _ = tt.prefill(params, {"tokens": seq, **extra}, cfg,
                              tt.init_cache(cfg, 2, P + seq.shape[1]))
    torch.testing.assert_close(res.logits, fresh, rtol=0,
                               atol=tol * float(fresh.abs().max()))
    assert torch.equal(res.logits.argmax(-1), fresh.argmax(-1))


def test_serve_asks_for_the_frontends_inputs():
    cfg = tconfigs.get_smoke(ARCH)
    params = tt.init_params(cfg, seed=0)
    with pytest.raises(ValueError, match="patches"):
        serve_lm.serve(cfg, params, torch.zeros((1, 4), dtype=torch.long), 2,
                       device="cpu")


def test_cli_serves_pixtral():
    """``serve_lm --arch pixtral-12b`` draws patches and prints the
    reference CLI's format, the cache position counting the prefix."""
    got: list[str] = []
    res = serve_lm.main(["--device", "cpu", "--arch", ARCH, "--tokens", "3",
                         "--prompt-len", "5"], log=got.append)
    assert got[0].startswith(f"{ARCH}: prefilled 2x5 in ")
    assert got[0].endswith(f"s (cache pos {P + 5})")
    assert res.tokens.shape == (2, 3) and int(res.cache["pos"]) == P + 5 + 2
    assert res.cache["attn"]["k"].shape[3] == P + 5 + 3
