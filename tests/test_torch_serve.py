"""Port parity for the serve path: ``init_cache`` / ``prefill`` /
``decode_step`` and ``launch/serve_lm`` of ``repro_torch`` against
``repro``'s, and the reference's own serve tests as twins.

Both packages start from identical weights (``params_from_numpy`` of the
reference's init) on the smoke configs, plus one case whose ``head_dim``
is not ``d_model / n_heads``.

Tolerances.  The serve path is float32 but its KV cache, which is
bfloat16 (the reference's default).  Prefill attends over the fresh
float32 k and v, so its logits agree to rtol 1e-4 (measured: 1.4e-6 of
the largest logit).  The cache it writes holds the same positions, and k
and v within one bfloat16 step (2**-7 of the value at most: a float32
difference in the last bit can round to the neighbouring bfloat16 value)
plus 1e-5 of the largest value (float32 noise of values that cancel to
near zero, several bfloat16 steps of their own).  Decode attends over the
cache, so such a flip moves the logits: 12 teacher-forced steps agree to
rtol 1e-4 with a float32 cache (measured 1.9e-6 of the largest logit),
and within 2**-8 of the largest logit with the bfloat16 cache (measured
2.6e-4 of it) or where ``attn_compute_dtype="bfloat16"`` rounds q, k and
v; ``param_dtype="bfloat16"`` rounds every matmul's output, so its
logits, k and v are held to four bfloat16 steps of the largest value
(``logit_tol``).  The window case uses a window of 4 and a prompt of 8,
a multiple of it, where the reference's ring buffer is right
(``test_ring_buffer_decode_matches_full_window``).
"""

import dataclasses
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import config as jmc
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.convert import numpy_from_tensors, params_from_numpy
from repro_torch.launch import serve_lm
from repro_torch.models import config as tmc
from repro_torch.models import layers as tly
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt

ROOT = Path(__file__).resolve().parent.parent
BF16_STEP = 2 ** -8     # bfloat16's relative precision
BF16_ULP = 2 ** -7      # one step of bfloat16 as a share of the value, at most


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Smoke-size ops are small: two intra-op threads are as fast and do
    not oversubscribe the cores when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cfg_pair(case: str):
    if case == "qwen3-hd128":
        return (jmc.reduce_for_smoke(jconfigs.get_config("qwen3-0.6b"),
                                     name=case, head_dim=128),
                tmc.reduce_for_smoke(tconfigs.get_config("qwen3-0.6b"),
                                     name=case, head_dim=128))
    arch, _, variant = case.partition(":")
    kw = {"attn-bf16": dict(attn_compute_dtype="bfloat16"),
          "param-bf16": dict(param_dtype="bfloat16"),
          "tied": dict(tie_embeddings=True),
          "window": dict(sliding_window=4), "ring6": dict(sliding_window=6),
          "": {}}[variant]
    return (dataclasses.replace(jconfigs.get_smoke(arch), **kw),
            dataclasses.replace(tconfigs.get_smoke(arch), **kw))


def reference_params(jcfg, seed: int = 0):
    return jax.tree_util.tree_map(
        np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(seed)))


def jitted(jcfg):
    return (jax.jit(lambda p, b, c: jt.prefill(p, b, jcfg, c)),
            jax.jit(lambda p, t, c: jt.decode_step(p, t, jcfg, c)))


def to_np(x) -> np.ndarray:
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def tokens(vocab: int, B: int = 2, S: int = 20, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def logit_tol(ref, tcfg, cache_dtype) -> dict:
    """rtol 1e-4 where every value the logits depend on is float32;
    2**-8 of the largest logit (bfloat16's precision) where a bfloat16
    rounding (the cache, or ``attn_compute_dtype``) lies on the path;
    four bfloat16 steps of it (4 x 2**-7) where the parameters, and so
    every matmul's output, are bfloat16 (measured up to 1.28e-2 of the
    largest logit over 3 archs x 2 prompts)."""
    scale = np.abs(to_np(ref)).max()
    if tcfg.param_dtype == "bfloat16":
        return dict(rtol=0, atol=4 * BF16_ULP * scale)
    if tcfg.attn_compute_dtype == "float32" and \
            cache_dtype == torch.float32:
        return dict(rtol=1e-4, atol=1e-4 * scale)
    return dict(rtol=0, atol=BF16_STEP * scale)


CASES = ["qwen3-0.6b", "internlm2-1.8b", "deepseek-7b", "glm4-9b",
         "qwen3-hd128", "internlm2-1.8b:attn-bf16", "glm4-9b:tied",
         "qwen3-0.6b:window", "deepseek-7b:param-bf16"]


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_match_reference(case):
    """Prefill 8 tokens, then 12 teacher-forced decode steps, with the
    bfloat16 cache and with a float32 one."""
    jcfg, tcfg = cfg_pair(case)
    jp = reference_params(jcfg)
    tp = params_from_numpy(jp)
    toks = tokens(jcfg.vocab)
    jpre, jdec = jitted(jcfg)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        jc = jt.init_cache(jcfg, 2, 24, jdt)
        tc = tt.init_cache(tcfg, 2, 24, tdt)
        assert [(p, x.shape, x.dtype) for p, x in
                sorted(numpy_from_tensors(tc)["attn"].items())] == \
            [(p, x.shape, x.dtype) for p, x in sorted(
                jax.tree_util.tree_map(np.asarray, jc)["attn"].items())]
        jl, jc = jpre(jp, {"tokens": jnp.asarray(toks[:, :8])}, jc)
        tl, tc = tt.prefill(tp, {"tokens": torch.from_numpy(toks[:, :8])},
                            tcfg, tc)
        np.testing.assert_allclose(to_np(tl), to_np(jl),
                                   **logit_tol(jl, tcfg, torch.float32))
        want, got = jax.tree_util.tree_map(np.asarray, jc), \
            numpy_from_tensors(tc)
        assert got["pos"].shape == () and int(got["pos"]) == int(want["pos"])
        np.testing.assert_array_equal(got["attn"]["pos_arr"],
                                      want["attn"]["pos_arr"])
        for kv in ("k", "v"):
            w = want["attn"][kv].astype(np.float32)
            tol = dict(rtol=0, atol=4 * BF16_ULP * np.abs(w).max()) \
                if tcfg.param_dtype == "bfloat16" else \
                dict(rtol=BF16_ULP, atol=1e-5 * np.abs(w).max())
            np.testing.assert_allclose(got["attn"][kv].astype(np.float32), w,
                                       **tol)
        for t in range(8, 20):
            jl, jc = jdec(jp, jnp.asarray(toks[:, t:t + 1]), jc)
            tl, tc = tt.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]),
                                    tcfg, tc)
            np.testing.assert_allclose(
                to_np(tl), to_np(jl),
                **logit_tol(jl, tcfg, tdt),
                err_msg=f"{tdt} pos {t}")
        assert int(tc["pos"]) == int(jc["pos"]) == 20


def test_caches_convert_both_ways():
    """A reference cache through ``params_from_numpy`` and back is bitwise
    the same tree; ``pos`` is a 0-d int32 tensor."""
    jcfg, tcfg = cfg_pair("glm4-9b")
    jp = reference_params(jcfg)
    jpre, _ = jitted(jcfg)
    _, jc = jpre(jp, {"tokens": jnp.asarray(tokens(jcfg.vocab)[:, :5])},
                 jt.init_cache(jcfg, 2, 8))
    want = jax.tree_util.tree_map(np.asarray, jc)
    tc = params_from_numpy(want)
    assert tc["pos"].shape == () and tc["pos"].dtype == torch.int32
    assert tc["attn"]["k"].dtype == torch.bfloat16
    back = numpy_from_tensors(tc)
    for part in ("k", "v", "pos_arr"):
        assert back["attn"][part].dtype == want["attn"][part].dtype
        np.testing.assert_array_equal(back["attn"][part].view(np.uint8),
                                      want["attn"][part].view(np.uint8))
    assert int(back["pos"]) == 5


NEW_ARCHS = ("qwen2-moe-a2.7b", "llama4-maverick-400b-a17b", "xlstm-350m",
             "jamba-v0.1-52b")
STATE_KINDS = ("mamba", "mlstm", "slstm")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_moe_and_recurrent_prefill_and_decode_match_reference(arch):
    """Prefill 8 tokens, then 12 teacher-forced decode steps, against the
    reference, for the MoE and recurrent archs: the logits (rtol 1e-4
    with a float32 cache, 2**-8 of the largest with the bfloat16 one, as
    for the dense zoo), and the cache after prefill: the recurrent states
    (float32 on both sides) within 1e-4 of their largest value, k and v
    as for the dense zoo.  Both packages drop the same MoE tokens (the
    same routing, the same capacity), so the published capacity is kept.
    Then the reference's cache after prefill, converted, carries the
    port's decode as it carries the reference's: every cache kind crosses
    the packages."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp = reference_params(jcfg)
    tp = params_from_numpy(jp)
    toks = tokens(jcfg.vocab)
    jpre, jdec = jitted(jcfg)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        jc = jt.init_cache(jcfg, 2, 24, jdt)
        tc = tt.init_cache(tcfg, 2, 24, tdt)
        want = jax.tree_util.tree_map(np.asarray, jc)
        got = numpy_from_tensors(tc)
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for (path, g), (_, w) in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree_util.tree_flatten_with_path(want)[0]):
            assert (g.shape, g.dtype) == (w.shape, w.dtype), path
            np.testing.assert_array_equal(g.astype(np.float32),
                                          w.astype(np.float32))
        jl, jc = jpre(jp, {"tokens": jnp.asarray(toks[:, :8])}, jc)
        tl, tc = tt.prefill(tp, {"tokens": torch.from_numpy(toks[:, :8])},
                            tcfg, tc)
        np.testing.assert_allclose(to_np(tl), to_np(jl),
                                   **logit_tol(jl, tcfg, torch.float32))
        want, got = jax.tree_util.tree_map(np.asarray, jc), \
            numpy_from_tensors(tc)
        assert int(got["pos"]) == int(want["pos"]) == 8
        for kind in STATE_KINDS:
            for part, w in want.get(kind, {}).items():
                np.testing.assert_allclose(
                    got[kind][part], w, rtol=0,
                    atol=1e-4 * np.abs(w[np.abs(w) < 1e8]).max(),
                    err_msg=f"{kind}.{part}")
        if "attn" in want:
            np.testing.assert_array_equal(got["attn"]["pos_arr"],
                                          want["attn"]["pos_arr"])
            for kv in ("k", "v"):
                w = want["attn"][kv].astype(np.float32)
                np.testing.assert_allclose(
                    got["attn"][kv].astype(np.float32), w, rtol=BF16_ULP,
                    atol=1e-5 * np.abs(w).max())
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


# -- the reference's serve tests, as twins ------------------------------------

def test_decode_matches_forward_dense():
    """Token-by-token decode reproduces the parallel forward (teacher
    forcing); the train forward carries bf16 residuals between units while
    the serve path stays float32, hence the reference's 5e-2."""
    cfg = tconfigs.get_smoke("internlm2-1.8b")
    params = tt.init_params(cfg, seed=1)
    S = 12
    toks = torch.randint(0, cfg.vocab, (1, S),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        h = tt.hidden_states(params, toks, cfg)
        full = tly.unembed(params["unembed"], h)[0]
        cache = tt.init_cache(cfg, 1, S + 4)
        logits, cache = tt.prefill(params, {"tokens": toks[:, :4]}, cfg,
                                   cache)
        torch.testing.assert_close(logits[0], full[3], rtol=5e-2, atol=5e-2)
        for t in range(4, S):
            logits, cache = tt.decode_step(params, toks[:, t:t + 1], cfg,
                                           cache)
            torch.testing.assert_close(logits[0], full[t], rtol=5e-2,
                                       atol=5e-2, msg=f"pos {t}")


def test_sliding_window_masks_old_tokens():
    """With window W, the hidden state at position t ignores tokens
    < t - W + 1."""
    cfg = dataclasses.replace(tconfigs.get_smoke("deepseek-7b"),
                              sliding_window=8)
    params = tt.init_params(cfg)
    t1 = torch.randint(0, cfg.vocab, (1, 24),
                       generator=torch.Generator().manual_seed(3))
    t2 = t1.clone()
    t2[:, :8] = (t1[:, :8] + 7) % cfg.vocab       # differ only in the past
    with torch.no_grad():
        h1, h2 = (tt.hidden_states(params, t, cfg)[:, -1] for t in (t1, t2))
        torch.testing.assert_close(h1, h2, rtol=1e-4, atol=1e-4)
        full = dataclasses.replace(cfg, sliding_window=0)
        assert not torch.allclose(tt.hidden_states(params, t1, full)[:, -1],
                                  tt.hidden_states(params, t2, full)[:, -1],
                                  rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("prompt", [4, 8, 9])
def test_ring_buffer_decode_matches_full_window(prompt):
    """A ring-buffer cache (capacity = W = 6) decodes as a big cache with
    the same window mask.  With a prompt of 4 the ring also equals the
    reference's.  Prompts of 8 and 9 are longer than the window and not a
    multiple of it: there the reference's prefill writes its last 6 keys
    into slots 0..5 while its decode writes position p into slot p % 6, so
    its ring overwrites keys still inside the window, and its own ring and
    big cache differ by more than 1 in the logits."""
    jcfg, tcfg = cfg_pair("glm4-9b:ring6")
    jp = reference_params(jcfg)
    tp = params_from_numpy(jp)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(4), (1, 20), 0,
                                         jcfg.vocab))
    big_cfg = dataclasses.replace(tcfg, sliding_window=0)
    big = tt.init_cache(big_cfg, 1, 32)            # window by the mask only
    ring = tt.init_cache(tcfg, 1, 32)
    assert ring["attn"]["k"].shape[3] == 6 and big["attn"]["k"].shape[3] == 32
    jpre, jdec = jitted(jcfg)
    jring = jt.init_cache(jcfg, 1, 32)
    jbig = jt.init_cache(dataclasses.replace(jcfg, sliding_window=0), 1, 32)
    first = {"tokens": toks[:, :prompt]}
    lb, big = tt.prefill(tp, {"tokens": torch.from_numpy(first["tokens"])},
                         tcfg, big)
    lr, ring = tt.prefill(tp, {"tokens": torch.from_numpy(first["tokens"])},
                          tcfg, ring)
    torch.testing.assert_close(lr, lb, rtol=1e-3, atol=1e-3)
    jr, jring = jpre(jp, first, jring)
    jb, jbig = jpre(jp, first, jbig)
    ref_gap = 0.0
    for t in range(prompt, 20):
        tok = toks[:, t:t + 1]
        lb, big = tt.decode_step(tp, torch.from_numpy(tok), tcfg, big)
        lr, ring = tt.decode_step(tp, torch.from_numpy(tok), tcfg, ring)
        torch.testing.assert_close(lr, lb, rtol=1e-3, atol=1e-3,
                                   msg=f"pos {t}")
        np.testing.assert_array_equal(
            np.sort(ring["attn"]["pos_arr"][0, 0].numpy()),
            np.arange(t - 5, t + 1))           # the window's last 6 tokens
        jr, jring = jdec(jp, tok, jring)
        jb, jbig = jdec(jp, tok, jbig)
        ref_gap = max(ref_gap, float(np.abs(to_np(jr) - to_np(jb)).max()))
        if prompt == 4:
            np.testing.assert_allclose(
                to_np(lr), to_np(jr), rtol=0,
                atol=BF16_STEP * np.abs(to_np(jr)).max(), err_msg=f"pos {t}")
    assert (ref_gap > 1.0) == (prompt in (8, 9))


# -- serve_lm -----------------------------------------------------------------

def test_serve_continues_as_a_fresh_prefill_would():
    """The chip's consistency check at smoke size: the logits of serve's
    last decode step against a fresh prefill of the whole sequence.  The
    decode attends over the bfloat16 cache and the prefill over float32
    k and v; over the five archs and three seeds the gap was at most
    5.4e-3 of the largest logit, so it is held to 1e-2 of it, and the
    argmax equal (``chip_smoke.py`` holds the full-width runs so).  A MoE
    prefill drops tokens past an expert's capacity and a decode of two
    tokens never does, so the MoE archs run under no-drop capacity
    (``moe.no_drop``); the recurrent archs' states are float32.
    whisper-small's requests carry frames and pixtral-12b's patches, whose
    prefix the cache holds too."""
    for arch in tconfigs.list_archs():
        cfg = tmoe.no_drop(tconfigs.get_smoke(arch))
        params = tt.init_params(cfg, seed=0)
        gen = torch.Generator().manual_seed(1)
        prompts = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
        extra = serve_lm.frontend_inputs(cfg, 2, gen)
        prefix = cfg.n_patches if cfg.frontend == "vision" else 0
        res = serve_lm.serve(cfg, params, prompts, 8, device="cpu", **extra)
        assert res.tokens.shape == (2, 8)
        assert int(res.cache["pos"]) == prefix + 16 + 7
        seq = torch.cat([prompts, res.tokens[:, :-1]], dim=1)
        with torch.no_grad():
            fresh, _ = tt.prefill(params, {"tokens": seq, **extra}, cfg,
                                  tt.init_cache(cfg, 2,
                                                prefix + seq.shape[1]))
        torch.testing.assert_close(res.logits, fresh, rtol=0,
                                   atol=1e-2 * float(fresh.abs().max()))
        assert torch.equal(res.logits.argmax(-1), fresh.argmax(-1))
        assert torch.equal(res.tokens[:, -1], res.logits.argmax(-1))


def reference_cli():
    spec = importlib.util.spec_from_file_location(
        "reference_serve_lm", ROOT / "examples" / "serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shape_of(lines: list[str]) -> list[str]:
    """The lines with their numbers replaced: times and token ids differ
    between the packages (each draws its own weights)."""
    return [re.sub(r"\[[0-9, ]*\]", "[...]",
                   re.sub(r"\d+\.\d+", "N", ln)) for ln in lines]


def test_cli_prints_the_references_format(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["serve_lm.py", "--tokens", "6"])
    reference_cli().main()
    want = capsys.readouterr().out.splitlines()
    got: list[str] = []
    res = serve_lm.main(["--device", "cpu", "--tokens", "6"], log=got.append)
    assert shape_of(got) == shape_of(want)
    assert got[0].startswith("internlm2-1.8b: prefilled 2x16 in ")
    assert got[0].endswith("s (cache pos 16)")
    assert res.tokens.shape == (2, 6)
    for ln, seq in zip(got[2:], res.tokens.tolist()):
        assert ln == f"  seq{got[2:].index(ln)}: {seq}"
        assert all(0 <= t < 512 for t in seq)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "xlstm-350m",
                                  "jamba-v0.1-52b"])
def test_cli_serves_the_moe_and_recurrent_archs(arch):
    """``serve_lm --arch`` takes the archs of this slice and prints the
    reference CLI's format."""
    got: list[str] = []
    res = serve_lm.main(["--device", "cpu", "--arch", arch, "--tokens", "3",
                         "--prompt-len", "5"], log=got.append)
    assert got[0].startswith(f"{arch}: prefilled 2x5 in ")
    assert got[0].endswith("s (cache pos 5)")
    assert re.fullmatch(r"decoded 3 tokens/seq at \d+\.\d ms/token", got[1])
    assert [ln.split(": ")[0] for ln in got[2:]] == ["  seq0", "  seq1"]
    assert res.tokens.shape == (2, 3) and int(res.cache["pos"]) == 5 + 2


# -- the decode's position and its path ---------------------------------------

def test_decode_step_advances_pos_in_place():
    """``decode_step`` adds one to the tensor ``prefill`` put in the cache,
    which stays the cache's ``pos``, and the steps read what they read
    when each step bound a new tensor: the logits equal those of a twin
    cache whose ``pos`` is replaced by a copy before every step."""
    cfg = tconfigs.get_smoke("internlm2-1.8b")
    params = tt.init_params(cfg, seed=0)
    toks = torch.randint(0, cfg.vocab, (2, 10),
                         generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        caches = [tt.prefill(params, {"tokens": toks[:, :6]}, cfg,
                             tt.init_cache(cfg, 2, 10))[1] for _ in range(2)]
        pos = caches[0]["pos"]
        for t in range(6, 10):
            caches[1]["pos"] = caches[1]["pos"].clone()
            got, cache = tt.decode_step(params, toks[:, t:t + 1], cfg,
                                        caches[0])
            want, _ = tt.decode_step(params, toks[:, t:t + 1], cfg,
                                     caches[1])
            assert cache["pos"] is pos and int(pos) == t + 1
            assert torch.equal(got, want)
    assert pos.shape == () and pos.dtype == torch.int32


@pytest.mark.parametrize("n_tokens", [1, 2, 5])
def test_serve_on_the_cpu_steps_eagerly(n_tokens):
    """On the CPU ``serve`` counts ``n_tokens - 1`` eager decode steps and
    no graph step, and gives what a prefill and a loop of
    ``decode_step`` give: the tokens, the last logits (the prefill's
    when ``n_tokens`` is 1) and the cache's position."""
    cfg = tconfigs.get_smoke("qwen3-0.6b")
    params = tt.init_params(cfg, seed=0)
    prompts = torch.randint(0, cfg.vocab, (2, 7),
                            generator=torch.Generator().manual_seed(6))
    before = dict(serve_lm.DECODE_STEPS)
    res = serve_lm.serve(cfg, params, prompts, n_tokens, device="cpu")
    assert serve_lm.DECODE_STEPS == {"graph": before["graph"],
                                     "eager": before["eager"] + n_tokens - 1}
    with torch.no_grad():
        logits, cache = tt.prefill(params, {"tokens": prompts}, cfg,
                                   tt.init_cache(cfg, 2, 7 + n_tokens))
        out = [logits.argmax(-1, keepdim=True)]
        for _ in range(n_tokens - 1):
            logits, cache = tt.decode_step(params, out[-1], cfg, cache)
            out.append(logits.argmax(-1, keepdim=True))
    assert torch.equal(res.tokens, torch.cat(out, dim=1))
    assert torch.equal(res.logits, logits)
    assert int(res.cache["pos"]) == 7 + n_tokens - 1
