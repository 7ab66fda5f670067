"""The benchmark's plain reference against the program at micro width on
the CPU: hashes, sketches, the layout's chunks, Delta, the model's loss,
gradients and served logits; and the FLOP and byte counts behind the mfu
and roofline metrics against hand counts."""

import json

import pytest
import torch

from fetchbench import harness, reference
from fetchbench.reference import dense_lm, sketch
from fetchbench.tests.util import ROOT
from repro_torch.core import count_sketch, hashing, layout, topk
from repro_torch.models import transformer

CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text())
           for c in json.loads((ROOT / "BENCHMARK.json").read_text())
           ["configs"]}


def micro(name):
    """The configuration at its family's micro widths, and the family."""
    fam = reference.family(CONFIGS[name])
    return dict(CONFIGS[name], **fam.MICRO), fam


@pytest.mark.parametrize("cols", [1 << 20, 4096, 1_000_003])
@pytest.mark.parametrize("row", range(5))
def test_row_hash_matches_the_program(row, cols):
    ids = torch.cat([torch.arange(0, 5000), torch.arange(2**31 - 2500,
                                                         2**31 + 2500),
                     torch.arange(2**32 - 100, 2**32)])
    bucket, sign = sketch.row_hash(sketch.low_words(ids), row, cols)
    hi, lo = hashing.split_ids(ids)
    assert torch.equal(bucket, hashing.bucket_hash(lo, hi, row, cols))
    assert torch.equal(sign, hashing.sign_hash(lo, hi, row))


def test_sketch_and_estimate_match_the_program():
    g = torch.randn(70_000, generator=torch.Generator().manual_seed(1))
    spans = [(0, 30_000), (30_000, 40_000)]
    table = sketch.sketch(g, spans, 5, 1031)
    want = sum(count_sketch.sketch_chunk(g[o:o + n], o, 5, 1031)
               for o, n in spans)
    torch.testing.assert_close(table, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sketch.estimate(table, 30_000, 40_000),
                               count_sketch.estimate_chunk(table, 30_000,
                                                           40_000))


@pytest.mark.parametrize("name", CONFIGS)
def test_chunks_match_the_programs_layout(name):
    cfg = CONFIGS[name]
    fam = reference.family(cfg)
    meta = transformer.init_params(harness.arch_config(cfg, fam),
                                   device="meta")
    lay = layout.build_layout(meta)
    assert sketch.chunks(fam.param_spec(cfg)) == \
        [(c.offset, c.size) for c in lay.chunks]
    assert lay.total == fam.n_params(fam.param_spec(cfg))


@pytest.mark.parametrize("n_leaves", [3, 70])
def test_top_k_matches_the_program(n_leaves):
    """More than 64 chunks: candidates capped a chunk, as the program."""
    spec = [(f"l{i:03d}", (3, 100)) for i in range(n_leaves)]
    spans = sketch.chunks(spec)
    meta = {p: torch.empty(s, device="meta") for p, s in spec}
    lay = layout.build_layout(meta)
    table = torch.randn(5, 257, generator=torch.Generator().manual_seed(2))
    ids, vals = sketch.top_k(table, spans, 600)
    d = topk.topk_from_sketch(table, lay, 600)
    got = topk.global_ids(d, lay)
    assert set(ids.tolist()) == set(got.tolist())
    order = torch.argsort(ids)
    torch.testing.assert_close(vals[order], d.values[torch.argsort(got)])


@pytest.mark.parametrize("name", CONFIGS)
def test_train_loss_and_grads_match_the_program(name):
    cfg, fam = micro(name)
    spec = fam.param_spec(cfg)
    mcfg = harness.arch_config(cfg, fam)
    harness.check_tree(mcfg, spec)
    flat = fam.init_flat(spec, cfg, 5, "cpu")
    gen = torch.Generator().manual_seed(3)
    tok = torch.randint(0, cfg["vocab"], (3, 24), generator=gen)
    lab = torch.randint(0, cfg["vocab"], (3, 24), generator=gen)
    loss, grad = fam.loss_and_grad(flat, spec, tok, lab, cfg)
    params = harness.tree(fam.leaves(flat, spec))
    ploss, pgrads = transformer.value_and_grad(
        params, {"tokens": tok, "labels": lab}, mcfg, remat=False)
    assert abs(loss - float(ploss)) <= 1e-6 * abs(loss)
    for (path, g), (ppath, pg) in zip(
            fam.leaves(grad, spec).items(), layout.flatten(pgrads)):
        assert path == ppath
        torch.testing.assert_close(g, pg, rtol=0,
                                   atol=1e-4 * float(pg.abs().max()))


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", CONFIGS)
def test_served_logits_match_the_program(name, cache):
    cfg, fam = micro(name)
    spec = fam.param_spec(cfg)
    mcfg = harness.arch_config(cfg, fam)
    flat = fam.init_flat(spec, cfg, 6, "cpu")
    P = fam.leaves(flat, spec)
    params = harness.tree(P)
    gen = torch.Generator().manual_seed(4)
    tok = torch.randint(0, cfg["vocab"], (2, 20), generator=gen)
    c = transformer.init_cache(mcfg, 2, 20, cache)
    logits, c = transformer.prefill(params, {"tokens": tok[:, :12]}, mcfg, c)
    got = [logits]
    for t in range(12, 20):
        logits, c = transformer.decode_step(params, tok[:, t:t + 1], mcfg, c)
        got.append(logits)
    want = fam.serve_logits(P, tok, 11, cfg, kv_dtype=cache)
    torch.testing.assert_close(torch.stack(got, 1), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_init_is_the_seeds_and_scaled_by_leaf():
    cfg = dict(CONFIGS["internlm2-1.8b"], **dense_lm.MICRO)
    spec = dense_lm.param_spec(cfg)
    a = dense_lm.init_flat(spec, cfg, 2**31 + 9, "cpu")
    assert torch.equal(a, dense_lm.init_flat(spec, cfg, 2**31 + 9, "cpu"))
    P = dense_lm.leaves(a, spec)
    assert torch.all(P["final_norm/scale"] == 1.0)
    assert abs(float(P["embed/table"].std()) - 0.02) < 2e-3
    assert abs(float(P["units/m0/attn/wo"].std()) - 64 ** -0.5) < 0.02


def _metric(name):
    return harness.metric_reader(name)


def test_train_flops_hand_count():
    cfg = {"d_model": 8, "n_layers": 2, "n_heads": 2, "n_kv_heads": 1,
           "head_dim": 4, "d_ff": 16, "vocab": 10, "act": "swiglu"}
    f = _metric("train.mfu").__globals__["forward_flops"](cfg, 3, 5)
    per_layer_token = 2 * (8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16)  # 1152
    attn = 2 * 2 * 2 * 4 * 5 * 6 / 2 * 2      # 2 layers: qk and pv, causal
    want = 3 * (5 * (2 * per_layer_token + 2 * 8 * 10) + attn)
    assert f == want == 3 * (5 * 2464 + 960)


def test_serve_flops_hand_count():
    cfg = {"d_model": 8, "n_layers": 1, "n_heads": 2, "n_kv_heads": 2,
           "head_dim": 4, "d_ff": 16, "vocab": 10, "act": "gelu"}
    f = _metric("serve.mfu").__globals__["call_flops"](cfg, 2, 3, 3)
    lin = 2 * (3 * 8 * 8 + 8 * 8 + 2 * 8 * 16)          # 768
    prefill = 3 * lin + 2 * 2 * 4 * 3 * 4 + 160          # causal 6 pairs
    decode = (lin + 4 * 2 * 4 * 4 + 160) + (lin + 4 * 2 * 4 * 5 + 160)
    assert f == 2 * (prefill + decode)


def test_roofline_byte_hand_counts():
    cfg = dict(CONFIGS["gpt2s-federated"])
    sk = {"rows": 5, "cols": 1 << 20, "k": 25000}
    d = 123_551_232
    enc = _metric("encode_roofline").__globals__["bytes_per_client"]
    assert enc(dense_lm, cfg, sk) == 4 * d + 4 * 5 * (1 << 20)
    est = _metric("estimate_select_roofline").__globals__["bytes_per_round"]
    spans = sketch.chunks(dense_lm.param_spec(cfg))
    assert len(spans) <= 64
    assert est(dense_lm, cfg, sk) == sum(4 * 5 * (1 << 20) + 12 * min(25000, n)
                               for _, n in spans)
