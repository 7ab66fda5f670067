"""Latent attention (MLA), the leading dense layer and the sigmoid-routed,
dropless expert layer that holds a share of the experts
(``moonlight-16b-a3b``), against the benchmark's plain reference
``fetchbench/reference/moe_mla_lm.py`` at its micro widths on the CPU: the
loss and every leaf's gradient, the router's selection, the expert layer
given one routing, one chip's share of the experts against the uncut
layer, dropless routing, the parameter tree; the registry and the serve
path's refusals; the model's block spans.

Routing near-ties.  A token's picks are the largest ``sigmoid(x W_r) +
bias``; the program and the reference each compute ``x W_r`` as a float32
product over d terms, whose roundings may differ.  With random weights a
token whose K-th and (K+1)-th values lie closer than those roundings may
pick either expert on either side, and both are right.  So the selection
is checked on tokens whose margin is above ``MARGIN``, and the expert
layer is compared on tokens all of whose picks clear it.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fetchbench import harness, reference  # noqa: E402
from fetchbench.traffic import persona  # noqa: E402
from repro_torch import configs, obs  # noqa: E402
from repro_torch.core import fetchsgd as F  # noqa: E402
from repro_torch.core import layout  # noqa: E402
from repro_torch.fed import orchestrator as O  # noqa: E402
from repro_torch.models import moe, sharding, transformer  # noqa: E402
from repro_torch.models.config import ArchConfig, LayerSpec  # noqa: E402
from repro_torch.optim import linear_decay  # noqa: E402

FILE = json.loads((ROOT / "fetchbench" / "configs" / "moonlight-16b-a3b.json")
                  .read_text())
FAM = reference.family(FILE)
# a product over d = 64 float32 terms of size ~1 rounds to ~1e-6 at most:
# a margin of 1e-4 cannot flip on either side
MARGIN = 1e-4
U = "units/m0/moe/"


def micro(**over):
    """The configuration at the family's micro widths (1 leading dense and
    2 expert layers, 8 experts of which 4 held, 3 a token, 2 shared,
    sigmoid with a drawn bias, routed_scale 2.446), its family dict and
    the port's ArchConfig."""
    cfg = dict(FILE, **FAM.MICRO)
    cfg.update(over)
    return cfg, harness.arch_config(cfg, FAM)


def weights(cfg, seed):
    spec = FAM.param_spec(cfg)
    flat = FAM.init_flat(spec, cfg, seed, "cpu")
    return spec, flat, FAM.leaves(flat, spec)


def layer_tree(P, l, prefix=U):
    """The program's tree of expert layer ``l``'s leaves."""
    return harness.tree({k[len(prefix):]: v[l] for k, v in P.items()
                         if k.startswith(prefix)})


def tokens(n, d, seed):
    return torch.randn(n, d, generator=torch.Generator().manual_seed(seed))


def margins(P, l, x, cfg):
    """Each token's gap between its K-th and (K+1)-th selection value."""
    s = torch.sigmoid(x @ P[U + "router"][l])
    v = torch.topk(s + P[U + "e_score_correction_bias"][l],
                   cfg["expert_top_k"] + 1, dim=-1).values
    return v[:, -2] - v[:, -1]


def clear_tokens(P, l, x, cfg):
    return x[margins(P, l, x, cfg) > MARGIN]


def close(got, want, rel):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=rel * float(want.detach().abs().max()))


# -- the model against the reference ---------------------------------------------------

def test_tree_is_the_references():
    for cfg, mcfg in (micro(), (FILE, harness.arch_config(FILE, FAM))):
        spec = FAM.param_spec(cfg)
        harness.check_tree(mcfg, spec)
        meta = transformer.init_params(mcfg, device="meta")
        assert transformer.param_count(meta) == FAM.n_params(spec)
    assert FAM.n_params(FAM.param_spec(FILE)) == 3_364_615_296


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 2**31 + 7])
def test_loss_and_every_gradient_match_the_reference(seed, remat):
    """The whole model, bf16 residual boundaries and all: the loss to a
    millionth, each leaf's gradient to 1e-4 of its largest (the
    benchmark's own CPU tolerance; a float32 rounding of a gradient can
    flip a bfloat16 rounding of the residual's gradient at a layer
    boundary, one part in 256 of that element)."""
    cfg, mcfg = micro()
    spec, flat, P = weights(cfg, seed)
    gen = torch.Generator().manual_seed(seed % 1000)
    tok = torch.randint(0, cfg["vocab"], (3, 24), generator=gen)
    lab = torch.randint(0, cfg["vocab"], (3, 24), generator=gen)
    loss, grad = FAM.loss_and_grad(flat, spec, tok, lab, cfg)
    ploss, pgrads = transformer.value_and_grad(
        harness.tree(P), {"tokens": tok, "labels": lab}, mcfg, remat=remat)
    assert abs(loss - float(ploss)) <= 1e-6 * abs(loss)
    got = layout.flatten(pgrads)
    assert [p for p, _ in got] == [p for p, _ in spec]
    for (path, g), (_, pg) in zip(FAM.leaves(grad, spec).items(), got):
        if path.endswith("e_score_correction_bias"):
            assert not pg.any() and not g.any()      # no gradient
            continue
        close(pg, g, 1e-4)


def test_selection_matches_on_clear_margins():
    """The program's picks are the reference's on every token whose
    margin clears ``MARGIN`` (near-ties are few), and the gates agree."""
    cfg, mcfg = micro()
    _, _, P = weights(cfg, 3)
    x = tokens(2048, cfg["d_model"], 4)
    Pl = FAM.by_layer(P)
    for l in range(cfg["n_layers"] - cfg["first_dense_layers"]):
        want_idx, want_gate = FAM.route(Pl, l, x, cfg, False)
        idx, gate = moe.route_sigmoid(layer_tree(P, l), x, mcfg)
        ok = margins(P, l, x, cfg) > MARGIN
        assert ok.float().mean() > 0.95
        assert torch.equal(idx[ok], want_idx[ok])
        close(gate[ok], want_gate[ok], 1e-6)
        # the bias moves the selection: some picks differ from score alone
        plain = torch.topk(torch.sigmoid(x @ P[U + "router"][l]),
                           cfg["expert_top_k"], dim=-1).indices
        assert (plain.sort(-1).values != idx.sort(-1).values).any(-1) \
            .float().mean() > 0.05


def test_expert_layer_matches_the_reference_given_one_routing():
    """On tokens whose picks all clear ``MARGIN`` both sides route alike:
    the layer's output, its input's gradient and every expert leaf's
    gradient agree to float32 rounding."""
    cfg, mcfg = micro()
    _, _, P = weights(cfg, 5)
    x = clear_tokens(P, 0, tokens(600, cfg["d_model"], 6), cfg)[None]
    Pl = FAM.by_layer({k: v.detach().requires_grad_(True)
                       for k, v in P.items()})
    p = layer_tree(P, 0)
    leaves = [t.requires_grad_(True) for _, t in layout.flatten(p)]
    x1, x2 = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    y1, _ = moe.moe_apply_held(p, x1, mcfg)
    y2 = FAM.experts(Pl, 0, x2, cfg, False)
    close(y1, y2, 1e-6)
    gy = tokens(y1.numel(), 1, 7).reshape(y1.shape)
    ref = [Pl[U + path][0] for path, _ in layout.flatten(p)]
    g1 = torch.autograd.grad(y1, [x1] + leaves, gy, allow_unused=True,
                             materialize_grads=True)
    g2 = torch.autograd.grad(y2, [x2] + ref, gy, allow_unused=True,
                             materialize_grads=True)
    for got, want in zip(g1, g2):
        close(got, want, 1e-6)


def _share(p, first, held):
    """The layer tree, of the uncut layer ``p``, that holds experts
    ``first .. first + held - 1``: the router's columns and the bias
    relabelled so that those experts are ids 0 .. held - 1 (the routing
    is the same up to the relabelling), and their weights."""
    E = p["router"].shape[-1]
    perm = torch.cat([torch.arange(first, E), torch.arange(first)])
    q = dict(p, router=p["router"][:, perm],
             e_score_correction_bias=p["e_score_correction_bias"][perm])
    q.update({k: p[k][first:first + held] for k in ("w_gate", "w_up",
                                                    "w_down")})
    return q


def test_two_shares_sum_to_the_uncut_layer():
    """One chip's share ties to the model: with 8 experts over two chips,
    the layers of rank 0 (experts 0-3) and rank 1 (4-7), summed with the
    shared experts counted once, equal the uncut reference layer (every
    expert held)."""
    cfg_all, _ = micro(experts_held=8)
    cfg, mcfg = micro()
    _, _, P = weights(cfg_all, 8)
    x = clear_tokens(P, 1, tokens(600, cfg["d_model"], 9), cfg)[None]
    want = FAM.experts(FAM.by_layer(P), 1, x, cfg_all, False)
    p = layer_tree(P, 1)
    shares = [moe.moe_apply_held(_share(p, first, mcfg.held), x, mcfg)[0]
              for first in (0, 4)]
    shared = moe.layers.mlp(p["shared"], x, "swiglu")
    close(shares[0] + shares[1] - shared, want, 1e-6)
    # each share alone leaves the other's experts out
    assert (shares[0] - want).abs().max() > 1e-3


def test_dropless_every_token_to_the_same_experts():
    """With the bias sending every token to experts 0-2, each of those
    experts computes every token (no capacity, none dropped): the output
    is each token's gated sum of the three experts plus the shared ones,
    and the span counts every pair."""
    cfg, mcfg = micro()
    _, _, P = weights(cfg, 10)
    p = layer_tree(P, 0)
    p["e_score_correction_bias"] = torch.tensor(
        [10.0] * 3 + [-10.0] * 5)
    x = tokens(200, cfg["d_model"], 11)[None]
    sink = obs.MemorySink()
    tele = obs.Telemetry([sink], trace=True)
    with tele.span("model.moe") as sp:
        y, aux = moe.moe_apply_held(p, x, mcfg, sp)
    (ev,) = [e for e in sink.events if e["type"] == "span"]
    assert (ev["held_rows"], ev["max_rows"]) == (600, 200)
    s = torch.sigmoid(x[0] @ p["router"])[:, :3]
    gate = s / s.sum(-1, keepdim=True) * cfg["routed_scale"]
    want = moe.layers.mlp(p["shared"], x[0], "swiglu")
    for e in range(3):
        h = torch.nn.functional.silu(x[0] @ p["w_gate"][e]) \
            * (x[0] @ p["w_up"][e])
        want = want + gate[:, e:e + 1] * (h @ p["w_down"][e])
    close(y[0], want, 1e-5)
    assert float(aux) == 0.0


def test_held_rows_count_the_routing():
    cfg, mcfg = micro()
    _, _, P = weights(cfg, 12)
    x = tokens(300, cfg["d_model"], 13)
    sink = obs.MemorySink()
    tele = obs.Telemetry([sink], trace=True)
    with tele.span("model.moe") as sp:
        moe.moe_apply_held(layer_tree(P, 1), x[None], mcfg, sp)
    idx, _ = moe.route_sigmoid(layer_tree(P, 1), x, mcfg)
    counts = torch.bincount(idx.reshape(-1), minlength=8)[:4]
    (ev,) = [e for e in sink.events if e["type"] == "span"]
    assert ev["held_rows"] == int(counts.sum()) > 0
    assert ev["max_rows"] == int(counts.max())


# -- the registry, the refusals and the configuration's checks ---------------------

def test_registry_resolves_moonlight_beside_the_zoo():
    assert "moonlight-16b-a3b" not in configs.list_archs()
    assert len(configs.list_archs()) == 11
    cfg = configs.get_config("moonlight-16b-a3b")
    assert (cfg.n_layers, cfg.first_dense_layers, cfg.n_units) == (27, 1, 26)
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim) == (512, 128, 64, 128)
    assert (cfg.n_experts, cfg.held, cfg.expert_top_k, cfg.moe_d_ff,
            cfg.n_shared_experts) == (64, 64, 6, 1408, 2)
    assert (cfg.router_score, cfg.routed_scale) == ("sigmoid", 2.446)
    meta = transformer.init_params(cfg, device="meta")
    assert transformer.param_count(meta) == 15_960_110_208
    smoke = configs.get_smoke("moonlight-16b-a3b")
    tok = torch.randint(0, smoke.vocab, (2, 8))
    loss, _ = transformer.value_and_grad(
        transformer.init_params(smoke), {"tokens": tok, "labels": tok},
        smoke, remat=False)
    assert torch.isfinite(loss)


def test_serving_and_the_mesh_refuse_mla():
    _, mcfg = micro()
    params = transformer.init_params(mcfg)
    tok = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="MLA"):
        transformer.init_cache(mcfg, 1, 8)
    with pytest.raises(NotImplementedError, match="MLA"):
        transformer.prefill(params, {"tokens": tok}, mcfg, {})
    with pytest.raises(NotImplementedError, match="MLA"):
        transformer.decode_step(params, tok[:, :1], mcfg, {})
    with pytest.raises(NotImplementedError, match="MLA"):
        sharding.param_spec("units/m0/mla/wq", (2, 64, 4, 24), mcfg, None)


@pytest.mark.parametrize("bad,match", [
    (dict(router_score="top1"), "router_score"),
    (dict(experts_held=2), "sigmoid router"),
    (dict(router_score="sigmoid", router_aux_coef=0.01), "auxiliary"),
    (dict(router_score="sigmoid", router_aux_coef=0.0, experts_held=9),
     "experts_held"),
    (dict(kv_lora_rank=16), "mla"),
    (dict(first_dense_layers=1, unit_pattern=(
        LayerSpec("attn"), LayerSpec("attn", moe=True))), "not divisible"),
])
def test_the_configuration_refuses_what_no_path_reads(bad, match):
    kw = dict(name="x", arch_type="moe", n_layers=4, d_model=16, n_heads=2,
              n_kv_heads=2, d_ff=32, vocab=64, n_experts=8, expert_top_k=2,
              unit_pattern=(LayerSpec("attn", moe=True),))
    ArchConfig(**kw)
    with pytest.raises(ValueError, match=match):
        ArchConfig(**dict(kw, **bad))


# -- the block spans -------------------------------------------------------------------

WL = {"traffic": {"clients_per_round": 2, "seq_len": 16, "population": 100,
                  "topics": 4, "mean_samples": 3, "power": 1.5,
                  "max_samples": 4, "population_seed": 0}}


def _round(mcfg, params, tele):
    """One micro FetchSGD round through the orchestrator."""
    data = persona.from_workload(WL, mcfg.vocab, 3)
    orch = O.Orchestrator(
        mcfg, F.FetchSGDConfig(rows=3, cols=4096, k=64),
        O.FederationConfig(rounds=10, clients_per_round=2,
                           aggregate="flat", seed=0),
        data, params=params, lr_fn=linear_decay(0.1, 10), device="cpu",
        telemetry=tele, health_every=0)
    return orch.run_round(0)


def _spans(sink, prefix="model."):
    return [e for e in sink.events
            if e["type"] == "span" and e["name"].startswith(prefix)]


def test_a_traced_round_spans_each_block_forward():
    """Each client's forward opens a ``model.mla`` span a layer and a
    ``model.moe`` span an expert layer, inside its gradient's span, with
    the layer's index and the expert layer's row counts."""
    cfg, mcfg = micro()
    _, _, P = weights(cfg, 14)
    sink = obs.MemorySink()
    rec = _round(mcfg, harness.tree(P), obs.Telemetry([sink], trace=True))
    spans = _spans(sink)
    mla = [e for e in spans if e["name"] == "model.mla"]
    moes = [e for e in spans if e["name"] == "model.moe"]
    n = len(rec.cohort)
    assert [e["layer"] for e in mla] == [0, 1, 2] * n
    assert [e["layer"] for e in moes] == [1, 2] * n
    assert all(e["parent"] == "fed.client.grad" for e in spans)
    data = persona.from_workload(WL, mcfg.vocab, 3)
    tokens_ = [16 * data.client_size(c) for c in rec.cohort for _ in (1, 2)]
    for e, T in zip(moes, tokens_):
        assert 0 < e["max_rows"] <= e["held_rows"] <= 3 * T


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-moe-a2.7b"])
def test_other_models_emit_no_block_span(arch):
    """A model without MLA or the sigmoid-routed layer opens no ``model.*``
    span in a traced gradient."""
    mcfg = configs.get_smoke(arch)
    sink = obs.MemorySink()
    tele = obs.Telemetry([sink], trace=True)
    tok = torch.randint(0, mcfg.vocab, (2, 16),
                        generator=torch.Generator().manual_seed(0))
    with tele.span("grad"), obs.active(tele):
        transformer.value_and_grad(transformer.init_params(mcfg),
                                   {"tokens": tok, "labels": tok}, mcfg,
                                   remat=False)
    assert _spans(sink, "grad")
    assert not _spans(sink)


def test_with_tracing_off_no_span_is_built(monkeypatch):
    built = []
    init = obs.Span.__init__

    def counting(self, *a, **k):
        built.append(a[0] if len(a) > 1 else None)
        init(self, *a, **k)
    monkeypatch.setattr(obs.Span, "__init__", counting)
    cfg, mcfg = micro()
    _, _, P = weights(cfg, 15)
    _round(mcfg, harness.tree(P), obs.Telemetry([obs.MemorySink()],
                                                trace=False))
    _round(mcfg, harness.tree(P), None)
    assert built == []


@pytest.mark.cuda
def test_block_spans_carry_device_time_and_syncs_on_the_card():
    """On the card each block span has its device time, and the expert
    layer's one host sync (its row counts) is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, mcfg = micro()
    spec = FAM.param_spec(cfg)
    flat = FAM.init_flat(spec, cfg, 16, "cuda")
    sink = obs.MemorySink()
    tele = obs.Telemetry([sink], trace=True)
    tok = torch.randint(0, cfg["vocab"], (2, 16), device="cuda")
    with tele.span("grad"), obs.active(tele):
        transformer.value_and_grad(harness.tree(FAM.leaves(flat, spec)),
                                   {"tokens": tok, "labels": tok}, mcfg,
                                   remat=False)
    tele.close()
    spans = _spans(sink)
    assert len(spans) == 5 and all(e["dev_s"] > 0 for e in spans)
    assert all(e["syncs"] == (1 if e["name"] == "model.moe" else 0)
               for e in spans)
