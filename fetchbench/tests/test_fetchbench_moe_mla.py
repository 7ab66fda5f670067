"""The Moonlight-16B-A3B configuration, its cell and its metrics: the file
states every number of the published config.json beside the program's
names of the same widths, the cell's manifest entries, and the readers of
``train.mfu_moe_mla``, ``moe.fwd_ms`` and ``mla.fwd_ms`` on hand-built
runs, the FLOPs counted by hand at micro widths."""

import json
import types

import pytest

from fetchbench import harness, reference
from fetchbench.tests.util import ROOT

CELL = "moonlight-fed.persona256-cap16"
MAN = harness.manifest()
FILE = json.loads((ROOT / "fetchbench" / "configs" / "moonlight-16b-a3b.json")
                  .read_text())
# the published config.json's numbers and flags, as the catalog has them
PUBLISHED = {
    "attention_bias": False, "ep_size": 1, "first_k_dense_replace": 1,
    "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 11264,
    "kv_lora_rank": 512, "max_position_embeddings": 8192,
    "model_type": "deepseek_v3", "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": True, "num_attention_heads": 16,
    "num_experts_per_tok": 6, "num_hidden_layers": 27,
    "num_key_value_heads": 16, "num_nextn_predict_layers": 0,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-05, "rope_theta": 50000, "routed_scaling_factor": 2.446,
    "scoring_func": "sigmoid", "seq_aux": True, "tie_word_embeddings": False,
    "topk_group": 1, "topk_method": "noaux_tc", "v_head_dim": 128,
    "vocab_size": 163840}


def read(name, ctx):
    return harness.metric_reader(name)(ctx)


def test_the_file_states_the_published_config_and_its_cut():
    assert {k: FILE[k] for k in PUBLISHED} == PUBLISHED
    assert FILE["reduced"] == ["experts_held"] and FILE["experts_held"] == 8
    fam = reference.family(FILE)
    fam.check_family(FILE)
    model = harness.arch_config(FILE, fam)
    assert (model.n_layers, model.first_dense_layers, model.d_model,
            model.held, model.n_experts) == (27, 1, 2048, 8, 64)


@pytest.mark.parametrize("key,value", [("hidden_size", 1024),
                                       ("scoring_func", "softmax"),
                                       ("q_lora_rank", 1536)])
def test_a_published_key_the_family_does_not_compute_is_refused(key, value):
    fam = reference.family(FILE)
    with pytest.raises(ValueError, match=key):
        fam.param_spec(dict(FILE, **{key: value}))


def test_the_cells_manifest_entries():
    per = {m["name"]: m for m in MAN["per_layer"]}
    for name in ("train.mfu_moe_mla", "moe.fwd_ms", "mla.fwd_ms"):
        assert per[name]["workloads"] == [CELL]
        assert per[name]["moves"] == "round_s"
    for name in ("device_idle.train", "fed.clients_ms", "fed.server_update_ms",
                 "encode_roofline", "estimate_select_roofline"):
        assert per[name]["workloads"][-1] == CELL
    assert CELL not in per["train.mfu"]["workloads"]
    cell = harness.find_cell(MAN, CELL)
    assert cell.workload["traffic"]["max_samples"] == 16
    assert [m["name"] for m in cell.end_to_end] == ["round_s", "peak_mem_gib",
                                                    "setup_s"]


MICRO = {"d_model": 64, "n_heads": 4, "kv_lora_rank": 32,
         "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
         "n_layers": 3, "first_dense_layers": 1, "d_ff": 128, "moe_d_ff": 32,
         "n_experts": 8, "experts_held": 4, "expert_top_k": 3,
         "n_shared_experts": 2, "vocab": 256}


def test_train_flops_hand_count():
    f = harness.metric_reader("train.mfu_moe_mla").__globals__[
        "forward_flops"](MICRO, 2, 5)
    mla = 2 * (64 * 4 * 24 + 64 * 40 + 32 * 4 * 32 + 4 * 16 * 64)   # 33,792
    dense = 2 * 3 * 64 * 128                                          # 49,152
    moe = 2 * 64 * 8 + 2 * 3 * 64 * 32 * (2 + 3 * 4 / 8)            # 44,032
    per_token = 3 * mla + dense + 2 * moe + 2 * 64 * 256              # 271,360
    core = 3 * 4 * 40 * 5 * 6                                         # 14,400
    assert f == 2 * (5 * per_token + core) == 2_742_400


def test_the_mfu_readers_arithmetic():
    ctx = types.SimpleNamespace(config=MICRO, clients=[(2, 5), (1, 5)],
                                window_s=2.0, peaks={"fp32_flops": 1e6})
    flops = 3 * (2_742_400 + 2_742_400 // 2)
    assert read("train.mfu_moe_mla", ctx) == pytest.approx(
        100 * flops / 2e6)
    assert read("train.mfu_moe_mla",
                types.SimpleNamespace(**{**vars(ctx), "clients": []})) is None


def span(name, **fields):
    return dict(type="span", name=name, dur_s=9.0, depth=3,
                parent="fed.client.grad", **fields)


@pytest.mark.parametrize("metric,name", [("moe.fwd_ms", "model.moe"),
                                         ("mla.fwd_ms", "model.mla")])
def test_the_block_span_readers(metric, name):
    """Device time of the block's spans, summed and over the rounds; a run
    without them (another model, or a CPU run, whose spans carry no
    ``dev_s``) reads nothing."""
    other = "model.mla" if name == "model.moe" else "model.moe"
    spans = [span(name, layer=l, dev_s=0.001 * (l + 1)) for l in range(3)]
    spans += [span(other, layer=0, dev_s=5.0),
              span("fed.client.grad", dev_s=7.0)]
    ctx = types.SimpleNamespace(spans=spans, rounds=2)
    assert read(metric, ctx) == pytest.approx(3.0)
    assert read(metric, types.SimpleNamespace(spans=spans, rounds=0)) is None
    cpu = [span(name, layer=0, held_rows=4, max_rows=2)]
    assert read(metric, types.SimpleNamespace(spans=cpu, rounds=1)) is None
    assert read(metric, types.SimpleNamespace(spans=[], rounds=1)) is None
