"""Hill-climb driver: run named variants of the dry-run and log them.

Port of ``scripts/hillclimb.py``: each variant is a (hypothesis, change)
pair run through ``launch.dryrun.run_one`` in a fake world of 256 ranks
(no card); results append to ``results/hillclimb_torch.json``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb <variant-name>
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --list

The reference's ``donate`` (buffer donation to XLA) has no counterpart:
the variants that used it run without it (``C2_ml_donate_bf16`` is
``C2_ml_bf16`` here), and the two that differed only by it
(``A2_ml_donate``, ``D1_donate_cache``) are dropped.  So is ``B4``, which
measured a change to the reference's scan and is ``B3``'s configuration.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch import dryrun

# variant -> (arch, shape, run_one kwargs)
VARIANTS = {
    # -- pair A: llama4 train_4k (most collective-bound; EP + sketch) ------
    "A0_baseline": ("llama4-maverick-400b-a17b", "train_4k", {}),
    "A1_model_local_sketch": ("llama4-maverick-400b-a17b", "train_4k",
                              dict(sketch_mode="model_local")),
    "A3_ml_bf16_attn": ("llama4-maverick-400b-a17b", "train_4k",
                        dict(sketch_mode="model_local",
                             cfg_overrides=dict(
                                 attn_compute_dtype="bfloat16"))),
    # -- pair B: jamba train_4k (worst roofline fraction) -------------------
    "B0_jamba_baseline": ("jamba-v0.1-52b", "train_4k", {}),
    "B1_jamba_model_local": ("jamba-v0.1-52b", "train_4k",
                             dict(sketch_mode="model_local")),
    "B2_jamba_ssm_remat": ("jamba-v0.1-52b", "train_4k",
                           dict(sketch_mode="model_local",
                                cfg_overrides=dict(ssm_remat=True))),
    "B3_jamba_full_opt": ("jamba-v0.1-52b", "train_4k",
                          dict(sketch_mode="model_local",
                               cfg_overrides=dict(
                                   ssm_remat=True,
                                   attn_compute_dtype="bfloat16"))),
    # -- bonus: deepseek-7b decode_32k (worst serving memory term) ---------
    "D0_baseline": ("deepseek-7b", "decode_32k", {}),
    "D2_bf16_attend": ("deepseek-7b", "decode_32k",
                       dict(cfg_overrides=dict(
                           attn_compute_dtype="bfloat16"))),
    # -- pair C: qwen2-moe train_4k (paper-representative mid-size MoE) ----
    "C0_baseline": ("qwen2-moe-a2.7b", "train_4k", {}),
    "C1_model_local_sketch": ("qwen2-moe-a2.7b", "train_4k",
                              dict(sketch_mode="model_local")),
    "C2_ml_bf16": ("qwen2-moe-a2.7b", "train_4k",
                   dict(sketch_mode="model_local",
                        cfg_overrides=dict(attn_compute_dtype="bfloat16"))),
    # dense-mean ablation (what FetchSGD's sketch replaces)
    "C3_dense_aggregate": ("qwen2-moe-a2.7b", "train_4k",
                           dict(aggregate="dense",
                                sketch_mode="model_local")),
}

OUT = Path(__file__).resolve().parents[3] / "results" / "hillclimb_torch.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    if args.list or not args.variants:
        for k, (a, s, kw) in VARIANTS.items():
            print(f"{k}: {a} x {s} {kw}")
        return 0
    OUT.parent.mkdir(parents=True, exist_ok=True)
    for name in args.variants:
        arch, shape, kw = VARIANTS[name]
        roof, dt, _ = dryrun.run_one(arch, shape, **kw)
        with open(OUT, "a") as f:
            f.write(json.dumps({
                "variant": name, "arch": arch, "shape": shape,
                "kwargs": {k: str(v) for k, v in kw.items()},
                "t_compute": roof.t_compute, "t_memory": roof.t_memory,
                "t_collective": roof.t_collective,
                "bottleneck": roof.bottleneck,
                "coll_detail": roof.coll_detail,
                "peak_mem": roof.peak_mem_bytes,
                "hbm_bytes": roof.hbm_bytes,
                "compile_s": dt}) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
