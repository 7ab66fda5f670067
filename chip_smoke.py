#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

In order, it
1. builds the four CUDA kernels (sm_90a) from the sources in this checkout;
2. holds each kernel against its plain PyTorch twin on the card, at the
   shapes of the full-width main path (a 5 x 2**20 sketch, a 2**24-element
   chunk at a 64-bit offset above 2**32, k = 25,000), and times both; the
   encode on both of its paths (binned at 2**24, one-pass at 2**19 and at
   the main path's largest one-pass chunk, which is timed apart), with a
   chunk of 90% zeros, with overflowing bins, and with a table of
   1,000,003 columns, which the estimate reads too; the estimate alone and
   fused with the selection of a chunk's 25,000 candidates, which the main
   path runs (its rule and its twin, an all-zero table, a second call that
   gives the same arrays), timed beside ``torch.topk`` of the estimates and
   the unfused estimate + ``torch.topk``;
3. runs 2 rounds of the reduced model on the card and on the CPU from the
   same weights, and compares them (the port's own reference on a small
   input);
4. runs 3 full-width FetchSGD rounds of gpt2s-federated through the driver
   (``python -m repro_torch.launch.train_lm --full --rounds 3``) from
   torch-initialised random weights, with every kernel's launch count set
   to 0 just before and read just after (and the encode's calls by path);
5. runs the federated simulation at full width through
   ``repro_torch.launch.simulate.run_simulation``: FetchSGD through the
   round-clock orchestrator (flat with dropout, async with late merges,
   tree) and each of the paper's baselines, checking losses, fates,
   traffic and the kernels' launches, and timing every round;
6. runs the four example entry points (``examples``):
   ``repro_torch.launch.quickstart``, ``.compression_sweep``,
   ``.async_federated`` and ``.heterogeneous_federation`` called from
   Python at full width (gpt2s-federated, PersonaLM clients at seq 256, 2
   rounds of the examples' own cohorts of 4 or 6 clients, the 5 x 2**20
   sketch with k = 25,000; the sweep's nine runs: FetchSGD over cols
   {2**19, 2**20} x k {12,500, 25,000}, local top-k over k, FedAvg over 1
   and 3 local epochs, uncompressed), each run's losses finite, launches
   equal to the formula and ledger equal to ``core/compression``'s
   reckoning (FetchSGD's upload_x 30.93 and 61.85); async_federated's
   late merges; async_federated and heterogeneous_federation against a
   second call at the micro width on the CPU (every record field but the
   loss, ``t_virtual`` and the critical paths to the byte); the Count
   Sketch object API (``sketch_vector`` at 2**24 + 3 and 9,216 values,
   ``estimate``, ``+``, ``scale``, ``l2_estimate``) on the card against
   its CPU twin, launches counted; then each example's command line,
   ``python -m repro_torch.launch.<name> --rounds 2`` with no
   ``--device``: exit 0 on the card, a refusal without a visible card,
   and async_federated's resume from its checkpoint directory
   (``chip_smoke_examples.json``, the command lines' output in
   ``chip_smoke_examples_cli.log``);
7. runs the event clock and the population-scale paths at full width
   through ``repro_torch.fed.Orchestrator`` (event-clock flat, async and
   tree over a population of 64; the vectorized round clock over 10**6
   clients; lazy events of a 10**4-client cohort from 10**6 on the event
   clock), checking launches, virtual time, traffic and every record
   but its loss against the same configuration at the micro model's
   width on the CPU, and reporting seconds per round, dispatch seconds
   and peak device memory;
8. checkpoints and resumes at full width (``resume``): event-clock async
   and round-clock async, each run 4 rounds straight and 2 + 2 rounds
   through a checkpoint in a fresh ``Orchestrator``; restore is bitwise,
   every record field but the loss equals the straight run's, losses
   within rtol 1e-3; checkpoint bytes, save and restore seconds;
9. runs FetchSGD through ``run_simulation`` with telemetry
   (``telemetry``): a JSONL stream with spans, kernel spans and a
   sketch-health sample each round, checked against the launch counts and
   against the same run without telemetry; the median seconds of each
   span, s/round with and without telemetry, and a health sample's cost;
10. serves the zoo at full width (``serve``): batch 2, a prompt of 64
   and 32 greedy tokens through ``repro_torch.launch.serve_lm.serve`` for
   gpt2s-federated, internlm2-1.8b, qwen3-0.6b, glm4-9b, qwen2-moe-a2.7b,
   xlstm-350m, jamba-v0.1-52b (16 of its 32 layers, bfloat16),
   whisper-small (1500 frames a request) and pixtral-12b (1024 patches a
   request), from torch-initialised random weights, each checked against
   a fresh prefill of the same sequence (a MoE arch on a second run under
   no-drop capacity), with parameters, cache bytes, prefill seconds,
   decode ms/token beside its HBM bound and the decode steps by path
   (all but the first replayed from a CUDA graph, checked), peak memory
   and a profiled eager decode step; the ring buffer of qwen3-0.6b (window 32, a prompt of 48)
   against a big cache; xlstm-350m's recurrent state after a prompt of
   136 (longer than the mLSTM's chunk) against a fresh prefill; and 2
   rounds of FetchSGD on qwen3-0.6b, qwen2-moe-a2.7b (8 of its 24
   layers), xlstm-350m, whisper-small and pixtral-12b (8 of its 40
   layers), every kernel's launches counted;
11. runs the mesh train step at full width (``mesh``): qwen3-0.6b at
    seq 64, global batch 8, the 5 x 2**20 sketch and k = 25,000; as a
    world of 1 (nccl) through ``python -m repro_torch.launch.train
    --rounds 3`` in flat, tree, dense, async (round 1 straggles) and
    model_local, each run's launches counted and equal to the
    single-device step's, round 0 of flat and dense held against the
    single-device ``F.step``; then two ranks sharing the card (gloo over
    CUDA tensors): mesh 2x1 flat, tree and weighted (0.5, 2.5) against the
    single-device step on the (weighted) mean of the batch's halves'
    gradients, weighted flat = weighted tree; mesh 1x2 tensor-parallel
    over the two ranks (each holds its ``param_spec`` shard and runs the
    forward and backward split over heads, FFN width and vocab, with
    ``remat``), gathered and model_local, 3 rounds each: round 0 against
    the world-of-1 ``F.step`` (Delta's ids equal with a float32
    residual; the common values within 1e-2 with the bfloat16 one), the
    resident parameter bytes equal to the shard sum, each rank's peak
    memory, its recorded collectives and s/round, model_local (view
    permutations, strided chunks) against gathered; mesh 1x2 of
    xlstm-350m with a float32 residual (the Megatron mLSTM forward and
    backward, the sLSTM replicated; gathered, 3 rounds, round 0 against
    the world-of-1 ``F.step``, launches, resident bytes); tensor-parallel
    serving at mesh 1x2 (``make_prefill_step`` / ``make_decode_step``,
    each rank its ``param_spec`` shard, drawn in turn, and its
    ``cache_spec`` slice of a float32 cache) of qwen3-0.6b, xlstm-350m,
    jamba-v0.1-52b (8 of its 32 layers, in float32) and whisper-small:
    batch 2, a prompt of 64 and 32 greedy tokens, held to the same run
    as a world of 1 (tokens equal, logits within 1e-4 of the largest),
    resident parameter and cache bytes equal to the shard sums, each
    rank's peak within 25% of the dry-run's prediction for it, the
    recorded collectives equal to ``step_collective_bytes``, prefill
    seconds and decode ms/token beside the world of 1's; seconds per
    round and of one table's all_reduce (``chip_smoke_mesh.json``);
12. runs the dry-run (``dryrun``): ``python -m repro_torch.launch.dryrun``
    in processes that see no card (qwen3-0.6b train_4k at 16 x 16 and at
    2 x 16 x 16, llama4-maverick-400b-a17b train_4k model_local), each
    exiting 0 with its roofline row; then ``dryrun.run_one``'s prediction
    for the mesh phase's step at mesh 1 x 1 against the same step as a
    world of 1 on the card: the FLOPs ``FlopCounterMode`` counts on the
    card equal the ``meta`` count, the peak memory of a round lies within
    25% of the predicted per-rank memory, and the mesh phase's 2 x 1 flat
    run's recorded collectives equal ``step_collective_bytes`` to the
    byte, and its 1 x 2 tensor-parallel runs' peaks (qwen3-0.6b, and
    xlstm-350m with its float32 residual) within 25% of the prediction for
    each rank and their collectives equal to the formula;
    the forward and backward alone at 8 x 64 and 4 x 1024 tokens
    (under ``FlopCounterMode`` and plain) against the live bytes and FLOPs
    counted on ``meta``, and at 4 x 1024 with ``remat`` (the mesh step's
    pass) below the plain pass and within 25% of its count, its
    gradients equal to the plain pass's; seconds per round and the
    step's and the model's FLOPs as shares of the bf16 and the float32
    peak (``chip_smoke_dryrun.json``);
13. prints the kernels line (with each kernel's launches in the mesh
    phase's world-of-1 runs and in the examples phase's runs), the card's
    name and power limit, and last ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result; so does a machine without CUDA, or a directory without the
package.  Nothing falls back to the CPU.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "chiprun_out"

ROWS, COLS, K = 5, 1 << 20, 25_000       # the --full sketch
CHUNK = 1 << 24                          # encode / estimate check chunk
SMALL = 1 << 19                          # a chunk under the binned threshold
ODD_COLS = 1_000_003                     # cols not a multiple of a bin
OFFSET = (1 << 32) + 12_345              # a 64-bit offset above 2**32
D_FULL = 162_148_608                     # gpt2s-federated parameters
N_CHUNKS = 17                            # its layout's chunks (pinned in
                                         # tests/test_torch_model.py)


class CheckFailed(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)
    print(f"  ok: {what}")


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time on the card: bytes at HBM rate vs f32 ops at peak."""
    from repro_torch.launch import mesh
    t_bytes = n_bytes / mesh.HBM_BW * 1e3
    t_ops = n_ops / mesh.PEAK_FLOPS_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up.

    A 50 ms device sleep is queued first, so that the host has enqueued
    every launch before the device reaches the start event: the events
    then time the device's work, not the host's launch rate.
    """
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)   # clock cycles: ~50 ms at ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(torch, a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def largest_one_pass_chunk(torch, dev) -> int:
    """Elements in the largest chunk of the full-width layout that the
    encode takes one-pass (the stacked norm scales)."""
    from repro_torch import configs
    from repro_torch.core import layout as layout_lib
    from repro_torch.kernels import count_sketch as cuda_cs
    from repro_torch.models import transformer

    lay = layout_lib.build_layout(transformer.init_params(
        configs.get_config("gpt2s-federated"), device=dev))
    check(lay.num_chunks == N_CHUNKS, f"the full-width layout has "
          f"{N_CHUNKS} chunks")
    return max(c.size for c in lay.chunks
               if not cuda_cs.bins().use(c.size, ROWS, COLS))


def card_checks(torch, dev):
    """Every kernel against its plain twin at the main path's shapes."""
    from repro_torch.kernels import count_sketch as cuda_cs
    from repro_torch.kernels import ref
    from repro_torch.kernels import server_step as cuda_ss

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    # -- encode --------------------------------------------------------------
    print("encode: 2**24 values at offset 2**32 + 12345 into 5 x 2**20")
    geo = cuda_cs.bins()
    check(geo.use(CHUNK, ROWS, COLS), "a 2**24 chunk takes the binned path")
    ints = torch.randint(-8, 9, (CHUNK,), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.float32)
    got = cuda_cs.sketch_encode(ints, OFFSET, ROWS, COLS)
    check(torch.equal(got, ref.sketch_encode(ints, OFFSET, ROWS, COLS)),
          "encode exact on integer-valued f32")
    ints_bf16 = ints.to(torch.bfloat16)
    check(torch.equal(cuda_cs.sketch_encode(ints_bf16, OFFSET, ROWS, COLS),
                      got), "encode exact on integer-valued bf16")
    sparse = ints * (torch.rand(CHUNK, generator=gen, device=dev) < 0.1)
    check(torch.equal(cuda_cs.sketch_encode(sparse, OFFSET, ROWS, COLS),
                      ref.sketch_encode(sparse, OFFSET, ROWS, COLS)),
          "encode exact on a chunk of 90% zeros")
    check(torch.equal(cuda_cs.sketch_encode(ints, OFFSET, ROWS, COLS,
                                            _bin_capacity=4096), got),
          "encode exact with bins of 4,096 records (most records overflow "
          "into the table)")
    small = ints[:SMALL]
    check(not geo.use(SMALL, ROWS, COLS)
          and torch.equal(cuda_cs.sketch_encode(small, OFFSET, ROWS, COLS),
                          ref.sketch_encode(small, OFFSET, ROWS, COLS)),
          f"encode of {SMALL} values takes the one-pass path, exact")
    odd = cuda_cs.sketch_encode(ints, OFFSET, ROWS, ODD_COLS)
    check(torch.equal(odd, ref.sketch_encode(ints, OFFSET, ROWS, ODD_COLS)),
          f"encode exact into 5 x {ODD_COLS:,} (not a multiple of a bin)")
    reals = torch.randn(CHUNK, generator=gen, device=dev)
    got = cuda_cs.sketch_encode(reals, OFFSET, ROWS, COLS)
    want = ref.sketch_encode(reals, OFFSET, ROWS, COLS)
    err = max_abs_err(torch, got, want)
    # ~16 normal values per cell summed in another order by the atomics
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-4),
          f"encode allclose on reals (rtol 1e-5, atol 1e-4): max err {err:g}")
    got_small = cuda_cs.sketch_encode(reals[:SMALL], OFFSET, ROWS, COLS)
    want_small = ref.sketch_encode(reals[:SMALL], OFFSET, ROWS, COLS)
    check(torch.allclose(got_small, want_small, rtol=1e-5, atol=1e-4),
          "one-pass encode allclose on reals")
    err = max(err, max_abs_err(torch, got_small, want_small))
    table = got
    scratch = torch.zeros_like(table)
    ms = time_ms(torch, lambda: cuda_cs.sketch_encode(
        reals, OFFSET, ROWS, COLS, out=scratch), 10)
    plain = time_ms(torch, lambda: ref.sketch_encode(
        reals, OFFSET, ROWS, COLS, out=scratch), 3)
    b, by = bound_ms(CHUNK * 4 + ROWS * COLS * 4, 2 * ROWS * CHUNK)
    rows["encode"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                          bound_by=by)
    # the one-pass kernel at the main path's largest one-pass chunk; its
    # bound counts the cells it can touch, rows * min(n, cols), written once
    n1 = largest_one_pass_chunk(torch, dev)
    print(f"encode: {n1} values, the main path's largest one-pass chunk")
    v1 = reals[:n1]
    got, want = (cuda_cs.sketch_encode(v1, OFFSET, ROWS, COLS),
                 ref.sketch_encode(v1, OFFSET, ROWS, COLS))
    err1 = max_abs_err(torch, got, want)
    check(not geo.use(n1, ROWS, COLS)
          and torch.allclose(got, want, rtol=1e-5, atol=1e-4),
          f"one-pass encode of {n1} values allclose: max err {err1:g}")
    ms1 = time_ms(torch, lambda: cuda_cs.sketch_encode(
        v1, OFFSET, ROWS, COLS, out=scratch), 50)
    plain1 = time_ms(torch, lambda: ref.sketch_encode(
        v1, OFFSET, ROWS, COLS, out=scratch), 10)
    b, by = bound_ms(n1 * 4 + ROWS * min(n1, COLS) * 4, 2 * ROWS * n1)
    rows["encode"]["one_pass"] = dict(n=n1, max_abs_err=err1, ms=ms1,
                                      plain_ms=plain1, bound_ms=b,
                                      bound_by=by)

    # -- estimate ------------------------------------------------------------
    print("estimate: 2**24 ids from the 5 x 2**20 table")
    got = cuda_cs.sketch_estimate(table, OFFSET, CHUNK)
    want = ref.sketch_estimate(table, OFFSET, CHUNK)
    check(torch.equal(got, want), "estimate exact")
    err = max_abs_err(torch, got, want)
    est = got
    got = cuda_cs.sketch_estimate(odd, OFFSET + 3, CHUNK - 3)
    want = ref.sketch_estimate(odd, OFFSET + 3, CHUNK - 3)
    check(torch.equal(got, want),
          f"estimate exact from 5 x {ODD_COLS:,}, 2**24 - 3 ids")
    err = max(err, max_abs_err(torch, got, want))
    ms = time_ms(torch, lambda: cuda_cs.sketch_estimate(table, OFFSET, CHUNK),
                 10)
    plain = time_ms(torch, lambda: ref.sketch_estimate(table, OFFSET, CHUNK),
                    3)
    comparators = sum(len(range(p & 1, ROWS - 1, 2)) for p in range(ROWS))
    ops_per_id = ROWS + 2 + 2 * comparators
    b, by = bound_ms(CHUNK * 4 + ROWS * COLS * 4, CHUNK * ops_per_id)
    estimate_only = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                         bound_by=by)

    # the fused estimate + selection that topk_from_sketch runs a chunk
    print(f"estimate + selection: the {K:,} largest of 2**24 estimates")
    vals, idx = cuda_cs.sketch_estimate_topk(table, OFFSET, CHUNK, K)
    err = select_checks(torch, cuda_cs, ref, table, OFFSET, CHUNK, vals, idx,
                        est, "of the encoded reals")
    again = cuda_cs.sketch_estimate_topk(table, OFFSET, CHUNK, K)
    check(torch.equal(again[1], idx)
          and torch.equal(again[0].view(torch.int32), vals.view(torch.int32)),
          "a second call gives identical arrays")
    vals, idx = cuda_cs.sketch_estimate_topk(odd, OFFSET + 3, CHUNK - 3, K)
    err = max(err, select_checks(
        torch, cuda_cs, ref, odd, OFFSET + 3, CHUNK - 3, vals, idx,
        cuda_cs.sketch_estimate(odd, OFFSET + 3, CHUNK - 3),
        f"from 5 x {ODD_COLS:,}, 2**24 - 3 ids"))
    vals, idx = cuda_cs.sketch_estimate_topk(torch.zeros_like(table), OFFSET,
                                             CHUNK, K)
    check(torch.equal(idx, torch.arange(K, device=dev))
          and int(torch.count_nonzero(vals)) == 0,
          f"an all-zero table: every estimate ties at 0, the {K:,} lowest "
          f"ids come out, with 0")
    ms = time_ms(torch, lambda: cuda_cs.sketch_estimate_topk(
        table, OFFSET, CHUNK, K), 10)
    plain = time_ms(torch, lambda: ref.sketch_estimate_topk(
        table, OFFSET, CHUNK, K), 3)
    library = time_ms(torch, lambda: torch.topk(est.abs(), K), 10)

    def unfused():
        e = cuda_cs.sketch_estimate(table, OFFSET, CHUNK)
        i = torch.topk(e.abs(), K).indices
        return e[i], i

    estimate_only["unfused_ms"] = time_ms(torch, unfused, 10)
    # the table read once and the candidates (4 + 8 bytes) written once,
    # against the estimate's operations
    b, by = bound_ms(ROWS * COLS * 4 + K * 12, CHUNK * ops_per_id)
    rows["estimate"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=b, bound_by=by, library_ms=library,
                            estimate_only=estimate_only)

    # -- momentum_error ------------------------------------------------------
    print("momentum_error: three 5 x 2**20 tables")
    agg, su, se = (torch.randn(ROWS, COLS, generator=gen, device=dev)
                   for _ in range(3))
    lr = torch.full((), 0.05, device=dev)
    got = cuda_ss.momentum_error(agg, su, se, lr, 0.9)
    want = ref.momentum_error(agg, su, se, lr, 0.9)
    err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
    check(all(torch.allclose(g, w, rtol=1e-6, atol=0)
              for g, w in zip(got, want)),
          f"momentum_error allclose (rtol 1e-6): max err {err:g}")
    ms = time_ms(torch, lambda: cuda_ss.momentum_error(agg, su, se, lr, 0.9),
                 50)
    plain = time_ms(torch, lambda: ref.momentum_error(agg, su, se, lr, 0.9),
                    50)
    b, by = bound_ms(5 * ROWS * COLS * 4, 4 * ROWS * COLS)
    rows["momentum_error"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                  bound_ms=b, bound_by=by)

    # -- topk_mask -----------------------------------------------------------
    print("topk_mask: k = 25,000 ids over d = 162,148,608")
    ids = torch.unique(torch.randint(0, D_FULL, (2 * K,), generator=gen,
                                     device=dev))
    ids = ids[torch.randperm(ids.numel(), generator=gen, device=dev)][:K]
    check(ids.numel() == K, "25,000 distinct ids")
    vals = torch.randint(-20, 21, (K,), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.float32)
    su_i, se_i = (torch.randint(-50, 51, (ROWS, COLS), generator=gen,
                                device=dev, dtype=torch.int32).float()
                  for _ in range(2))
    err = 0.0
    for mode in ("zero", "subtract"):
        for masking in (True, False):
            kw = dict(error_mode=mode, momentum_masking=masking)
            got = cuda_ss.topk_mask(su_i.clone(), se_i.clone(), ids, vals, 0,
                                    **kw)
            want = ref.topk_mask(su_i.clone(), se_i.clone(), ids, vals, 0,
                                 **kw)
            err = max(err, *(max_abs_err(torch, g, w)
                             for g, w in zip(got, want)))
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"topk_mask {mode} masking={masking} "
                  f"{'bitwise' if mode == 'zero' else 'exact on integers'}")
    before = cuda_ss.LAUNCHES["topk_mask"]
    empty = ids[:0]
    got = cuda_ss.topk_mask(su_i.clone(), se_i.clone(), empty, vals[:0], 0)
    check(torch.equal(got[0], su_i) and torch.equal(got[1], se_i)
          and cuda_ss.LAUNCHES["topk_mask"] == before,
          "topk_mask with k = 0 leaves the tables and launches nothing")
    su_t, se_t = su_i.clone(), se_i.clone()
    ms = time_ms(torch, lambda: cuda_ss.topk_mask(su_t, se_t, ids, vals, 0),
                 50)
    plain = time_ms(torch, lambda: ref.topk_mask(su_t, se_t, ids, vals, 0),
                    10)
    # zero mode with masking (the main path): the ids read, one 4-byte
    # store per (id, row) into each of se and su; no float operations
    b, by = bound_ms(K * 8 + 2 * ROWS * K * 4, 0)
    rows["topk_mask"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                             bound_ms=b, bound_by=by)
    return rows


def select_checks(torch, cuda_cs, ref, table, offset, n, vals, idx, est,
                  what: str) -> float:
    """The fused selection (``vals``, ``idx``) of ``n`` ids against its rule
    and its plain twin on the same table: the estimate kernel's ``est``
    gives the keys (|est| with NaN above +inf); the ids above the K-th
    largest key equal the twin's as a set, as many sit at it as in the
    twin's, and the tied ones are the lowest; ``idx`` ascends and ``vals``
    is ``est[idx]`` bit for bit.  Returns the values' largest error."""
    k = vals.numel()
    keys = est.view(torch.int32).to(torch.int64) & 0x7FFFFFFF
    keys = torch.where(keys > 0x7F800000, 0x7FC00000, keys)
    t = torch.topk(keys, k).values[-1]
    above = torch.nonzero(keys > t).flatten()
    tied = torch.nonzero(keys == t).flatten()[:k - above.numel()]
    check(torch.equal(idx, torch.sort(torch.cat([above, tied])).values),
          f"selection {what}: {above.numel():,} ids above the {k:,}-th "
          f"|estimate|, then the {tied.numel():,} lowest ids tied at it, "
          f"ascending")
    check(torch.equal(vals.view(torch.int32), est[idx].view(torch.int32)),
          f"selection {what}: values are the estimates, bit for bit")
    pv, pi = ref.sketch_estimate_topk(table, offset, n, k)
    pk = keys[pi]
    check(torch.equal(torch.sort(pi[pk > t]).values, above)
          and int((pk == t).sum()) == tied.numel(),
          f"selection {what}: the plain twin's ids above the threshold are "
          f"the same, and as many tie at it")
    return max_abs_err(torch, vals, ref.sketch_estimate(table, offset, n)[idx])


def small_reference_run(torch, dev):
    """2 rounds of the reduced model on the card and on the CPU (plain
    twins) from the same weights: the losses and the updates agree."""
    from repro_torch import configs
    from repro_torch.core import fetchsgd as F
    from repro_torch.core import layout as layout_lib
    from repro_torch.data import synthetic
    from repro_torch.launch import train_lm
    from repro_torch.models import transformer

    cfg = configs.get_smoke("gpt2s-federated")
    fs_cfg = F.FetchSGDConfig(rows=5, cols=1 << 14, k=512)
    dataset = synthetic.PersonaLM(vocab=cfg.vocab, seq_len=32, n_clients=8)
    init = dict(layout_lib.flatten(transformer.init_params(cfg, seed=1)))
    runs = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        params = layout_lib.unflatten(
            list(init), [x.to(device, copy=True) for x in init.values()])
        records, _ = train_lm.train(cfg, fs_cfg, params, dataset, rounds=2,
                                    clients_per_round=4, peak_lr=0.16,
                                    device=device, log=lambda *_: None)
        runs[name] = ([r.loss for r in records],
                      {p: x.cpu() - init[p]
                       for p, x in layout_lib.flatten(params)})
    (l_gpu, s_gpu), (l_cpu, s_cpu) = runs["cuda"], runs["cpu"]
    print(f"  losses card {l_gpu}  cpu {l_cpu}")
    check(all(math.isfinite(x) for x in l_gpu), "reduced-model losses finite")
    check(math.isclose(l_gpu[0], l_cpu[0], rel_tol=1e-4),
          "round-0 loss on the card = on the CPU (rtol 1e-4)")
    check(all(math.isclose(a, b, rel_tol=1e-2) for a, b in zip(l_gpu, l_cpu)),
          "round losses on the card = on the CPU (rtol 1e-2)")
    moved = sum(int(torch.count_nonzero(s)) for s in s_cpu.values())
    differ = sum(int((~torch.isclose(s_gpu[p], s_cpu[p], rtol=1e-2,
                                     atol=1e-6)).sum()) for p in s_cpu)
    check(moved > 0 and differ <= 0.1 * moved,
          f"updates agree: {differ} of {moved} moved coordinates differ")


def main_path():
    """3 full-width rounds through the driver, counting kernel launches."""
    from repro_torch.kernels import count_sketch as cuda_cs
    from repro_torch.kernels import ops
    from repro_torch.launch import train_lm

    ops.reset_launch_counts()
    records, _ = train_lm.main(["--full", "--rounds", "3"], log=print)
    counts = ops.launch_counts()
    paths = dict(cuda_cs.PATHS)
    print(f"launches on the main path: {counts}; encode calls by path: "
          f"{paths}")
    rounds, clients, n_chunks = len(records), 4, N_CHUNKS
    check(counts == {"encode": rounds * clients * n_chunks,
                     "estimate": rounds * n_chunks,
                     "momentum_error": rounds, "topk_mask": rounds},
          f"every kernel launched: {n_chunks} chunks x {clients} clients "
          f"x {rounds} rounds encodes, {n_chunks} estimates, 1 momentum_error "
          f"and 1 topk_mask a round")
    check(min(paths.values()) > 0 and sum(paths.values()) == counts["encode"],
          "the encode took both of its paths")
    for r in records:
        check(math.isfinite(r.loss), f"round {r.round} loss {r.loss} finite")
        check(r.delta_size == K and r.delta_unique == K,
              f"round {r.round} Delta has exactly {K} distinct entries")
    return records, counts, paths


def fedsim_phase(torch, dev, smi_line: str) -> list[dict]:
    """The federated simulation at full width (gpt2s-federated, PersonaLM
    clients at seq 256, a 5 x 2**20 sketch, k = 25,000): FetchSGD through
    the orchestrator under each aggregation policy, then every baseline.
    Kernel launches are counted per FetchSGD run (set to 0 just before,
    read just after); every round is timed on the host clock, ended by a
    device sync."""
    from repro_torch import configs, fed
    from repro_torch.baselines import fedavg, local_topk
    from repro_torch.core import compression
    from repro_torch.core import fetchsgd as F
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import simulate

    cfg = configs.get_config("gpt2s-federated")
    fs_cfg = F.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, momentum=0.9)
    dataset = synthetic.PersonaLM(vocab=cfg.vocab, seq_len=256,
                                  n_clients=24)
    down = compression.fetchsgd_round(ROWS, COLS, K).download
    SM = fed.StragglerModel
    runs = [
        ("fetchsgd", "flat", 3, 8, dict(straggler=SM(dropout_prob=0.25))),
        ("fetchsgd", "async", 3, 8, dict(straggler=SM(straggle_prob=0.25,
                                                      max_delay=1))),
        ("fetchsgd", "tree", 2, 8, dict(tree_fanout=2)),
        ("true_topk", None, 2, 4, {}), ("local_topk", None, 2, 4, {}),
        ("fedavg", None, 2, 4, {}), ("uncompressed", None, 2, 4, {})]
    print(f"fedsim on {smi_line}")
    out = []
    for method, policy, rounds, cpr, fkw in runs:
        name = method + (f"/{policy}" if policy else "")
        seconds: list[float] = []
        clock = [time.perf_counter()]

        def progress(r, loss):
            torch.cuda.synchronize()
            now = time.perf_counter()
            seconds.append(now - clock[0])
            clock[0] = now

        fed_cfg = (fed.FederationConfig(rounds=rounds, clients_per_round=cpr,
                                        aggregate=policy, **fkw)
                   if policy else None)
        ops.reset_launch_counts()
        res = simulate.run_simulation(
            cfg, method=method, rounds=rounds, clients_per_round=cpr,
            fs_cfg=fs_cfg, topk_cfg=local_topk.LocalTopKConfig(k=K),
            fa_cfg=fedavg.FedAvgConfig(local_epochs=2), dataset=dataset,
            fed_cfg=fed_cfg, device=dev, progress=progress)
        counts = ops.launch_counts()
        print(f"{name}: losses {res.losses}; s/round {seconds} "
              f"({smi_line})")
        check(all(math.isfinite(x) for x in res.losses),
              f"{name}: every loss finite")
        meter = compression.TrafficMeter(d=D_FULL)
        if method == "fetchsgd":
            recs = res.extras["fed_records"]
            for rec in recs:
                check(rec.n_fresh + rec.n_dropped + rec.n_straggling
                      == len(rec.cohort),
                      f"{name} round {rec.round_idx}: fresh {rec.n_fresh} + "
                      f"dropped {rec.n_dropped} + straggling "
                      f"{rec.n_straggling} = cohort {len(rec.cohort)}")
                meter.record(compression.RoundTraffic(
                    upload=rec.upload_bytes,
                    download=down * (rec.n_fresh + rec.n_straggling)), 1)
            computed = sum(r.n_fresh + r.n_straggling for r in recs)
            updates = sum(r.n_fresh + r.n_late > 0 for r in recs)
            want = {"encode": N_CHUNKS * computed,
                    "estimate": N_CHUNKS * updates,
                    "momentum_error": updates, "topk_mask": updates}
            print(f"{name}: launches {counts}")
            check(counts == want,
                  f"{name}: {N_CHUNKS} encodes for each of the {computed} "
                  f"clients that computed; {N_CHUNKS} estimates, 1 "
                  f"momentum_error and 1 topk_mask for each of the "
                  f"{updates} server updates")
            if policy == "async":
                late = sum(r.n_late for r in recs)
                check(late > 0, f"{name}: {late} late tables merged with "
                      f"their discount")
        else:
            check(not any(counts.values()),
                  f"{name}: no sketch kernel launched")
            per = {"true_topk": compression.RoundTraffic(D_FULL * 4, K * 8),
                   "fedavg": compression.fedavg_round(D_FULL),
                   "uncompressed": compression.uncompressed_round(D_FULL)}
            for _ in range(rounds):
                if method in per:
                    meter.record(per[method], cpr)
        if method == "local_topk":
            # the download is the union of the uploaded supports, which only
            # the run knows; the upload is k values a client
            check(res.traffic["upload_bytes"] == K * 4 * cpr * rounds,
                  f"{name}: upload = k values a client a round")
        else:
            check(res.traffic == meter.compression(cpr),
                  f"{name}: traffic = core/compression's reckoning for the "
                  f"same participation")
        out.append(dict(run=name, rounds=rounds, clients_per_round=cpr,
                        losses=res.losses, seconds=seconds,
                        launches=counts, traffic=res.traffic))
    return out


EXAMPLE_ROUNDS = 2
# compression_sweep at full width: the reference's grid (cols x k for
# FetchSGD, k for local top-k, local epochs for FedAvg) at the main path's
# sketch and its half
EXAMPLE_SWEEP = {"cols": (1 << 19, 1 << 20), "k": (12_500, 25_000),
                 "local_k": (12_500, 25_000), "local_epochs": (1, 3)}
EXAMPLE_CLIS = ("quickstart", "compression_sweep", "async_federated",
                "heterogeneous_federation")
OBJECT_LENGTHS = ((1 << 24) + 3, 9_216)     # the binned and one-pass paths
CLI_TIMEOUT_S = 300


def fetchsgd_launches(computed: int, updates: int) -> dict[str, int]:
    """17 encodes a client that computed; 17 estimates, one
    momentum_error and one topk_mask a server update."""
    return {"encode": N_CHUNKS * computed, "estimate": N_CHUNKS * updates,
            "momentum_error": updates, "topk_mask": updates}


NO_LAUNCHES = fetchsgd_launches(0, 0)


def examples_phase(torch, dev, smi_line: str) -> dict:
    """The four example entry points (``repro_torch.launch.quickstart``,
    ``.compression_sweep``, ``.async_federated``,
    ``.heterogeneous_federation``) at full width, called from Python:
    gpt2s-federated from random weights, PersonaLM clients at seq 256, 2
    rounds, the examples' own cohorts (4 or 6 clients), the 5 x 2**20
    sketch with k = 25,000 (the sweep: FetchSGD over cols {2**19, 2**20}
    x k {12,500, 25,000}, local top-k over k, FedAvg over 1 and 3 local
    epochs, uncompressed).  Each run's losses finite, its launches equal
    to the formula and its ledger to ``core/compression``'s reckoning;
    async_federated and heterogeneous_federation also against a second
    call at the micro model's width on the CPU, every record field but
    the loss equal (``t_virtual`` and the critical paths to the byte).
    Then each command line on the card, and the Count Sketch object API
    against its CPU twin."""
    from repro_torch import configs, fed
    from repro_torch.core import compression
    from repro_torch.core import fetchsgd as F
    from repro_torch.data import synthetic
    from repro_torch.launch import (async_federated, compression_sweep,
                                    heterogeneous_federation, quickstart,
                                    simulate)

    t0 = time.time()
    cfg = configs.get_config("gpt2s-federated")
    fs_cfg = F.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, momentum=0.9)
    dataset = synthetic.PersonaLM(vocab=cfg.vocab, seq_len=256,
                                  n_clients=64)
    micro = simulate.micro_cfg()
    micro_data = synthetic.PersonaLM(vocab=micro.vocab, seq_len=16,
                                     n_clients=64)
    rounds = EXAMPLE_ROUNDS
    seconds: dict[str, list] = {}
    clock = [0.0]

    def progress(name, r, loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds.setdefault(name, []).append(now - clock[0])
        clock[0] = now

    def start():
        torch.cuda.synchronize()
        clock[0] = time.perf_counter()

    print(f"examples on {smi_line}")
    out: list[dict] = []

    def ran(example, name, res, cpr, launches, per_round=None):
        """Check one run (launches, losses, the ledger) and keep it."""
        what = f"{example} {name}"
        print(f"{what}: losses {res['losses']}; s/round "
              f"{seconds.get(name)}; launches {res['launches']} "
              f"({smi_line})")
        check(all(x is not None and math.isfinite(x)
                  for x in res["losses"]), f"{what}: every loss finite")
        check(res["launches"] == launches,
              f"{what}: launches {res['launches']} = {launches}")
        if per_round is not None:
            meter = compression.TrafficMeter(d=D_FULL)
            for _ in range(rounds):
                meter.record(per_round, cpr)
            check(res["traffic"] == meter.compression(cpr),
                  f"{what}: traffic = core/compression's reckoning")
        out.append(dict(example=example, run=name, clients_per_round=cpr,
                        losses=res["losses"],
                        seconds=seconds.pop(name, []),
                        launches=res["launches"], traffic=res["traffic"]))

    # -- quickstart: uncompressed, then FetchSGD, 4 clients a round ---------
    start()
    for res in quickstart.run(cfg, dataset, fs_cfg, rounds, device=dev,
                              progress=progress):
        if res["method"] == "fetchsgd":
            ran("quickstart", "fetchsgd", res, 4,
                fetchsgd_launches(4 * rounds, rounds),
                compression.fetchsgd_round(ROWS, COLS, K))
            up = res["traffic"]["upload_x"]
            check(math.isclose(up, D_FULL / (ROWS * COLS), rel_tol=1e-12),
                  f"quickstart fetchsgd: upload_x {up:.4f} = d / (5 x 2**20)")
        else:
            ran("quickstart", res["method"], res, 4, NO_LAUNCHES,
                compression.uncompressed_round(D_FULL))

    # -- compression_sweep: the reference's nine runs at full width ---------
    start()
    for res in compression_sweep.run(cfg, dataset, EXAMPLE_SWEEP, rounds,
                                     device=dev, progress=progress):
        name, method = res["name"], res["method"]
        print("sweep CSV: " + compression_sweep.csv_row(res))
        if method == "fetchsgd":
            cols, k = (int(x) for x in name[len("fetchsgd_c"):].split("_k"))
            ran("compression_sweep", name, res, 4,
                fetchsgd_launches(4 * rounds, rounds),
                compression.fetchsgd_round(ROWS, cols, k))
            up = res["traffic"]["upload_x"]
            check(math.isclose(up, D_FULL / (ROWS * cols), rel_tol=1e-12),
                  f"{name}: upload_x {up:.4f} = d / (5 x {cols})")
        elif method == "local_topk":
            k = int(name[len("local_topk_k"):])
            # the download is the union of the uploaded supports, which
            # only the run knows; the upload is k values a client
            check(res["traffic"]["upload_bytes"] == k * 4 * 4 * rounds,
                  f"{name}: upload = k values a client a round")
            ran("compression_sweep", name, res, 4, NO_LAUNCHES)
        else:
            ran("compression_sweep", name, res, 4, NO_LAUNCHES,
                compression.fedavg_round(D_FULL) if method == "fedavg"
                else compression.uncompressed_round(D_FULL))

    # -- async_federated: flat and async over the same failure draws --------
    traffic = compression.fetchsgd_round(ROWS, COLS, K)
    start()
    card = async_federated.run(cfg, dataset, fs_cfg, rounds, device=dev,
                               progress=progress)
    cpu = async_federated.run(micro, micro_data, fs_cfg, rounds,
                              device="cpu")
    # both policies draw the same cohorts and fates; flat counts a
    # straggler, whose gradient and sketch it computed, as dropped, so the
    # clients that computed are the cohort less async's dropouts
    dropouts = [r["n_dropped"] for r in card["async"]["records"]]
    for policy, res in card.items():
        recs = [fed.RoundRecord(**r) for r in res["records"]]
        name = f"async_federated {policy}"
        if policy == "flat":
            check([r.cohort for r in recs] == [
                r["cohort"] for r in card["async"]["records"]],
                f"{name}: the cohorts are async's")
            launches = fetchsgd_launches(
                sum(len(r.cohort) - d for r, d in zip(recs, dropouts)),
                sum(r.n_fresh + r.n_late > 0 for r in recs))
        else:
            launches = expected_launches(recs, per_object_event=False)
        check(record_meta(recs) == [
            {k: v for k, v in r.items() if k != "loss"}
            for r in cpu[policy]["records"]],
            f"{name}: every record but its loss equals the micro model's "
            f"on the CPU")
        meter = compression.TrafficMeter(d=D_FULL)
        for r in recs:
            meter.record(compression.RoundTraffic(
                upload=r.upload_bytes,
                download=traffic.download * (r.n_fresh + r.n_straggling)), 1)
        check(res["traffic"] == meter.compression(6),
              f"{name}: traffic = core/compression's reckoning for the same "
              f"participation")
        ran("async_federated", policy, res, 6, launches)
    late = sum(r["n_late"] for r in card["async"]["records"])
    check(late > 0, f"async_federated async: {late} late tables merged with "
          f"their discount")
    del card

    # -- heterogeneous_federation: flat, tree, async on the event clock -----
    start()
    card = heterogeneous_federation.run(cfg, dataset, fs_cfg, rounds,
                                        device=dev, progress=progress)
    again = heterogeneous_federation.run(micro, micro_data, fs_cfg, rounds,
                                         device="cpu")
    het = {}
    for policy, res in card.items():
        recs = [fed.RoundRecord(**r) for r in res["records"]]
        name = f"heterogeneous_federation {policy}"
        fed_cfg = fed.FederationConfig(aggregate=policy, tree_fanout=2)
        meter, _ = event_ledger(name, recs, fed_cfg, traffic)
        check(res["traffic"] == meter.compression(6),
              f"{name}: traffic = core/compression's reckoning")
        other = again[policy]
        check(record_meta(recs) == [
            {k: v for k, v in r.items() if k != "loss"}
            for r in other["records"]]
            and res["t_virtual"] == other["t_virtual"]
            and res["cp_sum_s"] == other["cp_sum_s"],
            f"{name}: t_virtual {res['t_virtual']!r} and critical paths "
            f"{[r.critical_path_s for r in recs]} equal a second call's at "
            f"the micro width on the CPU, to the byte, and so does every "
            f"record field but the loss")
        ran("heterogeneous_federation", policy, res, 6,
            expected_launches(recs, per_object_event=True))
        het[policy] = dict(t_virtual=res["t_virtual"],
                           cp_sum_s=res["cp_sum_s"],
                           upload_mb=res["upload_mb"],
                           final_loss=res["final_loss"])
    del card
    torch.cuda.empty_cache()
    calls_s = time.time() - t0

    objects = object_api_checks(torch, dev)
    clis = example_clis()
    totals = {k: sum(r["launches"][k] for r in out) for k in NO_LAUNCHES}
    return dict(runs=out, heterogeneous=het, launches=totals,
                calls_seconds=calls_s, clis=clis, object_api=objects,
                seconds=time.time() - t0)


def run_all(cmds: dict[str, tuple[list, dict]]) -> dict[str, dict]:
    """Start every command at once and wait for all: {name: (argv, env)}
    -> {name: returncode, stdout, stderr, seconds}.  Kills what is left
    on the way out."""
    procs = {}
    try:
        t0 = time.perf_counter()
        for name, (argv, env) in cmds.items():
            procs[name] = subprocess.Popen(
                argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        res = {}
        for name, proc in procs.items():
            so, se = proc.communicate(timeout=CLI_TIMEOUT_S)
            res[name] = dict(returncode=proc.returncode, stdout=so,
                             stderr=se, seconds=time.perf_counter() - t0)
        return res
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def example_clis() -> dict:
    """Each example's command line as the README runs it, ``python -m
    repro_torch.launch.<name> --rounds 2`` with no ``--device``: it exits 0
    on the card, and without a visible card it refuses to start (the card
    is its default).  async_federated also into a checkpoint directory,
    then again with 4 rounds, which resumes after round 1."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    no_card = dict(env, CUDA_VISIBLE_DEVICES="")

    def cmd(name, *extra, rounds=EXAMPLE_ROUNDS):
        return [sys.executable, "-m", f"repro_torch.launch.{name}",
                "--rounds", str(rounds), *extra]

    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "ckpt")
        cmds = {name: (cmd(name), env) for name in EXAMPLE_CLIS}
        cmds["async_federated --checkpoint-dir"] = (
            cmd("async_federated", "--checkpoint-dir", ckpt), env)
        cmds.update({f"{name} without a card": (cmd(name), no_card)
                     for name in EXAMPLE_CLIS})
        res = run_all(cmds)
        res.update(run_all({"async_federated --rounds 4 --checkpoint-dir": (
            cmd("async_federated", "--checkpoint-dir", ckpt, rounds=4),
            env)}))
        check(os.path.isdir(ckpt + "-flat") and os.path.isdir(ckpt + "-async"),
              "async_federated checkpointed into <dir>-flat and <dir>-async")
    with open(OUT / "chip_smoke_examples_cli.log", "w") as f:
        for name, r in res.items():
            f.write(f"== {name}: rc {r['returncode']}, {r['seconds']:.1f} s"
                    f"\n{r['stdout']}\n-- stderr\n{r['stderr'][-4000:]}\n")
    marks = {"quickstart": "== fetchsgd",
             "compression_sweep": "uncompressed,1.00,1.00,",
             "async_federated": "final loss: flat ",
             "heterogeneous_federation": "same byte totals"}
    for name, r in res.items():
        base = name.split()[0]
        if name.endswith("without a card"):
            check(r["returncode"] != 0
                  and "CUDA is not available" in r["stderr"],
                  f"{name}: refuses to start (the card is its default)")
            continue
        check(r["returncode"] == 0 and marks[base] in r["stdout"],
              f"`python -m repro_torch.launch.{name} --rounds 2` exits 0 on "
              f"the card in {r['seconds']:.1f} s")
    resumed = res["async_federated --rounds 4 --checkpoint-dir"]["stdout"]
    check("[flat] resuming from round 2" in resumed
          and "[async] resuming from round 2" in resumed
          and "round   3" in resumed,
          "async_federated with 4 rounds resumes each policy from round 2 "
          "of its checkpoint and runs rounds 2-3")
    return {name: dict(returncode=r["returncode"], seconds=r["seconds"],
                       stdout=r["stdout"].splitlines()[-3:])
            for name, r in res.items()}


def object_api_checks(torch, dev) -> dict:
    """The Count Sketch object API on the card against its CPU twin, at
    offset 2**32 + 12,345 into 5 x 2**20: ``sketch_vector`` at 2**24 + 3
    values (binned) and 9,216 (one-pass), exact on integer values and
    allclose on reals (rtol 1e-5, atol 1e-4: the atomics sum in another
    order); ``estimate`` exact; ``+`` and ``scale`` exact; ``l2_estimate``
    within rtol 1e-5 of the float64 median of the CPU table's row norms
    (the CPU's own float32 norm of 2**20 squares a row drifts by about that
    much and is reported beside it).  The kernels' launches are counted."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.kernels import count_sketch as cuda_cs
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(24)
    out = {}
    for n in OBJECT_LENGTHS:
        path = "binned" if cuda_cs.bins().use(n, ROWS, COLS) else "one_pass"
        ints = torch.randint(-8, 9, (n,), generator=gen,
                             dtype=torch.int32).float()
        reals = torch.randn(n, generator=gen)
        ops.reset_launch_counts()
        paths = dict(cuda_cs.PATHS)
        a = cs.sketch_vector(ints.to(dev), ROWS, COLS, offset=OFFSET)
        r = cs.sketch_vector(reals.to(dev), ROWS, COLS, offset=OFFSET)
        est = cs.estimate(a, OFFSET, n)
        merged = (a + a.scale(3.0)).table
        l2 = float(r.l2_estimate())
        counts = ops.launch_counts()
        took = {p: cuda_cs.PATHS[p] - paths[p] for p in paths}
        a_cpu = cs.sketch_vector(ints, ROWS, COLS, offset=OFFSET)
        r_cpu = cs.sketch_vector(reals, ROWS, COLS, offset=OFFSET)
        err = max_abs_err(torch, r.table.cpu(), r_cpu.table)
        l2_64 = float(cs.l2_estimate(r_cpu.table.double()))
        l2_cpu = float(r_cpu.l2_estimate())
        print(f"object API, {n} values ({path}): launches {counts}, reals' "
              f"max err {err:g}, l2_estimate {l2!r} on the card, {l2_cpu!r} "
              f"on the CPU, {l2_64!r} in float64")
        check(counts == {"encode": 2, "estimate": 1, "momentum_error": 0,
                         "topk_mask": 0} and took[path] == 2,
              f"object API, {n} values: 2 sketch_vector calls launched the "
              f"{path} encode, 1 estimate call the estimate kernel")
        check(torch.equal(a.table.cpu(), a_cpu.table),
              f"sketch_vector of {n} integer values on the card = the CPU's")
        check(torch.allclose(r.table.cpu(), r_cpu.table, rtol=1e-5,
                             atol=1e-4),
              f"sketch_vector of {n} reals allclose to the CPU's "
              f"(max err {err:g})")
        check(torch.equal(est.cpu(), cs.estimate(a_cpu, OFFSET, n)),
              f"estimate of {n} ids on the card = the CPU's")
        check(torch.equal(merged.cpu(), (a_cpu + a_cpu.scale(3.0)).table),
              "a + a.scale(3) on the card = the CPU's")
        check(math.isclose(l2, l2_64, rel_tol=1e-5),
              "l2_estimate on the card = the CPU table's in float64 "
              "(rtol 1e-5)")
        out[n] = dict(path=path, launches=counts, reals_max_abs_err=err,
                      l2_estimate=l2, l2_estimate_cpu=l2_cpu,
                      l2_estimate_f64=l2_64)
        del a, r, est, merged
    return out


def eventsim_phase(torch, dev, smi_line: str) -> list[dict]:
    """The event clock and the population-scale paths at full width
    (gpt2s-federated, random weights from seed 0, PersonaLM clients at
    seq 256, a 5 x 2**20 sketch, k = 25,000), each run checked against the
    same configuration run on the CPU at the micro model's width: every
    record field but the loss is a function of the seed and the
    configuration, not of the model."""
    from repro_torch import configs, fed
    from repro_torch.core import compression
    from repro_torch.core import fetchsgd as F
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import simulate
    from repro_torch.models import transformer

    cfg = configs.get_config("gpt2s-federated")
    micro = simulate.micro_cfg()
    fs_cfg = F.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, momentum=0.9)
    traffic = compression.fetchsgd_round(ROWS, COLS, K)
    SM, Sim, Het = fed.StragglerModel, fed.SimTimeConfig, \
        fed.HeterogeneityConfig
    runs = [
        ("event-flat", 64, 3, dict(
            clock="event", aggregate="flat", clients_per_round=8,
            straggler=SM(dropout_prob=0.25),
            simtime=Sim(heterogeneity=Het(bandwidth_sigma=1.0)))),
        ("event-async", 64, 3, dict(
            clock="event", aggregate="async", clients_per_round=8,
            straggler=SM(straggle_prob=0.25),
            simtime=Sim(quorum=4, staleness_lambda=0.05, max_age=60.0))),
        ("event-tree", 64, 2, dict(
            clock="event", aggregate="tree", clients_per_round=8,
            tree_fanout=2, simtime=Sim(link_bandwidth=1e8))),
        ("pop-round", 10**6, 2, dict(
            clock="round", aggregate="flat", clients_per_round=32,
            vectorized=True, weight_by="profile",
            simtime=Sim(heterogeneity=Het(profile_stream="counter")))),
        ("pop-event", 10**6, 3, dict(
            clock="event", aggregate="async", clients_per_round=10**4,
            vectorized=True, simtime=Sim(quorum=16))),
    ]
    param_bytes = 4 * D_FULL
    print(f"eventsim on {smi_line}")
    out = []
    for name, population, rounds, kw in runs:
        fed_cfg = fed.FederationConfig(rounds=rounds, seed=0, **kw)
        # the same configuration at the micro model's width, on the CPU
        cpu = fed.Orchestrator(
            micro, fs_cfg, fed_cfg,
            synthetic.PersonaLM(vocab=micro.vocab, seq_len=16,
                                n_clients=population),
            device="cpu").run()

        orch = fed.Orchestrator(
            cfg, fs_cfg, fed_cfg,
            synthetic.PersonaLM(vocab=cfg.vocab, seq_len=256,
                                n_clients=population),
            params=transformer.init_params(cfg, 0, dev), device=dev)
        # the largest client computed sets the peak of activations
        largest = [0]
        batch_of = orch._client_batch

        def client_batch(c, batch_of=batch_of):
            batch = batch_of(c)
            largest[0] = max(largest[0], len(batch["tokens"]))
            return batch
        orch._client_batch = client_batch
        dispatch_s: list[float] = []
        if orch.vectorized and orch.is_event:
            inner = orch._dispatch_cohort_vec

            def timed_dispatch(r, inner=inner):
                t0 = time.perf_counter()
                got = inner(r)
                dispatch_s.append(time.perf_counter() - t0)
                return got
            orch._dispatch_cohort_vec = timed_dispatch
        seconds: list[float] = []
        snapshots = [0]
        clock = [time.perf_counter()]

        def progress(rec):
            torch.cuda.synchronize()
            now = time.perf_counter()
            seconds.append(now - clock[0])
            clock[0] = now
            snapshots[0] = max(snapshots[0], orch.held_snapshots)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        clock[0] = time.perf_counter()
        res = orch.run(progress=progress)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        recs = res.records
        print(f"{name}: losses {res.losses}; s/round {seconds}; dispatch "
              f"s {dispatch_s}; peak memory {peak / 2**30:.3f} GiB; "
              f"largest client {largest[0]} sequences; weight copies held "
              f"at most {snapshots[0]}; launches {counts} ({smi_line})")

        def meta(rr):
            return [{k: v for k, v in vars(r).items() if k != "loss"}
                    for r in rr]
        check(meta(recs) == meta(cpu.records),
              f"{name}: every record but its loss equals the micro model's "
              f"on the CPU")
        moved = ("upload_bytes", "download_bytes")
        check(res.extras["in_flight"] == cpu.extras["in_flight"]
              and all(res.traffic[k] == cpu.traffic[k] for k in moved),
              f"{name}: in flight ({res.extras['in_flight']}) and bytes "
              f"moved equal the CPU run's")
        check(all(math.isfinite(x) for x in res.losses if x is not None),
              f"{name}: every loss finite")
        sent = [len(r.cohort) - r.n_dropped for r in recs]
        meter = compression.TrafficMeter(d=D_FULL)
        if orch.is_event:
            meter, arrivals = event_ledger(name, recs, fed_cfg, traffic)
            materialized = sum(arrivals if orch.vectorized else sent)
        else:
            materialized = sum(sent)
            for r in recs:
                check(r.upload_bytes == r.n_fresh * traffic.upload,
                      f"{name} round {r.round_idx}: upload = {r.n_fresh} x "
                      f"{traffic.upload}")
                meter.record(compression.RoundTraffic(
                    upload=r.upload_bytes,
                    download=traffic.download * (r.n_fresh
                                                 + r.n_straggling)), 1)
        check(res.traffic == meter.compression(fed_cfg.clients_per_round),
              f"{name}: traffic = core/compression's reckoning")
        updates = sum(r.n_fresh + r.n_late > 0 for r in recs)
        want = {"encode": N_CHUNKS * materialized,
                "estimate": N_CHUNKS * updates,
                "momentum_error": updates, "topk_mask": updates}
        check(counts == want,
              f"{name}: {N_CHUNKS} encodes for each of the {materialized} "
              f"clients computed; {N_CHUNKS} estimates, 1 momentum_error "
              f"and 1 topk_mask for each of the {updates} server updates")
        if name == "event-async":
            check(sum(r.n_late for r in recs) > 0
                  and res.extras["in_flight"] > 0,
                  f"{name}: tables merged late while others stay in flight")
        if name == "pop-event":
            check(materialized == rounds * 16 and len(dispatch_s) == rounds,
                  f"{name}: {materialized} clients computed of "
                  f"{sum(sent)} dispatched")
            check(snapshots[0] >= 2,
                  f"{name}: {snapshots[0]} weight copies held for lazy "
                  f"events of earlier rounds")
        out.append(dict(
            run=name, population=population, rounds=rounds,
            clients_per_round=fed_cfg.clients_per_round,
            clients_computed=materialized, losses=res.losses,
            seconds=seconds, dispatch_seconds=dispatch_s,
            peak_memory_bytes=peak, largest_client_sequences=largest[0],
            weight_copies_peak=snapshots[0],
            weight_copies_peak_bytes=snapshots[0] * param_bytes,
            launches=counts, t_virtual=[r.t_virtual for r in recs],
            in_flight=res.extras["in_flight"], traffic=res.traffic))
    return out


def expected_launches(recs, per_object_event: bool) -> dict[str, int]:
    """Launches a run's records imply: 17 encodes for each client that
    computed, 17 estimates, one momentum_error and one topk_mask for each
    server update that carried weight."""
    computed = sum((len(r.cohort) - r.n_dropped) if per_object_event
                   else (r.n_fresh + r.n_straggling) for r in recs)
    updates = sum(r.n_fresh + r.n_late > 0 for r in recs)
    return fetchsgd_launches(computed, updates)


def event_ledger(name: str, recs, fed_cfg, traffic):
    """``core/compression``'s reckoning of an event-clock run from its
    records: each round's upload is the tables sent (and the tree's
    internal forwards), its download one model delta an arrival.  Checks
    that virtual time never goes back and each round's upload; returns
    the meter and the arrivals of each round."""
    from repro_torch.core import compression
    from repro_torch.core import fetchsgd as F

    times = [r.t_virtual for r in recs]
    check(all(a <= b for a, b in zip(times, times[1:]))
          and all(r.t_dispatch <= r.t_virtual for r in recs),
          f"{name}: virtual time never goes back ({times})")
    sent = [len(r.cohort) - r.n_dropped for r in recs]
    before = [0] + [r.n_straggling for r in recs[:-1]]
    arrivals = [b + s - r.n_straggling
                for b, s, r in zip(before, sent, recs)]
    meter = compression.TrafficMeter(d=D_FULL)
    for r, s, a in zip(recs, sent, arrivals):
        internal = (sum(b for _, b in F.tree_level_bytes(
                        traffic.upload, r.n_fresh, fed_cfg.tree_fanout)[1:])
                    if fed_cfg.aggregate == "tree" else 0)
        check(r.upload_bytes == s * traffic.upload + internal,
              f"{name} round {r.round_idx}: upload {r.upload_bytes} = {s} x "
              f"{traffic.upload} + {internal} of tree forwards")
        meter.record(compression.RoundTraffic(
            upload=r.upload_bytes, download=traffic.download * a), 1)
    return meter, arrivals


def record_meta(recs) -> list[dict]:
    return [{k: v for k, v in vars(r).items() if k != "loss"} for r in recs]


def resume_phase(torch, dev, smi_line: str) -> list[dict]:
    """Checkpoint and resume at full width (gpt2s-federated, random weights
    from seed 0, PersonaLM clients at seq 256, a 5 x 2**20 sketch,
    k = 25,000, the eventsim phase's heterogeneity): each run 4 rounds
    straight, then 2 rounds with a checkpoint and rounds 2-3 resumed from
    it by a fresh ``Orchestrator``.  The card's contract: save and restore
    are bitwise, every record field but the loss equals the straight
    run's, losses agree within rtol 1e-3 (the encode's float atomics sum
    in no fixed order).  The full-width pop-event run is not checkpointed:
    its ~30,000 lazy in-flight events would each be computed for the save
    (21 MB a table)."""
    import os
    import tempfile

    from repro_torch import configs, fed
    from repro_torch.core import fetchsgd as F
    from repro_torch.core import layout as layout_lib
    from repro_torch.data import synthetic
    from repro_torch.fed import checkpoint as ckpt
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.optim import linear_decay

    cfg = configs.get_config("gpt2s-federated")
    fs_cfg = F.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, momentum=0.9)
    dataset = synthetic.PersonaLM(vocab=cfg.vocab, seq_len=256,
                                  n_clients=64)
    SM, Sim = fed.StragglerModel, fed.SimTimeConfig
    runs = [
        ("event-async", dict(
            clock="event", aggregate="async", clients_per_round=8,
            straggler=SM(straggle_prob=0.25),
            simtime=Sim(quorum=4, staleness_lambda=0.05, max_age=60.0))),
        ("round-async", dict(
            clock="round", aggregate="async", clients_per_round=8,
            straggler=SM(straggle_prob=0.25))),
    ]
    print(f"resume on {smi_line}")
    out = []
    for name, kw in runs:
        def run(rounds, ckdir=None, seconds=None, save_s=None):
            """One leg: counts set to 0 just before, checked just after."""
            fed_cfg = fed.FederationConfig(
                rounds=rounds, seed=0, checkpoint_dir=ckdir,
                checkpoint_every=2 if ckdir else 0, **kw)
            orch = fed.Orchestrator(
                cfg, fs_cfg, fed_cfg, dataset,
                params=transformer.init_params(cfg, 0, dev), device=dev,
                lr_fn=linear_decay(0.2, 4))
            if save_s is not None:
                inner = orch._save

                def timed_save(r, inner=inner):
                    t0 = time.perf_counter()
                    inner(r)
                    save_s.append(time.perf_counter() - t0)
                orch._save = timed_save
            clock = [0.0]

            def progress(rec):
                torch.cuda.synchronize()
                now = time.perf_counter()
                if seconds is not None:
                    seconds.append(now - clock[0])
                clock[0] = now
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            clock[0] = time.perf_counter()
            res = orch.run(progress=progress)
            counts = ops.launch_counts()
            want = expected_launches(res.records, kw["clock"] == "event")
            check(counts == want, f"{name}, rounds {orch.start_round}-"
                  f"{rounds - 1}: launches {counts} = 17 encodes a client "
                  f"computed, 17 estimates, 1 momentum_error and 1 "
                  f"topk_mask an update")
            return orch, res

        seconds: dict[str, list] = {"straight": [], "first": [],
                                    "resumed": []}
        save_s: list[float] = []
        _, full = run(4, seconds=seconds["straight"])
        del _
        with tempfile.TemporaryDirectory() as d:
            first_orch, first = run(2, d, seconds["first"], save_s)
            files = sorted(os.listdir(d))
            ck_bytes = sum(os.path.getsize(os.path.join(d, f))
                           for f in files)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck = ckpt.restore(d, first_orch.params, first_orch.opt_state)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            saved = [x for _, x in layout_lib.flatten(first_orch.params)] + [
                first_orch.opt_state.momentum_sketch,
                first_orch.opt_state.error_sketch]
            got = [x for _, x in layout_lib.flatten(ck.params)] + [
                ck.opt_state.momentum_sketch, ck.opt_state.error_sketch]
            late = (first_orch.aggregator.state()
                    if kw["aggregate"] == "async" else [])
            saved += [e["table"] for e in late]
            got += [e["table"] for e in ck.late_buffer]
            events = (first_orch._queue.state() if kw["clock"] == "event"
                      else [])
            saved += [e.table for e in events]
            got += [e.table for e in (ck.simtime or {"events": []})["events"]]
            check(len(got) == len(saved)
                  and all(g.device == s.device and torch.equal(g, s)
                          for g, s in zip(got, saved))
                  and ck.opt_state.step == first_orch.opt_state.step,
                  f"{name}: restore is bitwise on the card: "
                  f"{len(saved)} tensors ({len(late)} late tables, "
                  f"{len(events)} in-flight event tables), step "
                  f"{ck.opt_state.step}")
            check(len(late) + len(events) > 0,
                  f"{name}: the checkpoint holds tables still to merge")
            if kw["clock"] == "event":
                check([e.meta() for e in ck.simtime["events"]]
                      == [e.meta() for e in events]
                      and ck.simtime["now"] == first_orch._now,
                      f"{name}: event queue and virtual clock restored")
            del ck, first_orch, saved, got, late, events
            resumed_orch, resumed = run(4, d, seconds["resumed"])
            check(resumed_orch.start_round == 2
                  and resumed.extras["start_round"] == 2,
                  f"{name}: the fresh Orchestrator resumes at round 2")
            check(len(os.listdir(d)) <= 4, f"{name}: at most 2 checkpoints "
                  f"on disk")
            del resumed_orch
        check(record_meta(first.records) == record_meta(full.records[:2])
              and record_meta(resumed.records)
              == record_meta(full.records[2:]),
              f"{name}: every record field but the loss equals the straight "
              f"run's (cohorts, fates, counts, bytes, virtual times)")
        losses = first.losses + resumed.losses
        check(all(math.isclose(a, b, rel_tol=1e-3)
                  for a, b in zip(losses, full.losses)),
              f"{name}: losses {losses} vs straight {full.losses} "
              f"(rtol 1e-3)")
        print(f"{name}: checkpoint {ck_bytes} bytes ({files}); save s "
              f"{save_s}; restore s {restore_s}; s/round straight "
              f"{seconds['straight']}, first {seconds['first']}, resumed "
              f"{seconds['resumed']} ({smi_line})")
        out.append(dict(run=name, checkpoint_bytes=ck_bytes,
                        checkpoint_files=files, save_seconds=save_s,
                        restore_seconds=restore_s, seconds=seconds,
                        losses_straight=full.losses, losses_resumed=losses,
                        pending_late=resumed.extras["pending_late"],
                        in_flight=resumed.extras["in_flight"]))
        del full, first, resumed
        torch.cuda.empty_cache()
    return out


def telemetry_phase(torch, dev, smi_line: str) -> dict:
    """FetchSGD flat with dropout 0.25, 8 clients a round, 3 rounds, at full
    width through ``run_simulation``, four times in turn: without
    telemetry, with (JSONL and memory sinks, tracing, the kernel dispatch
    traced, a sketch-health sample each round) twice, and without.  Each
    instrumented stream validates, its kernel spans count the launches,
    and every run's records but the loss are the first run's."""
    import statistics
    import tempfile

    from repro_torch import configs, fed, obs
    from repro_torch.core import fetchsgd as F
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import simulate

    cfg = configs.get_config("gpt2s-federated")
    fs_cfg = F.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, momentum=0.9)
    dataset = synthetic.PersonaLM(vocab=cfg.vocab, seq_len=256,
                                  n_clients=64)
    rounds, cpr = 3, 8
    fed_cfg = fed.FederationConfig(
        rounds=rounds, clients_per_round=cpr, aggregate="flat",
        straggler=fed.StragglerModel(dropout_prob=0.25))
    print(f"telemetry on {smi_line}")
    health_s: list[float] = []
    emit_health = fed.Orchestrator._emit_health

    def timed_health(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emit_health(self, *args)
        torch.cuda.synchronize()
        health_s.append(time.perf_counter() - t0)

    def sim(path=None):
        """One run, with telemetry into ``path`` when given: (result,
        s/round, events, launches)."""
        seconds: list[float] = []
        clock = [0.0]

        def progress(r, loss):
            torch.cuda.synchronize()
            now = time.perf_counter()
            seconds.append(now - clock[0])
            clock[0] = now
        mem, tele = obs.MemorySink(), obs.NOOP
        if path:
            tele = obs.Telemetry([obs.JsonlSink(path), mem], trace=True)
            tele.emit_meta(run="chip_smoke", phase="telemetry")
            fed.Orchestrator._emit_health = timed_health
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        clock[0] = time.perf_counter()
        try:
            with obs.active(tele):    # the kernel dispatch traced too
                res = simulate.run_simulation(
                    cfg, method="fetchsgd", rounds=rounds,
                    clients_per_round=cpr, fs_cfg=fs_cfg, dataset=dataset,
                    fed_cfg=fed_cfg, device=dev, progress=progress,
                    telemetry=tele, health_every=1)
            counts = ops.launch_counts()
        finally:
            if path:
                fed.Orchestrator._emit_health = emit_health
                tele.close()
        return res, seconds, mem.events, counts

    with tempfile.TemporaryDirectory() as d:
        paths = [str(Path(d) / f"run{i}.jsonl") for i in range(2)]
        runs = [sim(p) for p in (None, *paths, None)]
        for p in paths:
            check(obs.validate_jsonl(p) == [], f"the JSONL stream validates "
                  f"({len(obs.parse_jsonl(p))} events)")
        (OUT / "chip_smoke_telemetry.jsonl").write_text(
            Path(paths[0]).read_text())
    base = runs[0][0]
    spans: list[dict] = []
    for res, _, events, counts in runs[1:3]:
        recs = res.extras["fed_records"]
        rounds_ev = [e for e in events if e["type"] == "round"]
        health = [e for e in events if e["type"] == "sketch_health"]
        check([e["round"] for e in rounds_ev] == list(range(rounds))
              and [e["round"] for e in health] == list(range(rounds)),
              "one round event and one sketch_health event a round")
        check(all(math.isfinite(h["recovery_rel_err"])
                  and 0.0 <= h["heavy_hitter_overlap"] <= 1.0
                  for h in health),
              f"recovery_rel_err finite and heavy_hitter_overlap in [0, 1]: "
              f"{[(h['recovery_rel_err'], h['heavy_hitter_overlap']) for h in health]}")
        run_spans = [e for e in events if e["type"] == "span"]
        spans += run_spans
        by_kernel = {k: sum(e["name"].startswith(f"kernel.{k}[cuda:")
                            for e in run_spans) for k in counts}
        want = expected_launches(recs, False)
        want["estimate"] += N_CHUNKS * len(health)
        check(by_kernel == counts == want,
              f"kernel spans {by_kernel} = launches {counts} = the records' "
              f"plus {N_CHUNKS} estimates for each of the {len(health)} "
              f"health samples")
    for res, *_ in runs[1:]:
        check(record_meta(res.extras["fed_records"])
              == record_meta(base.extras["fed_records"])
              and res.traffic == base.traffic,
              "every record field but the loss equals the first run's "
              "(without telemetry)")
        check(all(math.isfinite(x) for x in res.losses), "every loss finite")
    medians: dict = {}
    for e in spans:
        medians.setdefault(e["name"], []).append(e["dur_s"])
    medians = {k: dict(n=len(v), median_s=statistics.median(v),
                       max_s=max(v)) for k, v in sorted(medians.items())}
    for k, v in medians.items():
        print(f"  span {k}: n={v['n']} median {v['median_s']:.6f} s, max "
              f"{v['max_s']:.6f} s")
    seconds = [r[1] for r in runs]
    print(f"telemetry: s/round without {seconds[0]}, with {seconds[1]}, "
          f"with {seconds[2]}, without {seconds[3]}; health sample s "
          f"{health_s} ({smi_line})")
    last_health = [e for e in runs[2][2] if e["type"] == "sketch_health"]
    return dict(rounds=rounds, clients_per_round=cpr, spans=medians,
                order=["without", "with", "with", "without"],
                seconds=seconds, health_seconds=health_s,
                launches=runs[1][3], losses=[r[0].losses for r in runs],
                health=[{k: h[k] for k in ("round", "recovery_rel_err",
                                           "heavy_hitter_overlap",
                                           "error_sketch_norm",
                                           "momentum_sketch_norm")}
                        for h in last_health])


SERVE_ARCHS = ("gpt2s-federated", "internlm2-1.8b", "qwen3-0.6b", "glm4-9b",
               "qwen2-moe-a2.7b", "xlstm-350m", "jamba-v0.1-52b",
               "whisper-small", "pixtral-12b")
# jamba's 32 layers take 96 GiB in bfloat16: 2 of its 4 units (48.5 GiB)
SERVE_CUTS = {"jamba-v0.1-52b": dict(n_layers=16)}
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 2, 64, 32
# A decode step attends over the bfloat16 cache, a prefill over float32 k
# and v: on the CPU the last decode step's logits and a fresh prefill's
# differed by at most 5.4e-3 of the largest logit (5 smoke archs x 3
# seeds, tests/test_torch_serve.py), so full width is held to 1e-2 of it.
SERVE_TOL = 1e-2
# A MoE's routing is discrete: a bfloat16 rounding of a cached key that
# moves a router's input can swap an expert.  On an H100 qwen2-moe's
# decode under no-drop capacity with the bfloat16 cache was off a fresh
# prefill by 0.639 of 4.386 (24 layers of top-4 of 60).  So the MoE check
# runs with a float32 cache, where decode and prefill differ by float32
# summation order only.
# bfloat16 jamba's decode and a fresh prefill differ by as much in the
# reference itself (0.14-0.25 of logits up to 3.4 at smoke size without
# its MoE layers, up to 1.66 with them, as bfloat16 noise flips a
# routing; 3 seeds on the CPU): its timed run's gap is measured, and the
# check runs in float32 on one unit (8 layers, 48.5 GiB) at full width
CHECK_CUTS = {"jamba-v0.1-52b": dict(n_layers=8, param_dtype="float32")}
RING_WINDOW, RING_PROMPT, RING_TOKENS = 32, 48, 24
XLSTM_PROMPT, XLSTM_TOKENS = 136, 16       # longer than the mLSTM's chunk
# (d, chunks, groups) of the FetchSGD runs' layouts; tests/test_torch_zoo.py
# pins each against the reference's layout
FETCH_LAYOUTS = {"qwen3-0.6b": (751_632_384, 55, 23),
                 "qwen2-moe-a2.7b": (5_186_750_464, 317, 24),
                 "xlstm-350m": (518_640_808, 70, 66),
                 "whisper-small": (278_482_944, 34, 32),
                 "pixtral-12b": (3_549_516_800, 221, 21)}
# qwen2-moe's weights and gradients of 24 layers take 107 GiB, pixtral's
# of 40 layers 91 GiB: FetchSGD trains 8 of each
FETCH_CUTS = {"qwen2-moe-a2.7b": dict(n_layers=8),
              "pixtral-12b": dict(n_layers=8)}
# a client of the frontend archs trains on its first 4 samples: each adds
# 1500 encoder positions (whisper) or 1024 patches (pixtral) to its 256
# tokens
FETCH_SAMPLES = 4


def profile_decode(torch, step, n: int = 2) -> dict:
    """Kernels and device busy time per decode step under torch.profiler
    over ``n`` steps, beside the steps' host time (ended by a sync)."""
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(kernels_per_token=sum(e.count for e in kernels) / n,
                device_busy_ms=busy_ms, wall_ms=wall * 1e3 / n,
                idle_share=1 - busy_ms / (wall * 1e3 / n),
                top=[dict(kernel=e.key[:80], count=e.count / n,
                          ms=e.self_device_time_total / 1e3 / n)
                     for e in top])


def fresh_check(torch, dev, arch, cfg, params, prompts, res,
                transformer, enforce: bool, extra: dict) -> dict:
    """The last decode step's logits of ``res`` against a fresh prefill of
    the same sequence (with the same frames or patches, ``extra``);
    checked when ``enforce``, else only measured."""
    seq = torch.cat([prompts.to(dev), res.tokens[:, :-1]], dim=1)
    prefix = extra["patches"].shape[1] if "patches" in extra else 0
    with torch.no_grad():
        fresh, _ = transformer.prefill(
            params, {"tokens": seq,
                     **{k: v.to(dev) for k, v in extra.items()}}, cfg,
            transformer.init_cache(cfg, SERVE_BATCH, prefix + seq.shape[1],
                                   device=dev))
    scale = float(fresh.abs().max())
    gap = float((res.logits - fresh).abs().max())
    top2 = fresh.topk(2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    out = dict(gap=gap, logit_scale=scale, top2_margin=margin,
               param_dtype=cfg.param_dtype, n_layers=cfg.n_layers,
               kv_cache_dtype=str(res.cache["attn"]["k"].dtype)
               if "attn" in res.cache else None,
               capacity_factor=cfg.capacity_factor if cfg.n_experts
               else None)
    if not enforce:
        print(f"{arch}: the last decode step vs a fresh prefill {gap:.3e} of "
              f"{scale:.3f} ({cfg.param_dtype}"
              + (f", capacity factor {cfg.capacity_factor:g}"
                 if cfg.n_experts else "") + "; measured, not checked)")
        return out
    check(gap <= SERVE_TOL * scale,
          f"{arch}: the last decode step's logits = a fresh prefill of the "
          f"{seq.shape[1]} tokens within {SERVE_TOL:g} of the largest logit "
          f"({gap:.3e} of {scale:.3f}; top-2 margin {margin:.3e}"
          + (f"; capacity factor {cfg.capacity_factor:g}, no drops, "
             f"{res.cache['attn']['k'].dtype} cache" if cfg.n_experts
             else "")
          + (f"; {cfg.n_layers} layers, {cfg.param_dtype}"
             if arch in CHECK_CUTS else "") + ")")
    check(torch.equal(res.logits.argmax(-1), fresh.argmax(-1)),
          f"{arch}: the same argmax as the fresh prefill")
    return out


def tree_bytes(tree) -> int:
    from repro_torch.core import layout as layout_lib
    return sum(t.numel() * t.element_size()
               for _, t in layout_lib.flatten(tree))


def prefill_only_bytes(params) -> int:
    """Bytes of the weights a decode step does not read: the encoder and
    the frontend's projection (prefill turns frames or patches into the
    cache) and the cross-attention's wk and wv (decode reads the cached
    keys and values)."""
    from repro_torch.core import layout as layout_lib
    return sum(t.numel() * t.element_size()
               for path, t in layout_lib.flatten(params)
               if path.startswith("enc/") or path == "frontend_proj"
               or path.endswith(("xattn/wk", "xattn/wv")))


def fetch_run(torch, dev, arch, cfg, params, smi_line: str) -> dict:
    """2 rounds of FetchSGD on ``arch``: through ``run_simulation``, or,
    for a model with a frontend, whose batch the orchestrator does not
    build, through ``train_lm.train``'s round."""
    run = fetchsgd_run if cfg.frontend == "none" else frontend_fetchsgd_run
    return run(torch, dev, arch, cfg, params, smi_line)


def serve_phase(torch, dev, smi_line: str) -> dict:
    """Serving at full width through ``launch/serve_lm.serve`` from
    torch-initialised random weights: batch 2, a prompt of 64 and 32
    greedy tokens for each of ``SERVE_ARCHS`` (jamba cut to 16 of its 32
    layers; whisper's requests carry 1500 frames and pixtral's 1024
    patches, standard normal from the prompts' generator), each checked
    against a fresh prefill of the same sequence (a
    MoE arch, whose prefill drops tokens past an expert's capacity, on a
    second run under no-drop capacity); the ring buffer at full width
    (qwen3-0.6b, window 32, a prompt of 48, 24 teacher-forced tokens, each
    step against a big cache with the same window); xlstm-350m's state
    after a prompt of 136 against a fresh prefill; and 2 rounds of
    FetchSGD (2 clients, flat, 5 x 2**20, k = 25,000) through
    ``run_simulation`` on qwen3-0.6b, qwen2-moe-a2.7b (8 of 24 layers) and
    xlstm-350m, and through ``train_lm.train``'s round on whisper-small
    and pixtral-12b (8 of 40 layers), counting every kernel's
    launches."""
    import dataclasses
    import gc

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh, serve_lm
    from repro_torch.models import moe, transformer

    print(f"serve on {smi_line}")
    runs, ring, xl, fetch = [], None, None, {}
    gen = torch.Generator().manual_seed(1)

    def fresh_memory():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    for arch in SERVE_ARCHS:
        cut = SERVE_CUTS.get(arch, {})
        cfg = dataclasses.replace(configs.get_config(arch), **cut)
        fresh_memory()
        params = transformer.init_params(cfg, seed=0, device=dev)
        n_params = transformer.param_count(params)
        prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                                generator=gen)
        extra = serve_lm.frontend_inputs(cfg, SERVE_BATCH, gen)
        prefix = extra["patches"].shape[1] if "patches" in extra else 0
        serve_lm.serve(cfg, params, prompts, 2, dev, **extra)  # warm-up
        ops.reset_launch_counts()
        steps0 = dict(serve_lm.DECODE_STEPS)
        res = serve_lm.serve(cfg, params, prompts, SERVE_TOKENS, dev,
                             **extra)
        steps = {k: v - steps0[k] for k, v in serve_lm.DECODE_STEPS.items()}
        check(not any(ops.launch_counts().values()),
              f"{arch}: serving launches no sketch kernel")
        check(steps == {"graph": SERVE_TOKENS - 2, "eager": 1},
              f"{arch}: {SERVE_TOKENS - 2} of the {SERVE_TOKENS - 1} decode "
              f"steps replayed from a CUDA graph ({steps})")
        check(bool(torch.isfinite(res.logits).all())
              and res.tokens.shape == (SERVE_BATCH, SERVE_TOKENS),
              f"{arch}: {SERVE_TOKENS} tokens a sequence, finite logits")
        # a MoE prefill drops tokens past an expert's capacity and a decode
        # of two tokens never does: the timed run keeps the published
        # capacity, the check runs again under no-drop capacity
        nodrop = moe.no_drop(cfg)
        enforce = arch not in CHECK_CUTS
        published = fresh_check(torch, dev, arch, cfg, params, prompts, res,
                                transformer, enforce and nodrop is cfg,
                                extra)
        checked = published
        if nodrop is not cfg:
            res_nd = serve_lm.serve(nodrop, params, prompts, SERVE_TOKENS,
                                    dev, cache_dtype=torch.float32, **extra)
            checked = fresh_check(torch, dev, arch, nodrop, params, prompts,
                                  res_nd, transformer, enforce, extra)
            del res_nd
        cache = {k: v for k, v in res.cache.items() if k != "pos"}
        cache_bytes = tree_bytes(cache)
        # the least a decode step reads: every weight once but the
        # embedding's unused rows and the weights only a prefill reads
        # (the encoder, the frontend's projection, the cross-attention's
        # wk and wv), the attention slots that hold a token, the
        # cross-attention cache once, and each recurrent state read and
        # written once.  Under capacity dispatch every expert runs on its
        # slots, so every expert's weights count.
        param_bytes = tree_bytes(params)
        p_bytes = param_bytes - prefill_only_bytes(params)
        table = params["embed"]["table"]
        if "unembed" in params:
            p_bytes -= (table.shape[0] - SERVE_BATCH) * table.shape[1] \
                * table.element_size()
        kv_bytes = 0.0
        if "attn" in cache:
            k = cache["attn"]["k"]
            kv_slot = 2 * k[:, :, :, 0].numel() * k.element_size()
            kv_bytes = kv_slot * (prefix + SERVE_PROMPT + SERVE_TOKENS / 2)
        xattn_bytes = tree_bytes(cache["xattn"]) if "xattn" in cache else 0
        state_bytes = sum(tree_bytes(cache[kind])
                          for kind in ("mamba", "mlstm", "slstm")
                          if kind in cache)
        bound_ms = (p_bytes + kv_bytes + xattn_bytes + 2 * state_bytes) \
            / mesh.HBM_BW * 1e3
        tok = res.tokens[:, -1:]
        prof = profile_decode(torch, lambda: transformer.decode_step(
            params, tok, cfg, res.cache))
        run = dict(arch=arch, cut=cut or None, param_dtype=cfg.param_dtype,
                   params=n_params, param_bytes=param_bytes,
                   decode_weight_bytes=p_bytes, prefix=prefix,
                   frontend_inputs={k: list(v.shape)
                                    for k, v in extra.items()} or None,
                   cache_bytes=cache_bytes, state_bytes=state_bytes,
                   xattn_cache_bytes=xattn_bytes,
                   prefill_s=res.prefill_s,
                   decode_ms_per_token=res.decode_s * 1e3,
                   hbm_bound_ms_per_token=bound_ms, decode_steps=steps,
                   bound_reads_every_expert=bool(cfg.n_experts),
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                   gap=checked["gap"], logit_scale=checked["logit_scale"],
                   top2_margin=checked["top2_margin"], check=checked,
                   published_capacity=published if nodrop is not cfg
                   else None, profile=prof)
        print(f"{arch}{f' (cut: {cut})' if cut else ''}: {n_params:,} "
              f"params ({param_bytes:,} B {cfg.param_dtype}), cache "
              f"{cache_bytes:,} B, prefill {res.prefill_s:.6f} s, decode "
              f"{run['decode_ms_per_token']:.6f} ms/token (HBM bound "
              f"{bound_ms:.6f} ms"
              + (", every expert's weights: capacity dispatch runs each "
                 "expert on its slots" if cfg.n_experts else "")
              + f"; decode steps: {steps['graph']} graph, "
              f"{steps['eager']} eager"
              + f"), peak {run['peak_mem_gib']:.3f} GiB; profiled: "
              f"{prof['kernels_per_token']:.0f} kernels/token, device busy "
              f"{prof['device_busy_ms']:.6f} of {prof['wall_ms']:.6f} ms "
              f"({smi_line})")
        for k in prof["top"]:
            print(f"  {k['ms']:.6f} ms {k['count']:6.1f}x  {k['kernel']}")
        runs.append(run)
        del res, cache
        if arch == "qwen3-0.6b":
            ring = ring_check(torch, dev, cfg, params, transformer)
        if arch == "xlstm-350m":
            xl = xlstm_check(torch, dev, cfg, params, transformer)
        if arch in FETCH_LAYOUTS and arch not in FETCH_CUTS:
            fetch[arch] = fetch_run(torch, dev, arch, cfg, params, smi_line)
        del params, table
        if arch in CHECK_CUTS:
            fresh_memory()
            ccfg = moe.no_drop(dataclasses.replace(cfg, **CHECK_CUTS[arch]))
            cparams = transformer.init_params(ccfg, seed=0, device=dev)
            res = serve_lm.serve(ccfg, cparams, prompts, SERVE_TOKENS, dev,
                                 cache_dtype=torch.float32, **extra)
            run["check"] = fresh_check(torch, dev, arch, ccfg, cparams,
                                       prompts, res, transformer, True,
                                       extra)
            run["check_cut"] = CHECK_CUTS[arch]
            del res, cparams
        if arch in FETCH_CUTS:
            fresh_memory()
            fcfg = dataclasses.replace(cfg, **FETCH_CUTS[arch])
            fparams = transformer.init_params(fcfg, seed=0, device=dev)
            fetch[arch] = fetch_run(torch, dev, arch, fcfg, fparams,
                                    smi_line)
            fetch[arch]["cut"] = FETCH_CUTS[arch]
            del fparams
    return dict(runs=runs, ring=ring, xlstm_state=xl, fetchsgd=fetch)


def ring_check(torch, dev, cfg, params, transformer) -> dict:
    """qwen3-0.6b with a window of 32 and a prompt of 48 (longer than the
    window and not a multiple of it): each of 24 teacher-forced decode
    steps of the ring-buffer cache against a big cache with the window."""
    import dataclasses

    wcfg = dataclasses.replace(cfg, sliding_window=RING_WINDOW)
    n = RING_PROMPT + RING_TOKENS
    toks = torch.randint(0, cfg.vocab, (SERVE_BATCH, n),
                         generator=torch.Generator().manual_seed(4)).to(dev)
    ring = transformer.init_cache(wcfg, SERVE_BATCH, n, device=dev)
    big = transformer.init_cache(dataclasses.replace(wcfg, sliding_window=0),
                                 SERVE_BATCH, n, device=dev)
    check(ring["attn"]["k"].shape[3] == RING_WINDOW
          and big["attn"]["k"].shape[3] == n,
          f"ring capacity {RING_WINDOW}, big cache {n}")
    worst = 0.0
    with torch.no_grad():
        first = {"tokens": toks[:, :RING_PROMPT]}
        lr, ring = transformer.prefill(params, first, wcfg, ring)
        lb, big = transformer.prefill(params, first, wcfg, big)
        for t in range(RING_PROMPT, n):
            lr, ring = transformer.decode_step(params, toks[:, t:t + 1], wcfg,
                                               ring)
            lb, big = transformer.decode_step(params, toks[:, t:t + 1], wcfg,
                                              big)
            worst = max(worst, float((lr - lb).abs().max()
                                     / lb.abs().max()))
            check(torch.allclose(lr, lb, rtol=1e-3,
                                 atol=1e-3 * float(lb.abs().max())),
                  f"ring pos {t}: ring = big cache (rtol 1e-3, atol 1e-3 of "
                  f"the largest logit)")
    return dict(window=RING_WINDOW, prompt=RING_PROMPT, tokens=RING_TOKENS,
                max_gap_rel=worst)


def xlstm_check(torch, dev, cfg, params, transformer) -> dict:
    """xlstm-350m with a prompt of 136 (longer than the mLSTM's chunk of
    128 and not a multiple of it), then 16 teacher-forced decode steps:
    the last step's logits against a fresh prefill of the 152 tokens.  A
    padded forget gate of 0 would wipe the state the prompt leaves."""
    n = XLSTM_PROMPT + XLSTM_TOKENS
    toks = torch.randint(0, cfg.vocab, (SERVE_BATCH, n),
                         generator=torch.Generator().manual_seed(5)).to(dev)
    with torch.no_grad():
        cache = transformer.init_cache(cfg, SERVE_BATCH, n, device=dev)
        _, cache = transformer.prefill(
            params, {"tokens": toks[:, :XLSTM_PROMPT]}, cfg, cache)
        state_max = float(cache["mlstm"]["C"].abs().max())
        for t in range(XLSTM_PROMPT, n):
            got, cache = transformer.decode_step(params, toks[:, t:t + 1],
                                                 cfg, cache)
        fresh, _ = transformer.prefill(
            params, {"tokens": toks}, cfg,
            transformer.init_cache(cfg, SERVE_BATCH, n, device=dev))
    scale = float(fresh.abs().max())
    gap = float((got - fresh).abs().max())
    check(state_max > 0, f"xlstm-350m: the mLSTM state after a prompt of "
          f"{XLSTM_PROMPT} is not wiped (max |C| {state_max:.3e})")
    check(gap <= SERVE_TOL * scale,
          f"xlstm-350m: prompt {XLSTM_PROMPT} + {XLSTM_TOKENS} decode steps "
          f"= a fresh prefill of {n} within {SERVE_TOL:g} of the largest "
          f"logit ({gap:.3e} of {scale:.3f})")
    return dict(prompt=XLSTM_PROMPT, tokens=XLSTM_TOKENS, gap=gap,
                logit_scale=scale, mlstm_state_max=state_max)


def fetchsgd_run(torch, dev, arch, cfg, params, smi_line: str) -> dict:
    """2 rounds of FetchSGD on ``arch`` at full width through
    ``run_simulation``: 2 clients a round, flat, PersonaLM at seq 256, the
    main path's sketch; every kernel's launches counted.  The loss the
    clients report is ``loss_fn``'s, cross entropy plus the MoE aux term
    (checked on the dataset's smallest client)."""
    from repro_torch.core import fetchsgd as F
    from repro_torch.core import layout as layout_lib
    from repro_torch.data import federated, synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import simulate
    from repro_torch.models import transformer

    d, n_chunks, n_groups = FETCH_LAYOUTS[arch]
    lay = layout_lib.build_layout(params)
    check((lay.total, lay.num_chunks, len(lay.groups))
          == (d, n_chunks, n_groups),
          f"{arch}: d = {d:,} in {n_chunks} chunks / {n_groups} groups")
    rounds, cpr = 2, 2
    dataset = synthetic.PersonaLM(vocab=cfg.vocab, seq_len=256, n_clients=24)
    small = min(range(dataset.n_clients), key=dataset.client_size)
    batch = federated.to_batch(dataset.client_batch(small), dev)
    with torch.no_grad():
        total, metrics = transformer.loss_fn(params, batch, cfg)
    reported, _ = transformer.value_and_grad(params, batch, cfg)
    aux = float(metrics["aux"])
    check(float(total) == float(metrics["xent"] + metrics["aux"])
          and (aux > 0) == bool(cfg.n_experts)
          and math.isclose(float(reported), float(total), rel_tol=1e-6),
          f"{arch}: a client's loss = cross entropy "
          f"{float(metrics['xent']):.6f} + aux {aux:.6f}, as value_and_grad "
          f"reports it")
    seconds: list[float] = []
    clock = [0.0]

    def progress(r, loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds.append(now - clock[0])
        clock[0] = now

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    clock[0] = time.perf_counter()
    res = simulate.run_simulation(
        cfg, method="fetchsgd", rounds=rounds, clients_per_round=cpr,
        fs_cfg=F.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, momentum=0.9),
        dataset=dataset, aggregate="flat", params=params, device=dev,
        progress=progress)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{arch} fetchsgd: losses {res.losses}; s/round {seconds}; peak "
          f"{peak:.3f} GiB; launches {counts} ({smi_line})")
    check(counts == {"encode": n_chunks * cpr * rounds,
                     "estimate": n_chunks * rounds,
                     "momentum_error": rounds, "topk_mask": rounds},
          f"{arch}: {n_chunks} encodes a client, {n_chunks} estimates, 1 "
          f"momentum_error and 1 topk_mask a round")
    check(all(math.isfinite(x) for x in res.losses),
          f"{arch}: every loss finite")
    up = ROWS * COLS * 4
    recs = res.extras["fed_records"]
    check(all(r.upload_bytes == up * r.n_fresh and r.n_fresh == cpr
              for r in recs),
          f"{arch}: {up:,} B ({up / 1e6:.2f} MB) up a client a round")
    return dict(rounds=rounds, clients_per_round=cpr, d=lay.total,
                chunks=lay.num_chunks, groups=len(lay.groups),
                losses=res.losses, seconds=seconds, peak_mem_gib=peak,
                launches=counts, upload_bytes_per_client=up,
                aux_check=dict(client=small, xent=float(metrics["xent"]),
                               aux=aux),
                traffic=res.traffic)


def frontend_fetchsgd_run(torch, dev, arch, cfg, params,
                          smi_line: str) -> dict:
    """2 rounds of FetchSGD on a model with a frontend at full width, in
    the round of ``launch/train_lm.train`` (``value_and_grad`` ->
    ``sketch_grads`` -> the mean -> ``server_step`` -> ``apply_delta``):
    2 clients a round, PersonaLM at seq 256, each client's first
    ``FETCH_SAMPLES`` samples with frames or patches drawn standard normal
    from a seeded generator, the main path's sketch; every kernel's
    launches counted."""
    from repro_torch.core import compression, fetchsgd as F
    from repro_torch.core import layout as layout_lib
    from repro_torch.data import federated, synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_lm
    from repro_torch.models import transformer
    from repro_torch.optim import linear_decay

    d, n_chunks, n_groups = FETCH_LAYOUTS[arch]
    lay = layout_lib.build_layout(params)
    check((lay.total, lay.num_chunks, len(lay.groups))
          == (d, n_chunks, n_groups),
          f"{arch}: d = {d:,} in {n_chunks} chunks / {n_groups} groups")
    rounds, cpr = 2, 2
    fs_cfg = F.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, momentum=0.9)
    dataset = synthetic.PersonaLM(vocab=cfg.vocab, seq_len=256, n_clients=24)
    gen = torch.Generator().manual_seed(6)
    lr_fn = linear_decay(0.16, rounds)
    opt = F.init_state(fs_cfg, dev)
    meter = compression.TrafficMeter(d=lay.total)
    losses, seconds, samples, table_bytes = [], [], [], set()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for r in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables, round_losses = [], []
        for c in federated.sample_clients(dataset.n_clients, cpr, r):
            batch = federated.to_batch(dataset.client_batch(int(c)), dev)
            batch = {k: v[:FETCH_SAMPLES] for k, v in batch.items()}
            n = batch["tokens"].shape[0]
            batch.update({k: v.to(dev) for k, v in
                          serve_lm.frontend_inputs(cfg, n, gen).items()})
            loss, g = transformer.value_and_grad(params, batch, cfg,
                                                 remat=False)
            tables.append(F.sketch_grads(g, lay, fs_cfg))
            del g
            round_losses.append(float(loss))
            samples.append(n)
        table_bytes |= {t.numel() * t.element_size() for t in tables}
        agg = sum(tables) / len(tables)
        delta, opt = F.server_step(
            agg, opt, torch.full((), lr_fn(r), dtype=torch.float32,
                                 device=dev), lay, fs_cfg)
        F.apply_delta(params, lay, delta)
        meter.record(compression.fetchsgd_round(
            ROWS, COLS, K, d=lay.total, staleness=max(r, 1)), cpr)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(round_losses)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{arch} fetchsgd: losses {losses}; samples a client {samples}; "
          f"s/round {seconds}; peak {peak:.3f} GiB; launches {counts} "
          f"({smi_line})")
    check(counts == {"encode": n_chunks * cpr * rounds,
                     "estimate": n_chunks * rounds,
                     "momentum_error": rounds, "topk_mask": rounds},
          f"{arch}: {n_chunks} encodes a client, {n_chunks} estimates, 1 "
          f"momentum_error and 1 topk_mask a round")
    check(all(math.isfinite(x) for rl in losses for x in rl),
          f"{arch}: every loss finite")
    up = ROWS * COLS * 4
    check(table_bytes == {up} and F.upload_bytes(fs_cfg) == up
          and meter.upload_total == up * cpr * rounds,
          f"{arch}: {up:,} B ({up / 1e6:.2f} MB) up a client a round")
    return dict(rounds=rounds, clients_per_round=cpr, d=lay.total,
                chunks=lay.num_chunks, groups=len(lay.groups),
                samples_per_client=samples, losses=losses, seconds=seconds,
                peak_mem_gib=peak, launches=counts,
                upload_bytes_per_client=up,
                traffic=meter.compression(cpr))


# -- the mesh phase --------------------------------------------------------------

MESH_ARCH = "qwen3-0.6b"                 # the mesh CLI's default arch
MESH_POLICIES = (("flat", []), ("tree", []), ("dense", []),
                 # round 1 draws 0.38 < 0.5 (seed 1234): it straggles and
                 # lands in round 2's merge
                 ("async", ["--straggle-prob", "0.5"]),
                 ("model_local", ["--sketch-mode", "model_local"]))
MESH_ARGV = ["--rounds", "3", "--cols", str(COLS), "--k", str(K)]
MESH_LR = 0.1
MESH_WEIGHTS = (0.5, 2.5)
# Delta of two runs that add the same terms in another order (the encode's
# float atomics, a gloo sum, a mean of sketches for a sketch of a mean):
# an id may trade places only with one whose |value| ties the k-th within
# this, and the common values agree to it
DELTA_RTOL = 1e-4
# Delta of a tensor-parallel step against the whole model's, both with a
# float32 residual: another order of summation, which a sketch bucket whose
# terms cancel amplifies (ROADMAP.md §3's rule between the packages)
TP_DELTA_RTOL = 1e-2
# With the bfloat16 residual that order flips roundings of the residual
# (2**-8 relative) over 28 layers, and Delta's ids near the k-th move: at
# most this share of Delta traded, a side
TP_BF16_TRADED = 0.1


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tree_clone(torch, tree):
    from repro_torch.core import layout as layout_lib
    return layout_lib.tree_map(lambda t: t.clone(), tree)


def delta_gap(torch, after_a, after_b, before, rtol: float = DELTA_RTOL
              ) -> dict:
    """Compare two parameter updates from the same weights: the changed
    ids as sets and the common values.  Returns the numbers the checks
    read: sizes, the ids in one set only and whether each ties the k-th
    |value| within ``rtol``, the largest relative gap of a common
    value."""
    from repro_torch.core import layout as layout_lib
    da, db = {}, {}
    for (p, a), (_, b), (_, w) in zip(layout_lib.flatten(after_a),
                                      layout_lib.flatten(after_b),
                                      layout_lib.flatten(before)):
        for d, out in ((a - w, da), (b - w, db)):
            flat = d.reshape(-1).float()
            idx = torch.nonzero(flat).flatten()
            out[p] = (idx.cpu(), flat[idx].cpu())
    ids_a = {(p, int(i)) for p, (idx, _) in da.items() for i in idx}
    ids_b = {(p, int(i)) for p, (idx, _) in db.items() for i in idx}
    val_a = {(p, int(i)): float(v) for p, (idx, vs) in da.items()
             for i, v in zip(idx, vs)}
    val_b = {(p, int(i)): float(v) for p, (idx, vs) in db.items()
             for i, v in zip(idx, vs)}
    kth = min(abs(v) for v in val_b.values()) if val_b else 0.0
    only = [val_a[i] for i in ids_a - ids_b] + [val_b[i] for i in
                                                 ids_b - ids_a]
    common = ids_a & ids_b
    gap = max((abs(val_a[i] - val_b[i]) / abs(val_b[i]) for i in common),
              default=0.0)
    return dict(n_a=len(ids_a), n_b=len(ids_b), only=len(only),
                only_tied=all(abs(abs(v) - kth) <= rtol * kth
                              for v in only), max_rel_gap=gap, rtol=rtol)


def check_delta(gap: dict, what: str) -> None:
    rtol = gap.get("rtol", DELTA_RTOL)
    check(gap["n_a"] == gap["n_b"] == K and gap["only_tied"]
          and gap["max_rel_gap"] <= rtol,
          f"{what}: Delta has {K} ids on both sides, {gap['only']} traded "
          f"only at ties of the k-th, values within "
          f"{gap['max_rel_gap']:.2e} (rtol {rtol})")


def mesh_batch(torch, dev, cfg, seq: int = 64, batch: int = 8) -> dict:
    """The mesh CLI's round-0 batch (``ClassShardLM`` client 0)."""
    from repro_torch.data import synthetic
    ds = synthetic.ClassShardLM(vocab=cfg.vocab, seq_len=seq, n_clients=256,
                                samples_per_client=batch)
    cb = ds.client_batch(0)
    return {k: torch.as_tensor(cb[k][:batch], dtype=torch.int64, device=dev)
            for k in ("tokens", "labels")}


def mesh_world_of_1(torch, dev, smi_line: str) -> dict:
    """A world of 1 (nccl) at full width: the CLI once a policy, with
    kernel launches counted a run, and round 0 of ``flat`` (and ``dense``)
    held against the single-device ``F.step``."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core import fetchsgd as F
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib, shapes, steps, train
    from repro_torch.models import transformer

    mesh_lib.init_from_env(dev.type)
    check(dist.get_world_size() == 1 and dist.get_backend() == "nccl",
          "the world of 1 on the card uses nccl")
    d, n_chunks, _ = FETCH_LAYOUTS[MESH_ARCH]
    runs = {}
    for name, extra in MESH_POLICIES:
        agg = "flat" if name == "model_local" else name
        argv = MESH_ARGV + ["--aggregate", agg] + extra
        sync(torch, dev)
        ops.reset_launch_counts()
        res = train.main(argv + ["--device", dev.type],
                         log=lambda line: print("  " + line))
        counts = ops.launch_counts()
        updates = sum("[straggled]" not in r.tag for r in res)
        check(counts == {"encode": len(res) * n_chunks,
                         "estimate": updates * n_chunks,
                         "momentum_error": updates, "topk_mask": updates},
              f"mesh {name}: {n_chunks} encodes a round, {n_chunks} "
              f"estimates, 1 momentum_error and 1 topk_mask an update "
              f"({updates} of {len(res)} rounds), as the single-device step")
        check(all(math.isfinite(r.loss) for r in res),
              f"mesh {name}: every loss finite")
        runs[name] = dict(argv=argv, losses=[r.loss for r in res],
                          seconds=[r.seconds for r in res],
                          tags=[r.tag for r in res], launches=counts)
        print(f"mesh {name}: s/round {runs[name]['seconds']} ({smi_line})")
    check("[straggled]" in runs["async"]["tags"][1]
          and "late merged: 1" in runs["async"]["tags"][2],
          "mesh async: round 1 straggled and merged late in round 2")
    check(runs["dense"]["losses"][0] == runs["flat"]["losses"][0],
          "mesh dense: round 0's loss = flat's")

    # round 0 of flat and dense against the single-device step, lr 0.1
    cfg = configs.get_config(MESH_ARCH)
    mesh = mesh_lib.make_debug_mesh(1, 1, dev.type)
    fs = F.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, momentum=0.9)
    shape = shapes.ShapeSpec("train", "train", 64, 8)
    init = transformer.init_params(cfg, seed=0, device=dev)
    batch = mesh_batch(torch, dev, cfg)
    lr = torch.full((), MESH_LR, device=dev)
    single = tree_clone(torch, init)
    loss1, grads = transformer.value_and_grad(single, batch, cfg)
    lay = steps.build_layout(cfg, mesh)
    check(lay.total == d and lay.num_chunks == n_chunks,
          f"the mesh layout of {MESH_ARCH} has d = {d:,} in {n_chunks} chunks")
    table1 = F.sketch_grads(grads, lay, fs)
    del grads
    delta, _ = F.server_step(table1, F.init_state(fs, dev), lr, lay, fs)
    F.apply_delta(single, lay, delta)
    out = dict(runs=runs)
    for name in ("flat", "dense"):
        mine = tree_clone(torch, init)
        bundle = steps.make_train_step(cfg, shape, mesh, fs, aggregate=name)
        mine, _, m = bundle.fn(mine, F.init_state(fs, dev), batch, lr)
        err = max_abs_err(torch, m["table"], table1)
        scale = float(table1.abs().max())
        check(math.isclose(float(m["loss"]), float(loss1), rel_tol=1e-5),
              f"mesh {name} round 0: loss {float(m['loss']):.6f} = the "
              f"single-device step's {float(loss1):.6f} (rtol 1e-5)")
        check(err <= 1e-5 * scale,
              f"mesh {name} round 0: table within {err:.3e} of the "
              f"single-device step's (largest {scale:.3e}; float atomics)")
        gap = delta_gap(torch, mine, single, init)
        check_delta(gap, f"mesh {name} round 0 vs the single-device step")
        out[name + "_vs_single"] = dict(table_err=err, table_max=scale, **gap)
        del mine
    del single, init
    dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def mesh_rank(rank: int, dev_type: str) -> dict:
    """One rank of the 2-rank world on one card (gloo over CUDA tensors):
    the probes, mesh 2x1 (flat, tree and weighted against the
    single-device step on the mean, or the weighted mean, of the batch's
    halves' gradients) and mesh 1x2 (model_local against gathered), with
    seconds per round and of one table's all_reduce."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core import fetchsgd as F
    from repro_torch.core import layout as layout_lib
    from repro_torch.kernels import ops
    from repro_torch.launch import analysis, mesh as mesh_lib, shapes, steps
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dev_type == "cuda" else torch.device(dev_type)
    out = dict(backend=dist.get_backend())
    probe = torch.full((4,), rank + 1.0, device=dev)
    dist.all_reduce(probe)
    sync(torch, dev)
    out["all_reduce_cuda"] = probe.tolist()
    try:
        a2a = torch.full((2, 3), float(rank), device=dev)
        got = torch.empty_like(a2a)
        dist.all_to_all_single(got, a2a)
        sync(torch, dev)
        out["all_to_all_cuda"] = got.tolist()
    except (RuntimeError, ValueError) as e:      # recorded, not hidden
        out["all_to_all_cuda"] = f"{type(e).__name__}: {e}"

    cfg = configs.get_config(MESH_ARCH)
    fs = F.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, momentum=0.9)
    shape = shapes.ShapeSpec("train", "train", 64, 8)
    init = transformer.init_params(cfg, seed=0, device=dev)
    batch = mesh_batch(torch, dev, cfg)
    lr = torch.full((), MESH_LR, device=dev)

    def timed(fn):
        sync(torch, dev)
        t0 = time.perf_counter()
        res = fn()
        sync(torch, dev)
        return res, time.perf_counter() - t0

    # the single-device references: each half's gradient, in this process
    halves = []
    for i in range(2):
        half = {k: v[4 * i:4 * i + 4] for k, v in batch.items()}
        halves.append(transformer.value_and_grad(init, half, cfg))

    def reference(weights, lay):
        w0, w1 = weights
        g = layout_lib.tree_map(lambda a, b: (w0 * a + w1 * b) / (w0 + w1),
                                halves[0][1], halves[1][1])
        p = tree_clone(torch, init)
        F.step(p, g, F.init_state(fs, dev), lr, lay, fs)
        return p

    mesh = mesh_lib.make_debug_mesh(2, 1, dev_type)
    table = torch.randn(ROWS, COLS, device=dev)
    mesh.all_sum(table.clone(), ("data",))
    reps = []
    for _ in range(5):
        _, s = timed(lambda: mesh.all_sum(table, ("data",)))
        reps.append(s)
    out["all_reduce_table_s"] = reps
    out["runs"] = {}
    lay = steps.build_layout(cfg, mesh)
    ref = {(1.0, 1.0): reference((1.0, 1.0), lay),
           MESH_WEIGHTS: reference(MESH_WEIGHTS, lay)}
    out["loss_halves"] = [float(h[0]) for h in halves]
    del halves
    firsts = {}
    for name, agg, weighted in (("flat", "flat", False),
                                ("tree", "tree", False),
                                ("weighted-flat", "flat", True),
                                ("weighted-tree", "tree", True)):
        bundle = steps.make_train_step(cfg, shape, mesh, fs, aggregate=agg,
                                       weighted=weighted)
        extra = (MESH_WEIGHTS,) if weighted else ()
        params, opt = tree_clone(torch, init), F.init_state(fs, dev)
        ops.reset_launch_counts()
        seconds, losses = [], []
        # each round's collectives, for the dry-run phase's formula
        with analysis.CollectiveRecorder() as rec:
            for r in range(3):
                (params, opt, m), s = timed(lambda: bundle.fn(
                    params, opt, batch, lr, *extra))
                seconds.append(s)
                losses.append(float(m["loss"]))
                if r == 0:
                    gap = delta_gap(torch, params, ref[
                        MESH_WEIGHTS if weighted else (1.0, 1.0)], init)
                    if weighted:
                        firsts[name] = tree_clone(torch, params)
        out["runs"][name] = dict(
            seconds=seconds, losses=losses, launches=ops.launch_counts(),
            expected=dict(encode=3 * len(bundle.layout.local_chunks),
                          estimate=3 * bundle.layout.num_chunks,
                          momentum_error=3, topk_mask=3),
            vs_single=gap, collectives=rec.bytes(), rounds=3)
        del params, opt
    out["weighted_flat_vs_tree"] = max(
        float((a - b).abs().max()) for (_, a), (_, b) in zip(
            layout_lib.flatten(firsts["weighted-flat"]),
            layout_lib.flatten(firsts["weighted-tree"])))
    del firsts, ref

    out["tp"] = tp_run(torch, dev, dev_type, cfg, fs, shape, init, batch,
                       lr, timed)
    del init
    if isinstance(out["all_to_all_cuda"], list):
        out["moe_ep"] = moe_ep_check(torch, mesh, dev)
    # the mLSTM's Megatron forward and backward on the mesh step, with a
    # float32 residual throughout (xlstm's bfloat16 roundings flip apart)
    xcfg = configs.get_config(XLSTM_TRAIN)
    init = transformer.init_params(xcfg, seed=0, device=dev)
    out["xlstm_tp"] = tp_run(torch, dev, dev_type, xcfg, fs, shape, init,
                             mesh_batch(torch, dev, xcfg), lr, timed,
                             modes=("gathered",), residual=torch.float32)
    del init
    out["serve_tp"] = serve_tp_run(torch, dev, dev_type)
    return out


TP_ROUNDS = 3


def tp_run(torch, dev, dev_type, cfg, fs, shape, init, batch, lr,
           timed, modes=("gathered", "model_local"),
           residual=None) -> dict:
    """Mesh 1 x 2 on this rank: the step tensor-parallel over the two
    ranks (each holds its ``param_spec`` shard, the forward and backward
    split over heads, FFN width and vocab, with ``remat``), in each sketch
    mode of ``modes``, ``TP_ROUNDS`` rounds each, with the residual
    ``residual`` (the train path's bfloat16 if None).  Records round 0
    against the world-of-1 ``F.step`` (the whole model's gradient on the
    same batch, in the 1 x 2 layout), the rank's resident parameter bytes
    against the ``param_spec`` shard sum, its peak memory of round 1 over
    what it held before the step, the recorded collectives and
    s/round."""
    from repro_torch.core import fetchsgd as F
    from repro_torch.core import layout as layout_lib
    from repro_torch.kernels import ops
    from repro_torch.launch import analysis, mesh as mesh_lib, steps
    from repro_torch.models import sharding, transformer

    mesh12 = mesh_lib.make_debug_mesh(1, 2, dev_type)
    lay12 = steps.build_layout(cfg, mesh12)
    s_m = mesh12.index("model")

    def world_of_1():
        """Round 0 of the world-of-1 step on the same batch, in the 1 x 2
        layout's ids."""
        single = tree_clone(torch, init)
        _, grads = transformer.value_and_grad(single, batch, cfg)
        F.step(single, grads, F.init_state(fs, dev), lr, lay12, fs)
        return single

    # with a float32 residual the two differ only by the order of
    # summation: Delta's ids are the same
    transformer.RESIDUAL_DTYPE = torch.float32
    try:
        single = world_of_1()
        bundle = steps.make_train_step(cfg, shape, mesh12, fs)
        params = tree_clone(torch, steps.local_params(init, cfg, mesh12))
        params, _, _ = bundle.fn(params, F.init_state(fs, dev), batch, lr)
        f32_gap = delta_gap(torch, steps.gather_params(params, cfg, mesh12),
                            single, init, rtol=TP_DELTA_RTOL)
    finally:
        transformer.RESIDUAL_DTYPE = torch.bfloat16
    del single, params, bundle
    if residual is not None:
        transformer.RESIDUAL_DTYPE = residual
    single = world_of_1()
    structs = steps.param_structs(cfg)
    spec_bytes = 0
    for path, t in layout_lib.flatten(structs):
        n = t.numel() * t.element_size()
        if "model" in sharding.param_spec(path, tuple(t.shape), cfg,
                                          mesh12):
            n //= 2
        spec_bytes += n
    out = dict(perms=sum(p is not None for p in lay12.leaf_perms),
               spec_bytes=spec_bytes, runs={}, f32_vs_single=f32_gap)
    after, gaps = {}, {}
    for name in modes:
        bundle = steps.make_train_step(cfg, shape, mesh12, fs,
                                       sketch_mode=name)
        sync(torch, dev)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        # a copy: an unsplit leaf of local_params is init's own tensor
        params = tree_clone(torch, steps.local_params(init, cfg, mesh12))
        resident = sum(t.numel() * t.element_size()
                       for _, t in layout_lib.flatten(params))
        opt = F.init_state(fs, dev)
        ops.reset_launch_counts()
        seconds, losses, peak, calls = [], [], None, []
        for r in range(TP_ROUNDS):
            if r == 1:
                sync(torch, dev)
                torch.cuda.reset_peak_memory_stats(dev)
            with analysis.CollectiveRecorder() as rec:
                (params, opt, m), s = timed(lambda: bundle.fn(
                    params, opt, batch, lr))
            calls += rec.calls
            if r == 1:
                peak = torch.cuda.max_memory_allocated(dev) - base
            seconds.append(s)
            losses.append(float(m["loss"]))
            if r == 0:     # compared here, kept on the host (not in
                               # round 1's peak)
                whole = steps.gather_params(params, cfg, mesh12)
                gaps[name] = delta_gap(torch, whole, single, init,
                                       rtol=TP_DELTA_RTOL)
                after[name] = to_host(whole)
                del whole
        plan = bundle.plan
        encodes = len(bundle.layout.local_chunks) if name == "gathered" \
            else sum(c.n_cols == c.row_stride
                     and (c.mode != "replicated" or s_m == 0)
                     for c in plan.chunks)
        out["runs"][name] = dict(
            seconds=seconds, losses=losses, launches=ops.launch_counts(),
            expected=dict(encode=TP_ROUNDS * encodes,
                          estimate=TP_ROUNDS * bundle.layout.num_chunks,
                          momentum_error=TP_ROUNDS, topk_mask=TP_ROUNDS),
            strided_chunks=sum(c.n_cols < c.row_stride for c in plan.chunks),
            resident_bytes=resident, peak=peak, base=base,
            collectives=analysis._coll_dict(calls), rounds=TP_ROUNDS,
            vs_single=gaps[name])
        del params, opt, m
    transformer.RESIDUAL_DTYPE = torch.bfloat16
    if "model_local" in modes:
        out["model_local_vs_gathered"] = delta_gap(
            torch, after["model_local"], after["gathered"], to_host(init))
    del after, single
    return out


def to_host(tree):
    from repro_torch.core import layout as layout_lib
    return layout_lib.tree_map(lambda t: t.cpu(), tree)


def moe_ep_check(torch, mesh, dev) -> dict:
    """One MoE layer of qwen2-moe-a2.7b at full width (60 experts, 30 a
    rank; no-drop capacity): ``moe_apply_ep`` over the 2 data ranks
    against ``moe_apply`` of both ranks' tokens, with the seconds of
    each."""
    from repro_torch import configs
    from repro_torch.models import moe

    cfg = moe.no_drop(configs.get_config("qwen2-moe-a2.7b"))
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    gen = torch.Generator(device=dev).manual_seed(5)

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    p = {"router": normal(d, E, scale=d ** -0.5),
         "w_gate": normal(E, d, f, scale=d ** -0.5),
         "w_up": normal(E, d, f, scale=d ** -0.5),
         "w_down": normal(E, f, d, scale=f ** -0.5)}
    x = normal(4, 64, d, scale=1.0)
    n, r = mesh.shape["data"], mesh.index("data")
    e_loc, b = E // n, x.shape[0] // n
    local = {k: v[r * e_loc:(r + 1) * e_loc] if k != "router" else v
             for k, v in p.items()}
    sync(torch, dev)
    t0 = time.perf_counter()
    y, _ = moe.moe_apply_ep(local, x[r * b:(r + 1) * b], cfg,
                            mesh.group(("data",)))
    sync(torch, dev)
    t_ep = time.perf_counter() - t0
    t0 = time.perf_counter()
    want, _ = moe.moe_apply(p, x, cfg)
    sync(torch, dev)
    t_local = time.perf_counter() - t0
    want = want[r * b:(r + 1) * b]
    return dict(max_abs_err=float((y - want).abs().max()),
                max_abs=float(want.abs().max()), ep_s=t_ep, local_s=t_local)


# -- tensor-parallel serving over the two ranks -------------------------------------

# full width; jamba at 1 of its 4 units (8 of 32 layers) and in float32,
# so that the two ranks' shards (26.6 GB each) and the world of 1 (53.1 GB,
# alone before them) fit the card and the logits compare at float32
MESH_SERVE = {"qwen3-0.6b": {}, "xlstm-350m": {},
              "jamba-v0.1-52b": dict(n_layers=8, param_dtype="float32"),
              "whisper-small": {}}
MESH_SERVE_B, MESH_SERVE_PROMPT, MESH_SERVE_TOKENS = 2, 64, 32
MESH_SERVE_TOL = 1e-4                    # of the largest logit
XLSTM_TRAIN = "xlstm-350m"               # the mesh step's mLSTM round


def mesh_serve_cfg(arch: str):
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(arch), **MESH_SERVE[arch])


def mesh_serve_inputs(torch, dev, cfg) -> dict:
    """The requests: prompts of ``MESH_SERVE_PROMPT`` tokens and the stub
    frontend's frames, from a seeded CPU generator."""
    from repro_torch.launch import serve_lm
    gen = torch.Generator().manual_seed(7)
    prompts = torch.randint(0, cfg.vocab, (MESH_SERVE_B, MESH_SERVE_PROMPT),
                            generator=gen)
    out = {"tokens": prompts,
           **serve_lm.frontend_inputs(cfg, MESH_SERVE_B, gen)}
    return {k: v.to(dev) for k, v in out.items()}


def greedy(torch, dev, prefill, decode, inputs: dict, n: int) -> dict:
    """Prefill ``inputs`` and decode ``n`` greedy tokens: the logits of
    each step (on the host, float32), the tokens, the prefill's seconds
    and each decode step's."""
    sync(torch, dev)
    t0 = time.perf_counter()
    logits, _ = prefill(inputs)
    sync(torch, dev)
    prefill_s = time.perf_counter() - t0
    out, toks, secs = [logits.float().cpu()], [], []
    for _ in range(n):
        tok = logits.argmax(-1, keepdim=True)
        toks.append(tok.cpu())
        t0 = time.perf_counter()
        logits, _ = decode(tok)
        sync(torch, dev)
        secs.append(time.perf_counter() - t0)
        out.append(logits.float().cpu())
    return dict(logits=torch.stack(out).numpy(),
                tokens=torch.cat(toks, 1).numpy(), prefill_s=prefill_s,
                decode_s=secs)


def spec_bytes(tree: dict, spec_of, mesh: dict) -> int:
    """The bytes of ``tree``'s leaves, each over the mesh axes its spec
    names (``spec_of(path, shape)``): a rank's shard sum."""
    from repro_torch.core import layout as layout_lib
    total = 0
    for path, t in layout_lib.flatten(tree):
        n = t.numel() * t.element_size()
        for entry in spec_of(path, tuple(t.shape)):
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    n //= mesh[ax]
        total += n
    return total


def mesh_serve_world_of_1(torch, dev, smi_line: str) -> dict:
    """Each serve case as a world of 1 on the card (float32 cache):
    the greedy run the two ranks are held to, and its ms/token."""
    from repro_torch.models import transformer

    out = {}
    for arch in MESH_SERVE:
        cfg = mesh_serve_cfg(arch)
        params = transformer.init_params(cfg, seed=0, device=dev)
        cache = transformer.init_cache(
            cfg, MESH_SERVE_B, MESH_SERVE_PROMPT + MESH_SERVE_TOKENS,
            torch.float32, dev)
        with torch.no_grad():
            res = greedy(
                torch, dev,
                lambda b: transformer.prefill(params, b, cfg, cache),
                lambda t: transformer.decode_step(params, t, cfg, cache),
                mesh_serve_inputs(torch, dev, cfg), MESH_SERVE_TOKENS)
        ms = statistics.median(res["decode_s"]) * 1e3
        print(f"mesh serve world of 1 {arch}: prefill {res['prefill_s']:.4f}"
              f" s, decode {ms:.3f} ms/token ({smi_line})")
        out[arch] = res
        del params, cache
        torch.cuda.empty_cache()
    return out


def serve_tp_run(torch, dev, dev_type) -> dict:
    """Each serve case at mesh 1 x 2 on this rank: the rank draws its
    ``param_spec`` shard (the ranks in turn, one member of the whole tree
    alive at a time) and its ``cache_spec`` slice of a float32 cache, then
    prefills and decodes greedily through the serve steps,
    tensor-parallel over the two ranks.  Records the greedy run, the
    resident parameter and cache bytes beside the shard sums, the peak
    memory of the serve over what the rank held before it, and the
    recorded collectives."""
    import torch.distributed as dist
    from repro_torch.core import layout as layout_lib
    from repro_torch.launch import analysis, mesh as mesh_lib, shapes, steps
    from repro_torch.models import sharding, transformer

    mesh12 = mesh_lib.make_debug_mesh(1, 2, dev_type)
    m12 = {"data": 1, "model": 2}
    seq = MESH_SERVE_PROMPT + MESH_SERVE_TOKENS
    out = {}
    for arch in MESH_SERVE:
        cfg = mesh_serve_cfg(arch)
        sync(torch, dev)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        for turn in range(2):
            if turn == mesh12.index("model"):
                params = transformer.init_params(
                    cfg, seed=0, device=dev,
                    shard=steps.param_shard(cfg, mesh12))
                sync(torch, dev)
            dist.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        cache = transformer.init_cache(cfg, MESH_SERVE_B, seq, torch.float32,
                                       dev, model=2)
        pre_shape = shapes.ShapeSpec("p", "prefill", MESH_SERVE_PROMPT,
                                     MESH_SERVE_B)
        dec_shape = shapes.ShapeSpec("d", "decode", seq, MESH_SERVE_B)
        pre = steps.make_prefill_step(cfg, pre_shape, mesh12)
        dec = steps.make_decode_step(cfg, dec_shape, mesh12)
        with analysis.CollectiveRecorder() as rec:
            res = greedy(torch, dev, lambda b: pre.fn(params, b, cache),
                         lambda t: dec.fn(params, t, cache),
                         mesh_serve_inputs(torch, dev, cfg),
                         MESH_SERVE_TOKENS)
        peak = torch.cuda.max_memory_allocated(dev) - base
        glob = transformer.init_cache(cfg, MESH_SERVE_B, seq, torch.float32,
                                      device="meta")
        pre_b, dec_b = (analysis.step_collective_bytes(cfg, sh, m12, None,
                                                       None)
                        for sh in (pre_shape, dec_shape))
        formula = {k: pre_b.get(k, 0) + MESH_SERVE_TOKENS * dec_b.get(k, 0)
                   for k in set(pre_b) | set(dec_b)}
        out[arch] = dict(
            res, peak=peak,
            resident_bytes=sum(t.numel() * t.element_size()
                               for _, t in layout_lib.flatten(params)),
            cache_bytes=sum(t.numel() * t.element_size()
                            for _, t in layout_lib.flatten(cache)),
            spec_bytes=spec_bytes(
                steps.param_structs(cfg),
                lambda p, sh: sharding.param_spec(p, sh, cfg, m12), m12),
            cache_spec_bytes=spec_bytes(
                glob, lambda p, sh: sharding.cache_spec(p, sh, cfg, m12),
                m12),
            collectives=rec.bytes(), formula=formula)
        del params, cache, pre, dec
    torch.cuda.empty_cache()
    return out


def mesh_serve_checks(res: list[dict], one: dict, smi_line: str) -> dict:
    """The two ranks' tensor-parallel serves against the world of 1 and
    the dry-run: greedy tokens equal, the logits within
    ``MESH_SERVE_TOL`` of the largest, resident bytes equal to the shard
    sums, each rank's peak within ``DRYRUN_MEM_RTOL`` of the dry-run's
    prediction for that rank, the collectives equal to the formula."""
    import numpy as np
    from repro_torch.launch import dryrun, shapes

    seq = MESH_SERVE_PROMPT + MESH_SERVE_TOKENS
    out = {}
    for arch, want in one.items():
        scale = float(np.abs(want["logits"]).max())
        ms1 = statistics.median(want["decode_s"]) * 1e3
        for rank, r in enumerate(res):
            got = r["serve_tp"][arch]
            pred = max(dryrun.run_one(
                arch, kind, shape=shapes.ShapeSpec(kind, kind, n,
                                                   MESH_SERVE_B),
                debug_mesh=(1, 2), rank=rank, verbose=False,
                cfg_overrides=MESH_SERVE[arch] or None)[0].peak_mem_bytes
                for kind, n in (("prefill", MESH_SERVE_PROMPT),
                                ("decode", seq)))
            err = float(np.abs(got["logits"] - want["logits"]).max())
            ratio = got["peak"] / pred
            ms2 = statistics.median(got["decode_s"]) * 1e3
            g = 2 ** 30
            print(f"mesh serve 1x2 {arch} rank {rank}: params "
                  f"{got['resident_bytes']:,} B, cache {got['cache_bytes']:,}"
                  f" B, peak {got['peak'] / g:.4f} GiB (predicted "
                  f"{pred / g:.4f}, ratio {ratio:.4f}), prefill "
                  f"{got['prefill_s']:.4f} s, decode {ms2:.3f} ms/token "
                  f"(world of 1: {ms1:.3f}), logits within {err:.3e} of "
                  f"{scale:.3f}, collectives {got['collectives']} "
                  f"({smi_line})")
            check(np.array_equal(got["tokens"], want["tokens"]),
                  f"mesh serve 1x2 {arch} rank {rank}: the "
                  f"{MESH_SERVE_TOKENS} greedy tokens equal the world of 1's")
            check(err <= MESH_SERVE_TOL * scale,
                  f"mesh serve 1x2 {arch} rank {rank}: logits within "
                  f"{err:.3e} of the world of 1's (tol {MESH_SERVE_TOL:g} "
                  f"of the largest, {scale:.3f})")
            check(got["resident_bytes"] == got["spec_bytes"]
                  and got["cache_bytes"] == got["cache_spec_bytes"],
                  f"mesh serve 1x2 {arch} rank {rank}: resident parameters "
                  f"{got['resident_bytes']:,} B and cache "
                  f"{got['cache_bytes']:,} B = the param_spec / cache_spec "
                  f"shard sums")
            check(abs(ratio - 1) <= DRYRUN_MEM_RTOL,
                  f"mesh serve 1x2 {arch} rank {rank}: peak within "
                  f"{DRYRUN_MEM_RTOL:.0%} of the dry-run's prediction "
                  f"(ratio {ratio:.4f})")
            check(got["collectives"] == got["formula"],
                  f"mesh serve 1x2 {arch} rank {rank}: recorded collectives "
                  f"= step_collective_bytes of the prefill and "
                  f"{MESH_SERVE_TOKENS} decode steps {got['formula']}")
            out[f"{arch}/{rank}"] = dict(
                {k: v for k, v in got.items() if k not in ("logits",
                                                           "tokens")},
                predicted_peak=pred, ratio=ratio, max_abs_err=err,
                max_abs=scale, ms_per_token=ms2, world_of_1=dict(
                    ms_per_token=ms1, prefill_s=want["prefill_s"],
                    decode_s=want["decode_s"]))
    return out


def mesh_world_of_2(torch, dev, smi_line: str, serve_one: dict) -> dict:
    """Two ranks on the one card (gloo over CUDA tensors); ``serve_one``:
    the serve cases' world-of-1 runs."""
    from repro_torch.launch import mesh as mesh_lib

    res = mesh_lib.spawn(mesh_rank, 2, (dev.type,), device=dev.type,
                         timeout=600)
    r0 = res[0]
    check(all(r["backend"] == "gloo" for r in res),
          "two ranks on one card use gloo")
    check(all(r["all_reduce_cuda"] == [3.0] * 4 for r in res),
          "gloo all_reduce sums CUDA tensors")
    for name, run in r0["runs"].items():
        print(f"mesh 2-rank {name}: losses {run['losses']} s/round "
              f"{run['seconds']} launches {run['launches']} ({smi_line})")
        check(run["launches"] == run["expected"],
              f"mesh 2-rank {name}: rank 0 launched {run['expected']} (one "
              f"encode a contiguous local chunk, one estimate a chunk, one "
              f"momentum_error and topk_mask a round)")
    for name in ("flat", "tree", "weighted-flat", "weighted-tree"):
        check_delta(r0["runs"][name]["vs_single"],
                    f"mesh 2x1 {name} round 0 vs the single-device step on "
                    f"the {'weighted ' if 'weighted' in name else ''}mean "
                    f"of the halves' gradients")
    mean = sum(r0["loss_halves"]) / 2
    check(math.isclose(r0["runs"]["flat"]["losses"][0], mean, rel_tol=1e-6),
          f"mesh 2x1 flat round 0: loss = the halves' mean {mean:.6f}")
    err = r0["weighted_flat_vs_tree"]
    check(err <= 1e-5, f"mesh 2x1 weighted flat = weighted tree within "
          f"{err:.2e} (1e-5)")
    for rank, r in enumerate(res):
        tp = r["tp"]
        f32 = tp["f32_vs_single"]
        print(f"mesh 1x2 tensor-parallel rank {rank}, float32 residual, "
              f"round 0 vs the world of 1: {f32['only']} ids traded, the "
              f"common values within {f32['max_rel_gap']:.3e} ({smi_line})")
        check_delta(f32, f"mesh 1x2 tensor-parallel rank {rank} round 0 vs "
                    f"the world-of-1 F.step, both with a float32 residual")
        for name, run in tp["runs"].items():
            print(f"mesh 1x2 tensor-parallel {name} rank {rank}: losses "
                  f"{run['losses']} s/round {run['seconds']} launches "
                  f"{run['launches']} resident {run['resident_bytes']:,} B "
                  f"peak {run['peak']:,} B Delta vs the world of 1: "
                  f"{run['vs_single']['only']} ids traded, the common values "
                  f"within {run['vs_single']['max_rel_gap']:.3e} "
                  f"({smi_line})")
            check(run["launches"] == run["expected"],
                  f"mesh 1x2 {name} rank {rank}: launched {run['expected']}")
            check(all(math.isfinite(x) for x in run["losses"]),
                  f"mesh 1x2 {name} rank {rank}: every loss finite")
            check(run["resident_bytes"] == tp["spec_bytes"],
                  f"mesh 1x2 {name} rank {rank}: resident parameters "
                  f"{run['resident_bytes']:,} B = the param_spec shard sum "
                  f"{tp['spec_bytes']:,} B")
            # the bfloat16 residual's roundings flip apart: measured, and
            # held only to most of Delta being shared
            gap = run["vs_single"]
            check(gap["n_a"] == gap["n_b"] == K
                  and gap["only"] <= TP_BF16_TRADED * 2 * K,
                  f"mesh 1x2 tensor-parallel {name} rank {rank} round 0 vs "
                  f"the world-of-1 F.step (bfloat16 residual): {K} ids on "
                  f"both sides, {gap['only']} traded (at most "
                  f"{TP_BF16_TRADED:.0%} a side), the common values within "
                  f"{gap['max_rel_gap']:.2e}")
        check(tp["perms"] > 0 and tp["runs"]["model_local"][
            "strided_chunks"] > 0,
              f"mesh 1x2: {tp['perms']} permuted views and "
              f"{tp['runs']['model_local']['strided_chunks']} strided chunks")
        check_delta(tp["model_local_vs_gathered"],
                    "mesh 1x2 model_local vs gathered")
    for rank, r in enumerate(res):
        xt = r["xlstm_tp"]
        check_delta(xt["f32_vs_single"],
                    f"mesh 1x2 {XLSTM_TRAIN} rank {rank} round 0 vs the "
                    f"world-of-1 F.step, both with a float32 residual")
        run = xt["runs"]["gathered"]
        print(f"mesh 1x2 tensor-parallel {XLSTM_TRAIN} rank {rank}, float32 "
              f"residual: losses {run['losses']} s/round {run['seconds']} "
              f"launches {run['launches']} resident "
              f"{run['resident_bytes']:,} B peak {run['peak']:,} B "
              f"({smi_line})")
        check(run["launches"] == run["expected"],
              f"mesh 1x2 {XLSTM_TRAIN} rank {rank}: launched "
              f"{run['expected']}")
        check(all(math.isfinite(x) for x in run["losses"]),
              f"mesh 1x2 {XLSTM_TRAIN} rank {rank}: every loss finite")
        check(run["resident_bytes"] == xt["spec_bytes"],
              f"mesh 1x2 {XLSTM_TRAIN} rank {rank}: resident parameters "
              f"{run['resident_bytes']:,} B = the param_spec shard sum")
        check_delta(run["vs_single"],
                    f"mesh 1x2 {XLSTM_TRAIN} rank {rank} round 0 of the "
                    f"measured run vs the world-of-1 F.step (float32)")
    serve = mesh_serve_checks(res, serve_one, smi_line)
    ar = r0["all_reduce_table_s"]
    print(f"mesh 2-rank: all_reduce of one {ROWS * COLS * 4 / 1e6:.2f} MB "
          f"table {ar} s; all_to_all on CUDA tensors: "
          f"{r0['all_to_all_cuda']} ({smi_line})")
    if "moe_ep" in r0:
        for r in res:
            ep = r["moe_ep"]
            check(ep["max_abs_err"] <= 1e-4 * ep["max_abs"],
                  f"mesh 2x1 moe_apply_ep (qwen2-moe layer, 60 experts over "
                  f"2 ranks) = moe_apply within {ep['max_abs_err']:.2e} of "
                  f"{ep['max_abs']:.3f} (rtol 1e-4); {ep['ep_s']:.4f} s vs "
                  f"{ep['local_s']:.4f} s")
    else:
        print("mesh 2-rank: gloo's all_to_all takes no CUDA tensors here; "
              "the EP exchange on the card waits for two cards")
    return dict(all_reduce_table_s=ar, all_to_all_cuda=r0["all_to_all_cuda"],
                moe_ep=[r.get("moe_ep") for r in res], runs=r0["runs"],
                loss_halves=r0["loss_halves"], tp=[r["tp"] for r in res],
                xlstm_tp=[r["xlstm_tp"] for r in res], serve_tp=serve)


def mesh_phase(torch, dev, smi_line: str) -> dict:
    """The mesh train step at full width (qwen3-0.6b, seq 64, global batch
    8, the main path's 5 x 2**20 sketch, k = 25,000): a world of 1 through
    the CLI in every policy; the tensor-parallel serve cases as worlds of
    1; then two ranks sharing the card."""
    t0 = time.time()
    one = mesh_world_of_1(torch, dev, smi_line)
    serve_one = mesh_serve_world_of_1(torch, dev, smi_line)
    two = mesh_world_of_2(torch, dev, smi_line, serve_one)
    return dict(world_of_1=one, world_of_2=two, seconds=time.time() - t0)


# -- the dry-run phase -----------------------------------------------------------

DRYRUN_COMBOS = (
    ["--arch", "qwen3-0.6b", "--shape", "train_4k"],
    ["--arch", "qwen3-0.6b", "--shape", "train_4k", "--multi-pod"],
    ["--arch", "llama4-maverick-400b-a17b", "--shape", "train_4k",
     "--sketch-mode", "model_local"])
DRYRUN_MEM_RTOL = 0.25           # the card's peak against the prediction


def dryrun_cli() -> list[dict]:
    """The dry-run CLI on each of ``DRYRUN_COMBOS``, all at once, each in
    a process that sees no card (a dry-run needs none): exit 0, its
    roofline row."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    procs = []
    for i, argv in enumerate(DRYRUN_COMBOS):
        path = OUT / f"chip_smoke_dryrun_{i}.jsonl"
        path.unlink(missing_ok=True)
        procs.append((argv, path, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--json", str(path)], cwd=ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    rows = []
    for argv, path, proc in procs:
        t0 = time.time()
        text, _ = proc.communicate(timeout=600)
        print("\n".join("  " + line for line in text.splitlines()))
        check(proc.returncode == 0,
              f"dryrun {' '.join(argv)}: exit 0 without a card")
        rec = json.loads(path.read_text())
        row = (f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} "
               f"| {rec['t_compute']*1e3:.2f} | {rec['t_memory']*1e3:.2f} "
               f"| {rec['t_collective']*1e3:.2f} | {rec['bottleneck']} "
               f"| {rec['useful']:.3f} | {rec['peak_mem']/2**30:.2f} |")
        print(f"dryrun row: {row} ({rec['sketch_mode']}; a dry-run on the "
              f"host, no card)")
        rows.append(dict(argv=argv, record=rec, row=row,
                         wait_s=time.time() - t0))
    return rows


DRYRUN_PASSES = ((8, 64), (4, 1024))    # (batch, seq): the step's, and
                                         # one where the activations dominate


def dryrun_activations(torch, dev, cfg, smi_line: str) -> list[dict]:
    """The rank's forward and backward alone (qwen3-0.6b) at each of
    ``DRYRUN_PASSES``, without ``remat``: the live bytes the ``meta`` pass
    counts against the card's peak over its own parameters and batch, once
    under ``FlopCounterMode`` (whose FLOPs must equal the ``meta`` count)
    and once plain; then at the largest, the rematerialized pass the mesh
    step runs, against the plain pass's peak and its own count, and its
    gradients against the plain pass's."""
    from repro_torch.core import layout as layout_lib
    from repro_torch.launch import analysis
    from repro_torch.models import transformer

    def grad(p, b):
        return transformer.value_and_grad(p, b, cfg, remat=False)

    def grad_remat(p, b):
        return transformer.value_and_grad(p, b, cfg, remat=True)

    def peak_of(fn):
        sync(torch, dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        sync(torch, dev)
        return out, torch.cuda.max_memory_allocated(dev) - base

    params = transformer.init_params(cfg, seed=0, device=dev)
    meta_params = transformer.init_params(cfg, device="meta")
    res = []
    for batch, seq in DRYRUN_PASSES:
        meta = analysis.count(grad, meta_params,
                              {k: torch.empty(batch, seq, dtype=torch.int64,
                                              device="meta")
                               for k in ("tokens", "labels")})
        data = mesh_batch(torch, dev, cfg, seq=seq, batch=batch)
        flops, counted = peak_of(lambda: analysis.count_flops(grad, params,
                                                              data))
        _, plain = peak_of(lambda: grad(params, data)[0])
        r = dict(batch=batch, seq=seq, flops=flops, counted=meta.peak_live,
                 card_counting=counted, card_plain=plain,
                 ratio_counting=counted / meta.peak_live,
                 ratio_plain=plain / meta.peak_live)
        print(f"dryrun: forward and backward of {batch} x {seq} tokens: "
              f"counted {meta.peak_live:,} B; the card's peak over its "
              f"inputs {counted:,} B under FlopCounterMode (ratio "
              f"{r['ratio_counting']:.6f}), {plain:,} B plain (ratio "
              f"{r['ratio_plain']:.6f}) ({smi_line})")
        check(flops == meta.flops, f"dryrun: {batch} x {seq} tokens: "
              f"{flops:,} FLOPs on the card = the meta count {meta.flops:,}")
        check(abs(r["ratio_plain"] - 1) <= DRYRUN_MEM_RTOL,
              f"dryrun: {batch} x {seq} tokens: the card's plain peak "
              f"within {DRYRUN_MEM_RTOL:.0%} of the counted live bytes")
        res.append(r)
        del data
    # the rematerialized pass at the largest (the mesh step's grad_fn)
    batch, seq = DRYRUN_PASSES[-1]
    meta = analysis.count(grad_remat, meta_params,
                          {k: torch.empty(batch, seq, dtype=torch.int64,
                                          device="meta")
                           for k in ("tokens", "labels")})
    data = mesh_batch(torch, dev, cfg, seq=seq, batch=batch)
    (_, g_remat), remat_peak = peak_of(lambda: grad_remat(params, data))
    _, g_plain = grad(params, data)
    err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
              for (_, a), (_, b) in zip(layout_lib.flatten(g_remat),
                                        layout_lib.flatten(g_plain)))
    plain = res[-1]["card_plain"]
    r = dict(batch=batch, seq=seq, remat=True, counted=meta.peak_live,
             card_plain=remat_peak, ratio_plain=remat_peak / meta.peak_live,
             plain_peak=plain, grads_max_rel_gap=err)
    print(f"dryrun: rematerialized forward and backward of {batch} x {seq} "
          f"tokens: the card's peak {remat_peak:,} B against the plain "
          f"pass's {plain:,} B and its count {meta.peak_live:,} B (ratio "
          f"{r['ratio_plain']:.6f}); gradients within {err:.3e} of each "
          f"leaf's largest ({smi_line})")
    check(remat_peak < plain, f"dryrun: remat peaks below the plain pass "
          f"({remat_peak:,} < {plain:,} B)")
    check(abs(r["ratio_plain"] - 1) <= DRYRUN_MEM_RTOL,
          f"dryrun: remat's peak within {DRYRUN_MEM_RTOL:.0%} of its count")
    check(err <= 1e-5, f"dryrun: remat's gradients = the plain pass's "
          f"within {err:.3e} of each leaf's largest (1e-5)")
    res.append(r)
    del data, g_remat, g_plain, params
    torch.cuda.empty_cache()
    return res


def dryrun_tp(ranks: list[dict], cfg, fs, shape, smi_line: str,
              arch: str = MESH_ARCH, residual=None) -> dict:
    """The dry-run's prediction for a mesh phase's 1 x 2 tensor-parallel
    step of ``arch`` (each rank: ``run_one`` as that rank of a fake world
    of 2, with the run's residual: bfloat16 if None) against each rank's
    peak memory on the card, and ``step_collective_bytes`` against each
    rank's recorded collectives, to the byte."""
    import torch
    from repro_torch.launch import analysis, dryrun, steps
    from repro_torch.models import transformer

    m12 = {"data": 1, "model": 2}
    lay = steps.build_layout(cfg, m12)
    out = {}
    transformer.RESIDUAL_DTYPE = residual or torch.bfloat16
    try:
        for name in ranks[0]["runs"]:
            one = analysis.step_collective_bytes(cfg, shape, m12, fs, lay,
                                                 sketch_mode=name)
            for rank, r in enumerate(ranks):
                run = r["runs"][name]
                roof, _, _ = dryrun.run_one(arch, "mesh", shape=shape,
                                            debug_mesh=(1, 2), fs_cfg=fs,
                                            sketch_mode=name, rank=rank,
                                            verbose=False)
                ratio = run["peak"] / roof.peak_mem_bytes
                want = {k: v * run["rounds"] for k, v in one.items()}
                g = 2 ** 30
                print(f"dryrun: mesh 1x2 {arch} {name} rank {rank}: peak "
                      f"of round 1 {run['peak'] / g:.4f} GiB, predicted "
                      f"{roof.peak_mem_bytes / g:.4f} GiB "
                      f"({roof.mem_detail}), ratio {ratio:.4f}; collectives "
                      f"{run['collectives']} ({smi_line})")
                check(abs(ratio - 1) <= DRYRUN_MEM_RTOL,
                      f"dryrun: mesh 1x2 {arch} {name} rank {rank}: the "
                      f"card's peak within {DRYRUN_MEM_RTOL:.0%} of the "
                      f"prediction (ratio {ratio:.4f})")
                check(run["collectives"] == want,
                      f"dryrun: mesh 1x2 {arch} {name} rank {rank}: "
                      f"recorded collectives {run['collectives']} = "
                      f"step_collective_bytes x {run['rounds']} rounds "
                      f"{want}")
                out[f"{name}/{rank}"] = dict(
                    peak=run["peak"], predicted=roof.peak_mem_bytes,
                    ratio=ratio, mem=roof.mem_detail,
                    collectives=run["collectives"], formula=want,
                    seconds=run["seconds"])
    finally:
        transformer.RESIDUAL_DTYPE = torch.bfloat16
    return out


def dryrun_phase(torch, dev, smi_line: str, mesh: dict) -> dict:
    """The dry-run (``launch/dryrun.py``): the CLI on three combos, then
    its prediction for the mesh phase's step (qwen3-0.6b at full width,
    seq 64, global batch 8, 5 x 2**20, k = 25,000) at mesh 1 x 1 against
    the same step run as a world of 1 on the card: FLOPs counted on the
    card equal the ``meta`` count, the peak memory of a round within 25%
    of the prediction, and the 2 x 1 run's recorded collectives equal
    ``step_collective_bytes``; the forward and backward alone at the
    step's 8 x 64 tokens and at 4 x 1024, where the activations dominate,
    against their counted live bytes; seconds per round and the shares of
    the card's peak rates."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core import fetchsgd as F
    from repro_torch.kernels import count_sketch as cuda_cs
    from repro_torch.launch import analysis, dryrun, mesh as mesh_lib
    from repro_torch.launch import shapes, steps
    from repro_torch.models import transformer

    t0 = time.time()
    check(cuda_cs.bins() == cuda_cs.SOURCE_BINS
          and cuda_cs.select_geometry() == cuda_cs.SOURCE_SELECT,
          f"the kernels' geometry is the dry-run's {cuda_cs.SOURCE_BINS}, "
          f"{cuda_cs.SOURCE_SELECT}")
    rows = dryrun_cli()
    cli_s = time.time() - t0

    cfg = configs.get_config(MESH_ARCH)
    fs = F.FetchSGDConfig(rows=ROWS, cols=COLS, k=K, momentum=0.9)
    shape = shapes.ShapeSpec("mesh", "train", 64, 8)
    roof, count_s, n_params = dryrun.run_one(
        MESH_ARCH, "mesh", shape=shape, debug_mesh=(1, 1), fs_cfg=fs)
    check(not dist.is_initialized(), "the prediction's fake world is closed")

    mesh_lib.init_from_env(dev.type)
    m11 = mesh_lib.make_debug_mesh(1, 1, dev.type)
    sync(torch, dev)
    base = torch.cuda.memory_allocated(dev)
    bundle = steps.make_train_step(cfg, shape, m11, fs, aggregate="flat")
    params = transformer.init_params(cfg, seed=0, device=dev)
    opt = F.init_state(fs, dev)
    batch = mesh_batch(torch, dev, cfg)
    lr = torch.full((), MESH_LR, device=dev)
    flops = analysis.count_flops(bundle.grad_fn, params, batch)
    check(flops == roof.flops,
          f"dryrun: FlopCounterMode on the card counts {flops:,} FLOPs of "
          f"the rank's forward and backward = the meta count "
          f"{int(roof.flops):,}")
    params, opt, _ = bundle.fn(params, opt, batch, lr)      # round 0: warm
    sync(torch, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    seconds = []
    for r in range(1, 4):
        t1 = time.perf_counter()
        params, opt, m = bundle.fn(params, opt, batch, lr)
        sync(torch, dev)
        seconds.append(time.perf_counter() - t1)
        if r == 1:
            peak = torch.cuda.max_memory_allocated(dev) - base
        check(math.isfinite(float(m["loss"])), f"dryrun round {r}: loss "
              f"{float(m['loss']):.6f} finite")
    ratio = peak / roof.peak_mem_bytes
    g = 2 ** 30
    print(f"dryrun: peak memory of round 1 {peak / g:.4f} GiB, predicted "
          f"{roof.peak_mem_bytes / g:.4f} GiB ({roof.mem_detail}), ratio "
          f"{ratio:.4f} ({smi_line})")
    check(abs(ratio - 1) <= DRYRUN_MEM_RTOL,
          f"dryrun: the card's peak within {DRYRUN_MEM_RTOL:.0%} of the "
          f"prediction (ratio {ratio:.4f})")
    del params, opt, m, bundle
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    fwd_bwd = dryrun_activations(torch, dev, cfg, smi_line)

    # the mesh phase's 2 x 1 flat run against the formula, to the byte
    run = mesh["world_of_2"]["runs"]["flat"]
    m21 = {"data": 2, "model": 1}
    one = analysis.step_collective_bytes(
        cfg, shape, m21, fs, steps.build_layout(cfg, m21), aggregate="flat")
    want = {k: v * run["rounds"] for k, v in one.items()}
    check(run["collectives"] == want,
          f"dryrun: the 2 x 1 flat run's recorded collectives "
          f"{run['collectives']} = step_collective_bytes x "
          f"{run['rounds']} rounds {want}")
    tp = dryrun_tp(mesh["world_of_2"]["tp"], cfg, fs, shape, smi_line)
    xlstm_tp = dryrun_tp(mesh["world_of_2"]["xlstm_tp"],
                         configs.get_config(XLSTM_TRAIN), fs, shape,
                         smi_line, arch=XLSTM_TRAIN, residual=torch.float32)

    s = statistics.median(seconds)
    model_flops, step_flops = roof.model_flops, roof.step_flops
    shares = {
        "step_flops_share_of_bf16_peak":
            step_flops / (s * mesh_lib.PEAK_FLOPS_BF16),
        "mfu_bf16_peak": model_flops / (s * mesh_lib.PEAK_FLOPS_BF16),
        "step_flops_share_of_f32_peak":
            step_flops / (s * mesh_lib.PEAK_FLOPS_F32),
        "mfu_f32_peak": model_flops / (s * mesh_lib.PEAK_FLOPS_F32)}
    print(f"dryrun: s/round {seconds} (median {s:.6f}) ({smi_line})")
    print(f"dryrun: model_flops {model_flops:.6e} step_flops "
          f"{step_flops:.6e} counted {roof.flops:.6e} ({smi_line})")
    for k, v in shares.items():
        print(f"dryrun: {k} {v:.6f} ({smi_line})")
    return dict(cli=rows, cli_s=cli_s, count_s=count_s, n_params=n_params,
                predicted=dict(flops=roof.flops, peak=roof.peak_mem_bytes,
                               mem=roof.mem_detail,
                               coll=roof.coll_detail, row=roof.row()),
                card=dict(flops=flops, peak=peak, ratio=ratio,
                          seconds=seconds),
                fwd_bwd=fwd_bwd, tp_1x2=tp, xlstm_tp_1x2=xlstm_tp,
                collectives_2x1=run["collectives"], formula_2x1=want,
                model_flops=model_flops, step_flops=step_flops, **shares,
                seconds=time.time() - t0)



def main() -> int:
    # the serve phase frees and allocates models of 35-54 GiB one after
    # another, and qwen2-moe's FetchSGD run then needs all but a few GiB
    # of the card: segments that grow in place keep the freed blocks usable
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    # float32 matmuls in full float32, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.time()
    lib_path = build.build()
    build.library()
    print(f"built {lib_path.name} from {len(build.sources())} sources in "
          f"{time.time() - t0:.1f}s")
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_build.log").write_text(build.build_log())

    kernels = card_checks(torch, dev)
    print("reduced model, card vs CPU:")
    small_reference_run(torch, dev)
    print("main path: train_lm --full --rounds 3")
    records, counts, paths = main_path()
    kernels["encode"]["one_pass"]["launches"] = paths["one_pass"]
    for r in records:
        print(f"round {r.round}: loss {r.loss:.6f}  {r.seconds:.3f} s/round")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print("fedsim: the federated simulation at full width")
    fedsim = fedsim_phase(torch, dev, smi)
    (OUT / "chip_smoke_fedsim.json").write_text(json.dumps(
        {"device": smi, "runs": fedsim}, indent=1))
    print("examples: the four example entry points at full width")
    examples = examples_phase(torch, dev, smi)
    (OUT / "chip_smoke_examples.json").write_text(json.dumps(
        {"device": smi, **examples}, indent=1))
    print("eventsim: the event clock and the population paths at full width")
    eventsim = eventsim_phase(torch, dev, smi)
    (OUT / "chip_smoke_eventsim.json").write_text(json.dumps(
        {"device": smi, "runs": eventsim}, indent=1))
    print("resume: checkpoints and resume at full width")
    resume = resume_phase(torch, dev, smi)
    (OUT / "chip_smoke_resume.json").write_text(json.dumps(
        {"device": smi, "runs": resume}, indent=1))
    print("telemetry: an instrumented simulation at full width")
    telemetry = telemetry_phase(torch, dev, smi)
    (OUT / "chip_smoke_telemetry.json").write_text(json.dumps(
        {"device": smi, **telemetry}, indent=1))
    print("serve: the zoo served and trained at full width")
    serve = serve_phase(torch, dev, smi)
    (OUT / "chip_smoke_serve.json").write_text(json.dumps(
        {"device": smi, **serve}, indent=1))
    print("mesh: the mesh train step at full width")
    mesh = mesh_phase(torch, dev, smi)
    (OUT / "chip_smoke_mesh.json").write_text(json.dumps(
        {"device": smi, **mesh}, indent=1))
    print("dryrun: the dry-run and its prediction against the card")
    dry = dryrun_phase(torch, dev, smi, mesh)
    (OUT / "chip_smoke_dryrun.json").write_text(json.dumps(
        {"device": smi, **dry}, indent=1))
    mesh_launches = {k: sum(r["launches"][k] for r in
                            mesh["world_of_1"]["runs"].values())
                     for k in counts}

    meta = {
        "encode": ("src/repro_torch/kernels/csrc/encode.cu",
                   "src/repro/kernels/count_sketch.py:59"),
        "estimate": ("src/repro_torch/kernels/csrc/estimate_select.cu",
                     "src/repro/kernels/count_sketch.py:134"),
        "momentum_error": ("src/repro_torch/kernels/csrc/momentum_error.cu",
                           "src/repro/kernels/server_step.py:73"),
        "topk_mask": ("src/repro_torch/kernels/csrc/topk_mask.cu",
                      "src/repro/kernels/server_step.py:103"),
    }
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[k], "max_abs_err": kernels[k]["max_abs_err"],
         "ms": kernels[k]["ms"], "kernel_ms": kernels[k]["ms"],
         "plain_ms": kernels[k]["plain_ms"],
         "bound_ms": kernels[k]["bound_ms"],
         "bound_by": kernels[k]["bound_by"],
         "library_ms": kernels[k].get("library_ms"),
         "mesh_launches": mesh_launches[k],
         "examples_launches": examples["launches"][k],
         **{sub: kernels[k][sub] for sub in ("one_pass", "estimate_only")
            if sub in kernels[k]}}
        for k, (src, rep) in meta.items()]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
