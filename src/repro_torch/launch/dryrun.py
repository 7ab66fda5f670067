"""Dry-run: every (arch x shape x mesh) step of the port on ranks with no
card.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
step with XLA on 512 forced host devices and reads the compiled program.
Here the world is one of ``torch.distributed``'s ``fake`` process groups:
this process is rank ``--rank`` (0) of 256 (16 x 16) or 512 (2 x 16 x 16)
ranks whose collectives move nothing, every tensor is on the ``meta``
device, and the rank's own forward and backward (a train shape: the
step's ``grad_fn`` on its local batch) or its ``prefill`` /
``decode_step`` (the serving shapes, the step's ``fn``) runs once under
counters (``launch/analysis.py``).  Nothing is allocated and no card is
needed: that is the point of it, not a fallback.

A train step runs as the mesh step does: its parameters split over
``model`` as ``param_spec`` places them, its forward and backward
tensor-parallel and rematerialized, so the per-rank columns are those of
that step.  The serving shapes run as the serve steps do: tensor-parallel
on the rank's ``param_spec`` shard, against its ``cache_spec`` slice of
the cache.

For each combination this prints the rank's memory (parameters, gradients,
the sketch's state, tables and kernel scratch, the activations' counted
peak), its FLOPs and bytes, the collective bytes and the three roofline
terms against the H100's constants.  The sketch and the server step are
not run: the kernels have no ``meta`` path (``kernels/ops.py`` raises for a
``meta`` tensor), so their FLOPs, bytes and scratch are analytic.  The
collectives of a step come from ``analysis.step_collective_bytes``;
those of a train step's forward and backward (tensor-parallel and EP)
are also recorded and must equal its part of them
(``analysis.model_collective_calls``), and a serving step's recorded
collectives must equal the formula's.

``xla_env`` has no counterpart: the fake world replaces
``force_host_devices(512)``, and no process is forked.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--aggregate dense]
  python -m repro_torch.launch.dryrun --all --json out.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import configs, obs
from repro_torch.core import fetchsgd as F
from repro_torch.core import layout as layout_lib
from repro_torch.launch import analysis, mesh as mesh_lib, shapes, steps
from repro_torch.models import transformer


def default_fetchsgd_config() -> F.FetchSGDConfig:
    # Paper-scale sketch: 5 rows x 1M cols (~20 MB upload), k=50k, rho=0.9.
    return F.FetchSGDConfig(rows=5, cols=1 << 20, k=50_000, momentum=0.9)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """This process as rank ``rank`` of a ``fake`` world of ``world_size``
    ranks; torn down on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _world_for(sizes: tuple[int, ...], rank: int):
    """The fake world of ``prod(sizes)`` ranks: the open one, or a new one
    for the call.  Another world open raises."""
    n = math.prod(sizes)
    if not dist.is_initialized():
        return fake_world(n, rank)
    if dist.get_backend() != "fake" or dist.get_world_size() != n:
        raise RuntimeError(f"the dry-run needs a fake world of {n} ranks; "
                           f"a {dist.get_backend()} world of "
                           f"{dist.get_world_size()} is open")
    return contextlib.nullcontext()


def _meta(glob: dict) -> dict:
    return {k: torch.empty(s, dtype=dt, device="meta")
            for k, (s, dt) in glob.items()}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for _, t in layout_lib.flatten(tree))


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            aggregate: str = "sketch", sketch_mode: str = "gathered",
            fs_cfg=None, cfg_overrides=None, verbose: bool = True,
            telemetry=None, shape=None, debug_mesh=None, rank: int = 0):
    """Build, count and print one (arch x shape x mesh) step; returns
    ``(roof, seconds, n_params)`` as the reference does.

    ``shape``: a ``ShapeSpec`` in place of ``SHAPES[shape_name]``;
    ``debug_mesh``: ``(data, model)`` in place of the production mesh;
    ``rank``: the rank this process plays.  The fake world is the one
    open, or one made for the call.  The reference's ``donate`` (XLA
    buffer donation) has no counterpart."""
    tele = telemetry if telemetry is not None else obs.NOOP
    shape = shape or shapes.SHAPES[shape_name]
    cfg = shapes.adapt_config(configs.get_config(arch), shape)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if debug_mesh is not None:
        sizes = tuple(debug_mesh)
        mesh_name = "x".join(map(str, sizes))
    else:
        sizes = (2, 16, 16) if multi_pod else (16, 16)
        mesh_name = "2x16x16" if multi_pod else "16x16"
    fs_cfg = fs_cfg or default_fetchsgd_config()
    is_train = shape.kind == "train"

    with _world_for(sizes, rank):
        t0 = time.time()
        with tele.span("dryrun.build_step", arch=arch, shape=shape_name):
            if debug_mesh is not None:
                mesh = mesh_lib.make_debug_mesh(*sizes, device="meta")
            else:
                mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                                     device="meta")
            full = steps.param_structs(cfg)
            n_params = transformer.param_count(full)
            params = steps.local_params(full, cfg, mesh)
            batch, batch_glob = steps.batch_structs(cfg, shape, mesh)
            cache = None
            if is_train:
                bundle = steps.make_train_step(cfg, shape, mesh, fs_cfg,
                                               aggregate=aggregate,
                                               sketch_mode=sketch_mode)
                args = (params, batch)
                fn = bundle.grad_fn
            else:
                cache, _ = steps.cache_structs(cfg, shape, mesh)
                make = steps.make_prefill_step if shape.kind == "prefill" \
                    else steps.make_decode_step
                bundle = make(cfg, shape, mesh)
                glob = _meta(batch_glob)
                args = (params, glob if shape.kind == "prefill"
                        else glob["tokens"], cache)
                fn = bundle.fn
        with tele.span("dryrun.count_flops", arch=arch, shape=shape_name):
            with analysis.CollectiveRecorder() as rec:
                counts = analysis.count(fn, *args)
        with tele.span("dryrun.count_memory", arch=arch, shape=shape_name):
            mem = _memory(counts, params, batch, cache, bundle, fs_cfg,
                          is_train, gathered=sketch_mode == "gathered")
            if is_train:
                coll = analysis.step_collective_bytes(
                    cfg, shape, mesh.shape, fs_cfg, bundle.layout,
                    aggregate=aggregate, sketch_mode=sketch_mode,
                    params=full)
                want = analysis._coll_dict(analysis.model_collective_calls(
                    cfg, shape, mesh.shape))
                if rec.bytes() != want:
                    raise RuntimeError(
                        f"the forward and backward moved {rec.bytes()}; "
                        f"model_collective_calls says {want}")
            else:
                coll = analysis.step_collective_bytes(cfg, shape, mesh.shape,
                                                      None, None)
                if rec.bytes() != coll:
                    raise RuntimeError(
                        f"the serve step moved {rec.bytes()}; "
                        f"step_collective_bytes says {coll}")
            # the batch split over the clients, the layers over model
            n_split = shape.global_batch // steps.local_batch_size(
                shape.global_batch, mesh) * mesh.shape.get("model", 1)
        dt = time.time() - t0

    n_active = analysis.active_params(cfg, n_params)
    mf = analysis.model_flops_estimate(cfg, shape, n_active)
    sf = analysis.step_flops_estimate(
        cfg, shape, n_active, fs_cfg=fs_cfg if is_train else None,
        layout_total=(bundle.layout.total if bundle.layout else None))
    hbm = counts.bytes + (analysis.fetchsgd_bytes_estimate(
        fs_cfg, bundle.layout, mem["grads"]) if is_train else 0)
    roof = analysis.Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name,
        flops=float(counts.flops), hbm_bytes=float(hbm),
        coll_bytes=float(coll["total"]), coll_detail=coll,
        peak_mem_bytes=float(mem["peak"]), model_flops=mf, step_flops=sf,
        n_devices=n_split, mem_detail=mem)
    if tele.enabled:
        tele.counter("dryrun.compiles").inc()
        tele.histogram("dryrun.compile_seconds").observe(dt)
        tele.emit("dryrun", arch=arch, shape=shape_name, mesh=mesh_name,
                  compile_s=dt, flops=roof.flops, hbm_bytes=roof.hbm_bytes,
                  coll_bytes=roof.coll_bytes,
                  peak_mem_bytes=roof.peak_mem_bytes,
                  bottleneck=roof.bottleneck)
    if verbose:
        g = 2 ** 30
        print(f"== {arch} x {shape_name} x {mesh_name} "
              f"(aggregate={aggregate if is_train else '-'}) "
              f"counted in {dt:.1f}s")
        print(f"   params: {n_params/1e9:.3f}B (active {n_active/1e9:.3f}B)")
        print(f"   memory/rank: params={mem['params']/g:.2f}G "
              f"grads={mem['grads']/g:.2f}G "
              f"sketch state={mem['sketch']/g:.2f}G "
              f"activations peak={mem['activations']/g:.2f}G "
              f"peak~{roof.peak_mem_bytes/g:.2f}G")
        print(f"   cost/rank: flops={roof.flops:.3e} "
              f"step_flops/rank={roof.step_flops/roof.n_devices:.3e} "
              f"bytes={roof.hbm_bytes:.3e} coll_bytes={roof.coll_bytes:.3e}")
        print(f"   collectives: { {k: v for k, v in roof.coll_detail.items()} }")
        print(f"   roofline(ms): compute={roof.t_compute*1e3:.2f} "
              f"(counted {roof.t_compute_hlo*1e3:.2f}) "
              f"memory={roof.t_memory*1e3:.2f} "
              f"collective={roof.t_collective*1e3:.2f} "
              f"-> {roof.bottleneck}-bound  useful={roof.useful_ratio:.3f}")
    return roof, dt, n_params


def _memory(counts, params, batch, cache, bundle, fs_cfg,
            is_train: bool, gathered: bool = True) -> dict:
    """The rank's memory, in bytes, by part and its peak.

    The forward and backward's counted peak (``counts.peak_live``, the
    gradients made by then included) comes first; then a train step holds
    every gradient while it sketches: its permuted leaves' copies, its
    table and the merged one, the gathered sketch's buffers at its largest
    chunk of a tensor-parallel leaf, and the kernels' scratch at its
    largest chunk.  The FetchSGD state (``su``, ``se``) and the inputs (parameters,
    batch, cache) are held throughout:

        peak = params + inputs + state
               + max(counted peak, grads + tables + copies + scratch)
    """
    p = _nbytes(params)
    inputs = _nbytes(batch) + (_nbytes(cache) if cache is not None else 0)
    if not is_train:
        return dict(params=p, grads=0, sketch=0, inputs=inputs,
                    activations=counts.peak_live,
                    peak=p + inputs + counts.peak_live)
    _, grads = counts.out
    g = _nbytes(grads)
    table = fs_cfg.rows * fs_cfg.cols * 4
    state = 2 * table
    after = (2 * table + analysis.view_copy_bytes(bundle.layout, grads)
             + (analysis.gather_scratch_bytes(bundle.layout, bundle.plan,
                                              grads) if gathered else 0)
             + analysis.kernel_scratch_bytes(fs_cfg, bundle.layout))
    return dict(params=p, grads=g, sketch=state + after, inputs=inputs,
                activations=counts.peak_live - counts.held_at_peak(grads),
                peak=p + inputs + state + max(counts.peak_live, g + after))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.list_archs())
    ap.add_argument("--shape", choices=list(shapes.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--aggregate", default="sketch",
                    choices=("sketch", "dense"))
    ap.add_argument("--sketch-mode", default="gathered",
                    choices=("gathered", "model_local"))
    ap.add_argument("--json", default=None, help="append results as JSON lines")
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    obs.add_cli_flags(ap)   # --metrics PATH.jsonl / --trace / --obs-summary
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("pass --arch and --shape, or --all")
    world = 512 if args.multi_pod else 256
    with fake_world(world, args.rank):
        return _run(args)


def _run(args) -> int:
    tele = obs.from_args(args, run="dryrun", aggregate=args.aggregate)
    combos = ([(args.arch, args.shape)] if not args.all else
              [(a, s) for a in configs.list_archs() if a != "gpt2s-federated"
               for s in shapes.SHAPES])
    done = set()
    if args.json and os.path.exists(args.json):
        with open(args.json) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    done.add((rec["arch"], rec["shape"], rec["mesh"],
                              rec.get("aggregate", "sketch")))
                except Exception:
                    pass
    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    failures, results = [], []
    for arch, shp in combos:
        if (arch, shp, mesh_name, args.aggregate) in done:
            print(f"== {arch} x {shp} x {mesh_name}: already in {args.json}")
            continue
        try:
            roof, dt, n_params = run_one(arch, shp, multi_pod=args.multi_pod,
                                         aggregate=args.aggregate,
                                         sketch_mode=args.sketch_mode,
                                         telemetry=tele, rank=args.rank)
            results.append((roof, dt, n_params))
            if args.json:
                with open(args.json, "a") as f:
                    f.write(json.dumps({
                        "arch": arch, "shape": shp, "mesh": roof.mesh,
                        "aggregate": args.aggregate,
                        "sketch_mode": args.sketch_mode,
                        "flops": roof.flops, "hbm_bytes": roof.hbm_bytes,
                        "coll_bytes": roof.coll_bytes,
                        "coll_detail": roof.coll_detail,
                        "peak_mem": roof.peak_mem_bytes,
                        "mem_detail": roof.mem_detail,
                        "model_flops": roof.model_flops,
                        "step_flops": roof.step_flops,
                        "params": n_params, "compile_s": dt,
                        "t_compute": roof.t_compute,
                        "t_memory": roof.t_memory,
                        "t_collective": roof.t_collective,
                        "bottleneck": roof.bottleneck,
                        "useful": roof.useful_ratio}) + "\n")
        except shapes.SkipShape as e:
            print(f"== {arch} x {shp}: SKIP ({e})")
        except Exception:
            print(f"== {arch} x {shp}: FAILED")
            traceback.print_exc()
            failures.append((arch, shp))
    tele.close()
    print(f"\n{len(results)} counted, {len(failures)} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
