"""Roofline analysis of the port's steps: counters and analytic estimates.

Port of ``repro.launch.analysis``.  The reference compiles each step with
XLA and reads its FLOPs and bytes from ``cost_analysis()``, its memory
from ``memory_analysis()`` and its collective bytes from the partitioned
HLO text.  PyTorch compiles nothing, so the port counts what its own step
does instead, on ``meta`` tensors in a world of fake ranks (the dry-run,
``launch/dryrun.py``):

    compute    = step FLOPs per rank / PEAK_FLOPS_BF16   (per card)
    memory     = bytes accessed      / HBM_BW            (per card)
    collective = collective bytes    / NVLINK_BW         (per card)

* :func:`count_flops` wraps ``torch.utils.flop_counter.FlopCounterMode``:
  the FLOPs of every matmul, convolution and attention the rank runs (the
  counterpart of the HLO FLOPs);
* :func:`count_bytes` sums the bytes of every op's tensor operands and
  results.  That is the counterpart of XLA's ``bytes accessed``: a per-op
  sum with no fusion, so an upper bound of the HBM traffic of an eager
  step;
* :func:`peak_live_bytes` gives the peak of the bytes of live tensors
  that the function allocates (its inputs not counted);
* :func:`count` runs all three in one pass, the modes stacked;
* :class:`CollectiveRecorder` records each collective the step runs
  (``Mesh.all_sum`` / ``all_mean`` / ``all_gather`` and the EP exchange
  ``moe._all_to_all``), and :func:`step_collective_bytes` gives the same
  bytes of a train step from its configuration alone, for a world that
  cannot run: the recorder is the formula's oracle.

No counterpart: the HLO parsing (``_COLL_RE``, ``_SHAPE_RE``,
``_shape_bytes``, ``collective_bytes``, ``count_collectives``) and
``analyze(compiled)``; there is no compiled artifact to read.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core import layout as layout_lib
from repro_torch.core import topk as topk_lib
from repro_torch.kernels import count_sketch
from repro_torch.models import moe, sharding

from . import mesh as mesh_lib
from . import steps


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops: float               # per-rank counted FLOPs (forward + backward)
    hbm_bytes: float           # per-rank bytes accessed (counted + sketch)
    coll_bytes: float          # per-rank collective bytes
    coll_detail: dict
    peak_mem_bytes: float      # per-rank peak (the port's placement)
    model_flops: float         # 6*N_active*D (useful FLOPs, whole step)
    step_flops: float          # analytic total step FLOPs (incl. attention,
                               # sketch/unsketch) — trip-count-aware
    n_devices: int             # ranks the step's work divides over
    mem_detail: dict = dataclasses.field(default_factory=dict)

    # The compute term uses the analytic ``step_flops`` as the reference's
    # does; the counted ``flops`` (the rank's forward and backward, no
    # sketch) is kept as a cross-check.  The port replicates the model
    # over ``model``: its step's work divides over the client ranks that
    # split the batch, not over the whole mesh (``n_devices``).
    @property
    def t_compute(self) -> float:
        return (self.step_flops / self.n_devices) / mesh_lib.PEAK_FLOPS_BF16

    @property
    def t_compute_hlo(self) -> float:
        return self.flops / mesh_lib.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / mesh_lib.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / mesh_lib.NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.step_flops if self.step_flops else 0.0

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} "
                f"| {self.t_compute*1e3:.2f} | {self.t_memory*1e3:.2f} "
                f"| {self.t_collective*1e3:.2f} | {self.bottleneck} "
                f"| {self.useful_ratio:.3f} "
                f"| {self.peak_mem_bytes/2**30:.2f} |")


# -- analytic estimates (the reference's, as pure Python) ------------------------

def model_flops_estimate(cfg, shape, n_active_params: float) -> float:
    """MODEL_FLOPS = 6 * N_active * D(tokens) for train; 2*N*D for inference."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active_params * tokens


def step_flops_estimate(cfg, shape, n_active_params: float,
                        fs_cfg=None, layout_total: int | None = None) -> float:
    """Analytic whole-step FLOPs, trip-count aware.

    matmul term (2*N_active per token, x3 for backward) + quadratic/windowed
    attention term + FetchSGD overhead (hash+scatter per element for the
    sketch, hash+gather+median for the unsketch; ~r*c_hash ops/element
    counted as 8 flop-equivalents per row).
    """
    B = shape.global_batch
    S = shape.seq_len
    is_train = shape.kind == "train"
    tokens = B * (S if shape.kind != "decode" else 1)
    mult = 6.0 if is_train else 2.0
    total = mult * n_active_params * tokens

    # attention: per layer, q@k + p@v = 4 * B * H * Sq * Sk_eff * hd
    n_attn = sum(1 for s in cfg.unit_pattern if s.kind == "attn") \
        * cfg.n_units + cfg.enc_layers
    H, hd = cfg.n_heads, cfg.hd
    win = cfg.sliding_window
    if shape.kind == "decode":
        sq, sk = 1, min(S, win) if win else S
    else:
        sq = S
        sk = min(S, win) if win else S
        sk = sk / 2 if not win else sk          # causal halves the band
    attn = 4.0 * B * H * sq * sk * hd * n_attn
    total += attn * (3.0 if is_train else 1.0)

    # FetchSGD sketch + unsketch: ~8 integer-op-equivalents per row-hash
    if is_train and fs_cfg is not None and layout_total:
        total += 2.0 * 8 * fs_cfg.rows * layout_total   # encode + decode
    return total


def active_params(cfg, param_count: int) -> float:
    """Active (per-token) parameter count for MoE archs; else total."""
    if cfg.n_experts:
        # subtract inactive expert fraction from the expert stacks
        ffe = cfg.moe_d_ff or cfg.d_ff
        n_moe_layers = sum(1 for s in cfg.unit_pattern if s.moe) * cfg.n_units
        expert_params = n_moe_layers * cfg.n_experts * 3 * cfg.d_model * ffe
        active_expert = expert_params * cfg.expert_top_k / cfg.n_experts
        return param_count - expert_params + active_expert
    return float(param_count)


# -- counters --------------------------------------------------------------------

def _tensors(x):
    """The tensors of a nest of tuples, lists and dicts."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _OpCounter(TorchDispatchMode):
    """Sums the bytes of every op's operands and results, and tracks the
    bytes of the live storages that ops create (freed when the last
    tensor on a storage dies)."""

    def __init__(self, inputs=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.seq = 0              # storages created so far
        self.peak_seq = 0         # ... when the peak was reached
        self._seen = WeakIdKeyDictionary()
        for t in _tensors(inputs):          # the inputs count as held
            self._seen[t.untyped_storage()] = (0, 0)

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        n = 0
        for t in _tensors((args, kwargs)):
            n += _nbytes(t)
        for t in _tensors(out):
            n += _nbytes(t)
            st = t.untyped_storage()
            if st not in self._seen:
                size = st.nbytes()
                self.seq += 1
                self._seen[st] = (size, self.seq)
                self.live += size
                weakref.finalize(st, self._free, size)
                if self.live > self.peak:
                    self.peak, self.peak_seq = self.live, self.seq
        self.bytes += n
        return out

    def held_at_peak(self, tensors) -> int:
        """Bytes of ``tensors``' storages (created in the pass) that were
        live when the peak was reached."""
        total, done = 0, set()
        for t in _tensors(tensors):
            st = t.untyped_storage()
            size, seq = self._seen.get(st, (0, 0))
            if id(st) not in done and 0 < seq <= self.peak_seq:
                total += size
                done.add(id(st))
        return total


@dataclasses.dataclass
class Counts:
    """What one pass of a function counted (see :func:`count`)."""

    flops: int            # FlopCounterMode's total
    bytes: int            # operands + results of every op
    peak_live: int        # peak bytes of live storages the pass created
    out: object           # the function's result
    counter: _OpCounter = dataclasses.field(repr=False, default=None)

    def held_at_peak(self, tensors) -> int:
        return self.counter.held_at_peak(tensors)


def count(fn, *args) -> Counts:
    """Run ``fn(*args)`` once under a FLOP counter and a byte / live-bytes
    counter stacked: its FLOPs, bytes accessed and peak live bytes (the
    tensors in ``args`` are held before the pass and not counted)."""
    ops = _OpCounter(args)
    with FlopCounterMode(display=False) as fc, ops:
        out = fn(*args)
    return Counts(int(fc.get_total_flops()), ops.bytes, ops.peak, out, ops)


def count_flops(fn, *args) -> int:
    """FLOPs of ``fn(*args)`` (``FlopCounterMode``)."""
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return int(fc.get_total_flops())


def count_bytes(fn, *args) -> int:
    """Bytes of every op's tensor operands and results in ``fn(*args)``:
    a per-op sum with no fusion, an upper bound of the HBM traffic."""
    return count(fn, *args).bytes


def peak_live_bytes(fn, *args) -> int:
    """Peak bytes of the live tensors ``fn(*args)`` allocates."""
    return count(fn, *args).peak_live


# -- collectives -----------------------------------------------------------------

def _coll_dict(calls) -> dict:
    out: dict = {}
    for kind, _, nbytes in calls:
        out[kind] = out.get(kind, 0) + nbytes
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


class CollectiveRecorder:
    """Records each collective the step runs while the context is open:
    ``Mesh.all_sum`` and ``all_mean`` (kind ``all-reduce``, the operand's
    bytes), ``Mesh.all_gather`` (``all-gather``, the gathered result's
    bytes) and the EP exchange ``moe._all_to_all`` (``all-to-all``, the
    buffer's bytes).  A collective over one rank runs nothing and is not
    recorded.  ``calls`` holds ``(kind, axes, bytes)`` in order."""

    def __init__(self):
        self.calls: list[tuple[str, tuple, int]] = []
        self._saved = None

    def __enter__(self):
        rec = self.calls
        all_sum, all_gather = mesh_lib.Mesh.all_sum, mesh_lib.Mesh.all_gather
        a2a = moe._all_to_all

        def rec_sum(mesh, t, axes):
            if mesh.size(axes) > 1:
                rec.append(("all-reduce", tuple(axes), _nbytes(t)))
            return all_sum(mesh, t, axes)

        def rec_gather(mesh, t, axes):
            if mesh.size(axes) > 1:
                rec.append(("all-gather", tuple(axes),
                            _nbytes(t) * mesh.size(axes)))
            return all_gather(mesh, t, axes)

        def rec_a2a(x, group):
            if dist.get_world_size(group) > 1:
                rec.append(("all-to-all", ("data",), _nbytes(x)))
            return a2a(x, group)

        self._saved = (all_sum, all_gather, a2a)
        mesh_lib.Mesh.all_sum = rec_sum
        mesh_lib.Mesh.all_gather = rec_gather
        moe._all_to_all = rec_a2a
        return self

    def __exit__(self, *exc):
        (mesh_lib.Mesh.all_sum, mesh_lib.Mesh.all_gather,
         moe._all_to_all) = self._saved
        return False

    def bytes(self) -> dict:
        """Bytes by kind plus ``"total"``, the reference's shape."""
        return _coll_dict(self.calls)

    def counts(self) -> dict:
        out: dict = {}
        for kind, _, _ in self.calls:
            out[kind] = out.get(kind, 0) + 1
        return out


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def exchange_bytes(cfg, tokens: int, ep: int) -> int:
    """Bytes one rank's EP ``all_to_all`` moves in one direction of one MoE
    layer over ``tokens`` local tokens: the (ep, E / ep, cap, d) buffer,
    in the activations' dtype, which the parameters' promote to."""
    dt = torch.promote_types(torch.bfloat16, getattr(torch, cfg.param_dtype))
    return cfg.n_experts * moe.capacity(cfg, tokens) * cfg.d_model \
        * _itemsize(dt)


def step_collective_bytes(cfg, shape, mesh_shape: dict, fs_cfg, layout,
                          aggregate: str = "sketch",
                          sketch_mode: str = "gathered",
                          weighted: bool = False, params=None) -> dict:
    """The bytes one rank's train step moves by collective, by kind plus
    ``"total"``, from the configuration alone (what
    :class:`CollectiveRecorder` records of ``steps.make_train_step``):

    * the loss: one mean over the client axes;
    * ``sketch`` / ``flat`` / ``async``: one mean of the r x c table over
      the client axes; ``tree``: one per client axis; ``weighted`` adds a
      sum of the 4-byte weight beside each;
    * ``dense``: every leaf's gradient (the rank's local leaf), the EP
      leaves over the client axes other than ``data``; the table is the
      sketch of the mean and is not reduced;
    * ``model_local`` (with ``sketch``): the sum of the table over
      ``model`` first;
    * EP: each MoE layer's dispatch and return ``all_to_all``, in the
      forward and again in the backward.

    ``mesh_shape``: axis -> size; ``params``: the full tree on ``meta``
    (``steps.param_structs(cfg)``; built when needed and not given).
    """
    shape_of = dict(mesh_shape)
    client = tuple(a for a in ("pod", "data") if a in shape_of)

    def size(axes):
        return math.prod(shape_of[a] for a in axes)

    agg = "sketch" if aggregate == "flat" else aggregate
    table = fs_cfg.rows * fs_cfg.cols * 4
    calls = []
    if size(client) > 1:
        calls.append(("all-reduce", client, 4))                 # the loss
    if agg == "dense":
        if params is None:
            params = steps.param_structs(cfg)
        ds_axes = sharding.data_shard_axes(params, cfg, shape_of)
        n_data = shape_of.get("data", 1)
        for path, leaf in layout_lib.flatten(params):
            red = client if path not in ds_axes else tuple(
                a for a in client if a != "data")
            if size(red) > 1:
                n = _nbytes(leaf) // (n_data if path in ds_axes else 1)
                calls.append(("all-reduce", red, n))
    else:
        if agg == "sketch" and sketch_mode == "model_local" \
                and shape_of.get("model", 1) > 1:
            calls.append(("all-reduce", ("model",), table))
        merges = [client] if agg in ("sketch", "async") else \
            [(a,) for a in reversed(client)]
        for axes in merges:
            if size(axes) > 1:
                calls.append(("all-reduce", axes, table))
                if weighted:
                    calls.append(("all-reduce", axes, 4))
    if layout is not None and layout.has_ep:
        b = steps.local_batch_size(shape.global_batch, shape_of)
        one = exchange_bytes(cfg, b * shape.seq_len, shape_of["data"])
        n_moe = sum(s.moe for s in cfg.unit_pattern) * cfg.n_units
        calls += [("all-to-all", ("data",), one)] * (4 * n_moe)
    return _coll_dict(calls)


# -- the step's memory and bytes beyond the forward and backward ------------------

def kernel_scratch_bytes(fs_cfg, layout) -> int:
    """The sketch kernels' own scratch at the rank's largest chunk: the
    binned encode's records (``count_sketch.SOURCE_BINS``), or the fused
    estimate + selection's n-float scratch, its state words, tile counts
    and candidate list (``SOURCE_SELECT``) with the pool of every chunk's
    candidates."""
    rows, cols = fs_cfg.rows, fs_cfg.cols
    geo = count_sketch.SOURCE_BINS
    enc = 0
    for lc in layout.local_chunks:
        n = lc.size
        if geo.use(n, rows, cols):
            nbins = rows * geo.per_row(cols)
            enc = max(enc, nbins * geo.capacity(n, cols) * 6 + nbins * 4)
    sel = count_sketch.SOURCE_SELECT
    nall = layout.num_chunks
    est, pool = 0, 0
    for g in layout.groups:
        n = g.n_rows * g.row_len
        kk = topk_lib._chunk_k(fs_cfg.k, n, nall)
        est = max(est, n * 4 + sel.work_words(n) * 4 + sel.tiles(n) * 12
                  + sel.capacity(n, kk) * 8 + kk * 12)
        pool += len(g.chunk_ids) * kk * 20
    return max(enc, est + 2 * pool)


def view_copy_bytes(layout, grads_itemsize: dict) -> int:
    """Bytes of the permuted copies ``layout.leaf_views`` makes of the
    rank's gradient leaves for the sketch (an unpermuted leaf is a view)."""
    total = 0
    for path, shape, perm in zip(layout.leaf_paths,
                                 layout.leaf_local_shapes or
                                 layout.leaf_shapes, layout.leaf_perms):
        if perm is not None:
            total += math.prod(shape) * grads_itemsize[path]
    return total


def fetchsgd_bytes_estimate(fs_cfg, layout, grad_bytes: int) -> int:
    """HBM bytes of the sketch and the server step, analytic: the encode
    reads the rank's gradient once and the table twice; the estimate reads
    r buckets an id and writes and twice reads its 4-byte scratch over the
    whole layout; momentum_error reads three tables and writes two; the
    mean copies one."""
    table = fs_cfg.rows * fs_cfg.cols * 4
    return (grad_bytes + 2 * table
            + layout.total * (fs_cfg.rows + 3) * 4
            + 5 * table + 2 * table)
