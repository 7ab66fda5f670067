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
  (``Mesh.all_sum`` / ``all_mean`` / ``all_gather``, the EP exchange
  ``moe._all_to_all`` and the tensor-parallel ``tp._all_reduce`` /
  ``tp._all_gather`` / ``tp._all_to_all``), and
  :func:`step_collective_bytes` gives the same bytes of a train, prefill
  or decode step from its configuration alone, for a world that cannot
  run: the recorder is the formula's oracle.

The counters run the step as it is: its ``torch.utils.checkpoint``
regions too.  The non-reentrant checkpoint drops what a region saves
through saved-tensor hooks and recomputes it in the backward, under the
modes then active, so the live bytes count the recompute where the
backward makes it (``tests/test_torch_remat.py`` holds the count to
``MemTracker``).

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
from repro_torch.core import model_local
from repro_torch.core import topk as topk_lib
from repro_torch.kernels import count_sketch
from repro_torch.models import moe, sharding, ssm, tp, transformer, xlstm

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
    # sketch) is kept as a cross-check.  ``n_devices`` is every rank the
    # step's work divides over: the client ranks that split the batch
    # times, for a train step, the model ranks that split each layer.
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
    bytes), the EP exchange ``moe._all_to_all`` (``all-to-all``, the
    buffer's bytes) and the tensor-parallel ``tp._all_reduce``,
    ``tp._all_gather`` and ``tp._all_to_all`` (axes ``("model",)``; an
    exchange records the bytes the rank sends, its own share included).
    A collective over one rank runs nothing and is not recorded.
    ``calls`` holds ``(kind, axes, bytes)`` in order."""

    def __init__(self):
        self.calls: list[tuple[str, tuple, int]] = []
        self._saved = None

    def __enter__(self):
        rec = self.calls
        all_sum, all_gather = mesh_lib.Mesh.all_sum, mesh_lib.Mesh.all_gather
        a2a = moe._all_to_all
        tp_reduce, tp_gather = tp._all_reduce, tp._all_gather
        tp_a2a = tp._all_to_all

        def rec_tp_reduce(t, grp, *op):
            rec.append(("all-reduce", ("model",), _nbytes(t)))
            return tp_reduce(t, grp, *op)

        def rec_tp_gather(t, grp, dim):
            rec.append(("all-gather", ("model",),
                        _nbytes(t) * dist.get_world_size(grp)))
            return tp_gather(t, grp, dim)

        def rec_tp_a2a(t, grp, send, recv):
            rec.append(("all-to-all", ("model",), _nbytes(t)))
            return tp_a2a(t, grp, send, recv)

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

        self._saved = (all_sum, all_gather, a2a, tp_reduce, tp_gather,
                       tp_a2a)
        mesh_lib.Mesh.all_sum = rec_sum
        mesh_lib.Mesh.all_gather = rec_gather
        moe._all_to_all = rec_a2a
        tp._all_reduce, tp._all_gather = rec_tp_reduce, rec_tp_gather
        tp._all_to_all = rec_tp_a2a
        return self

    def __exit__(self, *exc):
        (mesh_lib.Mesh.all_sum, mesh_lib.Mesh.all_gather,
         moe._all_to_all, tp._all_reduce, tp._all_gather,
         tp._all_to_all) = self._saved
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


def model_collective_calls(cfg, shape, mesh_shape: dict,
                           remat: bool = True) -> list:
    """The collectives of one rank's forward and backward in the train
    step (``steps.make_train_step``'s ``grad_fn``), as ``(kind, axes,
    bytes)``: the tensor-parallel ones over ``model`` (``models/tp.py``)
    and the EP exchange over ``data``.  A checkpointed unit (``remat``)
    issues its forward collectives twice, in the forward and again in the
    recompute, but for the sum that ends it: the non-reentrant checkpoint
    stops its recompute at the last tensor a unit saves, the input of the
    last FFN's (or shared experts') down-projection; the backward's
    collectives run once.

    Over ``model`` (M ranks), each split by ``param_spec``'s rule:
    the vocab-parallel embedding's sum; the frontend projection gathered
    at use; each checkpointed unit's input gathered from its slice of
    ``d`` (forward) and its gradient's slices gathered (backward);
    head-parallel attention: the output projection's sum forward, the
    input's gradient sum backward (and the encoder output's, for
    cross-attention), K/V over head_dim gathered at use, replicated K/V
    and qk-norm scales' gradient sums; attention whose heads do not
    divide M: each split leaf gathered at use; the MLP and the shared
    experts: one sum each way; MoE experts split over their width: the
    experts' outputs summed forward, the tokens' gradient backward; the
    Megatron mamba: the channel exchange of ``in_proj``'s output both
    ways, ``x_proj``'s partial sum forward and its gradient's sum
    backward (per scan chunk with ``ssm_remat``, whose checkpointed
    chunks recompute once more), ``out_proj``'s sum forward and the
    input's gradient sum backward; the Megatron mLSTM: the channel
    exchange both ways, ``x`` gathered forward and its gradient summed
    backward, the gates' sum forward (and backward when split over
    heads), ``down``'s sum and the input's gradient sum; split over
    ``dh``, also q, k and v gathered forward and q's and k's gradients
    summed backward, per chunk the scores, reads and normalizers summed
    forward and the replicated tensors' gradients summed backward (the
    last chunk's state feeds nothing, so two of them), and ``y``'s
    gradient gathered; each loss chunk's max, sum of exponentials and
    gold logit forward and its input's gradient backward.
    """
    shape_of = dict(mesh_shape)
    M = shape_of.get("model", 1)
    b = steps.local_batch_size(shape.global_batch, shape_of)
    S = shape.seq_len
    P = cfg.n_patches if cfg.frontend == "vision" else 0
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pdt = getattr(torch, cfg.param_dtype)
    pb = _itemsize(pdt)
    ab = _itemsize(torch.promote_types(transformer.RESIDUAL_DTYPE, pdt))
    rb = _itemsize(transformer.RESIDUAL_DTYPE)
    fwd = 2 if remat else 1
    calls: list = []

    def div(n):
        return M > 1 and n % M == 0

    def ar(n, times=1):
        calls.extend([("all-reduce", ("model",), n)] * times)

    def ag(n, times=1):
        calls.extend([("all-gather", ("model",), n)] * times)

    def attn(n_tok, a, times, qk_norm, kv=None):
        kv_split = "kv" if div(KV) else None if cfg.qk_norm else \
            "hd" if div(hd) else None
        if div(H):                                  # head-parallel
            ar(n_tok * d * a, times)
            if kv_split == "hd":
                ag(d * KV * hd * pb, 2 * times)
            ar(n_tok * d * a)
            if kv is not None:
                ar(kv[0] * d * kv[1])
            if kv_split != "kv":
                ar(d * KV * hd * pb, 2)
            if qk_norm:
                ar(hd * pb, 2)
        elif div(hd):                               # whole, gathered
            ag(d * H * hd * pb, times)
            if kv_split == "hd":
                ag(d * KV * hd * pb, 2 * times)
            ag(H * hd * d * pb, times)

    def mlp(n_tok, a, width, times):
        if div(width):
            ar(n_tok * d * a, times)
            ar(n_tok * d * a)

    ep = shape_of.get("data", 1) if cfg.shard_experts_data and \
        cfg.n_experts and cfg.n_experts % shape_of.get("data", 1) == 0 \
        and shape_of.get("data", 1) > 1 else 1

    def moe_ffn(n_tok, times, shared_times):
        ffe = cfg.moe_d_ff or cfg.d_ff
        if div(ffe):
            ar(cfg.n_experts * moe.capacity(cfg, n_tok) * d * ab, times)
            ar(n_tok * d * ab)
        if cfg.n_shared_experts:
            mlp(n_tok, ab, cfg.n_shared_experts * ffe, shared_times)
        if ep > 1:
            calls.extend([("all-to-all", ("data",),
                           exchange_bytes(cfg, n_tok, ep))] * (2 * times + 2))

    def a2a(n, times=1):
        calls.extend([("all-to-all", ("model",), n)] * times)

    di, mi = cfg.d_inner, int(d * cfg.xlstm_proj_factor)

    def mamba(b, S, a, times):
        dbc = cfg.dt_rank + 2 * cfg.ssm_d_state
        a2a(b * S * 2 * (di // M) * a, times + 1)
        ar(b * S * d * a, times + 1)
        if cfg.ssm_remat:                  # x_proj's sum in each chunk
            c = min(ssm.SSM_CHUNK, S)
            ar(b * c * dbc * a, -(-S // c) * (times + 2))
        else:
            ar(b * S * dbc * a, times + 1)

    def mlstm(b, S, a, times):
        n = b * S
        a2a(n * 2 * (mi // M) * a, times + 1)
        ag(n * mi * a, times)
        ar(n * mi * a)                     # x's gradient
        ar(n * 2 * H * 4, times + (1 if div(H) else 0))
        ar(n * d * a, times + 1)
        if not div(H):                     # split over dh
            ag(n * mi * a, 3 * times)
            ar(n * mi * a, 2)              # q's and k's gradients
            c = min(xlstm.MLSTM_CHUNK, S)
            n_ch = -(-S // c)
            ar(b * c * c * H * 4, n_ch * (times + 1))
            ar(b * c * mi * 4, n_ch * times + n_ch - 1)
            ar(b * c * H * 4, n_ch * times)
            ar(b * c * H * 4, n_ch + 2 * (n_ch - 1))
            ag(n * mi * 4)                 # y's gradient

    if M > 1:
        if div(cfg.vocab):                            # the embedding
            ar(b * (S - P) * d * pb)
        if cfg.frontend in ("audio", "vision") and div(d):
            ag(d * d * pb)
    if cfg.is_encdec:
        eb = _itemsize(torch.promote_types(torch.float32, pdt))
        for _ in range(cfg.enc_layers):
            attn(b * cfg.enc_seq, eb, 1, False)
            mlp(b * cfg.enc_seq, eb, cfg.d_ff, 1)
    for _ in range(cfg.n_units):
        if remat and div(d):
            ag(b * S * d * rb, fwd + 1)
        for i, spec in enumerate(cfg.unit_pattern):
            # the recompute stops before the unit's last sum
            last = 1 if i == len(cfg.unit_pattern) - 1 else fwd
            if spec.kind == "attn":
                attn(b * S, ab, fwd, cfg.qk_norm)
                if cfg.is_encdec:
                    attn(b * S, ab, fwd, False,
                         kv=(b * cfg.enc_seq, eb))
            elif spec.kind == "mamba" and div(di):
                mamba(b, S, ab, fwd)
            elif spec.kind == "mlstm" and div(mi):
                mlstm(b, S, ab, fwd)
            if spec.ffn:
                if spec.moe:
                    moe_ffn(b * S, fwd, last)
                else:
                    mlp(b * S, ab, cfg.d_ff, last)
    if div(cfg.vocab):                                # the loss chunks
        xb = _itemsize(torch.promote_types(transformer.RESIDUAL_DTYPE, pdt))
        for s0 in range(0, S - P, cfg.loss_chunk):
            c = min(cfg.loss_chunk, S - P - s0)
            ar(b * c * 4, 3 * fwd)
            ar(b * c * d * xb)
    return calls


def serve_collective_calls(cfg, shape, mesh_shape: dict) -> list:
    """The collectives of one rank's prefill or decode in the serve steps
    (``steps.make_prefill_step`` / ``make_decode_step``, the forward only,
    tensor-parallel over ``model``), as ``(kind, axes, bytes)``; the
    activations are in the parameters' dtype.

    Prefill runs the train path's forms (the vocab-parallel embedding's
    sum; the frontend projection gathered; the whisper encoder; attention
    head-parallel, its output summed, K/V weights over head_dim gathered,
    or every split leaf gathered when the heads do not divide the group;
    the MLP's and the shared experts' sums, the experts' outputs summed,
    the EP exchange), then per block:

    * mamba: the channel exchange of ``in_proj``'s output, ``x_proj``'s
      partial sum and ``out_proj``'s;
    * the mLSTM: the channel exchange of ``up``'s output, ``x`` gathered,
      the gates' partial sum and ``down``'s; split over ``dh``, also q, k
      and v gathered and, per chunk, the scores, the read of ``C`` and
      the normalizer summed;
    * decode's attention against a head_dim-split cache: q regrouped from
      the rank's heads (or gathered for RoPE or qk-norm from its
      head_dim shard), k gathered for RoPE from its head_dim shard, the
      partial scores ``(B, H, 1, cap)`` in float32 summed, the output
      regrouped back to the rank's heads (for a ``wo`` over heads) and
      summed after ``wo``; against kv heads: the output's sum;
    * decode's sLSTM: its four states gathered;

    and the logits gathered over vocab.
    """
    shape_of = dict(mesh_shape)
    M = shape_of.get("model", 1)
    if M == 1:
        return []
    b = steps.local_batch_size(shape.global_batch, shape_of)
    decode = shape.kind == "decode"
    S = 1 if decode else shape.seq_len
    P = cfg.n_patches if cfg.frontend == "vision" and not decode else 0
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pdt = getattr(torch, cfg.param_dtype)
    pb = _itemsize(pdt)
    calls: list = []

    def div(n):
        return n % M == 0

    def ar(n, times=1):
        calls.extend([("all-reduce", ("model",), n)] * times)

    def ag(n, times=1):
        calls.extend([("all-gather", ("model",), n)] * times)

    def a2a(n):
        calls.append(("all-to-all", ("model",), n))

    # wk / wv split over head_dim by param_spec
    wk_hd = not div(KV) and not cfg.qk_norm and div(hd)

    def attn_train(n_tok, a):
        """The train path's forward (prefill, the encoder)."""
        if div(H):
            ar(n_tok * d * a)
            if wk_hd:
                ag(d * KV * hd * pb, 2)
        elif div(hd):
            ag(d * H * hd * pb)
            if wk_hd:
                ag(d * KV * hd * pb, 2)
            ag(H * hd * d * pb)

    def attn_decode(n_keys, rope_or_norm, k_hd):
        if div(KV):                                # the rank's kv heads
            ar(b * d * pb)
        elif div(hd):                              # the rank's head_dim
            if div(H):
                a2a(b * (H // M) * hd * pb)
            elif rope_or_norm:
                ag(b * H * hd * pb)
            if k_hd:
                ag(b * KV * hd * pb)
            ar(b * H * n_keys * 4)
            if div(H):
                a2a(b * H * (hd // M) * pb)
            ar(b * d * pb)
        elif div(H):
            ar(b * d * pb)

    def mlp(n_tok, width, a=pb):
        if div(width):
            ar(n_tok * d * a)

    ep = shape_of.get("data", 1) if cfg.shard_experts_data and \
        cfg.n_experts and cfg.n_experts % shape_of.get("data", 1) == 0 \
        and shape_of.get("data", 1) > 1 else 1

    def moe_ffn(n_tok):
        ffe = cfg.moe_d_ff or cfg.d_ff
        if div(ffe):
            ar(cfg.n_experts * moe.capacity(cfg, n_tok) * d * pb)
        if cfg.n_shared_experts:
            mlp(n_tok, cfg.n_shared_experts * ffe)
        if ep > 1:
            calls.extend([("all-to-all", ("data",),
                           exchange_bytes(cfg, n_tok, ep))] * 2)

    if div(cfg.vocab):                              # the embedding
        ar(b * (S - P) * d * pb)
    if not decode:
        if cfg.frontend in ("audio", "vision") and div(d):
            ag(d * d * pb)
        if cfg.is_encdec:
            eb = _itemsize(torch.promote_types(torch.float32, pdt))
            for _ in range(cfg.enc_layers):
                attn_train(b * cfg.enc_seq, eb)
                mlp(b * cfg.enc_seq, cfg.d_ff, eb)
    cap = min(shape.seq_len, cfg.sliding_window) if cfg.sliding_window \
        else shape.seq_len
    di, mi = cfg.d_inner, int(d * cfg.xlstm_proj_factor)
    n = b * S
    for _ in range(cfg.n_units):
        for spec in cfg.unit_pattern:
            if spec.kind == "attn":
                if decode:
                    attn_decode(cap, True, wk_hd)
                    if cfg.is_encdec:
                        attn_decode(cfg.enc_seq, False, False)
                else:
                    attn_train(n, pb)
                    if cfg.is_encdec:
                        attn_train(n, pb)
            elif spec.kind == "mamba" and div(di):
                a2a(n * 2 * (di // M) * pb)
                ar(n * (cfg.dt_rank + 2 * cfg.ssm_d_state) * pb)
                ar(n * d * pb)
            elif spec.kind == "mlstm" and div(mi):
                a2a(n * 2 * (mi // M) * pb)
                ag(n * mi * pb)
                ar(n * 2 * H * 4)
                if not div(H):                      # split over dh
                    ag(n * mi * pb, 3)
                    c = min(xlstm.MLSTM_CHUNK, S)
                    for _ in range(-(-S // c)):
                        ar(b * c * c * H * 4)
                        ar(b * c * mi * 4)
                        ar(b * c * H * 4)
                ar(n * d * pb)
            elif spec.kind == "slstm" and decode and div(d // H):
                ag(b * d * 4, 4)
            if spec.ffn:
                if spec.moe:
                    moe_ffn(n)
                else:
                    mlp(n, cfg.d_ff)
    if div(cfg.vocab):                              # the logits
        ag(b * cfg.vocab * pb)
    return calls


def step_collective_bytes(cfg, shape, mesh_shape: dict, fs_cfg, layout,
                          aggregate: str = "sketch",
                          sketch_mode: str = "gathered",
                          weighted: bool = False, params=None) -> dict:
    """The bytes one rank's step moves by collective, by kind plus
    ``"total"``, from the configuration alone (what
    :class:`CollectiveRecorder` records of ``steps.make_train_step``, or
    of the serve steps for a prefill or decode ``shape``: their
    :func:`serve_collective_calls` and the logits gathered over the
    client axes when the batch is split; ``fs_cfg`` and ``layout`` are
    then not read).  A train step's:

    * the forward and backward's (:func:`model_collective_calls`): the
      tensor-parallel ones over ``model`` and the EP exchange, each MoE
      layer's dispatch and return ``all_to_all`` in the forward, the
      recompute and the backward;
    * the loss: one mean over the client axes;
    * ``sketch`` / ``flat`` / ``async``: one mean of the r x c table over
      the client axes; ``tree``: one per client axis; ``weighted`` adds a
      sum of the 4-byte weight beside each;
    * ``dense``: every leaf's gradient (the rank's local leaf), the EP
      leaves over the client axes other than ``data``; the table is the
      sketch of the mean and is not reduced;
    * gathered sketches on a model axis of more than one rank: each local
      chunk of a tensor-parallel leaf gathered over ``model`` (its
      column-split rows) or summed over it (row-split rows);
    * ``model_local`` (with ``sketch``): the sum of the table over
      ``model`` first.

    ``mesh_shape``: axis -> size; ``params``: the full tree on ``meta``
    (``steps.param_structs(cfg)``; built when needed and not given).
    """
    shape_of = dict(mesh_shape)
    client = tuple(a for a in ("pod", "data") if a in shape_of)
    M = shape_of.get("model", 1)

    def size(axes):
        return math.prod(shape_of[a] for a in axes)

    if shape.kind != "train":
        calls = serve_collective_calls(cfg, shape, shape_of)
        b = steps.local_batch_size(shape.global_batch, shape_of)
        if b != shape.global_batch:               # the logits, whole
            calls.append(("all-gather", client, shape.global_batch
                          * cfg.vocab * _itemsize(getattr(
                              torch, cfg.param_dtype))))
        return _coll_dict(calls)
    agg = "sketch" if aggregate == "flat" else aggregate
    table = fs_cfg.rows * fs_cfg.cols * 4
    calls = model_collective_calls(cfg, shape, shape_of)
    if size(client) > 1:
        calls.append(("all-reduce", client, 4))                 # the loss
    if params is None and (agg == "dense" or M > 1):
        params = steps.param_structs(cfg)
    if agg == "dense":
        ds_axes = sharding.data_shard_axes(params, cfg, shape_of)
        ms_axes = sharding.model_shard_axes(params, cfg, shape_of)
        n_data = shape_of.get("data", 1)
        for path, leaf in layout_lib.flatten(params):
            red = client if path not in ds_axes else tuple(
                a for a in client if a != "data")
            if size(red) > 1:
                n = _nbytes(leaf) // (n_data if path in ds_axes else 1) \
                    // (M if path in ms_axes else 1)
                calls.append(("all-reduce", red, n))
    if M > 1 and not (agg == "sketch" and sketch_mode == "model_local"):
        calls += _gather_calls(cfg, shape_of, layout, params)
    if agg != "dense":
        if agg == "sketch" and sketch_mode == "model_local" and M > 1:
            calls.append(("all-reduce", ("model",), table))
        merges = [client] if agg in ("sketch", "async") else \
            [(a,) for a in reversed(client)]
        for axes in merges:
            if size(axes) > 1:
                calls.append(("all-reduce", axes, table))
                if weighted:
                    calls.append(("all-reduce", axes, 4))
    return _coll_dict(calls)


def _gather_calls(cfg, shape_of: dict, layout, params) -> list:
    """The gathered sketch's collectives over ``model``: one a local
    chunk of a tensor-parallel leaf (``model_local.gathered_values``)."""
    _, modes, _ = sharding.layout_view_plan(params, cfg, shape_of)
    plan = model_local.build_plan(layout, modes, tp=shape_of["model"])
    sizes = [t.element_size() for _, t in layout_lib.flatten(params)]
    calls = []
    for lc in layout.local_chunks:
        split = model_local.split_of(layout, plan, lc.leaf)
        if split is not None:
            calls.append(("all-gather" if split == "cols" else "all-reduce",
                          ("model",), lc.size * sizes[lc.leaf]))
    return calls


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


def view_copy_bytes(layout, grads: dict) -> int:
    """Bytes of the permuted copies the sketch makes of the rank's
    gradient leaves (``grads``, its local tree: model shards, EP slices)
    when it views them in 2-D (an unpermuted leaf is a view)."""
    return sum(_nbytes(g) for (_, g), perm in zip(layout_lib.flatten(grads),
                                                   layout.leaf_perms)
               if perm is not None)


def gather_scratch_bytes(layout, plan, grads: dict) -> int:
    """The gathered sketch's buffers at its largest chunk of a
    tensor-parallel leaf (``model_local.gathered_values``): the gathered
    pieces and their join, or the zero-padded rows and their sum; 0 with
    no model split."""
    if plan is None or plan.tp == 1:
        return 0
    sizes = [g.element_size() for _, g in layout_lib.flatten(grads)]
    return max((2 * lc.size * sizes[lc.leaf] for lc in layout.local_chunks
                if model_local.split_of(layout, plan, lc.leaf) is not None),
               default=0)


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
