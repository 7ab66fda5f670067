"""Round orchestration: cohorts, dropout, stragglers, aggregation, resume.

Port of ``repro.fed.orchestrator``.  The orchestrator
owns the outer federated loop: sample a (possibly variable-size) cohort,
compute per-client sketches, push them through a pluggable
``Aggregator``, run the server update, and keep the communication ledger.
On top it adds the failure modes real federations see:

* **dropout** — a sampled client never reports (its sketch is lost);
* **stragglers** — a sampled client reports ``delay`` rounds late.  Under
  flat/tree aggregation the synchronous round barrier misses it (counted
  as dropped); under async aggregation it lands in the buffer and is
  merged later with a staleness-discounted weight.

Two clocks drive the loop (``FederationConfig.clock``):

* ``"round"`` — the classic barrier loop: round r waits for round r's
  cohort, staleness is counted in round indices.
* ``"event"`` — a discrete-event virtual clock (``fed.simtime``): each
  client's upload is a timed event (``finish = next_available(now) +
  compute_seconds + table_bytes / bandwidth`` from its heterogeneity
  profile), the server merges on *arrival order*, and staleness is
  measured in virtual seconds (discount ``exp(-lambda * age)``).  Under
  flat/tree the round barrier sits at the cohort's slowest upload; under
  async the server updates every ``quorum`` arrivals while slower uploads
  from older rounds are still in flight.

``vectorized=True`` is the population-scale path: profiles come as
``PopulationModel`` columns, a round-clock cohort is computed in chunks
of ``COHORT_CHUNK`` clients and folded as it appears, and an event-clock
cohort is dispatched as *lazy* events (metadata only) whose gradients are
computed when they arrive, against a copy of the weights they were
dispatched with.  Vectorized and per-object runs give byte-identical
``RoundRecord``s on the CPU.

Cohorts, fates and profiles are drawn with numpy exactly as the reference
draws them, and the virtual clock does the reference's float64
operations, so every ``RoundRecord`` field but the loss is a pure
function of the seed and the configuration, equal to the reference's on
any device.

One encoder serves every client of a run: on the CPU the gather-plan
encoder (``core.gather_sketch``, the reference's choice), on the card
``core.fetchsgd.sketch_grads`` (the encode kernel).  Two runs on the card
can differ in the last bits: the encode kernel's float atomics sum in no
fixed order.

The loop over a round's clients waits for the device nowhere: a batch goes
up from pinned memory without blocking (``data.federated.to_batch``), and
each client's loss stays on the device until the round, or a vectorized
chunk, reads them all at once.  So on the card the host dispatches the
next client's gradient while the device still runs this client's sketch.

Checkpoints (``checkpoint_dir``, ``fed.checkpoint``) hold the weights,
the server state, the async late buffer and, on the event clock, the
virtual clock and the in-flight events (lazy ones computed for the save),
so a resumed run replays the uninterrupted one: byte for byte on the CPU;
on the card every record field but the loss, and losses within the
encode's reordered float sums.

Telemetry (``telemetry=``, ``repro_torch.obs``) is read-only: round and
sketch-health events, ``fed.*`` / ``event.*`` / ``agg.*`` instruments and
the spans ``fed.round``, ``fed.clients``, ``fed.dispatch``,
``fed.aggregate`` and ``fed.server_update``, and for every client
computed, on every path, ``fed.client.batch`` (its batch, copied to the
device), ``fed.client.grad`` (forward, backward and gradient assembly) and
``fed.client.sketch``, each with the client's id as ``client``.  It draws
from no RNG and changes no order, so an instrumented run's records equal
an uninstrumented one's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core import compression, fetchsgd as F
from repro_torch.core import gather_sketch
from repro_torch.core import layout as layout_lib
from repro_torch.data import federated
from repro_torch.models import transformer
from repro_torch.optim import triangular

from . import aggregator as agg_lib
from . import checkpoint as ckpt_lib
from . import simtime as simtime_lib


@dataclasses.dataclass(frozen=True)
class StragglerModel:
    """Per-client failure model, sampled i.i.d. each round."""

    dropout_prob: float = 0.0    # client never reports
    straggle_prob: float = 0.0   # client reports late
    max_delay: int = 3           # late arrival delay ~ uniform[1, max_delay]

    def __post_init__(self):
        if self.dropout_prob + self.straggle_prob > 1.0:
            raise ValueError("dropout_prob + straggle_prob must be <= 1")
        if self.max_delay < 1:
            raise ValueError("max_delay must be >= 1")


@dataclasses.dataclass(frozen=True)
class FederationConfig:
    """Static configuration of a federated run (the reference's fields)."""

    rounds: int = 30
    clients_per_round: int = 4
    min_clients_per_round: int | None = None  # variable cohort if set
    aggregate: str = "flat"                   # flat | tree | async
    tree_fanout: int = 4
    staleness_discount: float = 0.9
    max_staleness: int = 8
    straggler: StragglerModel = StragglerModel()
    clock: str = "round"                      # round | event (fed.simtime)
    simtime: simtime_lib.SimTimeConfig | None = None   # event-clock knobs
                                              # (round clock reads only the
                                              # heterogeneity profiles)
    weight_by: str = "uniform"                # uniform | samples | profile
    seed: int = 0
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0                 # 0 = only if dir set: final round
    vectorized: bool = False                  # population-scale loop: batched
                                              # dispatch (+ lazy events under
                                              # the event clock)

    def __post_init__(self):
        if self.clock not in ("round", "event"):
            raise ValueError(
                f"clock must be 'round'|'event', got {self.clock}")
        if self.weight_by not in ("uniform", "samples", "profile"):
            raise ValueError(f"unknown weight_by {self.weight_by!r}")


@dataclasses.dataclass
class RoundRecord:
    """What actually happened in one round."""

    round_idx: int
    cohort: list[int]
    loss: float | None
    n_fresh: int
    n_late: int
    n_dropped: int
    n_straggling: int     # round clock: produced this round, arriving
                          # later; event clock: uploads still in flight
    upload_bytes: int
    t_dispatch: float | None = None   # event clock: cohort send time
    t_virtual: float | None = None    # event clock: server update time
    critical_path_s: float = 0.0      # wall-clock critical path of the merge


@dataclasses.dataclass
class FedRunResult:
    losses: list            # per-round mean client loss (None if no clients)
    records: list           # RoundRecord per round
    traffic: dict           # TrafficMeter.compression(...)
    params: Any
    opt_state: F.FetchSGDState
    extras: dict


def make_grad_fn(cfg) -> Callable:
    """(params, batch) -> (loss, grads) for the transformer LM; the loss
    is the cross entropy plus the MoE routers' aux term, as the
    reference's, without ``remat`` as the reference's clients run it."""
    return lambda params, batch: transformer.value_and_grad(
        params, batch, cfg, remat=False)


# Clients materialized per sweep of the vectorized loops: the lazy events
# of one dispatch round that arrive together are computed COHORT_CHUNK at a
# time, and the aggregator folds each table before the next sweep.
COHORT_CHUNK = 16


def _add_weighted(acc, grads: dict, w: float):
    """acc + w * grads over a parameter tree (acc None: w * grads)."""
    wg = layout_lib.tree_map(lambda g: w * g, grads)
    return wg if acc is None else layout_lib.tree_map(torch.add, acc, wg)


def _floats(losses: list) -> list[float]:
    """Clients' 0-dim device losses as Python floats, in one read: a
    float32 scalar gives the same float through ``tolist`` as through
    ``float``."""
    return torch.stack(losses).tolist() if losses else []


def _round_rng(seed: int, round_idx: int,
               stream: int = 0) -> np.random.Generator:
    # tuple entropy goes through SeedSequence mixing: cohort sizing and
    # client fates use distinct streams so the two draws never correlate
    return np.random.default_rng((seed, round_idx, stream))


class Orchestrator:
    """Drives multi-round FetchSGD training through an aggregation policy.

    Runs on ``device`` (``cuda`` unless asked otherwise); ``params``, when
    given, lie there already and are updated in place — unless a
    checkpoint in ``fed_cfg.checkpoint_dir`` replaces them.
    """

    def __init__(self, model_cfg, fs_cfg: F.FetchSGDConfig,
                 fed_cfg: FederationConfig, dataset, *,
                 params=None, lr_fn: Callable | None = None,
                 peak_lr: float = 0.2, grad_fn: Callable | None = None,
                 device=None, telemetry=None, health_every: int = 1):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.tele = telemetry if telemetry is not None else obs.NOOP
        self.health_every = health_every
        self._wall0: float | None = None   # first round's wall clock (the
                                           # event clock's virtual/wall ratio)
        self.fs_cfg = fs_cfg
        self.fed_cfg = fed_cfg
        self.dataset = dataset
        self.params = (params if params is not None else
                       transformer.init_params(model_cfg, fed_cfg.seed,
                                               self.device))
        self.layout = layout_lib.build_layout(self.params)
        self.opt_state = F.init_state(fs_cfg, self.device)
        self.start_round = 0
        self.lr_fn = lr_fn or triangular(peak_lr, fed_cfg.rounds)
        self.grad_fn = grad_fn or make_grad_fn(model_cfg)
        self.is_event = fed_cfg.clock == "event"
        self.vectorized = fed_cfg.vectorized
        self.sim_cfg = fed_cfg.simtime or simtime_lib.SimTimeConfig()
        if self.is_event:
            n_clients = getattr(dataset, "n_clients", 0)
            if n_clients < 1:
                raise ValueError("event-clock federation needs a dataset "
                                 "with n_clients >= 1 (empty population)")
            if fed_cfg.clients_per_round > n_clients:
                raise ValueError(
                    f"cohort of {fed_cfg.clients_per_round} clients exceeds "
                    f"the population of {n_clients} — shrink "
                    f"clients_per_round or grow the population")
        self.het = (simtime_lib.HeterogeneityModel(
                        self.sim_cfg.heterogeneity, fed_cfg.seed)
                    if self.is_event or fed_cfg.weight_by == "profile"
                    else None)
        # population-scale path: batched profile columns + bucketed queue
        # (one heap entry per *bucket*, not per client)
        self.pop = (simtime_lib.PopulationModel(
                        self.sim_cfg.heterogeneity, fed_cfg.seed)
                    if self.vectorized else None)
        self._queue = (simtime_lib.BucketedEventQueue(
                           self.sim_cfg.queue_bucket_s)
                       if self.vectorized and self.is_event
                       else simtime_lib.EventQueue())
        self._now = 0.0
        # weights that in-flight lazy events were dispatched with, keyed by
        # dispatch round and refcounted, so server memory stays O(active
        # rounds).  A copy, not a reference: the server update changes
        # ``self.params`` in place.
        self._snapshots: dict[int, dict] = {}
        self._snap_refs: dict[int, int] = {}
        self.aggregator = agg_lib.make_aggregator(
            fed_cfg.aggregate, fs_cfg, fanout=fed_cfg.tree_fanout,
            discount=fed_cfg.staleness_discount,
            max_staleness=fed_cfg.max_staleness,
            staleness_lambda=(self.sim_cfg.staleness_lambda
                              if self.is_event else None),
            max_age=self.sim_cfg.max_age if self.is_event else None,
            link_bandwidth=(self.sim_cfg.link_bandwidth
                            if self.is_event else None),
            device=self.device, telemetry=self.tele)
        self.meter = compression.TrafficMeter(d=self.layout.total)
        lay = self.layout
        # every path (round clock, per-object event, chunked cohort) encodes
        # through this one function, which is what makes vectorized and
        # per-object runs byte-identical on the CPU
        self._sketch = (gather_sketch.build_encoder(lay, fs_cfg)
                        if self.device.type == "cpu" else
                        (lambda g: F.sketch_grads(g, lay, fs_cfg)))

        if fed_cfg.checkpoint_dir:
            restored = ckpt_lib.restore(fed_cfg.checkpoint_dir, self.params,
                                        self.opt_state)
            if restored is not None:
                self._check_profile_stream(restored.extra)
                self.params = restored.params
                self.opt_state = restored.opt_state
                self.start_round = restored.round_idx + 1
                if self._is_async:
                    self.aggregator.load_state(restored.late_buffer)
                if restored.simtime is not None:
                    self._now = float(restored.simtime["now"])
                    self._queue.load_state(restored.simtime["events"])

    def _check_profile_stream(self, extra: dict) -> None:
        """Refuse a resume whose profile rng stream differs from the
        checkpoint's: every profile, and so every fate and finish time,
        would diverge from the saved run.  Checkpoints without a
        ``profile_stream`` key were written under the legacy stream.
        """
        if self.het is None and self.pop is None:
            return   # run never samples profiles: the stream is irrelevant
        saved = extra.get("profile_stream", "legacy")
        want = self.sim_cfg.heterogeneity.profile_stream
        if saved != want:
            raise ValueError(
                f"checkpoint in {self.fed_cfg.checkpoint_dir!r} was written "
                f"with profile_stream={saved!r} but this run is configured "
                f"with profile_stream={want!r} — resuming would resample "
                f"every client profile from a different stream. Pass "
                f"--profile-stream {saved} (HeterogeneityConfig("
                f"profile_stream={saved!r})) to resume, or start a fresh "
                f"checkpoint directory.")

    @property
    def _is_async(self) -> bool:
        return isinstance(self.aggregator, agg_lib.AsyncBufferedAggregator)

    @property
    def held_snapshots(self) -> int:
        """Weight copies held for lazy events still in flight."""
        return len(self._snapshots)

    # -- per-round pieces ---------------------------------------------------

    def _cohort(self, r: int) -> np.ndarray:
        fc = self.fed_cfg
        w = fc.clients_per_round
        if fc.min_clients_per_round is not None:
            w = int(_round_rng(fc.seed, r).integers(
                fc.min_clients_per_round, fc.clients_per_round + 1))
        return federated.sample_clients(self.dataset.n_clients, w, r, fc.seed)

    def _fates(self, rng: np.random.Generator,
               n: int) -> tuple[np.ndarray, np.ndarray]:
        """Whole-cohort client fates: (codes, delays).

        ``codes[i]``: 0 fresh, 1 late (``delays[i]`` rounds), 2 dropped —
        one uniform draw for the cohort, one delay draw for the late
        subset, as the reference draws them.  Every path shares this draw.
        """
        sm = self.fed_cfg.straggler
        u = rng.random(n)
        codes = np.zeros(n, np.int8)
        codes[u < sm.dropout_prob + sm.straggle_prob] = 1
        codes[u < sm.dropout_prob] = 2
        delays = np.zeros(n, np.int64)
        late = codes == 1
        if late.any():
            delays[late] = rng.integers(1, sm.max_delay + 1,
                                        size=int(late.sum()))
        return codes, delays

    def _client_batch(self, c: int) -> dict:
        return federated.to_batch(self.dataset.client_batch(c), self.device)

    def _client_work(self, params: dict, c: int) -> tuple:
        """(batch, loss, grads, table) of client ``c`` against ``params``,
        each step in its ``fed.client.*`` span (the gradient's with the
        model's block spans inside); the loss stays on the device.
        Callers drop the batch and gradients before the next client's, as
        the peak memory is the backward pass's."""
        span = self.tele.span
        with span("fed.client.batch", client=c):
            batch = self._client_batch(c)
        # the model's block spans only: kernel spans (sketch, server step)
        # are the run owner's choice, by its own obs.active
        with span("fed.client.grad", client=c), obs.active(self.tele):
            loss, grads = self.grad_fn(params, batch)
        with span("fed.client.sketch", client=c):
            table = self._sketch(grads)
        return batch, loss, grads, table

    def _client_weight(self, c: int, batch: dict) -> float:
        """FedSKETCH-style per-client merge weight (exact by linearity)."""
        wb = self.fed_cfg.weight_by
        if wb == "samples":
            return float(len(batch["tokens"]))
        if wb == "profile":
            return self.het.profile(c).weight
        return 1.0

    def _client_weights_vec(self, ids: np.ndarray,
                            cols: dict) -> np.ndarray:
        """Batched ``_client_weight``: same values, no per-client batches."""
        wb = self.fed_cfg.weight_by
        if wb == "profile":
            return cols["weight"]
        if wb == "samples":
            spc = getattr(self.dataset, "samples_per_client", None)
            if spc is not None:
                return np.full(len(ids), float(spc))
            return np.array([float(len(self.dataset.client_batch(int(c))
                                       ["tokens"])) for c in ids])
        return np.ones(len(ids))

    def _record_traffic(self, upload_bytes: int,
                        n_participating: int) -> dict:
        """Charge this round's bytes to the meter and return the round's
        accounting (the telemetry's ``round`` event fields).

        Paper accounting (``compression.fetchsgd_round``, Sec. 5): the
        download is k values at 4 bytes each per participating client.
        The dense-equivalent fields are what uncompressed SGD would have
        moved for the same participation (d float32 values each way per
        client).
        """
        per_client_down = compression.fetchsgd_round(
            self.fs_cfg.rows, self.fs_cfg.cols, self.fs_cfg.k).download
        download = per_client_down * n_participating
        self.meter.record(compression.RoundTraffic(
            upload=upload_bytes, download=download), clients=1)
        dense_each = self.layout.total * 4 * n_participating
        return {
            "upload_bytes": int(upload_bytes),
            "download_bytes": int(download),
            "dense_equiv_upload_bytes": int(dense_each),
            "dense_equiv_download_bytes": int(dense_each),
            "upload_compression_x": dense_each / max(upload_bytes, 1),
            "total_compression_x": (2 * dense_each
                                    / max(upload_bytes + download, 1)),
        }

    # -- telemetry (read-only; no-ops when ``self.tele`` is obs.NOOP) -------

    def _emit_round(self, rec: RoundRecord, stats, traffic: dict) -> None:
        tele = self.tele
        if not tele.enabled:
            return
        ev = dict(round=rec.round_idx, loss=rec.loss,
                  cohort_size=len(rec.cohort), n_fresh=rec.n_fresh,
                  n_late=rec.n_late, n_dropped=rec.n_dropped,
                  n_straggling=rec.n_straggling, policy=stats.policy,
                  total_weight=stats.total_weight,
                  root_ingress_tables=stats.root_ingress_tables, **traffic)
        tele.counter("fed.rounds").inc()
        tele.counter("fed.upload_bytes").inc(traffic["upload_bytes"])
        tele.counter("fed.download_bytes").inc(traffic["download_bytes"])
        tele.counter("fed.clients.dropped").inc(rec.n_dropped)
        tele.counter("fed.clients.fresh").inc(rec.n_fresh)
        tele.counter("fed.clients.late").inc(rec.n_late)
        if rec.loss is not None:
            tele.gauge("fed.loss").set(rec.loss)
        tele.gauge("fed.compression.upload_x").set(
            traffic["upload_compression_x"])
        tele.histogram("fed.cohort_size").observe(len(rec.cohort))
        if self.pop is not None:
            ev["profile_cache_blocks"] = self.pop.cache_blocks
            tele.gauge("fed.profile_cache_blocks").set(self.pop.cache_blocks)
        if self.is_event:
            pop_n = getattr(self.dataset, "n_clients", None)
            ev.update(t_dispatch=rec.t_dispatch, t_virtual=rec.t_virtual,
                      critical_path_s=rec.critical_path_s,
                      queue_depth=len(self._queue),
                      population_size=pop_n)
            tele.gauge("event.queue_depth").set(len(self._queue))
            tele.gauge("event.t_virtual").set(rec.t_virtual)
            if pop_n is not None:
                tele.gauge("fed.population_size").set(pop_n)
            wall = time.perf_counter() - self._wall0
            if wall > 0 and rec.t_virtual is not None:
                ratio = rec.t_virtual / wall
                ev["virtual_wall_ratio"] = ratio
                tele.gauge("event.virtual_wall_ratio").set(ratio)
        if self._is_async:
            ev["buffer_depth"] = self.aggregator.pending()
            tele.gauge("agg.async.buffer_depth").set(
                self.aggregator.pending())
        tele.emit("round", **ev)

    def _sample_health(self, r: int) -> bool:
        return (self.tele.enabled and self.health_every > 0
                and r % self.health_every == 0)

    def _emit_health(self, r: int, agg_table, fresh_tables, fresh_w,
                     grad_acc) -> None:
        """Sketch-space diagnostics for a sampled round.

        The dense reference is the *fresh* cohort's weighted mean gradient
        (late contributions' gradients are long gone), so the recovery
        comparison rebuilds the matching fresh-only mean table (exact by
        linearity) instead of the merged ``agg_table``, which may fold in
        stale entries.
        """
        from repro_torch.obs import sketch_health as sh
        ev: dict = sh.state_norms(self.opt_state, agg_table)
        ev.update(round=r, recovery_rel_err=None, heavy_hitter_overlap=None)
        if fresh_tables and grad_acc is not None:
            total_w = sum(fresh_w)
            htable = sum(w * t for t, w in
                         zip(fresh_tables, fresh_w)) / total_w
            dense = sh.flatten_dense(
                layout_lib.tree_map(lambda g: g / total_w, grad_acc),
                self.layout)
            ev.update(sh.recovery_error(htable, dense, self.layout,
                                        self.fs_cfg))
            self.tele.gauge("sketch.recovery_rel_err").set(
                ev["recovery_rel_err"])
            self.tele.gauge("sketch.heavy_hitter_overlap").set(
                ev["heavy_hitter_overlap"])
        self.tele.gauge("sketch.error_norm").set(ev["error_sketch_norm"])
        self.tele.gauge("sketch.momentum_norm").set(
            ev["momentum_sketch_norm"])
        self.tele.emit("sketch_health", **ev)

    # -- per-round pieces (cont.) ---------------------------------------------

    def _server_update(self, table: torch.Tensor, stats, r: int) -> None:
        """The server step and w <- w - Delta, for a merge that carried
        weight (the weights change in place), in a ``fed.server_update``
        span."""
        with self.tele.span("fed.server_update") as sp:
            if stats.total_weight > 0:
                lr = torch.full((), self.lr_fn(r), dtype=torch.float32,
                                device=self.device)
                delta, self.opt_state = F.server_step(
                    table, self.opt_state, lr, self.layout, self.fs_cfg)
                F.apply_delta(self.params, self.layout, delta)
            sp.sync(self.params)

    def _compute_chunk(self, params: dict,
                       ids: list[int]) -> list[tuple[float, torch.Tensor]]:
        """(loss, table) per client, computed against ``params``.

        A plain loop over the per-client gradient and encoder the
        per-object paths call, so each (loss, table) is the one a
        per-object run computes from the same weights; the chunk's losses
        are read once, after its last client is enqueued.  Both vectorized
        loops (lazy-event materialization and the round-clock cohort
        sweep) share it.
        """
        losses, tables = [], []
        for c in ids:
            batch, loss, grads, table = self._client_work(params, c)
            del batch, grads
            losses.append(loss)
            tables.append(table)
        return list(zip(_floats(losses), tables))

    def run_round(self, r: int) -> RoundRecord:
        if self._wall0 is None:
            self._wall0 = time.perf_counter()
        if self.is_event:
            return self._run_event_round(r)
        if self.vectorized:
            return self._run_round_vec(r)
        fc = self.fed_cfg
        tele = self.tele
        with tele.span("fed.round", round=r):
            clients = self._cohort(r)
            rng = _round_rng(fc.seed, r, stream=1)
            sample_health = self._sample_health(r)
            codes, delays = self._fates(rng, len(clients))
            fresh, fresh_w, losses, n_dropped, n_straggling = [], [], [], 0, 0
            grad_acc = None
            with tele.span("fed.clients") as sp:
                for i, c in enumerate(clients):
                    fate, delay = codes[i], int(delays[i])
                    if fate == 2:
                        n_dropped += 1
                        continue
                    batch, loss, grads, table = self._client_work(
                        self.params, int(c))
                    losses.append(loss)
                    w = self._client_weight(int(c), batch)
                    if sample_health and fate == 0:
                        grad_acc = _add_weighted(grad_acc, grads, w)
                    del grads, batch
                    if fate == 1:
                        if self._is_async:
                            self.aggregator.submit(
                                table, produced_round=r,
                                arrival_round=r + delay, weight=w)
                            n_straggling += 1
                        else:  # sync barrier: a late client is a lost client
                            n_dropped += 1
                        continue
                    fresh.append(table)
                    fresh_w.append(w)
                sp.sync(fresh)
            with tele.span("fed.aggregate") as sp:
                table, stats = self.aggregator.aggregate(
                    fresh, weights=fresh_w, round_idx=r)
                sp.sync(table)
            self._server_update(table, stats, r)
            # the round's one read of its losses, once every client and the
            # server step are enqueued: no client waits for the one before
            losses = _floats(losses)
            traffic = self._record_traffic(stats.upload_bytes,
                                           len(fresh) + n_straggling)
            rec = RoundRecord(
                round_idx=r, cohort=[int(c) for c in clients],
                loss=(sum(losses) / len(losses)) if losses else None,
                n_fresh=stats.n_fresh, n_late=stats.n_late,
                n_dropped=n_dropped, n_straggling=n_straggling,
                upload_bytes=stats.upload_bytes)
            self._emit_round(rec, stats, traffic)
            if sample_health:
                self._emit_health(r, table, fresh, fresh_w, grad_acc)
        return rec

    def _run_round_vec(self, r: int) -> RoundRecord:
        """Vectorized round clock: the per-object ``run_round`` loop as
        column ops and a streaming fold.

        Fates and merge weights come from the same batched draws the
        per-object path uses (``weight_by="profile"`` reads
        ``PopulationModel`` columns), (loss, table) pairs are computed
        COHORT_CHUNK clients at a time, and the aggregator folds each fresh
        table as it appears, so a large cohort never holds O(cohort) tables
        or profile objects.  The records equal the per-object path's byte
        for byte: same loss-sum order, same fold order, same straggler
        submits, same accumulation of the weights.
        """
        fc = self.fed_cfg
        tele = self.tele
        with tele.span("fed.round", round=r):
            clients = self._cohort(r)
            rng = _round_rng(fc.seed, r, stream=1)
            codes, delays = self._fates(rng, len(clients))
            sent = codes != 2
            ids = np.asarray(clients)[sent].astype(np.int64)
            late = codes[sent] == 1
            late_delays = delays[sent]
            counts = {"dropped": int(len(clients) - sent.sum()),
                      "straggling": 0}
            cols = self.pop.columns(ids) if len(ids) else None
            weights = (self._client_weights_vec(ids, cols) if len(ids)
                       else np.zeros(0))
            losses: list[float] = []

            def fresh_pairs():
                # slot order, chunked: losses accumulate for every
                # participating client; only fresh (table, weight) pairs
                # reach the aggregator — stragglers submit (async) or drop
                # (sync barrier) as in the per-object loop
                for j0 in range(0, len(ids), COHORT_CHUNK):
                    chunk = [int(c) for c in ids[j0:j0 + COHORT_CHUNK]]
                    for k, (loss, table) in enumerate(
                            self._compute_chunk(self.params, chunk)):
                        j = j0 + k
                        losses.append(loss)
                        w = float(weights[j])
                        if late[j]:
                            if self._is_async:
                                self.aggregator.submit(
                                    table, produced_round=r,
                                    arrival_round=r + int(late_delays[j]),
                                    weight=w)
                                counts["straggling"] += 1
                            else:
                                counts["dropped"] += 1
                            continue
                        yield table, w

            with tele.span("fed.aggregate") as sp:
                table, stats = self.aggregator.aggregate_stream(
                    fresh_pairs(), round_idx=r)
                sp.sync(table)
            self._server_update(table, stats, r)
            traffic = self._record_traffic(
                stats.upload_bytes, stats.n_fresh + counts["straggling"])
            rec = RoundRecord(
                round_idx=r, cohort=[int(c) for c in clients],
                loss=(sum(losses) / len(losses)) if losses else None,
                n_fresh=stats.n_fresh, n_late=stats.n_late,
                n_dropped=counts["dropped"],
                n_straggling=counts["straggling"],
                upload_bytes=stats.upload_bytes)
            self._emit_round(rec, stats, traffic)
        return rec

    # -- event-driven clock (fed.simtime) -----------------------------------

    def _dispatch_cohort(self, r: int) -> tuple[np.ndarray, int, tuple]:
        """Sample cohort r at the current virtual time, compute each
        client's sketch against the *current* weights (the ones it
        downloads at dispatch), and enqueue its timed upload event.

        The third return value is the health sample ``(tables, weights,
        grad_acc)`` of this dispatch cohort: ``(None, None, None)`` unless
        telemetry samples this round."""
        fc = self.fed_cfg
        tele = self.tele
        now = self._now
        clients = self._cohort(r)
        rng = _round_rng(fc.seed, r, stream=1)
        codes, delays = self._fates(rng, len(clients))
        n_dropped = 0
        sample_health = self._sample_health(r)
        h_tables, h_weights, grad_acc = (([], [], None) if sample_health
                                         else (None, None, None))
        for slot, c in enumerate(clients):
            if codes[slot] == 2:
                n_dropped += 1
                continue
            delay = int(delays[slot])
            batch, loss, grads, table = self._client_work(self.params,
                                                          int(c))
            prof = self.het.profile(int(c))
            # a "late" fate under the event clock is a transient slowdown:
            # this round the client computes (1 + delay)x slower
            finish = prof.finish_time(now, self.aggregator.table_bytes,
                                      compute_scale=1.0 + delay)
            w = self._client_weight(int(c), batch)
            if tele.enabled:
                # availability idle: how long the client sat outside its
                # window before it could even start computing
                idle = prof.next_available(now) - now
                tele.histogram("event.client_idle_s").observe(idle)
                tele.counter("event.client_idle_s_total").inc(idle)
                tele.histogram("event.upload_s").observe(
                    prof.upload_seconds(self.aggregator.table_bytes))
            if sample_health:
                h_tables.append(table)
                h_weights.append(w)
                grad_acc = _add_weighted(grad_acc, grads, w)
            del grads, batch
            self._queue.push(simtime_lib.Event(
                time=finish, round_produced=r, slot=slot, client=int(c),
                produced=now, weight=w, loss=float(loss), table=table))
        return clients, n_dropped, (h_tables, h_weights, grad_acc)

    def _dispatch_cohort_vec(self, r: int) -> tuple[np.ndarray, int, tuple]:
        """Vectorized ``_dispatch_cohort``: O(cohort) numpy metadata, no
        gradient work (and no health sample).

        Pushes *lazy* events (loss and table None) carrying only metadata,
        and copies the current weights once per round: the gradient and
        sketch run when the event arrives, against that copy, through the
        same functions, so the records match the per-object path's while a
        cohort of 10^4-10^6 clients is dispatched in milliseconds.
        """
        fc = self.fed_cfg
        tele = self.tele
        now = self._now
        clients = self._cohort(r)
        rng = _round_rng(fc.seed, r, stream=1)
        codes, delays = self._fates(rng, len(clients))
        sent = codes != 2
        n_dropped = int(len(clients) - sent.sum())
        ids = np.asarray(clients)[sent].astype(np.int64)
        slots = np.nonzero(sent)[0]
        cols = self.pop.columns(ids)
        table_bytes = self.aggregator.table_bytes
        finish = self.pop.finish_times(cols, now, table_bytes,
                                       compute_scale=1.0 + delays[sent])
        weights = self._client_weights_vec(ids, cols)
        if tele.enabled and len(ids):
            idle = self.pop.next_available(cols, now) - now
            tele.histogram("event.client_idle_s").observe_many(idle)
            tele.counter("event.client_idle_s_total").inc(float(idle.sum()))
            tele.histogram("event.upload_s").observe_many(
                table_bytes / cols["bandwidth"])
        evs = [simtime_lib.Event(
                   time=float(finish[k]), round_produced=r,
                   slot=int(slots[k]), client=int(ids[k]), produced=now,
                   weight=float(weights[k]), loss=None, table=None)
               for k in range(len(ids))]
        self._queue.push_batch(evs)
        if evs:
            self._snapshots[r] = layout_lib.tree_map(torch.clone,
                                                     self.params)
            self._snap_refs[r] = len(evs)
        return clients, n_dropped, (None, None, None)

    def _materialize(self, events: list, idxs: list[int],
                     r: int) -> dict[int, tuple[float, torch.Tensor]]:
        """Compute {idx: (loss, table)} for lazy events of dispatch round
        ``r`` against its weights."""
        res = self._compute_chunk(self._snapshots[r],
                                  [int(events[j].client) for j in idxs])
        return {j: res[k] for k, j in enumerate(idxs)}

    def _arrival_stream(self, arrivals: list):
        """Yield ``(event, table)`` in pop order, materializing lazy events
        chunk by chunk.

        At most COHORT_CHUNK tables per dispatch round are alive at once;
        the streaming aggregator folds each one before the next chunk is
        computed.  A round's weight copy is released the moment its last
        in-flight event materializes.  Events restored from a checkpoint
        carry their table already.
        """
        by_round: dict[int, list[int]] = {}
        for i, e in enumerate(arrivals):
            if e.table is None:
                by_round.setdefault(e.round_produced, []).append(i)
        ptr = {rr: 0 for rr in by_round}
        cache: dict[int, tuple[float, torch.Tensor]] = {}
        for i, e in enumerate(arrivals):
            if e.table is not None:      # restored from a checkpoint: eager
                yield e, e.table
                continue
            rr = e.round_produced
            if i not in cache:
                idxs = by_round[rr][ptr[rr]:ptr[rr] + COHORT_CHUNK]
                ptr[rr] += len(idxs)
                cache.update(self._materialize(arrivals, idxs, rr))
            loss, table = cache.pop(i)
            e.loss = loss
            self._snap_refs[rr] -= 1
            if self._snap_refs[rr] == 0:
                del self._snap_refs[rr]
                del self._snapshots[rr]
            yield e, table

    def _materialized_events(self, events: list) -> list:
        """Checkpoint form of the in-flight queue: lazy events get their
        (loss, table) computed from their dispatch round's weights — the
        same functions and inputs as at arrival, so the resumed run replays
        the same bytes on the CPU.  The live queue stays lazy (the weight
        copies are kept)."""
        out = list(events)
        by_round: dict[int, list[int]] = {}
        for i, e in enumerate(out):
            if e.table is None:
                by_round.setdefault(e.round_produced, []).append(i)
        for rr, idxs in by_round.items():
            for j0 in range(0, len(idxs), COHORT_CHUNK):
                part = idxs[j0:j0 + COHORT_CHUNK]
                mat = self._materialize(out, part, rr)
                for j in part:
                    loss, table = mat[j]
                    out[j] = dataclasses.replace(out[j], loss=loss,
                                                 table=table)
        return out

    def _arrival_bandwidths(self, arrivals: list) -> list[float]:
        if self.vectorized:
            ids = np.array([e.client for e in arrivals], np.int64)
            return self.pop.columns(ids)["bandwidth"].tolist()
        return [self.het.profile(e.client).bandwidth for e in arrivals]

    def _run_event_round(self, r: int) -> RoundRecord:
        """One server update of the event loop.

        flat/tree: the barrier sits at the cohort's slowest upload — the
        queue drains fully and the virtual clock jumps to the last arrival.
        async: the server updates after ``quorum`` arrivals, merging them
        through the timed buffer with weight ``w * exp(-lambda * age)``;
        slower uploads (possibly from older rounds) stay in flight.

        Upload bytes are charged when the bytes hit the wire: every
        dispatched (non-dropped) client's leaf upload counts in its
        *dispatch* round — even if the table is still in flight or later
        dropped as too stale — plus the merge's internal-level forwards
        (tree backbone edges).
        """
        fc = self.fed_cfg
        tele = self.tele
        with tele.span("fed.round", round=r, clock="event"):
            t_dispatch = self._now
            with tele.span("fed.dispatch"):
                # per-client float(loss) inside the dispatch already syncs
                # (vectorized: metadata only, the work happens at merge)
                clients, n_dropped, health = (
                    self._dispatch_cohort_vec(r) if self.vectorized
                    else self._dispatch_cohort(r))
            if tele.enabled:
                tele.gauge("event.queue_depth").set(len(self._queue))
                tele.histogram("event.queue_depth").observe(len(self._queue))
            is_async = self._is_async
            n_pop = (min(self.sim_cfg.quorum or fc.clients_per_round,
                         len(self._queue))
                     if is_async else len(self._queue))
            arrivals = [self._queue.pop() for _ in range(n_pop)]
            if arrivals:
                self._now = arrivals[-1].time    # pop order: the max popped
            bandwidths = self._arrival_bandwidths(arrivals)
            with tele.span("fed.aggregate") as sp:
                if self.vectorized:
                    # lazy events materialize chunk by chunk inside the
                    # stream; the aggregator folds each table before the
                    # next chunk exists
                    stream = self._arrival_stream(arrivals)
                    if is_async:
                        table, stats = self.aggregator.merge_timed_stream(
                            ((t, e.produced, e.time, e.weight)
                             for e, t in stream),
                            now=self._now, bandwidths=bandwidths)
                    else:
                        table, stats = self.aggregator.aggregate_stream(
                            ((t, e.weight) for e, t in stream),
                            round_idx=r, bandwidths=bandwidths)
                elif is_async:
                    for e in arrivals:
                        self.aggregator.submit(e.table,
                                               produced_round=e.produced,
                                               arrival_round=e.time,
                                               weight=e.weight)
                    table, stats = self.aggregator.aggregate(
                        [], round_idx=self._now, bandwidths=bandwidths)
                else:
                    table, stats = self.aggregator.aggregate(
                        [e.table for e in arrivals],
                        weights=[e.weight for e in arrivals],
                        round_idx=r, bandwidths=bandwidths)
                sp.sync(table)
            # after the merge: every arrival's loss is materialized
            losses = [e.loss for e in arrivals]
            self._server_update(table, stats, r)
            n_sent = len(clients) - n_dropped
            internal = sum(lv.bytes_on_wire for lv in stats.levels[1:])
            upload = n_sent * self.aggregator.table_bytes + internal
            traffic = self._record_traffic(upload, len(arrivals))
            rec = RoundRecord(
                round_idx=r, cohort=[int(c) for c in clients],
                loss=(sum(losses) / len(losses)) if losses else None,
                n_fresh=stats.n_fresh, n_late=stats.n_late,
                n_dropped=n_dropped, n_straggling=len(self._queue),
                upload_bytes=upload, t_dispatch=t_dispatch,
                t_virtual=self._now, critical_path_s=stats.critical_path_s)
            self._emit_round(rec, stats, traffic)
            h_tables, h_weights, grad_acc = health
            if h_tables is not None:
                self._emit_health(r, table, h_tables, h_weights, grad_acc)
        return rec

    # -- the run --------------------------------------------------------------

    def _save(self, r: int) -> None:
        """Checkpoint the state after round ``r`` (``fed.checkpoint``)."""
        fc = self.fed_cfg
        sim = None
        if self.is_event:
            events = self._queue.state()
            if self.vectorized:
                events = self._materialized_events(events)
            sim = {"now": self._now, "events": events}
        ckpt_lib.save(fc.checkpoint_dir, self.params, self.opt_state, r,
                      extra={"aggregate": fc.aggregate, "clock": fc.clock,
                             "profile_stream":
                                 self.sim_cfg.heterogeneity.profile_stream},
                      late_buffer=(self.aggregator.state()
                                   if self._is_async else None),
                      simtime=sim)

    def run(self, progress: Callable[[RoundRecord], None] | None = None
            ) -> FedRunResult:
        """Rounds ``start_round`` (0, or the round after the restored
        checkpoint) to ``rounds - 1``; checkpoints every
        ``checkpoint_every`` rounds and after the last, when
        ``checkpoint_dir`` is set."""
        fc = self.fed_cfg
        records = []
        for r in range(self.start_round, fc.rounds):
            rec = self.run_round(r)
            records.append(rec)
            if progress:
                progress(rec)
            if fc.checkpoint_dir and (
                    (fc.checkpoint_every and (r + 1) % fc.checkpoint_every == 0)
                    or r == fc.rounds - 1):
                self._save(r)
        return FedRunResult(
            losses=[rec.loss for rec in records], records=records,
            traffic=self.meter.compression(fc.clients_per_round),
            params=self.params, opt_state=self.opt_state,
            extras={"fs_cfg": self.fs_cfg, "fed_cfg": fc,
                    "pending_late": (self.aggregator.pending()
                                     if self._is_async else 0),
                    "in_flight": len(self._queue),
                    "t_virtual": self._now if self.is_event else None,
                    "start_round": self.start_round})


def run_federated(model_cfg, dataset, *, fs_cfg: F.FetchSGDConfig,
                  fed_cfg: FederationConfig, peak_lr: float = 0.2,
                  params=None, progress=None, device=None,
                  telemetry=None, health_every: int = 1) -> FedRunResult:
    """One-call convenience wrapper around ``Orchestrator``."""
    return Orchestrator(model_cfg, fs_cfg, fed_cfg, dataset, params=params,
                        peak_lr=peak_lr, device=device, telemetry=telemetry,
                        health_every=health_every).run(progress=progress)
