"""Round orchestration: cohorts, dropout, stragglers, aggregation.

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

Checkpoints (``checkpoint_dir``) are not ported yet and raise
``NotImplementedError`` from ``FederationConfig``.  Telemetry hooks wait
for the port of ``obs``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import compression, fetchsgd as F
from repro_torch.core import gather_sketch
from repro_torch.core import layout as layout_lib
from repro_torch.data import federated
from repro_torch.models import transformer
from repro_torch.optim import triangular

from . import aggregator as agg_lib
from . import simtime as simtime_lib


def _not_ported(what: str, queue: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, queue {queue})")


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
    checkpoint_dir: str | None = None         # not ported
    checkpoint_every: int = 0
    vectorized: bool = False                  # population-scale loop: batched
                                              # dispatch (+ lazy events under
                                              # the event clock)

    def __post_init__(self):
        if self.clock not in ("round", "event"):
            raise ValueError(
                f"clock must be 'round'|'event', got {self.clock}")
        if self.weight_by not in ("uniform", "samples", "profile"):
            raise ValueError(f"unknown weight_by {self.weight_by!r}")
        if self.checkpoint_dir is not None:
            raise _not_ported("checkpoints (fed.checkpoint)", "5")


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
    """(params, batch) -> (loss, grads) for the transformer LM."""
    return lambda params, batch: transformer.value_and_grad(params, batch,
                                                            cfg)


# Clients materialized per sweep of the vectorized loops: the lazy events
# of one dispatch round that arrive together are computed COHORT_CHUNK at a
# time, and the aggregator folds each table before the next sweep.
COHORT_CHUNK = 16


def _round_rng(seed: int, round_idx: int,
               stream: int = 0) -> np.random.Generator:
    # tuple entropy goes through SeedSequence mixing: cohort sizing and
    # client fates use distinct streams so the two draws never correlate
    return np.random.default_rng((seed, round_idx, stream))


class Orchestrator:
    """Drives multi-round FetchSGD training through an aggregation policy.

    Runs on ``device`` (``cuda`` unless asked otherwise); ``params``, when
    given, lie there already and are updated in place.
    """

    def __init__(self, model_cfg, fs_cfg: F.FetchSGDConfig,
                 fed_cfg: FederationConfig, dataset, *,
                 params=None, lr_fn: Callable | None = None,
                 peak_lr: float = 0.2, grad_fn: Callable | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.fs_cfg = fs_cfg
        self.fed_cfg = fed_cfg
        self.dataset = dataset
        self.params = (params if params is not None else
                       transformer.init_params(model_cfg, fed_cfg.seed,
                                               self.device))
        self.layout = layout_lib.build_layout(self.params)
        self.opt_state = F.init_state(fs_cfg, self.device)
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
            device=self.device)
        self.meter = compression.TrafficMeter(d=self.layout.total)
        lay = self.layout
        # every path (round clock, per-object event, chunked cohort) encodes
        # through this one function, which is what makes vectorized and
        # per-object runs byte-identical on the CPU
        self._sketch = (gather_sketch.build_encoder(lay, fs_cfg)
                        if self.device.type == "cpu" else
                        (lambda g: F.sketch_grads(g, lay, fs_cfg)))

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
                        n_participating: int) -> None:
        """Charge this round's bytes to the meter.

        Paper accounting (``compression.fetchsgd_round``, Sec. 5): the
        download is k values at 4 bytes each per participating client.
        (The reference also returns a per-round dict for its telemetry,
        which waits for the port of ``obs``.)
        """
        per_client_down = compression.fetchsgd_round(
            self.fs_cfg.rows, self.fs_cfg.cols, self.fs_cfg.k).download
        self.meter.record(compression.RoundTraffic(
            upload=upload_bytes, download=per_client_down * n_participating),
            clients=1)

    def _server_update(self, table: torch.Tensor, stats, r: int) -> None:
        """The server step and w <- w - Delta, for a merge that carried
        weight (the weights change in place)."""
        if stats.total_weight > 0:
            lr = torch.full((), self.lr_fn(r), dtype=torch.float32,
                            device=self.device)
            delta, self.opt_state = F.server_step(table, self.opt_state, lr,
                                                  self.layout, self.fs_cfg)
            F.apply_delta(self.params, self.layout, delta)

    def _compute_chunk(self, params: dict,
                       ids: list[int]) -> list[tuple[float, torch.Tensor]]:
        """(loss, table) per client, computed against ``params``.

        A plain loop over the per-client gradient and encoder the
        per-object paths call, so each (loss, table) is the one a
        per-object run computes from the same weights.  Both vectorized
        loops (lazy-event materialization and the round-clock cohort
        sweep) share it.
        """
        out = []
        for c in ids:
            loss, grads = self.grad_fn(params, self._client_batch(c))
            table = self._sketch(grads)
            del grads
            out.append((float(loss), table))
        return out

    def run_round(self, r: int) -> RoundRecord:
        if self.is_event:
            return self._run_event_round(r)
        if self.vectorized:
            return self._run_round_vec(r)
        fc = self.fed_cfg
        clients = self._cohort(r)
        rng = _round_rng(fc.seed, r, stream=1)
        is_async = isinstance(self.aggregator,
                              agg_lib.AsyncBufferedAggregator)
        codes, delays = self._fates(rng, len(clients))
        fresh, fresh_w, losses, n_dropped, n_straggling = [], [], [], 0, 0
        for i, c in enumerate(clients):
            fate, delay = codes[i], int(delays[i])
            if fate == 2:
                n_dropped += 1
                continue
            batch = self._client_batch(int(c))
            loss, grads = self.grad_fn(self.params, batch)
            table = self._sketch(grads)
            del grads
            losses.append(float(loss))
            w = self._client_weight(int(c), batch)
            if fate == 1:
                if is_async:
                    self.aggregator.submit(table, produced_round=r,
                                           arrival_round=r + delay, weight=w)
                    n_straggling += 1
                else:  # sync barrier: a late client is a lost client
                    n_dropped += 1
                continue
            fresh.append(table)
            fresh_w.append(w)

        table, stats = self.aggregator.aggregate(fresh, weights=fresh_w,
                                                 round_idx=r)
        self._server_update(table, stats, r)
        self._record_traffic(stats.upload_bytes, len(fresh) + n_straggling)
        return RoundRecord(
            round_idx=r, cohort=[int(c) for c in clients],
            loss=(sum(losses) / len(losses)) if losses else None,
            n_fresh=stats.n_fresh, n_late=stats.n_late,
            n_dropped=n_dropped, n_straggling=n_straggling,
            upload_bytes=stats.upload_bytes)

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
        clients = self._cohort(r)
        rng = _round_rng(fc.seed, r, stream=1)
        is_async = isinstance(self.aggregator,
                              agg_lib.AsyncBufferedAggregator)
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
            # participating client; only fresh (table, weight) pairs reach
            # the aggregator — stragglers submit (async) or drop (sync
            # barrier) as in the per-object loop
            for j0 in range(0, len(ids), COHORT_CHUNK):
                chunk = [int(c) for c in ids[j0:j0 + COHORT_CHUNK]]
                for k, (loss, table) in enumerate(
                        self._compute_chunk(self.params, chunk)):
                    j = j0 + k
                    losses.append(loss)
                    w = float(weights[j])
                    if late[j]:
                        if is_async:
                            self.aggregator.submit(
                                table, produced_round=r,
                                arrival_round=r + int(late_delays[j]),
                                weight=w)
                            counts["straggling"] += 1
                        else:
                            counts["dropped"] += 1
                        continue
                    yield table, w

        table, stats = self.aggregator.aggregate_stream(fresh_pairs(),
                                                        round_idx=r)
        self._server_update(table, stats, r)
        self._record_traffic(stats.upload_bytes,
                             stats.n_fresh + counts["straggling"])
        return RoundRecord(
            round_idx=r, cohort=[int(c) for c in clients],
            loss=(sum(losses) / len(losses)) if losses else None,
            n_fresh=stats.n_fresh, n_late=stats.n_late,
            n_dropped=counts["dropped"], n_straggling=counts["straggling"],
            upload_bytes=stats.upload_bytes)

    # -- event-driven clock (fed.simtime) -----------------------------------

    def _dispatch_cohort(self, r: int) -> tuple[np.ndarray, int]:
        """Sample cohort r at the current virtual time, compute each
        client's sketch against the *current* weights (the ones it
        downloads at dispatch), and enqueue its timed upload event."""
        fc = self.fed_cfg
        now = self._now
        clients = self._cohort(r)
        rng = _round_rng(fc.seed, r, stream=1)
        codes, delays = self._fates(rng, len(clients))
        n_dropped = 0
        for slot, c in enumerate(clients):
            if codes[slot] == 2:
                n_dropped += 1
                continue
            delay = int(delays[slot])
            batch = self._client_batch(int(c))
            loss, grads = self.grad_fn(self.params, batch)
            table = self._sketch(grads)
            del grads
            prof = self.het.profile(int(c))
            # a "late" fate under the event clock is a transient slowdown:
            # this round the client computes (1 + delay)x slower
            finish = prof.finish_time(now, self.aggregator.table_bytes,
                                      compute_scale=1.0 + delay)
            w = self._client_weight(int(c), batch)
            self._queue.push(simtime_lib.Event(
                time=finish, round_produced=r, slot=slot, client=int(c),
                produced=now, weight=w, loss=float(loss), table=table))
        return clients, n_dropped

    def _dispatch_cohort_vec(self, r: int) -> tuple[np.ndarray, int]:
        """Vectorized ``_dispatch_cohort``: O(cohort) numpy metadata, no
        gradient work.

        Pushes *lazy* events (loss and table None) carrying only metadata,
        and copies the current weights once per round: the gradient and
        sketch run when the event arrives, against that copy, through the
        same functions, so the records match the per-object path's while a
        cohort of 10^4-10^6 clients is dispatched in milliseconds.
        """
        fc = self.fed_cfg
        now = self._now
        clients = self._cohort(r)
        rng = _round_rng(fc.seed, r, stream=1)
        codes, delays = self._fates(rng, len(clients))
        sent = codes != 2
        n_dropped = int(len(clients) - sent.sum())
        ids = np.asarray(clients)[sent].astype(np.int64)
        slots = np.nonzero(sent)[0]
        cols = self.pop.columns(ids)
        finish = self.pop.finish_times(cols, now, self.aggregator.table_bytes,
                                       compute_scale=1.0 + delays[sent])
        weights = self._client_weights_vec(ids, cols)
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
        return clients, n_dropped

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
        in-flight event materializes.
        """
        by_round: dict[int, list[int]] = {}
        for i, e in enumerate(arrivals):
            by_round.setdefault(e.round_produced, []).append(i)
        ptr = {rr: 0 for rr in by_round}
        cache: dict[int, tuple[float, torch.Tensor]] = {}
        for i, e in enumerate(arrivals):
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
        t_dispatch = self._now
        clients, n_dropped = (self._dispatch_cohort_vec(r) if self.vectorized
                              else self._dispatch_cohort(r))
        is_async = isinstance(self.aggregator,
                              agg_lib.AsyncBufferedAggregator)
        n_pop = (min(self.sim_cfg.quorum or fc.clients_per_round,
                     len(self._queue))
                 if is_async else len(self._queue))
        arrivals = [self._queue.pop() for _ in range(n_pop)]
        if arrivals:
            self._now = arrivals[-1].time    # pop order: the max popped
        bandwidths = self._arrival_bandwidths(arrivals)
        if self.vectorized:
            # lazy events materialize chunk by chunk inside the stream; the
            # aggregator folds each table before the next chunk exists
            stream = self._arrival_stream(arrivals)
            if is_async:
                table, stats = self.aggregator.merge_timed_stream(
                    ((t, e.produced, e.time, e.weight) for e, t in stream),
                    now=self._now, bandwidths=bandwidths)
            else:
                table, stats = self.aggregator.aggregate_stream(
                    ((t, e.weight) for e, t in stream),
                    round_idx=r, bandwidths=bandwidths)
        elif is_async:
            for e in arrivals:
                self.aggregator.submit(e.table, produced_round=e.produced,
                                       arrival_round=e.time, weight=e.weight)
            table, stats = self.aggregator.aggregate(
                [], round_idx=self._now, bandwidths=bandwidths)
        else:
            table, stats = self.aggregator.aggregate(
                [e.table for e in arrivals],
                weights=[e.weight for e in arrivals],
                round_idx=r, bandwidths=bandwidths)
        # after the merge: every arrival's loss is materialized
        losses = [e.loss for e in arrivals]
        self._server_update(table, stats, r)
        n_sent = len(clients) - n_dropped
        internal = sum(lv.bytes_on_wire for lv in stats.levels[1:])
        upload = n_sent * self.aggregator.table_bytes + internal
        self._record_traffic(upload, len(arrivals))
        return RoundRecord(
            round_idx=r, cohort=[int(c) for c in clients],
            loss=(sum(losses) / len(losses)) if losses else None,
            n_fresh=stats.n_fresh, n_late=stats.n_late,
            n_dropped=n_dropped, n_straggling=len(self._queue),
            upload_bytes=upload, t_dispatch=t_dispatch,
            t_virtual=self._now, critical_path_s=stats.critical_path_s)

    # -- the run --------------------------------------------------------------

    def run(self, progress: Callable[[RoundRecord], None] | None = None
            ) -> FedRunResult:
        fc = self.fed_cfg
        records = []
        for r in range(fc.rounds):
            rec = self.run_round(r)
            records.append(rec)
            if progress:
                progress(rec)
        is_async = isinstance(self.aggregator,
                              agg_lib.AsyncBufferedAggregator)
        return FedRunResult(
            losses=[rec.loss for rec in records], records=records,
            traffic=self.meter.compression(fc.clients_per_round),
            params=self.params, opt_state=self.opt_state,
            extras={"fs_cfg": self.fs_cfg, "fed_cfg": fc,
                    "pending_late": (self.aggregator.pending()
                                     if is_async else 0),
                    "in_flight": len(self._queue),
                    "t_virtual": self._now if self.is_event else None})


def run_federated(model_cfg, dataset, *, fs_cfg: F.FetchSGDConfig,
                  fed_cfg: FederationConfig, peak_lr: float = 0.2,
                  params=None, progress=None, device=None) -> FedRunResult:
    """One-call convenience wrapper around ``Orchestrator``."""
    return Orchestrator(model_cfg, fs_cfg, fed_cfg, dataset, params=params,
                        peak_lr=peak_lr, device=device).run(progress=progress)
