"""Round orchestration: cohorts, dropout, stragglers, aggregation.

Port of the round clock of ``repro.fed.orchestrator``.  The orchestrator
owns the outer federated loop: sample a (possibly variable-size) cohort,
compute per-client sketches, push them through a pluggable
``Aggregator``, run the server update, and keep the communication ledger.
On top it adds the failure modes real federations see:

* **dropout** — a sampled client never reports (its sketch is lost);
* **stragglers** — a sampled client reports ``delay`` rounds late.  Under
  flat/tree aggregation the synchronous round barrier misses it (counted
  as dropped); under async aggregation it lands in the buffer and is
  merged later with a staleness-discounted weight.

Cohorts and fates are drawn with numpy from per-(seed, round, stream)
generators exactly as the reference draws them, so a run's cohorts,
fates and counts equal the reference's.

One encoder serves every client of a run: on the CPU the gather-plan
encoder (``core.gather_sketch``, the reference's choice), on the card
``core.fetchsgd.sketch_grads`` (the encode kernel).  Two runs on the card
can differ in the last bits: the encode kernel's float atomics sum in no
fixed order.

Not ported yet, each raising ``NotImplementedError`` from
``FederationConfig``: the event clock and its heterogeneity profiles
(``clock="event"``, ``simtime``, ``weight_by="profile"``), the vectorized
population paths (``vectorized=True``) and checkpoints
(``checkpoint_dir``).  Telemetry hooks wait for the port of ``obs``.
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
    clock: str = "round"                      # round (event: not ported)
    simtime: Any = None                       # event-clock knobs (not ported)
    weight_by: str = "uniform"                # uniform | samples
    seed: int = 0
    checkpoint_dir: str | None = None         # not ported
    checkpoint_every: int = 0
    vectorized: bool = False                  # not ported

    def __post_init__(self):
        if self.clock not in ("round", "event"):
            raise ValueError(
                f"clock must be 'round'|'event', got {self.clock}")
        if self.weight_by not in ("uniform", "samples", "profile"):
            raise ValueError(f"unknown weight_by {self.weight_by!r}")
        if self.clock == "event" or self.simtime is not None:
            raise _not_ported("the event clock (fed.simtime)", "4")
        if self.weight_by == "profile":
            raise _not_ported("weight_by='profile' (fed.simtime's "
                              "heterogeneity profiles)", "4")
        if self.vectorized:
            raise _not_ported("the vectorized population paths", "4")
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
    n_straggling: int     # produced this round, arriving later
    upload_bytes: int


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
        self.aggregator = agg_lib.make_aggregator(
            fed_cfg.aggregate, fs_cfg, fanout=fed_cfg.tree_fanout,
            discount=fed_cfg.staleness_discount,
            max_staleness=fed_cfg.max_staleness, device=self.device)
        self.meter = compression.TrafficMeter(d=self.layout.total)
        lay = self.layout
        self._sketch = (gather_sketch.build_encoder(lay, fs_cfg)
                        if self.device.type == "cpu" else
                        (lambda g: F.sketch_grads(g, lay, fs_cfg)))

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
        subset, as the reference draws them.
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
        if self.fed_cfg.weight_by == "samples":
            return float(len(batch["tokens"]))
        return 1.0

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

    def run_round(self, r: int) -> RoundRecord:
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
        if stats.total_weight > 0:
            lr = torch.full((), self.lr_fn(r), dtype=torch.float32,
                            device=self.device)
            delta, self.opt_state = F.server_step(table, self.opt_state, lr,
                                                  self.layout, self.fs_cfg)
            F.apply_delta(self.params, self.layout, delta)
        self._record_traffic(stats.upload_bytes, len(fresh) + n_straggling)
        return RoundRecord(
            round_idx=r, cohort=[int(c) for c in clients],
            loss=(sum(losses) / len(losses)) if losses else None,
            n_fresh=stats.n_fresh, n_late=stats.n_late,
            n_dropped=n_dropped, n_straggling=n_straggling,
            upload_bytes=stats.upload_bytes)

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
                                     if is_async else 0)})


def run_federated(model_cfg, dataset, *, fs_cfg: F.FetchSGDConfig,
                  fed_cfg: FederationConfig, peak_lr: float = 0.2,
                  params=None, progress=None, device=None) -> FedRunResult:
    """One-call convenience wrapper around ``Orchestrator``."""
    return Orchestrator(model_cfg, fs_cfg, fed_cfg, dataset, params=params,
                        peak_lr=peak_lr, device=device).run(progress=progress)
