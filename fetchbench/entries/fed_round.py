"""Entry kind ``fed_round``: federated FetchSGD rounds through the port's
``Orchestrator.run_round`` on the round clock, flat aggregation, every
client fresh and weighted alike.

Set-up builds one orchestrator on weights the benchmark draws from the
seed, and drives it through rounds 0-2 with the same call and feed as the
window: they warm every kernel up and are the rounds the comparison
checks.  The window runs rounds 3, 4, ... until its time is up.
"""

from __future__ import annotations

import sys

from fetchbench import harness, reference
from fetchbench.reference import federated
from fetchbench.traffic import persona

CHECKED_ROUNDS = 3


class Session:
    def __init__(self, cell: harness.Cell, seed: int, device,
                 traced: bool):
        from repro_torch import obs
        from repro_torch.core import fetchsgd as F
        from repro_torch.fed import orchestrator as O
        from repro_torch.optim import linear_decay

        self.cfg, self.wl, self.seed = cell.config, cell.workload, seed
        self.device = device
        t, sk = self.wl["traffic"], self.wl["sketch"]
        fam = self.fam = reference.family(self.cfg, cell.root)
        model_cfg = harness.arch_config(self.cfg, fam)
        self.spec = fam.param_spec(self.cfg)
        harness.check_tree(model_cfg, self.spec)
        self.flat = fam.init_flat(self.spec, self.cfg, seed, device)
        params = harness.tree(fam.leaves(self.flat, self.spec))
        self.data = persona.from_workload(self.wl, self.cfg["vocab"], seed)
        self.sink = obs.MemorySink() if traced else None
        tele = obs.Telemetry([self.sink], trace=True) if traced else None
        self.orch = O.Orchestrator(
            model_cfg,
            F.FetchSGDConfig(rows=sk["rows"], cols=sk["cols"], k=sk["k"],
                             momentum=sk["momentum"]),
            O.FederationConfig(rounds=self.wl["schedule_rounds"],
                               clients_per_round=t["clients_per_round"],
                               aggregate="flat", seed=t["population_seed"]),
            self.data, params=params,
            lr_fn=linear_decay(self.wl["lr"], self.wl["schedule_rounds"]),
            device=device, telemetry=tele, health_every=0)
        losses = []
        for r in range(CHECKED_ROUNDS):
            losses.append(self.orch.run_round(r).loss)
            if r == 0:
                state = self.orch.opt_state.momentum_sketch.cpu()
        flat0 = fam.init_flat(self.spec, self.cfg, seed, device)
        change = federated.change_norms(self.flat, flat0,
                                        fam.leaf_spans(self.spec))
        del flat0
        self.readings = federated.Readings(losses, state, change)
        self.round = CHECKED_ROUNDS
        self.clients: list[tuple[int, int]] = []

    def begin_window(self) -> None:
        if self.sink is not None:
            self.sink.events.clear()
        self.clients = []

    def step(self) -> None:
        rec = self.orch.run_round(self.round)
        self.round += 1
        S = self.wl["traffic"]["seq_len"]
        self.clients += [(self.data.client_size(c), S) for c in rec.cohort]

    def steps_attempted(self, n: int) -> int:
        return n

    def window_metrics(self, elapsed: float, n: int) -> dict:
        return {"round_s": elapsed / n}

    def layer_stats(self) -> dict:
        spans = [] if self.sink is None else \
            [e for e in self.sink.events if e["type"] == "span"]
        return {"rounds": self.round - CHECKED_ROUNDS,
                "clients": list(self.clients), "spans": spans}

    def release(self) -> None:
        del self.orch, self.flat
        harness.free_device(self.device)

    def check(self) -> dict:
        ref = federated.run(self.fam, self.cfg, self.wl, self.seed,
                            self.device, CHECKED_ROUNDS)
        for side, r in (("program", self.readings), ("reference", ref)):
            print(federated.describe(side, r), file=sys.stderr)
        print(f"details {federated.details(self.readings, ref)}",
              file=sys.stderr)
        return federated.gaps(self.readings, ref)
