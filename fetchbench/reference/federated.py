"""Plain reference of a federated FetchSGD round on the flat clock: each
cohort client's loss and gradient, the mean gradient sketched (the mean of
the clients' sketches, by linearity), the server step, and the update.

``lowp`` and ``half_batch`` put the control and a fault in the program's
place: products at TF32's precision, or each client's gradient over the
first half of its examples.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from fetchbench.reference import sketch
from fetchbench.traffic import persona


@dataclasses.dataclass
class Readings:
    """What a run's first rounds give the comparison."""

    losses: list          # mean client loss of each round
    state: torch.Tensor   # S_u after the first round, on the host
    change: dict          # leaf -> norm of the weights' change over the rounds
    grad: dict | None = None   # leaf -> norm of the first mean gradient


def lr_at(wl: dict, r: int) -> float:
    """The workload's linear decay, in float32 arithmetic."""
    f = np.float32
    peak, total = f(wl["lr"]), f(wl["schedule_rounds"])
    return float(peak * np.maximum(total - f(r), f(0)) / total)


def leaf_norms(vec: torch.Tensor, leaf_spans) -> dict:
    """Each leaf's norm, over ``(path, offset, size)``."""
    return {p: float(torch.linalg.vector_norm(vec[o:o + n]))
            for p, o, n in leaf_spans}


def change_norms(flat: torch.Tensor, flat0: torch.Tensor, leaf_spans
                 ) -> dict:
    return {p: float(torch.linalg.vector_norm(flat[o:o + n] - flat0[o:o + n]))
            for p, o, n in leaf_spans}


def run(fam, cfg: dict, wl: dict, seed: int, device, n_rounds: int = 3,
        lowp: bool = False, half_batch: bool = False) -> Readings:
    """The first ``n_rounds`` rounds of the workload on the configuration
    of the reference family ``fam``."""
    spec = fam.param_spec(cfg)
    spans = sketch.chunks(spec)
    data = persona.from_workload(wl, cfg["vocab"], seed)
    sk, t = wl["sketch"], wl["traffic"]
    flat = fam.init_flat(spec, cfg, seed, device)
    server = sketch.Server(sk["rows"], sk["cols"], sk["k"], sk["momentum"],
                           spans, device)
    losses, state, grad = [], None, None
    times = {"clients": 0.0, "sketch": 0.0, "server": 0.0}

    def lap(name, t0):
        if flat.is_cuda:
            torch.cuda.synchronize()
        times[name] += time.perf_counter() - t0
        return time.perf_counter()

    for r in range(n_rounds):
        t0 = time.perf_counter()
        cohort = persona.sample_clients(t["population"],
                                        t["clients_per_round"], r,
                                        t["population_seed"])
        gsum, round_losses = None, []
        for c in cohort:
            b = data.client_batch(int(c))
            tok = torch.as_tensor(b["tokens"], dtype=torch.int64,
                                  device=device)
            lab = torch.as_tensor(b["labels"], dtype=torch.int64,
                                  device=device)
            if half_batch:
                keep = (tok.shape[0] + 1) // 2
                tok, lab = tok[:keep], lab[:keep]
            loss, g = fam.loss_and_grad(flat, spec, tok, lab, cfg, lowp)
            round_losses.append(loss)
            gsum = g if gsum is None else gsum.add_(g)
            del g
        mean = gsum.div_(len(cohort))
        if r == 0:
            grad = leaf_norms(mean, fam.leaf_spans(spec))
        t0 = lap("clients", t0)
        table = sketch.sketch(mean, spans, sk["rows"], sk["cols"])
        del gsum, mean
        t0 = lap("sketch", t0)
        server.step(table, lr_at(wl, r), flat)
        lap("server", t0)
        if r == 0:
            state = server.su.cpu()
        losses.append(sum(round_losses) / len(round_losses))
    flat0 = fam.init_flat(spec, cfg, seed, device)
    change = change_norms(flat, flat0, fam.leaf_spans(spec))
    print("reference seconds " + " ".join(f"{k} {v:.2f}"
                                          for k, v in times.items()),
          file=sys.stderr)
    return Readings(losses, state, change, grad)


def state_rows(prog: Readings, ref: Readings) -> tuple[list, list]:
    """Row norms of each side's S_u after the first round over the cells
    neither side's Delta zeroed: which cells a Delta hits turns on ties at
    its k-th magnitude, while the cells both keep hold the merged
    gradient as the optimizer got it."""
    keep = (prog.state != 0) & (ref.state != 0)
    return ([float(torch.linalg.vector_norm(r.state[i][keep[i]]))
             for i in range(keep.shape[0])] for r in (prog, ref))


def _gap(p: float, r: float, med: float) -> float:
    """|p - r| over max(r, med); 1 where one side is empty and the other
    is not."""
    den = max(r, med)
    return abs(p - r) / den if den > 0 else float(p != 0)


def gaps(prog: Readings, ref: Readings) -> dict:
    """The compared numbers: the first round's relative loss gap; by the
    worst row of S_u after the first round, and by the worst leaf of the
    weights' change over the rounds, the gap between the two sides' norms
    over the reference's norm of that row or leaf or of the median one,
    whichever is larger.  Leaves whose first gradient is below a
    thousandth of the median leaf's in the reference are left out of the
    change."""
    loss = abs(prog.losses[0] - ref.losses[0]) / abs(ref.losses[0])
    p_rows, r_rows = state_rows(prog, ref)
    med = float(np.median(r_rows))
    state = max(1.0 if not prog.state[i].any() and ref.state[i].any()
                else _gap(p, r, med)
                for i, (p, r) in enumerate(zip(p_rows, r_rows)))
    gmed = float(np.median(list(ref.grad.values())))
    leaves = [p for p, g in ref.grad.items() if g >= 1e-3 * gmed]
    cmed = float(np.median([ref.change[p] for p in leaves]))
    change = max((_gap(prog.change[p], ref.change[p], cmed)
                  for p in leaves), default=0.0)
    return {"loss_gap": loss, "first_grad_gap": state, "change_gap": change}


def details(prog: Readings, ref: Readings) -> dict:
    """What the compared numbers leave out, for the record: every round's
    relative loss gap, the row gap over every cell, zeroed ones too, and
    the median leaf's change gap."""
    rows = [(float(torch.linalg.vector_norm(p)), float(torch.linalg.vector_norm(r)))
            for p, r in zip(prog.state, ref.state)]
    med = float(np.median([r for _, r in rows]))
    cmed = float(np.median(list(ref.change.values())))
    leaf = min(ref.change, key=lambda p: abs(ref.change[p] - cmed))
    return {"round_loss_gaps": [abs(p - r) / abs(r) for p, r in
                                zip(prog.losses, ref.losses)],
            "all_cells_grad_gap": max(abs(p - r) / max(r, med)
                                      for p, r in rows),
            "median_leaf_change_gap": abs(prog.change[leaf] - ref.change[leaf])
            / max(ref.change[leaf], 1e-30)}


def describe(side: str, r: Readings) -> str:
    """One line of a side's readings, for the run's standard error."""
    ch = " ".join(f"{p.split('/')[-2]}/{p.split('/')[-1]}={v:.6g}"
                  for p, v in r.change.items())
    return f"{side}: losses {[float(x) for x in r.losses]} change {ch}"
