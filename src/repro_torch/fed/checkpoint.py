"""Checkpointing for long federated runs: params + FetchSGDState + round.

Port of ``repro.fed.checkpoint``, in its on-disk format: one ``.npz``
plus a JSON sidecar, the same member names (``param_%05d``,
``momentum_sketch``, ``error_sketch``, ``opt_step``, ``late_%05d``, the
columnar ``event_*`` arrays) and the same sidecar keys.  A checkpoint
written by either package restores in the other, and one written on the
CPU resumes on the card: tensors are written as numpy arrays
(``.cpu().numpy()``, no pickle) and restored with ``torch.from_numpy``
onto the device and dtype of the template they replace.

Parameter leaves are stored in the reference's leaf order
(``core.layout.flatten``: nested dict keys sorted), so restore needs a
same-structure template tree (the orchestrator always has one: its
freshly-initialized params).  The async aggregator's late buffer is
persisted alongside, and under the event clock the virtual clock and the
in-flight event queue — each event's sketch table plus its (time, round,
slot, client, produced, weight, loss) metadata — so the resumed event loop
pops the identical arrival sequence.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any

import numpy as np
import torch

from repro_torch.core import fetchsgd as F
from repro_torch.core import layout as layout_lib

from . import simtime as simtime_lib

_CKPT_RE = re.compile(r"^ckpt_(\d{8})\.npz$")


@dataclasses.dataclass
class Checkpoint:
    """One restored checkpoint."""

    params: Any
    opt_state: F.FetchSGDState
    round_idx: int
    extra: dict
    late_buffer: list       # AsyncBufferedAggregator.state() entries
    simtime: dict | None = None   # {"now": float, "events": [Event, ...]}


def _paths(directory: str, round_idx: int) -> tuple[str, str]:
    stem = os.path.join(directory, f"ckpt_{round_idx:08d}")
    return stem + ".npz", stem + ".json"


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` on ``like``'s device with its dtype (no silent move)."""
    return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)


def latest_round(directory: str) -> int | None:
    """Highest round with a complete (npz + json) checkpoint, or None."""
    if not os.path.isdir(directory):
        return None
    rounds = []
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m and os.path.exists(_paths(directory, int(m.group(1)))[1]):
            rounds.append(int(m.group(1)))
    return max(rounds) if rounds else None


def save(directory: str, params, opt_state: F.FetchSGDState,
         round_idx: int, *, extra: dict | None = None,
         late_buffer: list | None = None,
         simtime: dict | None = None, keep: int = 3) -> str:
    """Write one checkpoint; prune to the newest ``keep``. Returns npz path.

    ``late_buffer`` is ``AsyncBufferedAggregator.state()``: each entry's
    table goes in the npz, its (produced, arrival, weight) in the sidecar.
    ``simtime`` is the event clock's state ``{"now": float, "events":
    [simtime.Event, ...]}``: event tables go in the npz, their metadata in
    the sidecar.
    """
    os.makedirs(directory, exist_ok=True)
    leaves = [leaf for _, leaf in layout_lib.flatten(params)]
    arrays = {f"param_{i:05d}": _np(v) for i, v in enumerate(leaves)}
    arrays["momentum_sketch"] = _np(opt_state.momentum_sketch)
    arrays["error_sketch"] = _np(opt_state.error_sketch)
    arrays["opt_step"] = np.asarray(int(opt_state.step), np.int32)
    late_meta = []
    for i, e in enumerate(late_buffer or []):
        arrays[f"late_{i:05d}"] = _np(e["table"])
        # produced/arrival are round ints (round clock) or virtual-second
        # floats (event clock); JSON keeps either exactly
        late_meta.append({"produced": e["produced"],
                          "arrival": e["arrival"],
                          "weight": float(e["weight"])})
    sim_meta = None
    if simtime is not None:
        # columnar: one stacked array per field; ``restore`` still reads the
        # reference's legacy per-event layout (migration shim below)
        evs = simtime["events"]
        for ev in evs:
            if ev.table is None or ev.loss is None:
                raise ValueError(
                    "cannot checkpoint a lazy event (table/loss=None) — "
                    "the orchestrator materializes in-flight events before "
                    "saving; file a bug if you hit this")
        sim_meta = {"now": float(simtime["now"]), "n_events": len(evs),
                    "format": "columnar"}
        arrays["event_time"] = np.array([ev.time for ev in evs], np.float64)
        arrays["event_round"] = np.array(
            [ev.round_produced for ev in evs], np.int64)
        arrays["event_slot"] = np.array([ev.slot for ev in evs], np.int64)
        arrays["event_client"] = np.array(
            [ev.client for ev in evs], np.int64)
        arrays["event_produced"] = np.array(
            [ev.produced for ev in evs], np.float64)
        arrays["event_weight"] = np.array(
            [ev.weight for ev in evs], np.float64)
        arrays["event_loss"] = np.array([ev.loss for ev in evs], np.float64)
        arrays["event_tables"] = (
            np.stack([_np(ev.table) for ev in evs])
            if evs else np.zeros((0,), np.float32))
    npz, meta = _paths(directory, round_idx)
    tmp = npz + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, npz)
    with open(meta, "w") as f:
        json.dump({"round": round_idx, "n_param_leaves": len(leaves),
                   "late": late_meta, "simtime": sim_meta,
                   "extra": extra or {}}, f, indent=1)
    _prune(directory, keep)
    return npz


def restore(directory: str, params_template, state_template: F.FetchSGDState,
            round_idx: int | None = None) -> Checkpoint | None:
    """Load a ``Checkpoint``; None if none exists.

    ``params_template`` / ``state_template`` supply the tree structure,
    dtypes and devices (sketch, late and event tables go to the momentum
    sketch's device); shapes are checked so a config mismatch fails loudly
    instead of silently reinterpreting leaves.
    """
    if round_idx is None:
        round_idx = latest_round(directory)
        if round_idx is None:
            return None
    npz, meta = _paths(directory, round_idx)
    if not (os.path.exists(npz) and os.path.exists(meta)):
        return None
    with open(meta) as f:
        info = json.load(f)
    named = layout_lib.flatten(params_template)
    if info["n_param_leaves"] != len(named):
        raise ValueError(
            f"checkpoint has {info['n_param_leaves']} param leaves, "
            f"template has {len(named)} — wrong model config?")
    sketch = state_template.momentum_sketch
    with np.load(npz) as data:
        new_leaves = []
        for i, (_, tmpl) in enumerate(named):
            arr = data[f"param_{i:05d}"]
            if arr.shape != tuple(tmpl.shape):
                raise ValueError(f"param leaf {i}: checkpoint shape "
                                 f"{arr.shape} != template "
                                 f"{tuple(tmpl.shape)}")
            new_leaves.append(_tensor(arr, tmpl))
        tables = {k: data[k] for k in ("momentum_sketch", "error_sketch")}
        for k, arr in tables.items():
            if arr.shape != tuple(sketch.shape):
                raise ValueError(f"{k} shape {arr.shape} != "
                                 f"{tuple(sketch.shape)} — wrong "
                                 f"FetchSGDConfig?")
        state = F.FetchSGDState(
            momentum_sketch=_tensor(tables["momentum_sketch"], sketch),
            error_sketch=_tensor(tables["error_sketch"], sketch),
            step=int(data["opt_step"]))
        late_buffer = [
            dict(table=_tensor(data[f"late_{i:05d}"], sketch), **e)
            for i, e in enumerate(info.get("late", []))]
        sim_meta = info.get("simtime")
        sim = None
        if sim_meta is not None and "n_events" in sim_meta:
            n_ev = int(sim_meta["n_events"])
            cols = {k: data[f"event_{k}"] for k in
                    ("time", "round", "slot", "client", "produced",
                     "weight", "loss")}
            ev_tables = data["event_tables"] if n_ev else None
            sim = {"now": float(sim_meta["now"]),
                   "events": [simtime_lib.Event(
                       time=float(cols["time"][i]),
                       round_produced=int(cols["round"][i]),
                       slot=int(cols["slot"][i]),
                       client=int(cols["client"][i]),
                       produced=float(cols["produced"][i]),
                       weight=float(cols["weight"][i]),
                       loss=float(cols["loss"][i]),
                       table=_tensor(ev_tables[i], sketch))
                       for i in range(n_ev)]}
        elif sim_meta is not None:
            # migration shim: legacy heap-queue checkpoints stored one
            # ``event_%05d`` npz member per in-flight event plus a sidecar
            # meta list; load them into the same Event objects the columnar
            # format produces
            sim = {"now": float(sim_meta["now"]),
                   "events": [simtime_lib.Event(
                       table=_tensor(data[f"event_{i:05d}"], sketch), **m)
                       for i, m in enumerate(sim_meta["events"])]}
    params = layout_lib.unflatten([p for p, _ in named], new_leaves)
    return Checkpoint(params=params, opt_state=state,
                      round_idx=int(info["round"]),
                      extra=info.get("extra", {}), late_buffer=late_buffer,
                      simtime=sim)


def _prune(directory: str, keep: int) -> None:
    rounds = sorted(r for r in (int(m.group(1))
                    for m in (_CKPT_RE.match(n) for n in os.listdir(directory))
                    if m))
    for r in rounds[:-keep] if keep > 0 else []:
        for path in _paths(directory, r):
            try:
                os.remove(path)
            except OSError:
                pass
