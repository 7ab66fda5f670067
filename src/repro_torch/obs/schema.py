"""JSONL event schema: the contract between emitters and report tooling.

The port's own copy of ``repro.obs.schema``: the same event types and
fields, so a port run's stream reads unchanged under ``python -m
repro.obs`` and ``scripts/report_run.py``.

Every event is one JSON object with at least ``type`` (str) and ``t``
(float seconds since telemetry start).  Known types carry required,
typed fields; unknown types are rejected — an emitter adding an event
kind must register it here, which is what keeps ``scripts/report_run.py``
and CI's schema gate honest.

Validate a stream from the command line (non-zero exit on any error):

    PYTHONPATH=src python -m repro_torch.obs run.jsonl
"""

from __future__ import annotations

import numbers
import sys

_NUM = numbers.Real
_OPT_NUM = (numbers.Real, type(None))

# type -> {field: python type (or tuple of types)}; events may carry extra
# fields beyond these (forward-compatible), but never miss or mistype one.
EVENT_SCHEMAS: dict[str, dict] = {
    "meta": {"env": dict},
    "round": {"round": numbers.Integral, "loss": _OPT_NUM,
              "cohort_size": numbers.Integral,
              "n_fresh": numbers.Integral, "n_late": numbers.Integral,
              "n_dropped": numbers.Integral,
              "n_straggling": numbers.Integral,
              "upload_bytes": _NUM, "download_bytes": _NUM,
              "dense_equiv_upload_bytes": _NUM,
              "dense_equiv_download_bytes": _NUM,
              "upload_compression_x": _NUM,
              "total_compression_x": _NUM},
    "span": {"name": str, "dur_s": _NUM, "depth": numbers.Integral,
             "parent": (str, type(None))},
    "sketch_health": {"round": numbers.Integral,
                      "error_sketch_norm": _NUM,
                      "momentum_sketch_norm": _NUM,
                      "agg_table_norm": _NUM,
                      "recovery_rel_err": _OPT_NUM,
                      "heavy_hitter_overlap": _OPT_NUM},
    "metrics": {"counters": dict, "gauges": dict, "histograms": dict},
    "dryrun": {"arch": str, "shape": str},
    "train_round": {"round": numbers.Integral, "loss": _NUM,
                    "step_seconds": _NUM},
}


def validate_event(ev: object, idx: int | None = None) -> list[str]:
    """Errors for one event ([] = valid)."""
    where = f"event {idx}" if idx is not None else "event"
    if not isinstance(ev, dict):
        return [f"{where}: not an object"]
    errs = []
    etype = ev.get("type")
    if not isinstance(etype, str):
        return [f"{where}: missing/invalid 'type'"]
    if not isinstance(ev.get("t"), _NUM):
        errs.append(f"{where} ({etype}): missing/invalid 't'")
    spec = EVENT_SCHEMAS.get(etype)
    if spec is None:
        errs.append(f"{where}: unknown event type {etype!r}")
        return errs
    for field, typ in spec.items():
        if field not in ev:
            errs.append(f"{where} ({etype}): missing field {field!r}")
        elif not isinstance(ev[field], typ):
            errs.append(f"{where} ({etype}): field {field!r} has type "
                        f"{type(ev[field]).__name__}, want {typ}")
    return errs


def validate_events(events: list[dict]) -> list[str]:
    errs = []
    for i, ev in enumerate(events):
        errs.extend(validate_event(ev, i))
    if not events:
        errs.append("empty event stream")
    return errs


def validate_jsonl(path: str) -> list[str]:
    from . import sinks
    try:
        events = sinks.parse_jsonl(path)
    except Exception as e:
        return [f"{path}: unreadable ({e})"]
    return validate_events(events)


def main(argv: list[str]) -> int:
    if not argv:
        print("usage: python -m repro_torch.obs RUN.jsonl [...]",
              file=sys.stderr)
        return 2
    bad = 0
    for path in argv:
        errs = validate_jsonl(path)
        if errs:
            bad += 1
            for e in errs:
                print(f"{path}: {e}", file=sys.stderr)
        else:
            from . import sinks
            n = len(sinks.parse_jsonl(path))
            print(f"{path}: OK ({n} events)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
