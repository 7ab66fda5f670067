"""Telemetry for the federation runtime: metrics, spans, sinks, schema.

Port of ``repro.obs``, with the same event stream.  One import point for
instrumented code::

    from repro_torch import obs

    tele = obs.Telemetry([obs.JsonlSink("run.jsonl")], trace=True)
    with tele.span("round", round=r) as sp:
        tele.counter("bytes").inc(n)
        out = sp.sync(kernel(x))        # span waits for the card's work
    tele.close()                        # final metrics snapshot event

Disabled is the default and must stay free: ``obs.NOOP`` satisfies the
same API with shared stateless singletons.  The JSONL contract lives in
``repro_torch.obs.schema`` (also a CLI: ``python -m repro_torch.obs
run.jsonl``); the reference's ``python -m repro.obs`` and
``scripts/report_run.py`` read a port run's stream unchanged.
"""

from .metrics import (Counter, Gauge, Histogram,              # noqa: F401
                      MetricsRegistry, default_buckets,
                      quantile_from_snapshot)
from .schema import (EVENT_SCHEMAS, validate_event,           # noqa: F401
                     validate_events, validate_jsonl)
from .sinks import (JsonlSink, MemorySink, NullSink, Sink,    # noqa: F401
                    StdoutSummarySink, parse_jsonl)
from .telemetry import (NOOP, NoopTelemetry, Telemetry,       # noqa: F401
                        active, add_cli_flags, current, env_fingerprint,
                        from_args)
from .trace import NULL_SPAN, NullSpan, Span                  # noqa: F401

# NOTE: ``repro_torch.obs.sketch_health`` is imported lazily by its users
# (it pulls in repro_torch.core and the kernels).
