"""fed.host_syncs: host-device synchronisations a round, the mean of the
``syncs`` count on the program's ``fed.round`` spans (torch's own sync
check, the telemetry's own syncs not counted)."""


def read(ctx):
    n = [e["syncs"] for e in ctx.spans
         if e["name"] == "fed.round" and "syncs" in e]
    return sum(n) / len(n) if n else None
