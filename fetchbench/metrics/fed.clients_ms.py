"""fed.clients_ms: the mean of the program's ``fed.clients`` span (every
cohort client's gradient and sketch, ended by a device sync) over the
traced rounds."""


def read(ctx):
    d = [e["dur_s"] for e in ctx.spans if e["name"] == "fed.clients"]
    return 1e3 * sum(d) / len(d) if d else None
