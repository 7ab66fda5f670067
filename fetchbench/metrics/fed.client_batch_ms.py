"""fed.client_batch_ms: the host time of the program's ``fed.client.batch``
spans (each client's numpy batch and its copy to the device), summed over
the traced window and divided by its rounds."""


def read(ctx):
    d = [e["dur_s"] for e in ctx.spans if e["name"] == "fed.client.batch"]
    return 1e3 * sum(d) / ctx.rounds if d and ctx.rounds else None
