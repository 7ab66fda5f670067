"""fed.server_update_ms: the mean of the program's ``fed.server_update``
span (the server step and the update of the weights, ended by a device
sync) over the traced rounds."""


def read(ctx):
    d = [e["dur_s"] for e in ctx.spans if e["name"] == "fed.server_update"]
    return 1e3 * sum(d) / len(d) if d else None
