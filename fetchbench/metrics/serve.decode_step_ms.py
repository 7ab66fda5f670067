"""serve.decode_step_ms: the mean of the program's own time per decode
step (``ServeResult.decode_s``: host clock over the call's decode steps,
ended by a device sync) over the traced calls."""


def read(ctx):
    d = [c["decode_s"] for c in ctx.calls]
    return 1e3 * sum(d) / len(d) if d else None
