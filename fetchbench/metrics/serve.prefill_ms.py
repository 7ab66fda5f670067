"""serve.prefill_ms: the mean of the program's own prefill time
(``ServeResult.prefill_s``: host clock ended by a device sync) over the
traced calls."""


def read(ctx):
    d = [c["prefill_s"] for c in ctx.calls]
    return 1e3 * sum(d) / len(d) if d else None
