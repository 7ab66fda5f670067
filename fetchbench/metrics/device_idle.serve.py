"""device_idle.serve: the share of the traced calls' window in which no
kernel, copy or set ran on the device (the union of the profiler's device
intervals)."""


def read(ctx):
    if ctx.busy_s <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
