"""encode_roofline: the least time the clients' sketches need over the
device time of the encode kernels, in percent.

The work, from the layout and not from the implementation: each client's
d float32 gradient values read once and its rows x cols float32 table
written once, at the H100's 3.35 TB/s."""

KERNELS = ("one_pass_kernel", "partition_kernel", "accumulate_kernel")


def bytes_per_client(fam, cfg: dict, sketch: dict) -> int:
    """``fam``: the configuration's reference family."""
    d = fam.n_params(fam.param_spec(cfg))
    return 4 * d + 4 * sketch["rows"] * sketch["cols"]


def read(ctx):
    t = sum(s for n, s in ctx.kernels.items() if any(k in n for k in KERNELS))
    if t <= 0 or not ctx.clients:
        return None
    need = len(ctx.clients) * bytes_per_client(ctx.family, ctx.config,
                                               ctx.cell["sketch"])
    return 100.0 * need / ctx.peaks["hbm_bytes"] / t
