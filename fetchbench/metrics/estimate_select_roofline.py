"""estimate_select_roofline: the least time the server's per-chunk
estimate and candidate selection need over the device time of the fused
kernels, in percent.

The work, from the layout: for each selection chunk, the rows x cols
float32 table read once and its kk candidates (a float32 value and an
int64 index each) written once, at the H100's 3.35 TB/s."""

from fetchbench.reference import sketch

KERNELS = ("estimate_hist_kernel", "refine_kernel", "tile_count_kernel",
           "tile_write_kernel")


def bytes_per_round(fam, cfg: dict, sk: dict) -> int:
    """``fam``: the configuration's reference family."""
    spans = sketch.chunks(fam.param_spec(cfg))
    table = 4 * sk["rows"] * sk["cols"]
    return sum(table + 12 * sketch.chunk_k(sk["k"], n, len(spans))
               for _, n in spans)


def read(ctx):
    t = sum(s for n, s in ctx.kernels.items() if any(k in n for k in KERNELS))
    if t <= 0 or not ctx.rounds:
        return None
    need = ctx.rounds * bytes_per_round(ctx.family, ctx.config,
                                        ctx.cell["sketch"])
    return 100.0 * need / ctx.peaks["hbm_bytes"] / t
