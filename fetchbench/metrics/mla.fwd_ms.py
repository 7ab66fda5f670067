"""mla.fwd_ms: the device time (``dev_s``) of the program's ``model.mla``
spans (each forward of a latent attention block: projections, the
latent's norm, RoPE, the causal core and the output projection), summed
over the traced window and divided by its rounds.  The backward passes
are not spanned."""


def read(ctx):
    d = [e["dev_s"] for e in ctx.spans
         if e["name"] == "model.mla" and "dev_s" in e]
    return 1e3 * sum(d) / ctx.rounds if d and ctx.rounds else None
