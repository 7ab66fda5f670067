"""moe.fwd_ms: the device time (``dev_s``) of the program's ``model.moe``
spans (each forward of a sigmoid-routed expert layer: router, the held
experts' products, the combine and the shared experts, with the host
sync that sizes the products), summed over the traced window and divided
by its rounds.  The backward passes are not spanned."""


def read(ctx):
    d = [e["dev_s"] for e in ctx.spans
         if e["name"] == "model.moe" and "dev_s" in e]
    return 1e3 * sum(d) / ctx.rounds if d and ctx.rounds else None
