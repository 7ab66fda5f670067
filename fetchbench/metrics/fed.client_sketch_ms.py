"""fed.client_sketch_ms: the device time (``dev_s``, between the CUDA
events the span records) of the program's ``fed.client.sketch`` spans
(each client's Count Sketch of its gradient), summed over the traced
window and divided by its rounds."""


def read(ctx):
    d = [e["dev_s"] for e in ctx.spans
         if e["name"] == "fed.client.sketch" and "dev_s" in e]
    return 1e3 * sum(d) / ctx.rounds if d and ctx.rounds else None
