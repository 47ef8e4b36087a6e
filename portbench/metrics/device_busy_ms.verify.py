"""Device busy ms a verified batch: the union of the kernels, copies and
sets of the traced stretch (``profiled_batches`` batches fed and drained),
over the batches."""


def read(ctx):
    p = ctx.profile
    busy = p.busy_s() if p is not None else 0.0
    return 1e3 * busy / p.units if busy > 0 else None
