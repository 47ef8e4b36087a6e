"""Stage VI's graphed ms at the cell's batch, from the port's per-stage
profiler (``tools/profile_verify``: the DEEP quotients captured alone and
replayed, timed with CUDA events), run after the traced stretch."""


def read(ctx):
    return ctx.probe("stage_vi_ms")
