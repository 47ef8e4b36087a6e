"""Host ms of one replay call of the cell's captured verifier: one feed of
the stream timed with CUDA events around its graph replay, the host's
time inside ``CUDAGraph.replay`` (``common.replay_split``)."""


def read(ctx):
    split = ctx.probe("replay_split")
    return None if split is None or split["replays"] != 1 else split["host_ms"]
