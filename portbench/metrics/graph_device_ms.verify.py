"""Device ms of one replay of the stream's captured verifier: the device
span `dev.graph.replay` around ``CUDAGraph.replay``, median over the
batches of the program-span stretch (``program_spans``)."""

from portbench import program_spans as S


def read(ctx):
    return S.median_ms(ctx, "dev.graph.replay")
