"""Device ms of the stwo verifier's stage V, the trace and CP leaves and
their walk, inside the stream's graph as it replays: the device span
`dev.stwo.stage_v`, median over the batches of the program-span stretch
(``program_spans``)."""

from portbench import program_spans as S


def read(ctx):
    return S.median_ms(ctx, "dev.stwo.stage_v")
