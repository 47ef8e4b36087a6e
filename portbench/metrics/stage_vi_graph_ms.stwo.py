"""Device ms of the stwo verifier's stage VI, the query points and the DEEP
quotients, inside the stream's graph as it replays: the device span
`dev.stwo.stage_vi`, median over the batches of the program-span stretch
(``program_spans``)."""

from portbench import program_spans as S


def read(ctx):
    return S.median_ms(ctx, "dev.stwo.stage_vi")
