"""Device ms of the stark101 verifier's transcript, genesis through the
query draw, inside the stream's graph as it replays: the device span
`dev.stark101.transcript`, median over the batches of the program-span
stretch (``program_spans``)."""

from portbench import program_spans as S


def read(ctx):
    return S.median_ms(ctx, "dev.stark101.transcript")
