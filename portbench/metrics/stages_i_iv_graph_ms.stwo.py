"""Device ms of the stwo verifier's stages I-IV, the transcript through the
query draw, inside the stream's graph as it replays: the device span
`dev.stwo.stages_i_iv`, median over the batches of the program-span
stretch (``program_spans``)."""

from portbench import program_spans as S


def read(ctx):
    return S.median_ms(ctx, "dev.stwo.stages_i_iv")
