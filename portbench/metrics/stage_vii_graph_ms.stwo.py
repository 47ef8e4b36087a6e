"""Device ms of the stwo verifier's stage VII, the folds, the FRI walk and
the last checks, inside the stream's graph as it replays: the device
span `dev.stwo.stage_vii`, median over the batches of the program-span
stretch (``program_spans``)."""

from portbench import program_spans as S


def read(ctx):
    return S.median_ms(ctx, "dev.stwo.stage_vii")
