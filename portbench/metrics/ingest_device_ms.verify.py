"""Device ms a batch takes to come in: the device spans `dev.stream.h2d`
(the copy to the card) and `dev.stream.widen` (int32 words widened to
the verifier's int64 words), their sum a batch, median over the batches
of the program-span stretch (``program_spans``)."""

from portbench import program_spans as S


def read(ctx):
    return S.median_ms(ctx, "dev.stream.h2d", "dev.stream.widen")
