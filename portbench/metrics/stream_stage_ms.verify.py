"""Host ms a batch spends staging in the stream: the span `stream.stage`
(``host_i32`` and the copy into pinned memory), median over the batches
of the program-span stretch (``program_spans``)."""

from portbench import program_spans as S


def read(ctx):
    return S.median_ms(ctx, "stream.stage")
