"""The program's own spans (``stark_symphony_tpu_torch/utils/trace``'s
``record_spans``) over a stretch of the cell's stream, read by the
``program_span`` metrics.

The stretch runs once a run, after the profiled stretch, and is kept on
the run's ``Context``.  It builds a fresh ``StreamVerifier`` at the
traffic's `depth` over the driver's own verify function (``verify_fn`` of
the driver module), so its graph is captured under the recorder and holds
the verifier's stage spans as event nodes; its first feed, the capture, is
recorded apart and not read.  Then it feeds each of the driver's distinct
host batches twice and drains.  Every bitmap it gets is appended, with
its batch index, to the driver's, so the reference checks them as it
checks the window's.  Then the stream is freed.

A reading is the median over the stretch's batches of a batch's ms in the
named spans (summed where a batch has several).  Where the program has
no span recorder, nothing is run and every reading is None.
"""

from __future__ import annotations

from portbench.common import quantile

ROUNDS = 2  # feeds of each distinct host batch


def per_batch(ctx):
    """{span name: {batch number: ms}} of the stretch, run at the first
    call and kept on `ctx`; None where the program records no spans."""
    if not hasattr(ctx, "program_spans"):
        ctx.program_spans = _stretch(ctx)
    return ctx.program_spans


def median_ms(ctx, *names):
    """The median over the stretch's batches of the batch's ms in the spans
    `names` (the batches that have each of them), or None."""
    table = per_batch(ctx)
    if not table or any(n not in table for n in names):
        return None
    batches = set.intersection(*(set(table[n]) for n in names))
    if not batches:
        return None
    return quantile([sum(table[n][b] for n in names) for b in batches], 0.5)


def _stretch(ctx):
    from stark_symphony_tpu_torch.utils import trace

    record_spans = getattr(trace, "record_spans", None)
    if record_spans is None:
        return None
    import torch
    from stark_symphony_tpu_torch.parallel.pipeline import StreamVerifier

    driver = ctx.driver
    stream = getattr(driver, "stream", None)
    if stream is not None:  # the driver's batches in flight come back first
        driver.bitmaps += [b.cpu().numpy() for b in stream.finish()]
    verify = ctx.cell.driver().verify_fn(driver.config, driver.control)
    ours = StreamVerifier(verify, depth=ctx.cell.traffic["depth"], device=driver.dev)
    order = [0] + list(range(len(driver.host))) * ROUNDS
    with record_spans():  # the capture: its spans are not read
        ours.feed(driver.host[order[0]])
    with record_spans() as spans:
        for k in order[1:]:
            ours.feed(driver.host[k])
        bitmaps = [b.cpu().numpy() for b in ours.finish()]
    driver.fed += order
    driver.bitmaps += bitmaps
    del ours
    if driver.dev.type == "cuda":
        torch.cuda.synchronize(driver.dev)
        torch.cuda.empty_cache()
    table = {}
    for s in spans.spans:
        b = s.attrs.get("batch")
        if b is not None and b > 0:  # batch 0 is the capture's
            row = table.setdefault(s.name, {})
            row[b] = row.get(b, 0.0) + s.ms
    return table
