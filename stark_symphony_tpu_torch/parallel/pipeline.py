"""Pipelining over proof batches: micro-batches and a stream of host batches.

Counterpart of ``stark_symphony_tpu/parallel/pipeline.py``.  The port's
verifiers are natively batched, so both functions take the batched
verifier (``verify_batch_fn``: device batch -> accept bitmap) where the JAX
package takes a one-proof verifier and ``vmap``.

* ``scan_microbatches`` verifies a batch micro-batch by micro-batch: one
  graph of size `micro` (``tools.build.capture``) replayed on each, so peak
  memory follows `micro`, not the batch.
* ``StreamVerifier`` verifies numpy batches as they arrive.  Each batch's
  words are copied into pinned host buffers, sent to the device on a copy
  stream, and handed by an event to a compute stream, which lays them out
  (``layout``: widened to int64 words, or ``tiled.relayout`` for the tiled
  path) and replays the verifier's graph.  The copy of batch i+1 overlaps
  the verification of batch i.  There are `depth` slots of buffers; one
  graph serves them all, fed by a device-to-device copy into its static
  inputs (``GraphedVerifier``), so the graphs' memory does not grow with
  `depth`.  On the CPU the same steps run without streams, pinned memory or
  a graph.

Its spans (``utils/trace.record_spans``; a global test each when none is
recorded): ``stream.feed`` around each feed, with ``batch=<feed number>``
(every span of the feed inherits it), and inside it ``stream.slot_wait``
(the slot's last copy), ``stream.stage`` (``host_i32`` and the copy into
pinned memory) and ``stream.enqueue`` (the copy, the widen and the graph
call), then ``stream.drain`` for each batch drained, with its own
``batch``.  Device spans: ``dev.stream.h2d`` on the copy stream,
``dev.stream.widen`` and the graph's ``dev.graph.replay`` on the compute
stream; a batch's device spans are read at its drain, once its bitmap is
done.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.u32 import from_i32, host_i32
from ..tools.build import capture, tree_leaves, tree_map
from ..utils import trace


def scan_microbatches(verify_batch_fn, batch, micro: int) -> torch.Tensor:
    """Accept bitmap of `batch` (a proof pytree whose every tensor has the
    leading axis B, B divisible by `micro`), computed micro-batch by
    micro-batch with one graph of size `micro`; equal to
    verify_batch_fn(batch).  A tiled batch (lanes on the last axis) is not
    such a pytree."""
    sizes = {x.shape[0] for x in tree_leaves(batch) if isinstance(x, torch.Tensor)}
    if len(sizes) != 1:
        raise ValueError(f"ragged proof batch: leading sizes {sorted(sizes)}")
    b = sizes.pop()
    if micro < 1 or b % micro:
        raise ValueError(f"batch {b} not divisible by micro {micro}")
    parts = [tree_map(lambda x, i=i: x[i:i + micro], batch) for i in range(0, b, micro)]
    fn = capture(verify_batch_fn, (parts[0],))
    return torch.cat([fn(p) for p in parts])


def widen(words):
    """The standard layout: every int32 word tensor of a batch widened to
    int64 words (what ``proof.to_torch`` gives)."""
    return tree_map(from_i32, words)


class StreamVerifier:
    """Streaming verification of host (numpy) proof batches, up to `depth`
    in flight.

    feed() stages a batch and enqueues its copy and its verification;
    finish() waits for everything in flight and returns the bitmaps in the
    order fed.  The verifier's graph is captured at the first feed, on the
    first batch's shapes; every later batch must have them."""

    def __init__(self, verify_batch_fn, depth: int = 2, device="cuda", layout=widen):
        if depth < 1:
            raise ValueError(f"depth must be at least 1, not {depth}")
        self._fn = verify_batch_fn
        self._layout = layout
        self._depth = depth
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._slots = [None] * depth
        self._next = 0
        self._fed = 0
        self._graph = None
        self._inflight = []  # (batch number, bitmap, event recorded after it, span mark)
        self._done = []
        if self._cuda:
            self._copy = torch.cuda.Stream(self.device)
            self._compute = torch.cuda.Stream(self.device)

    def _slot(self):
        """The next slot: (pinned host words, device words, copied,
        consumed), or None before its first use (``_make_slot``)."""
        k = self._next
        self._next = (k + 1) % self._depth
        return k, self._slots[k]

    def _make_slot(self, k, host):
        """Slot k, made on the shapes of `host`."""
        pinned = tree_map(lambda a: torch.empty(a.shape, dtype=torch.int32,
                                                pin_memory=True), host)
        dev = tree_map(lambda a: torch.empty(a.shape, dtype=torch.int32,
                                             device=self.device), host)
        self._slots[k] = (pinned, dev, torch.cuda.Event(), torch.cuda.Event())
        return self._slots[k]

    def _verify(self, words):
        with trace.device_span("dev.stream.widen", self.device):
            batch = self._layout(words)
        if self._graph is None:
            self._graph = capture(self._fn, (batch,))
        return self._graph(batch)

    def feed(self, batch) -> None:
        seq, self._fed = self._fed, self._fed + 1
        with trace.span("stream.feed", batch=seq):
            if not self._cuda:
                with trace.span("stream.stage"):
                    host = tree_map(torch.from_numpy, tree_map(host_i32, batch))
                with trace.span("stream.enqueue"):
                    self._done.append(self._verify(host))
                return
            k, slot = self._slot()
            if slot is not None:
                with trace.span("stream.slot_wait"):
                    slot[2].synchronize()  # the slot's last copy has read its pinned words
            with trace.span("stream.stage"):
                host = tree_map(host_i32, batch)
                pinned, dev, copied, consumed = slot or self._make_slot(k, host)
                tree_map(lambda p, a: np.copyto(p.numpy(), a), pinned, host)
            with trace.span("stream.enqueue"):
                with torch.cuda.stream(self._copy):
                    self._copy.wait_event(consumed)  # the slot's last batch is laid out
                    with trace.device_span("dev.stream.h2d", self.device):
                        tree_map(lambda d, p: d.copy_(p, non_blocking=True), dev, pinned)
                    copied.record(self._copy)
                with torch.cuda.stream(self._compute):
                    self._compute.wait_event(copied)
                    bitmap = self._verify(dev)
                    consumed.record(self._compute)
                    done = torch.cuda.Event()
                    done.record(self._compute)
            self._inflight.append((seq, bitmap, done, trace.mark()))
            while len(self._inflight) > self._depth:
                self._drain_one()

    def _drain_one(self) -> None:
        seq, bitmap, done, mark = self._inflight.pop(0)
        with trace.span("stream.drain", batch=seq):
            done.synchronize()
            trace.resolve(mark)
        self._done.append(bitmap)

    def finish(self) -> list:
        """Wait for every batch in flight; the bitmaps in the order fed."""
        while self._inflight:
            self._drain_one()
        out, self._done = self._done, []
        return out
