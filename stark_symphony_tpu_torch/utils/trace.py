"""Transcript, op and span tracing (the execution-tracker analogue).

Port of ``stark_symphony_tpu/utils/trace.py``.  ``record_transcript``
records every Fiat-Shamir channel operation (mix/draw) with its value
while a verifier runs, for bit-exactness triage against the native oracle
(``native/symphony verify-stwo -v`` prints the same digests);
``record_ops`` records every field, hash, Merkle and circle primitive call
with decoded arguments and result, and stwo's stage VI (``fri_answers``)
as one op.

The port runs eagerly, so values are concrete as they are recorded (the
JAX package turns jit off for the same end).  Recording copies each value
to the host, one device-to-host synchronisation an event on the card.
Neither recorder may be entered while a CUDA graph is being captured, and
a value met during a capture is not recorded: both raise
``EagerOnlyError``.  A replay of a captured graph (``tools/build``'s
``GraphedVerifier``) runs no Python, so it records nothing.

The third recorder, ``record_spans``, times where the work happens and
records no values, so it is safe inside a capture.  ``span(name,
**attrs)`` is a host span (``time.perf_counter_ns``); ``device_span(name,
device, **attrs)`` a device span: a pair of timing CUDA events on the
device's current stream (the host clock on the CPU).  Met while a graph
is captured, a device span becomes a pair of event-record nodes
(``external`` events) that every replay of that graph records again;
``GraphedVerifier`` turns each replay's pass over them into spans of its
own.  Each span keeps its name, start and end, the id of the span open
around it (its parent) and its attrs, with its parent's attrs under its
own (so every span of one stream batch carries that batch's
``batch=<feed number>``).  A device span is read with ``elapsed_time``
against the recorder's anchor only where the program already waits (a
stream batch's drain, ``record_spans``'s exit), except that a graph
captured under the recorder waits for its own last replay before the next
(``GraphedVerifier``).  The anchor pairs one synchronised CUDA event
with ``perf_counter_ns`` and ``time.time_ns`` (the clock of
``torch.profiler``'s ``start_ns()``), so every span lies on one timeline
beside a profiler trace.  Spans stay in memory; ``summary()`` reads them.

With no span recorder, a span costs a test of one global, as ``emit``
does, plus, for a host span, a test of whether ``torch.profiler`` is
running: while it is, a host span enters ``record_function(name)``, so a
profiled trace shows the program's spans as user annotations.  A graph
captured with no recorder holds no event nodes and never waits.

Usage:
    with record_transcript() as events:
        verifier.verify(proof, cfg)
    print(format_transcript(events))

    with record_spans() as spans:
        stream.feed(batch)
        stream.finish()
    print(spans.summary())
"""

from __future__ import annotations

import contextlib
import importlib
import itertools
import time
from typing import Any, List, Tuple

import numpy as np
import torch

from ..ops.checks import EagerOnlyError, capturing
from ..ops.u32 import WORD

_TRACE: List[Tuple[str, Any]] | None = None


def _refuse_capture(what: str) -> None:
    if capturing():
        raise EagerOnlyError(f"{what} reads values on the host and cannot run inside a "
                             "CUDA graph capture; trace an eager call")


def _host(x) -> np.ndarray:
    """A tensor's values on the host; int64 word tensors as np.uint32, the
    JAX package's dtype for them."""
    _refuse_capture("tracing")
    a = x.detach().cpu().numpy()
    return a.astype(np.uint32) if x.dtype == WORD else a


def emit(op: str, value) -> None:
    """Record one channel event if a transcript is being recorded: a test
    of one global when none is (no copy, no launch, no sync)."""
    if _TRACE is not None:
        _TRACE.append((op, _host(value)))


@contextlib.contextmanager
def record_transcript():
    """Context manager: collects the (op, value) channel events of the
    eager calls inside it."""
    global _TRACE
    _refuse_capture("record_transcript")
    prev = _TRACE
    _TRACE = []
    try:
        yield _TRACE
    finally:
        _TRACE = prev


def _hex_words(words: np.ndarray) -> str:
    flat = np.atleast_1d(words).reshape(-1)
    return "".join(f"{int(w):08x}" for w in flat)


def format_transcript(events) -> str:
    lines = []
    for i, (op, value) in enumerate(events):
        lines.append(f"[{i:3d}] {op:<14s} {_hex_words(value)}")
    return "\n".join(lines)


# (module, attributes) wrapped by record_ops: the port's primitives, and
# every module that imports a hash op by name (``from ...ops.sha256 import
# sha256_words``): rebinding only ops.sha256's global would miss their
# call sites.
_OP_SITES = [
    ("stark_symphony_tpu_torch.ops.field",
     ("m31_add", "m31_sub", "m31_mul", "m31_neg", "m31_inv",
      "cm31_mul", "cm31_inv",
      "qm31_mul", "qm31_inv", "qm31_mul_m31", "qm31_mul_cm31")),
    ("stark_symphony_tpu_torch.ops.sha256", ("sha256_words", "sha256_pair")),
    ("stark_symphony_tpu_torch.ops.merkle", ("compute_root", "sha256_pair")),
    ("stark_symphony_tpu_torch.ops.circle", ("point_add", "point_from_index")),
    ("stark_symphony_tpu_torch.ops.field101",
     ("f_add", "f_sub", "f_mul", "f_inv", "f_pow", "mod_u64")),
    # direct-import call sites of the hash ops
    ("stark_symphony_tpu_torch.models.stwo.channel", ("sha256_words",)),
    ("stark_symphony_tpu_torch.models.stwo.verifier",
     ("sha256_words", "sha256_pair", "fri_answers")),
    ("stark_symphony_tpu_torch.models.stwo.prover", ("sha256_words",)),
    ("stark_symphony_tpu_torch.models.stark101.channel", ("sha256_words",)),
    ("stark_symphony_tpu_torch.models.stark101.verifier", ("sha256_words",)),
    ("stark_symphony_tpu_torch.models.stark101.prover", ("sha256_words",)),
    ("stark_symphony_tpu_torch.parallel.fri_shard", ("sha256_words", "sha256_pair")),
]
# Ops recorded whole: one event, and none for the primitives they call.  On
# the card stage VI is one kernel (K6), so its plain version's field ops on
# the CPU are hidden too, and the two devices record the same events.
_WHOLE_OPS = {"fri_answers"}


def _summarize(x):
    """Decode one argument/result into a compact printable form, as the
    JAX package prints it."""
    if isinstance(x, torch.Tensor):
        a = _host(x)
    else:
        try:
            a = np.asarray(x)
        except (TypeError, ValueError):
            return repr(x)
    if a.ndim == 0:
        return f"{int(a):#x}" if np.issubdtype(a.dtype, np.integer) else str(a)
    flat = a.reshape(-1)
    if flat.size <= 8 and np.issubdtype(a.dtype, np.integer):
        return "[" + " ".join(f"{int(v):08x}" for v in flat) + "]"
    return f"<{a.dtype}{list(a.shape)}>"


@contextlib.contextmanager
def record_ops(ops=None):
    """Record every primitive-op call with decoded args and results.

    Usage:
        with record_ops() as events:
            verifier.verify(proof, cfg)
        print(format_ops(events))

    `ops`: optional iterable of op names to restrict to (e.g. {"m31_mul"}).
    Events are (name, [decoded args], decoded result) tuples.  The
    primitives are wrapped inside the block and the originals restored on
    leaving it, so the hot path carries no hook outside it.
    """
    _refuse_capture("record_ops")
    events: List[tuple] = []
    saved = []
    only = set(ops) if ops is not None else None

    inside = [0]  # calls of _WHOLE_OPS open

    def _wrap(name, fn):
        whole = name in _WHOLE_OPS

        def wrapper(*args, **kwargs):
            inside[0] += whole
            try:
                out = fn(*args, **kwargs)
            finally:
                inside[0] -= whole
            if not inside[0] and (only is None or name in only):
                events.append((name, [_summarize(a) for a in args], _summarize(out)))
            return out

        wrapper.__name__ = f"traced_{name}"
        wrapper.__wrapped__ = fn
        return wrapper

    # every module imported before any is patched: a module first imported
    # inside the patch would bind a wrapper by name and keep it
    mods = [(importlib.import_module(name), attrs) for name, attrs in _OP_SITES]
    try:
        for mod, attrs in mods:
            for attr in attrs:
                orig = getattr(mod, attr)
                saved.append((mod, attr, orig))
                setattr(mod, attr, _wrap(attr, orig))
        yield events
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def format_ops(events, limit: int | None = None) -> str:
    lines = []
    for i, (name, args, out) in enumerate(events):
        if limit is not None and i >= limit:
            lines.append(f"... ({len(events) - limit} more)")
            break
        lines.append(f"[{i:5d}] {name:<16s} ({', '.join(args)}) -> {out}")
    return "\n".join(lines)


# --- spans ------------------------------------------------------------------------

_SPANS: "SpanRecorder | None" = None  # the recorder spans go to, or None
_CAPTURE: "GraphSpans | None" = None  # the graph being captured under GraphedVerifier
_IDS = itertools.count()  # span ids, unique across recorders
_NULL = contextlib.nullcontext()


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class Span:
    """One span: `name`, `start_ns` and `end_ns` on ``perf_counter_ns``'s
    clock, `parent` (the id of the span open around it, None at a root),
    `attrs`, and `device` (a device span)."""

    __slots__ = ("id", "name", "parent", "attrs", "device", "start_ns", "end_ns")

    def __init__(self, name, parent, attrs, device):
        self.id = next(_IDS)
        self.name = name
        self.attrs = attrs if parent is None else {**parent.attrs, **attrs}
        self.parent = None if parent is None else parent.id
        self.device = device
        self.start_ns = self.end_ns = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


def _quantile(sorted_values, share: float) -> float:
    pos = share * (len(sorted_values) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    return sorted_values[lo] + (sorted_values[hi] - sorted_values[lo]) * (pos - lo)


def _cover_ns(intervals) -> int:
    total, reach = 0, None
    for lo, hi in sorted(intervals):
        if reach is None or lo > reach:
            total, reach = total + hi - lo, hi
        elif hi > reach:
            total, reach = total + hi - reach, hi
    return total


class SpanRecorder:
    """The spans of one ``record_spans`` block.  `spans`: the spans read so
    far (a host span when it ends, a device span when its events are
    read); `perf_ns` and `unix_ns`: the anchor's two host clocks."""

    def __init__(self):
        self.spans: List[Span] = []
        self._open: List[Span] = []  # spans entered and not left, innermost last
        self._pending = []  # (span, start event, end event, device index), not read yet
        self._anchors = {}  # CUDA device index -> (event, its perf_counter_ns)
        if torch.cuda.is_available() and torch.cuda.is_initialized() and not capturing():
            self._anchor(torch.cuda.current_device())  # others at their first span
        self.perf_ns = time.perf_counter_ns()
        self.unix_ns = time.time_ns()

    def _anchor(self, index: int):
        """Device `index`'s anchor: an event recorded on an idle device and
        waited for, paired with the host clock as the wait returns."""
        if index not in self._anchors:
            torch.cuda.synchronize(index)
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(index))
            event.synchronize()
            self._anchors[index] = (event, time.perf_counter_ns())
        return self._anchors[index]

    def unix(self, ns: int) -> int:
        """`ns` of ``perf_counter_ns``'s clock on the Unix clock in ns, the
        clock of ``torch.profiler``'s ``start_ns()``."""
        return self.unix_ns + ns - self.perf_ns

    def _enter(self, name, attrs, device) -> Span:
        s = Span(name, self._open[-1] if self._open else None, attrs, device)
        self._open.append(s)
        return s

    def _leave(self, s: Span) -> None:
        if self._open.pop() is not s:
            raise RuntimeError(f"span {s.name!r} left out of order")

    def _read(self, rec) -> None:
        span, start, end, index = rec
        if span.start_ns is not None:
            return
        anchor, at = self._anchors[index]
        span.start_ns = at + round(anchor.elapsed_time(start) * 1e6)
        span.end_ns = span.start_ns + round(start.elapsed_time(end) * 1e6)
        self.spans.append(span)

    def resolve(self, upto=None) -> None:
        """Read the device spans begun before span id `upto` (every one where
        `upto` is None): their events must have completed."""
        keep = []
        for rec in self._pending:
            if upto is None or rec[0].id < upto:
                self._read(rec)
            elif rec[0].start_ns is None:
                keep.append(rec)
        self._pending = keep

    def close(self) -> None:
        """Wait for every anchored device and read every device span."""
        for index in self._anchors:
            torch.cuda.synchronize(index)
        self.resolve()

    def named(self, name: str) -> List[Span]:
        """The spans called `name`, in order of their start."""
        return sorted((s for s in self.spans if s.name == name), key=lambda s: s.start_ns)

    def summary(self) -> dict:
        """Per name, in ms: count, total, median, p95, max, and self (the
        durations less the cover of each span's children of its own kind,
        host or device)."""
        children = {}
        for s in self.spans:
            children.setdefault((s.parent, s.device), []).append(s)
        groups = {}
        for s in self.spans:
            groups.setdefault(s.name, []).append(s)
        out = {}
        for name, group in groups.items():
            ms = sorted(s.ms for s in group)
            own = 0
            for s in group:
                kids = [(max(c.start_ns, s.start_ns), min(c.end_ns, s.end_ns))
                        for c in children.get((s.id, s.device), [])]
                own += s.end_ns - s.start_ns - _cover_ns((a, b) for a, b in kids if b > a)
            out[name] = {"count": len(ms), "total_ms": sum(ms), "median_ms": _quantile(ms, 0.5),
                         "p95_ms": _quantile(ms, 0.95), "max_ms": ms[-1], "self_ms": own / 1e6}
        return out


class _HostSpan:
    __slots__ = ("rec", "name", "attrs", "span", "note")

    def __init__(self, rec, name, attrs):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        self.note = None
        if _profiling():
            self.note = torch.profiler.record_function(self.name)
            self.note.__enter__()
        self.span = self.rec._enter(self.name, self.attrs, False)
        self.span.start_ns = time.perf_counter_ns()
        return self.span

    def __exit__(self, *exc):
        s = self.span
        s.end_ns = time.perf_counter_ns()
        self.rec._leave(s)
        self.rec.spans.append(s)
        if self.note is not None:
            self.note.__exit__(*exc)
        return False


class _DeviceSpan:
    __slots__ = ("rec", "name", "attrs", "device", "span", "start", "index", "graph")

    def __init__(self, rec, name, device, attrs):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.device = torch.device("cpu" if device is None else device)

    def __enter__(self):
        self.span = self.start = self.graph = None
        if self.device.type != "cuda":  # the host's clock
            self.span = self.rec._enter(self.name, self.attrs, True)
            self.span.start_ns = time.perf_counter_ns()
            return self.span
        index = self.device.index if self.device.index is not None else torch.cuda.current_device()
        if capturing():
            if _CAPTURE is None or index not in self.rec._anchors:
                return None  # a capture no GraphedVerifier replays, or no anchor
            self.graph = _CAPTURE
        else:
            self.rec._anchor(index)
        self.index = index
        self.start = torch.cuda.Event(enable_timing=True, external=self.graph is not None)
        self.start.record(torch.cuda.current_stream(self.device))
        if self.graph is not None:
            return self.graph._enter(self.name, self.attrs, self.start, index)
        self.span = self.rec._enter(self.name, self.attrs, True)
        return self.span

    def __exit__(self, *exc):
        if self.start is None:
            if self.span is not None:  # the host's clock
                self.span.end_ns = time.perf_counter_ns()
                self.rec._leave(self.span)
                self.rec.spans.append(self.span)
            return False
        end = torch.cuda.Event(enable_timing=True, external=self.graph is not None)
        end.record(torch.cuda.current_stream(self.device))
        if self.graph is not None:
            self.graph._leave(end)
        else:
            self.rec._leave(self.span)
            self.rec._pending.append((self.span, self.start, end, self.index))
        return False


def span(name: str, **attrs):
    """A host span around a block: ``with span("stream.stage"): ...``.
    With no recorder, nothing, or ``record_function(name)`` while
    torch.profiler runs."""
    if _SPANS is None:
        return torch.profiler.record_function(name) if _profiling() else _NULL
    return _HostSpan(_SPANS, name, attrs)


def device_span(name: str, device=None, **attrs):
    """A device span around the work a block enqueues on `device`'s current
    stream (the host's clock on the CPU, where the work is done when the
    block ends); inside a capture under ``GraphedVerifier``, event-record
    nodes of the graph.  With no recorder, nothing."""
    if _SPANS is None:
        return _NULL
    return _DeviceSpan(_SPANS, name, device, attrs)


def mark():
    """The id below every span begun so far, or None with no recorder: a
    stream batch keeps it, and its drain reads its device spans
    (``resolve``)."""
    return None if _SPANS is None else next(_IDS)


def resolve(upto) -> None:
    """Read the device spans begun before `upto` (a ``mark()``), whose work
    the caller has waited for.  Nothing with no recorder or no mark."""
    if _SPANS is not None and upto is not None:
        _SPANS.resolve(upto)


class GraphSpans:
    """The device spans met while a graph was captured: per span its name,
    attrs, the index of the captured span open around it, its two
    external events and the device index.  ``replayed`` makes spans of a
    replay's pass over them, ``settle`` reads those before the events are
    recorded again."""

    def __init__(self):
        self.templates = []
        self._open = []
        self._rec = None
        self._pending = []
        self._done = None

    def _enter(self, name, attrs, start, index):
        parent = self._open[-1] if self._open else None
        self._open.append(len(self.templates))
        self.templates.append([name, attrs, parent, start, None, index])

    def _leave(self, end):
        self.templates[self._open.pop()][4] = end

    def replayed(self, stream) -> None:
        """After a replay on `stream`: under a recorder, one span per
        captured span, to be read once the replay is done."""
        if _SPANS is None or not self.templates:
            return
        rec = _SPANS
        outer = rec._open[-1] if rec._open else None
        made = []
        for name, attrs, parent, start, end, index in self.templates:
            s = Span(name, outer if parent is None else made[parent][0], attrs, True)
            made.append((s, start, end, index))
        rec._pending += made
        self._rec, self._pending = rec, made
        self._done = torch.cuda.Event()
        self._done.record(stream)

    def settle(self) -> None:
        """Before a replay: wait for the last replay made under a recorder
        and read its spans (nothing where there is none)."""
        if self._pending:
            self._done.synchronize()
            for rec in self._pending:
                self._rec._read(rec)
            self._pending = []


@contextlib.contextmanager
def capture_spans():
    """Around a graph's capture: collects the device spans met in it
    (``GraphSpans``; none with no recorder)."""
    global _CAPTURE
    prev, _CAPTURE = _CAPTURE, GraphSpans()
    try:
        yield _CAPTURE
    finally:
        _CAPTURE = prev


@contextlib.contextmanager
def record_spans():
    """Context manager: records the spans met inside it; yields the
    ``SpanRecorder``.  On leaving it waits for the devices it anchored and
    reads every device span."""
    global _SPANS
    prev, _SPANS = _SPANS, SpanRecorder()
    rec = _SPANS
    try:
        yield rec
    finally:
        _SPANS = prev
        rec.close()
