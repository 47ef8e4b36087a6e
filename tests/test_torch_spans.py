"""The port's span recorder (``utils/trace.record_spans``) and the spans of
the stream, the compile step and both verifiers, on the CPU.

With no recorder and no profiler a feed and a graphed call make no span
and enter no ``record_function``; under the recorder the stream's and the
graph's host spans come once a batch with their parents and ``batch``;
under ``torch.profiler`` alone they are user annotations, which the
recorder's anchor places on the profiler's clock; each verifier's stage
spans come in code order and cover the call; ``summary``'s self time is
the duration less the children's cover.  The device path (CUDA events,
event nodes replayed by a graph, their reading at a drain or before the
next replay) runs against stand-in events on the host's clock.
"""

import pathlib
import time

import numpy as np
import pytest
import torch

from stark_symphony_tpu_torch.models.stark101 import proof as SP
from stark_symphony_tpu_torch.models.stark101 import verifier as SV
from stark_symphony_tpu_torch.models.stark101.config import Stark101Config
from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.models.stwo import verifier as TV
from stark_symphony_tpu_torch.models.stwo.config import TESTING
from stark_symphony_tpu_torch.parallel.pipeline import StreamVerifier
from stark_symphony_tpu_torch.tools.build import capture
from stark_symphony_tpu_torch.utils import trace as TT
from stark_symphony_tpu_torch.utils.proofcache import cached_stwo_proof

STREAM = ("stream.feed", "stream.stage", "stream.enqueue")
GRAPH = ("graph.copy_in", "graph.replay", "graph.copy_out")


def parity(b):
    """A stand-in batched verifier: cheap, and a graph of one op."""
    return (b["words"].sum(-1) + b["nonce"]) & 1


def host_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"words": rng.integers(0, 1 << 32, (4, 6), dtype=np.uint64).astype(np.uint32),
            "nonce": np.uint32(seed)}


def test_no_recorder_no_profiler_makes_no_span(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span was made with no recorder")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for name in ("Span", "_HostSpan", "_DeviceSpan"):
        monkeypatch.setattr(TT, name, refuse)
    stream = StreamVerifier(parity, device="cpu")
    stream.feed(host_batch())
    stream.feed(host_batch(1))
    assert len(stream.finish()) == 2
    graphed = capture(parity, ({"words": torch.zeros(4, 6, dtype=torch.int64),
                                "nonce": torch.zeros((), dtype=torch.int64)},))
    graphed({"words": torch.ones(4, 6, dtype=torch.int64),
             "nonce": torch.ones((), dtype=torch.int64)})


def test_stream_and_graph_spans_on_the_cpu():
    stream = StreamVerifier(parity, device="cpu")
    stream.feed(host_batch())  # the capture
    with TT.record_spans() as spans:
        stream.feed(host_batch(1))
        stream.feed(host_batch(2))
        stream.finish()
    feeds = spans.named("stream.feed")
    assert [f.attrs for f in feeds] == [{"batch": 1}, {"batch": 2}]
    assert all(f.parent is None for f in feeds)
    for f in feeds:
        kids = [s for s in spans.spans if s.parent == f.id]
        assert [s.name for s in sorted(kids, key=lambda s: s.start_ns)] == list(STREAM[1:])
        assert all(s.attrs == f.attrs and f.start_ns <= s.start_ns <= s.end_ns <= f.end_ns
                   for s in kids)
    names = [s.name for s in spans.spans]
    for name in STREAM + GRAPH + ("dev.stream.widen", "dev.graph.replay"):
        assert names.count(name) == 2, name
    assert "stream.slot_wait" not in names and "stream.drain" not in names
    enqueue = {s.id: s for s in spans.named("stream.enqueue")}
    assert all(s.parent in enqueue and s.attrs == enqueue[s.parent].attrs
               for s in spans.spans if s.name in GRAPH)
    graphed = capture(parity, ({"words": torch.zeros(4, 6, dtype=torch.int64),
                                "nonce": torch.zeros((), dtype=torch.int64)},))
    with TT.record_spans() as spans:
        graphed({"words": torch.ones(4, 6, dtype=torch.int64),
                 "nonce": torch.ones((), dtype=torch.int64)})
    assert sorted((s.name for s in spans.spans), key=lambda n: spans.named(n)[0].start_ns) == \
        ["graph.copy_in", "graph.replay", "dev.graph.replay", "graph.copy_out"]


def _annotations(prof):
    return {e.name(): e for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()}


def test_profiler_sees_the_spans_and_the_anchor_places_them():
    from torch.profiler import ProfilerActivity, profile

    stream = StreamVerifier(parity, device="cpu")
    stream.feed(host_batch())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stream.feed(host_batch(1))
    assert set(STREAM + GRAPH) <= set(_annotations(prof))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TT.record_spans() as spans:
            time.sleep(0.01)
            stream.feed(host_batch(2))
    notes = _annotations(prof)
    for name in STREAM + GRAPH:
        (s,) = spans.named(name)
        assert abs(spans.unix(s.start_ns) - notes[name].start_ns()) < 2_000_000, name


def _stark101_lane():
    path = pathlib.Path(__file__).parent / "fixtures" / "stark101" / "golden_proof.json"
    return SP.to_torch(SP.load_json(str(path)))


@pytest.mark.parametrize("system", ["stwo", "stark101"])
def test_verifier_stage_spans_cover_the_call_in_code_order(system):
    if system == "stwo":
        proof, names = TP.to_torch(cached_stwo_proof(TESTING)), \
            ["dev.stwo.stages_i_iv", "dev.stwo.stage_v", "dev.stwo.stage_vi",
             "dev.stwo.stage_vii"]
        call = lambda: TV.verify(proof, TESTING)  # noqa: E731
    else:
        proof, names = _stark101_lane(), \
            ["dev.stark101.transcript", "dev.stark101.trace_merkle", "dev.stark101.fold",
             "dev.stark101.fri_merkle"]
        call = lambda: SV.verify(proof, Stark101Config())  # noqa: E731
    with TT.record_spans() as spans:
        t0 = time.perf_counter_ns()
        ok, _ = call()
        t1 = time.perf_counter_ns()
    assert bool(ok)
    got = sorted(spans.spans, key=lambda s: s.start_ns)
    assert [s.name for s in got] == names and all(s.device for s in got)
    assert t0 <= got[0].start_ns and got[-1].end_ns <= t1
    assert all(a.end_ns <= b.start_ns for a, b in zip(got, got[1:]))
    assert sum(s.end_ns - s.start_ns for s in got) > 0.98 * (t1 - t0)


def _span(rec, name, start, end, parent=None, device=False):
    s = TT.Span(name, parent, {}, device)
    s.start_ns, s.end_ns = start * 1_000_000, end * 1_000_000
    rec.spans.append(s)
    return s


def test_summary_self_time_is_the_duration_less_the_childrens_cover():
    rec = TT.SpanRecorder()
    root = _span(rec, "root", 0, 10)
    _span(rec, "a", 1, 4, root)
    _span(rec, "a", 3, 6, root)  # overlaps the first: the cover counts 1-6 once
    _span(rec, "b", 8, 12, root)  # clipped to the root's end
    _span(rec, "dev", 0, 10, root, device=True)  # another kind: not a child for self time
    other = _span(rec, "root", 20, 30)
    _span(rec, "a", 21, 22, other)
    out = rec.summary()
    assert out["root"]["count"] == 2 and out["root"]["total_ms"] == 20
    assert out["root"]["self_ms"] == (10 - 5 - 2) + (10 - 1)
    assert out["a"] == {"count": 3, "total_ms": 7, "median_ms": 3, "p95_ms": 3,
                        "max_ms": 3, "self_ms": 7}
    assert out["dev"]["self_ms"] == 10 and out["b"]["max_ms"] == 4


class _Event:
    """A CUDA event on the host's clock; one captured into a graph is
    recorded again by each replay (``_replay``)."""

    captured = []

    def __init__(self, enable_timing=False, blocking=False, interprocess=False,
                 external=False):
        self.external, self.ns = external, None

    def record(self, stream=None):
        if self.external:
            _Event.captured.append(self)
        self.ns = time.perf_counter_ns()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.ns - self.ns) / 1e6


def _replay():
    for e in _Event.captured:
        time.sleep(0.001)
        e.ns = time.perf_counter_ns()


def test_device_spans_in_a_replayed_graph(monkeypatch):
    capture_on = [False]
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(_Event, "captured", [])
    for name, value in (("is_available", True), ("is_initialized", True), ("device_count", 1),
                        ("current_device", 0), ("synchronize", None), ("current_stream", None)):
        monkeypatch.setattr(torch.cuda, name, lambda *a, v=value: v)
    monkeypatch.setattr(TT, "capturing", lambda: capture_on[0])
    with TT.record_spans() as spans:
        with TT.device_span("dev.eager", "cuda:0", batch=0):
            time.sleep(0.002)
        mark = TT.mark()
        assert spans.named("dev.eager") == []  # read where the program waits
        TT.resolve(mark)
        (eager,) = spans.named("dev.eager")
        assert eager.ms >= 2 and eager.attrs == {"batch": 0}
        capture_on[0] = True
        with TT.capture_spans() as graph:
            with TT.device_span("dev.outer", "cuda:0"):
                with TT.device_span("dev.inner", "cuda:0", stage=1):
                    pass
        with TT.device_span("dev.elsewhere", "cuda:0"):  # a capture no graph replays
            pass
        capture_on[0] = False
        assert [t[0] for t in graph.templates] == ["dev.outer", "dev.inner"]
        assert spans.named("dev.outer") == [] and spans.named("dev.elsewhere") == []
        for batch in (1, 2):
            with TT.span("feed", batch=batch):
                graph.settle()
                if batch == 2:  # the first replay's spans were read before the second
                    assert [s.attrs for s in spans.named("dev.inner")] == [
                        {"batch": 1, "stage": 1}]
                _replay()
                graph.replayed(None)
    outer, inner = spans.named("dev.outer"), spans.named("dev.inner")
    feeds = spans.named("feed")
    assert [s.attrs["batch"] for s in outer] == [1, 2] and len(inner) == 2
    for f, o, i in zip(feeds, outer, inner):
        assert o.parent == f.id and i.parent == o.id
        assert o.start_ns < i.start_ns <= i.end_ns < o.end_ns
        assert f.start_ns <= o.start_ns and o.end_ns <= f.end_ns
    with TT.span("feed", batch=3):  # no recorder: the graph's events are not read
        graph.settle()
        _replay()
        graph.replayed(None)
    assert len(spans.named("dev.outer")) == 2
