"""The program-span metrics: the 11 readers on a synthetic stretch, and the
stretch itself (``program_spans``) run on the CPU over a small stark101
stream, its bitmaps checked against the reference's verdicts."""

import json
import pathlib
import types

import pytest

from portbench import common, program_spans

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = [m for m in BENCH["per_layer"] if m["source"] == "program_span"
           and m["name"] != "stage_vi_ms.stwo"]

SPANS = {  # a metric's spans, as its reader sums them
    "stream_stage_ms.verify": ("stream.stage",),
    "ingest_device_ms.verify": ("dev.stream.h2d", "dev.stream.widen"),
    "graph_device_ms.verify": ("dev.graph.replay",),
    **{f"{s}_graph_ms.stwo": (f"dev.stwo.{s}",)
       for s in ("stages_i_iv", "stage_v", "stage_vi", "stage_vii")},
    **{f"{s}_graph_ms.stark101": (f"dev.stark101.{s}",)
       for s in ("transcript", "trace_merkle", "fold", "fri_merkle")},
}


def _reader(name):
    return common.load_module(ROOT / "portbench/metrics" / f"{name}.py", name.replace(".", "_"))


def _ctx(table):
    ctx = common.Context(types.SimpleNamespace(traffic={}, config={}), None, {}, None)
    ctx.program_spans = table
    return ctx


def test_the_eleven_program_span_readers():
    assert sorted(m["name"] for m in READERS) == sorted(SPANS)
    for m in READERS:
        assert m["moves"] == "verify_proofs_per_s" and m["unit"] == "ms"
        assert m["workloads"]


@pytest.mark.parametrize("name", sorted(SPANS))
def test_reader_takes_the_median_batch(name):
    names = SPANS[name]
    # batches 1, 2, 4 hold every span; where the reader sums two, batch 3
    # holds the first alone and is left out
    table = {n: {1: 1.0 + k, 2: 5.0 + k, 4: 2.0 + k} for k, n in enumerate(names)}
    table["other"] = {1: 50.0}
    if len(names) > 1:
        table[names[0]][3] = 100.0
    want = sorted(sum(table[n][b] for n in names) for b in (1, 2, 4))[1]
    assert _reader(name).read(_ctx(table)) == pytest.approx(want)
    # a program without the spans, or a stretch without this one: no reading
    assert _reader(name).read(_ctx(None)) is None
    assert _reader(name).read(_ctx({"other": {1: 1.0}})) is None


def test_the_stretch_on_the_cpu_feeds_the_driver_and_reads_the_spans():
    from portbench.drivers import stream_verify

    spec = next(w for w in BENCH["workloads"] if w["config"] == "stark101")
    cell = common.Cell(ROOT / "BENCHMARK.json", spec["name"])
    cell.traffic.update(lanes=16, distinct_batches=2, tampered_lanes=8, warmup_s=0)
    import torch

    driver = stream_verify.Driver(cell, 4294967311, [torch.device("cpu")])
    driver.setup()
    ctx = common.Context(cell, driver, {}, None)
    table = program_spans.per_batch(ctx)
    assert program_spans.per_batch(ctx) is table  # run once, kept
    assert len(driver.fed) == len(driver.bitmaps)
    assert driver.fed[-5:] == [0, 0, 1, 0, 1]  # the capture's, then each batch twice
    assert set(table["stream.stage"]) == {1, 2, 3, 4}
    stages = [f"dev.stark101.{s}" for s in ("transcript", "trace_merkle", "fold", "fri_merkle")]
    for b in range(1, 5):
        total = sum(table[n][b] for n in stages)
        assert 0.95 * table["dev.graph.replay"][b] <= total <= table["dev.graph.replay"][b]
    for m in READERS:
        if spec["name"] in m["workloads"] and m["name"] != "ingest_device_ms.verify":
            assert _reader(m["name"]).read(ctx) > 0, m["name"]  # no copy to a card here
    driver.release()
    numbers, failed = driver.check()
    assert failed == 0 and all(v <= limit for _, v, limit in numbers)
