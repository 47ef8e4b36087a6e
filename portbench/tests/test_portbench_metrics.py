"""The per-layer readers' and the profile's arithmetic on synthetic spans."""

import json
import pathlib
import types

import pytest

from portbench import common
from portbench.rooflines import sha256_work as W

ROOT = pathlib.Path(__file__).resolve().parents[2]


def ev(name, start, end, host=False, index=0):
    return {"name": name, "host": host, "index": index, "start": start, "end": end}


def profile(units=2):
    """A stretch of 10 s: on device 0 a hash kernel 1-3 s and a field
    kernel 2-5 s (overlapping), a copy 7-8 s and the pad kernel (dropped);
    on device 1 one kernel 0-10 s; the host in a replay 5-7 s."""
    return common.Profile([
        ev(common.STRETCH, 0.0, 10.0, host=True),
        ev("sha256_words_kernel", 1.0, 3.0), ev("vectorized_elementwise_kernel", 2.0, 5.0),
        ev("Memcpy HtoD", 7.0, 8.0), ev("cos_kernel", 0.0, 9.0),
        ev("merkle_walk_kernel", -1.0, 11.0, index=1),
        ev("cudaGraphLaunch", 5.0, 7.0, host=True), ev("aten::copy_", 5.5, 6.5, host=True),
    ], units)


def test_union_and_gaps():
    assert common.union([(0, 2), (1, 3), (5, 6)]) == 4
    assert common.union([]) == 0
    assert common.gaps([(1, 3), (2, 5), (7, 8)], 0, 10) == [(0, 1), (5, 7), (8, 10)]
    assert common.gaps([(-1, 11)], 0, 10) == []


def test_quantile_interpolates_between_ranks():
    assert common.quantile([3, 1, 2, 4, 5], 0.5) == 3
    assert common.quantile(list(range(101)), 0.95) == 95
    assert common.quantile([0, 10], 0.95) == pytest.approx(9.5)


def test_profile_reads_busy_ops_kernels_and_gaps():
    p = profile()
    assert p.window_s == 10
    assert p.busy_s(0) == 5  # 1-5 and 7-8; the pad kernel dropped
    assert p.busy_s(1) == 10  # clipped to the stretch
    assert p.busy_s() == 7.5
    assert p.kernel_s(["sha256_words_kernel", "merkle_walk_kernel"]) == 12
    ops = dict(p.device_ops())
    assert ops["merkle_walk_kernel"] == 10 and "cos_kernel" not in ops
    gaps = p.idle_gaps()
    assert gaps[0] == ["aten::copy_", 2.0]  # 5-7: the shortest host event at its middle
    assert sorted(g[1] for g in gaps) == [1.0, 2.0, 2.0]


def _ctx(cell, units=2, driver=None):
    return common.Context(cell, driver, {"latencies_ms": [1.0]}, profile(units))


def _reader(name):
    return common.load_module(ROOT / "portbench/metrics" / f"{name}.py", name.replace(".", "_"))


def test_device_busy_reader():
    cell = types.SimpleNamespace(traffic={"lanes": 4}, config={})
    assert _reader("device_busy_ms.verify").read(_ctx(cell)) == pytest.approx(3750)


def test_replay_host_reader_takes_the_split_of_one_replay():
    cell = types.SimpleNamespace(traffic={"lanes": 4}, config={})
    one = types.SimpleNamespace(probe_replay_split=lambda: {"replays": 1, "host_ms": 1.25})
    two = types.SimpleNamespace(probe_replay_split=lambda: {"replays": 2, "host_ms": 2.5})
    none = types.SimpleNamespace(probe_replay_split=lambda: None)
    assert _reader("replay_host_ms.verify").read(_ctx(cell, driver=one)) == 1.25
    assert _reader("replay_host_ms.verify").read(_ctx(cell, driver=two)) is None
    assert _reader("replay_host_ms.verify").read(_ctx(cell, driver=none)) is None


def test_kernels_roofline_reader_counts_the_configurations_work():
    cfg = json.loads((ROOT / "portbench/configs/stwo_production.json").read_text())
    cell = types.SimpleNamespace(traffic={"lanes": 4096}, config=cfg)
    share = _reader("kernels_roofline.verify").read(_ctx(cell))
    least = W.stwo_verify(cfg).least_s(2 * 4096)
    assert share == pytest.approx(100 * least / 12)
    # an empty profile gives no reading, never 0
    empty = common.Profile([ev(common.STRETCH, 0.0, 1.0, host=True)], 1)
    assert _reader("kernels_roofline.verify").read(common.Context(cell, None, {}, empty)) is None


def test_work_counts():
    """One stwo verification: 37 hashes of the transcript-size messages
    plus stages V and VII, in compressions near tools/build.static_cost's
    3,797 (which counts a root mix as one block, here two)."""
    cfg = json.loads((ROOT / "portbench/configs/stwo_production.json").read_text())
    w = W.stwo_verify(cfg)
    assert 3797 * 640 < w.ops < 3900 * 1024
    assert W.hash_ops(9) == 1024 and W.hash_ops(16) == 1024 + 640 and W.hash_ops(1) == 1024
    s101 = json.loads((ROOT / "portbench/configs/stark101.json").read_text())
    assert W.stark101_verify(s101).ops > 0
    assert W.kernel_names()[0] == "sha256_words_kernel"
