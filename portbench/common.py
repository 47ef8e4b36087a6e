"""What every cell of the benchmark shares: the cell's files, the run's
context, quantiles, the device's description, the profiler's reading and
the check that nothing of JAX was loaded.

``union``, ``pad_session``, ``replay_split`` and the profiler's device
events are copied from ``chip_smoke.py`` (``_union``, ``_pad_session``,
``replay_split``, ``_device_events``); the events are read from the
profiler's raw activity list, which needs no parse of the event tree.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "stark_symphony_tpu")


# --- the cell's files -----------------------------------------------------------

def load_module(path: pathlib.Path, name: str):
    """A module from a file path (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, str(path))
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic and
    metrics, read from the files the names lead to: the configuration's
    `file`, ``traffic/<traffic>.json`` and ``metrics/<metric>.py`` under
    the benchmark's folder (the first of `paths`).  The traffic names its
    driver, ``drivers/<driver>.py``."""

    def __init__(self, bench_file: pathlib.Path, workload: str):
        spec = json.loads(bench_file.read_text())
        self.root = bench_file.parent
        self.dir = self.root / spec["paths"][0]
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in {bench_file}; it has {sorted(cells)}")
        self.workload = cells[workload]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = json.loads((self.root / configs[self.workload["config"]]["file"]).read_text())
        self.traffic = json.loads((self.dir / "traffic" / f"{self.workload['traffic']}.json")
                                  .read_text())
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in spec["end_to_end"] if self._reports(m)]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if m["moves"] in names and self._reports(m)]

    def _reports(self, metric) -> bool:
        return "workloads" not in metric or self.workload["name"] in metric["workloads"]

    def driver(self):
        return load_module(self.dir / "drivers" / f"{self.traffic['driver']}.py",
                           f"portbench_driver_{self.traffic['driver']}")

    def reader(self, metric: str):
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           "portbench_metric_" + metric.replace(".", "_"))


class Context:
    """What a per-layer metric's reader reads: the cell, the window's
    record (`window`), the profiled stretch (`profile`, a Profile) and the
    driver, whose probes (``probe(name)``) measure one layer alone."""

    def __init__(self, cell, driver, window, profile):
        self.cell = cell
        self.driver = driver
        self.window = window
        self.profile = profile
        self._probes = {}

    def probe(self, name: str):
        """The driver's probe `name`, measured once and kept, or None where
        the driver has none."""
        if name not in self._probes:
            fn = getattr(self.driver, f"probe_{name}", None)
            self._probes[name] = None if fn is None else fn()
        return self._probes[name]


# --- statistics ---------------------------------------------------------------------

def quantile(values, share: float) -> float:
    """The `share` quantile of `values`, interpolated between the two
    nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("quantile of no values")
    pos = share * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union(spans) -> float:
    """The length of the union of (start, end) spans."""
    total, reach = 0.0, None
    for lo, hi in sorted(spans):
        if reach is None or lo > reach:
            total += hi - lo
            reach = hi
        elif hi > reach:
            total += hi - reach
            reach = hi
    return total


def gaps(spans, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no span covers."""
    out, reach = [], lo
    for a, b in sorted(spans):
        if a > reach:
            out.append((reach, min(a, hi)))
        reach = max(reach, b)
        if reach >= hi:
            break
    if reach < hi:
        out.append((reach, hi))
    return [(a, b) for a, b in out if b > a]


# --- the device ------------------------------------------------------------------------

def devices(torch, chips: int, device) -> list:
    """The devices a cell runs on: `chips` CUDA cards, or the CPU where a
    test asks for it."""
    if device is not None:
        return [torch.device(device)] * chips
    return [torch.device(f"cuda:{i}") for i in range(chips)]


def device_record(torch, devs) -> dict:
    if devs[0].type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": len(devs), "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(devs[0]),
            "count": len(devs),
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d) for d in devs)}


def synchronize(torch, devs) -> None:
    for d in {str(d) for d in devs}:
        if d.startswith("cuda"):
            torch.cuda.synchronize(d)


# --- the profiler -------------------------------------------------------------------------

PAD_KERNELS = 20_000
STRETCH = "portbench.stretch"


def pad_session(torch, dev) -> None:
    """On the card torch.profiler drops device activities at the start of a
    session, the more the longer the process has run; after 20,000 other
    kernels in the same session it keeps them all (PERF.md).  So a session
    opens with launches of a kernel no cell runs, which the reading drops."""
    x = torch.empty(1, device=dev)
    for _ in range(PAD_KERNELS):
        x.cos_()
    torch.cuda.synchronize(dev)


class Profile:
    """The reading of one profiled stretch of a run.

    `units`: the batches, proofs or calls the stretch holds; `window_s`:
    its length, between the ends of its annotation; `device`: per device
    index, the (start_s, end_s, name) of each kernel, copy and set clipped
    to the stretch; `host`: the host's (start_s, end_s, name) events inside
    it (annotations, ATen operators and runtime calls)."""

    def __init__(self, events, units: int):
        self.units = units
        marks = [e for e in events if e["name"] == STRETCH and e["host"]]
        if not marks:
            raise RuntimeError("the profile holds no stretch annotation")
        self.lo = min(e["start"] for e in marks)
        self.hi = max(e["end"] for e in marks)
        self.window_s = self.hi - self.lo
        self.device = {}
        self.host = []
        for e in events:
            lo, hi = max(e["start"], self.lo), min(e["end"], self.hi)
            if hi <= lo:
                continue
            if e["host"]:
                if e["name"] != STRETCH:
                    self.host.append((lo, hi, e["name"]))
            elif e["name"] != STRETCH and "cos_kernel" not in e["name"]:
                self.device.setdefault(e["index"], []).append((lo, hi, e["name"]))

    def busy_s(self, index=None) -> float:
        """Seconds in which some device activity ran: on device `index`, or
        the mean over the devices the stretch saw."""
        if index is not None:
            return union((a, b) for a, b, _ in self.device.get(index, []))
        if not self.device:
            return 0.0
        return sum(self.busy_s(i) for i in self.device) / len(self.device)

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time, summed by name."""
        total = {}
        for evs in self.device.values():
            for a, b, name in evs:
                total[name] = total.get(name, 0.0) + (b - a)
        return sorted(([n, s] for n, s in total.items()), key=lambda x: -x[1])[:top]

    def kernel_s(self, patterns) -> float:
        """Summed seconds of the device activities whose name holds one of
        `patterns`."""
        return sum(b - a for evs in self.device.values() for a, b, name in evs
                   if any(p in name for p in patterns))

    def idle_gaps(self, top: int = 10) -> list:
        """The longest stretches in which a device ran nothing, each named
        by the shortest host event that covers its middle."""
        out = []
        for evs in self.device.values():
            for a, b in gaps([(x, y) for x, y, _ in evs], self.lo, self.hi):
                mid = (a + b) / 2
                cover = [(y - x, n) for x, y, n in self.host if x <= mid <= y]
                out.append([min(cover)[1] if cover else "host, no torch call", b - a])
        return sorted(out, key=lambda x: -x[1])[:top]


def profiled(torch, devs, fn, units: int) -> Profile:
    """torch.profiler (host and device) over fn(), inside one annotation
    (STRETCH), read from the raw activity list."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = devs[0].type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        if cuda:
            pad_session(torch, devs[0])
        with record_function(STRETCH):
            fn()
            synchronize(torch, devs)
    events = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        host = str(e.device_type()).endswith("CPU")
        if host and not (e.is_user_annotation() or name.startswith(("aten::", "cuda"))):
            continue  # of the host: annotations, operators and runtime calls
        if not host and e.is_user_annotation():
            continue  # an annotation's device-side span is none of its work
        start = e.start_ns() / 1e9
        events.append({"name": name, "host": host, "index": e.device_index(),
                       "start": start, "end": start + e.duration_ns() / 1e9})
    return Profile(events, units)


def replay_split(torch, fn) -> dict:
    """One fn(), timed with CUDA events, split by its graph replays:
    `host_ms`, the host time inside their ``CUDAGraph.replay`` calls;
    `device_ms`, the union of their spans on the device (CUDA events around
    each replay); `call_ms`, the whole call; `replays`, their count."""
    spent, spans = [], []
    replay = torch.cuda.CUDAGraph.replay

    def timed_replay(graph):
        before = torch.cuda.Event(enable_timing=True)
        after = torch.cuda.Event(enable_timing=True)
        before.record()
        t0 = time.perf_counter()
        replay(graph)
        spent.append(time.perf_counter() - t0)
        after.record()
        spans.append((before, after))

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.CUDAGraph.replay = timed_replay
    try:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        torch.cuda.CUDAGraph.replay = replay
    ms = [(start.elapsed_time(a), start.elapsed_time(b)) for a, b in spans]
    return {"call_ms": start.elapsed_time(end), "replays": len(spent),
            "host_ms": 1e3 * sum(spent), "device_ms": union(ms)}


# --- JAX ----------------------------------------------------------------------------

def jax_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole (the port's name begins with the
    JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
