"""The benchmark of the PyTorch and CUDA port (``stark_symphony_tpu_torch``).

Usage, from the root of a checkout, on a machine with the cell's cards:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It finds the workload in ``BENCHMARK.json``, its configuration file, its
traffic (``traffic/<traffic>.json``, which names its driver under
``drivers/``) and, with ``--trace 1``, the readers of its per-layer
metrics (``metrics/<metric>.py``); it sets up (loads the inputs, stages
the host batches, captures the cell's graphs, runs the cell's traffic for
the traffic's ``warmup_s``), measures for ``--seconds``
seconds, and, with ``--trace 1``, profiles a short stretch of the same
traffic and reads the per-layer metrics.  Then it frees the program's
device state and checks every output of the run against the plain
reference (``reference/``).  It prints each number compared with its
limit as the last lines of standard error and, as the last line of
standard output, one JSON object: correct, attempted, failed, metrics,
device, with ``--trace 1`` breakdown, and last the checks.

It exits non-zero, printing no result, where there is no CUDA device or
fewer than the cell asks for, or where a module of JAX or of the JAX
package (``stark_symphony_tpu``) was loaded.  The port's kernels build
into ``build/`` of the checkout, and any other cache it sets goes there.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _environment(trace: bool) -> None:
    """Fixed cache directories inside the checkout; with a trace, CUPTI kept
    up between profiler sessions, as PyTorch keeps it around CUDA graphs."""
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    if trace:
        os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"
        os.environ["TEARDOWN_CUPTI"] = "0"


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _log(msg: str) -> None:
    print(f"[portbench {time.perf_counter() - T_START:8.3f} s] {msg}", file=sys.stderr, flush=True)


class _gc_pauses:
    """The garbage collector's pauses while it is installed, logged on
    close: how many of each generation, and their total and longest ms."""

    def __init__(self):
        self.spans, self._start = [], None
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.spans.append((info["generation"], time.perf_counter() - self._start))

    def close(self):
        gc.callbacks.remove(self)
        per_gen = [sum(1 for g, _ in self.spans if g == k) for k in range(3)]
        longest = max((d for _, d in self.spans), default=0.0)
        _log(f"gc in the window: collections by generation {per_gen}, "
             f"{1e3 * sum(d for _, d in self.spans):.3f} ms, longest {1e3 * longest:.3f} ms")


def main(argv=None, *, bench_file=None, device=None, traffic=None, control=False) -> int:
    """Run one cell.  The keywords serve the tests alone: `bench_file`
    another BENCHMARK.json, `device` a device to run on instead of the
    cards ("cpu"), `traffic` keys that replace the traffic file's, and
    `control` the driver's control in the program's place."""
    args = _args(argv)
    _environment(bool(args.trace))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import common

    cell = common.Cell(pathlib.Path(bench_file or ROOT / "BENCHMARK.json"), args.workload)
    cell.traffic.update(traffic or {})

    import torch

    if device is None and (not torch.cuda.is_available()
                           or torch.cuda.device_count() < cell.chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), this machine has "
              f"{have}", file=sys.stderr)
        return 3
    devs = common.devices(torch, cell.chips, device)
    driver = cell.driver().Driver(cell, args.seed, devs, control=control)
    _log(f"{args.workload}: setting up on {[str(d) for d in devs]}")
    driver.setup()
    _log("set up")
    gc_pauses = _gc_pauses()
    win = driver.window(args.seconds)
    gc_pauses.close()
    _log("window closed: " + ", ".join(f"{k} {v}" for k, v in win.items()
                                         if isinstance(v, (int, float)) and k != "t0"))
    record = common.device_record(torch, devs)
    values = {**win, "setup_s": win["t0"] - T_START}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in cell.end_to_end}
    breakdown = None
    if args.trace:
        fn, units = driver.stretch()
        profile = common.profiled(torch, devs, fn, units)
        _log("profiled stretch read")
        ctx = common.Context(cell, driver, win, profile)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        record["busy_s"] = profile.busy_s()
        record["window_s"] = profile.window_s
        breakdown = {"device_ops": profile.device_ops(), "idle_gaps": profile.idle_gaps()}
    driver.release()
    numbers, failed = driver.check()
    _log("checked against the reference")
    found = common.jax_modules()
    if found:
        print(f"portbench: modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    for name, value, limit in numbers:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    line = {"correct": all(value <= limit for _, value, limit in numbers),
            "attempted": win["attempted"], "failed": failed, "metrics": metrics,
            "device": record}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in numbers}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
