"""``run.py`` end to end at small sizes on the CPU, for every cell's
driver; what a run may load; a cell added by new files alone; the names
and units of BENCHMARK.json."""

import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

# Each cell at a size a CPU holds: the traffic keys that replace the file's.
SMALL = {
    "stwo.verify.stream4096": dict(lanes=8, distinct_batches=2, tampered_lanes=4, warmup_s=0,
                                   profiled_batches=1),
    "stark101.verify.stream8192": dict(lanes=32, distinct_batches=2, tampered_lanes=12,
                                        warmup_s=0, profiled_batches=1),
}
TRACED = {"stark101.verify.stream8192"}  # a CPU trace of the others' eager ops is slow
# A stream holds a batch's verdicts `depth` feeds later: a window of a few feeds
SECONDS = {"stwo.verify.stream4096": 12, "stark101.verify.stream8192": 2}

RUN = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import run
rc = run.main({argv!r}, device="cpu", traffic={traffic!r}, bench_file={bench!r})
print(json.dumps({{"rc": rc, "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def run_cell(workload, traffic, trace=0, seed=4294967311, bench=None, seconds=1):
    """One run in a fresh interpreter: (its result line, its own report of
    the exit code and the loaded top-level modules, its standard error)."""
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]
    code = RUN.format(root=str(ROOT), argv=argv, traffic=traffic,
                      bench=str(bench or ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1]), out.stderr


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_cell_runs_on_the_cpu_and_loads_no_jax(workload):
    trace = int(workload in TRACED)
    result, report, err = run_cell(workload, SMALL[workload], trace,
                                   seconds=SECONDS.get(workload, 1))
    assert report["rc"] == 0
    assert not set(report["modules"]) & {"jax", "jaxlib", "flax", "stark_symphony_tpu"}
    assert "stark_symphony_tpu_torch" in report["modules"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    cell = next(w for w in BENCH["workloads"] if w["name"] == workload)
    if trace:
        assert "breakdown" in result and "window_s" in result["device"]
    else:
        want = {m["name"] for m in BENCH["end_to_end"]
                if workload in m.get("workloads", [workload])}
        assert set(result["metrics"]) == want, cell
        assert all(v["value"] > 0 for v in result["metrics"].values())
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert [l.split()[1] for l in tail] == list(result["checks"])


def test_a_run_without_a_card_prints_no_result():
    code = ("import sys; sys.path.insert(0, %r); from portbench import run; "
            "sys.exit(run.main(['--workload', 'stwo.verify.stream4096', '--seed', '1', "
            "'--seconds', '1', '--trace', '0']))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_cell_added_by_new_files_alone_is_found_and_run(tmp_path):
    """A new configuration file, traffic file, metric reader and entries in a
    copy of BENCHMARK.json, nothing edited: the harness finds and runs them."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "tests").symlink_to(ROOT / "tests")
    cfg = json.loads((ROOT / "portbench/configs/stark101.json").read_text())
    (tmp_path / "portbench/configs/stark101_copy.json").write_text(json.dumps(cfg))
    (tmp_path / "portbench/traffic/verify_stream48.json").write_text(json.dumps(
        {"driver": "stream_verify", "lanes": 48, "depth": 3, "distinct_batches": 3,
         "tampered_lanes": 10, "warmup_s": 0, "profiled_batches": 1}))
    (tmp_path / "portbench/metrics/fed_batches.stark101.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window['latencies_ms']))\n")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "stark101_copy", "source": "https://example.org/x",
                            "file": "portbench/configs/stark101_copy.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "stark101.verify.stream48", "config": "stark101_copy",
                              "traffic": "verify_stream48", "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("stark101.verify.stream48")
    spec["per_layer"].append({"name": "fed_batches.stark101", "unit": "batches",
                              "better": "higher", "source": "host_clock", "layer": "stream",
                              "moves": "verify_proofs_per_s",
                              "workloads": ["stark101.verify.stream48"]})
    bench = tmp_path / "BENCHMARK.json"
    bench.write_text(json.dumps(spec))
    result, _, _ = run_cell("stark101.verify.stream48", {}, trace=1, bench=bench)
    assert result["correct"] is True and result["attempted"] % 48 == 0
    assert result["metrics"]["fed_batches.stark101"]["value"] >= 1


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_names_and_units_are_plain():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in BENCH["workloads"]] + \
        [c["name"] for c in BENCH["configs"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    texts = [w["why"] for w in BENCH["workloads"] + BENCH["configs"]] + \
        [m["layer"] for m in BENCH["per_layer"]] + [c["source"] for c in BENCH["configs"]]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(0 < m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
            assert w in moved.get("workloads", [w])
    for w in BENCH["workloads"]:
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").is_file()
    for m in BENCH["per_layer"]:
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").is_file()
