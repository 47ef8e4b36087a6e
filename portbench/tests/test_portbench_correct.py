"""The check that decides ``correct``: its control, and the faults of the
timed path it has to catch, each driven through a whole run on the CPU at
a small size (and the control on the card at the cell's size)."""

import io
import json
import pathlib
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from portbench import run

ROOT = pathlib.Path(__file__).resolve().parents[2]

STREAMS = {
    "stwo.verify.stream4096": dict(lanes=32, distinct_batches=2, tampered_lanes=16,
                                   warmup_s=0, profiled_batches=1),
    "stark101.verify.stream8192": dict(lanes=32, distinct_batches=2, tampered_lanes=12,
                                        warmup_s=0, profiled_batches=1),
}


def result(workload, traffic, control=False, seed=2 ** 31 + 11):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.5",
                       "--trace", "0"], device="cpu", traffic=traffic, control=control)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def verifier_module(workload):
    if workload.startswith("stwo"):
        from stark_symphony_tpu_torch.models.stwo import verifier
    else:
        from stark_symphony_tpu_torch.models.stark101 import verifier
    return verifier


def stale(fn):
    """The step returns its first answer again: its state never moves on."""
    first = []

    def wrapped(*a, **k):
        if not first:
            first.append(fn(*a, **k))
        return first[0].clone()

    return wrapped


def half(fn):
    """Half of the batch left out: the second half takes the first's."""
    def wrapped(*a, **k):
        ok = fn(*a, **k).clone()
        n = ok.shape[0] // 2
        ok[n:2 * n] = ok[:n]
        return ok

    return wrapped


def flip(fn):
    """One answer altered where it is produced."""
    def wrapped(*a, **k):
        ok = fn(*a, **k).clone()
        ok[0] = ~ok[0]
        return ok

    return wrapped


@pytest.mark.parametrize("workload", sorted(STREAMS))
def test_stream_runs_sound(workload):
    assert result(workload, STREAMS[workload])["correct"] is True


@pytest.mark.parametrize("workload", sorted(STREAMS))
def test_stream_control_is_not_correct(workload):
    r = result(workload, STREAMS[workload], control=True)
    assert r["correct"] is False and r["checks"]["wrong_verdicts"]["value"] > 0


@pytest.mark.parametrize("fault", [stale, half, flip])
@pytest.mark.parametrize("workload", sorted(STREAMS))
def test_stream_faults_are_not_correct(workload, fault, monkeypatch):
    module = verifier_module(workload)
    monkeypatch.setattr(module, "verify_batch", fault(module.verify_batch))
    assert result(workload, STREAMS[workload])["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("workload", ["stwo.verify.stream4096", "stark101.verify.stream8192"])
def test_control_fails_at_the_cells_size_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    out = subprocess.run([sys.executable, str(ROOT / "portbench/control.py"), "--workload",
                          workload, "--seeds", "3000000019,3000000037,3000000079"],
                         capture_output=True, text=True, cwd=str(ROOT), timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(l) for l in out.stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 3 and not any(l["correct"] for l in lines)
