"""The port's multi-process runtime (``utils/distributed.py``).

In one process: no STPU_* variables initialize nothing; the batch-slice
convention; every barrier call a barrier of its own; a group of one
process on localhost.  Then two real
processes on localhost over the gloo backend, mirroring the JAX suite's
``test_two_process_distributed_dp``: each holds 4 CPU shards of its half
of a 16-lane TESTING batch with lane 3 tampered, and the accept count that
crosses the process boundary must read 15 in both.  And a peer that exits
before a barrier fails it within its timeout, by name, instead of hanging.
Each subprocess is killed if it outlives its timeout.
"""

import os
import pathlib
import socket
import subprocess
import sys
import time

import pytest

from stark_symphony_tpu_torch.parallel.batch import make_mesh
from stark_symphony_tpu_torch.parallel.mesh import Mesh
from stark_symphony_tpu_torch.utils import distributed as D

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_initialize_from_env_noop_without_env(monkeypatch):
    monkeypatch.delenv("STPU_COORDINATOR", raising=False)
    assert D.initialize_from_env() is False
    assert not D.is_initialized()
    assert D.process_count() == 1 and D.process_index() == 0


def test_local_batch_slice(monkeypatch):
    assert D.local_batch_slice(16) == (0, 16)
    monkeypatch.setattr(D, "process_count", lambda: 2)
    monkeypatch.setattr(D, "process_index", lambda: 1)
    assert D.local_batch_slice(16) == (8, 8)
    with pytest.raises(ValueError):
        D.local_batch_slice(15)


class _Store:
    """A stand-in for the process group's TCPStore: counters by key."""

    def __init__(self):
        self.counts = {}

    def add(self, key, n):
        self.counts[key] = self.counts.get(key, 0) + n
        return self.counts[key]


def test_barrier_ids_unique_per_call(monkeypatch):
    """Repeated calls of one name are distinct barriers (the reference
    reuses its id on every call)."""
    store = _Store()
    monkeypatch.setattr(D, "_STORE", store)
    monkeypatch.setattr(D, "_BARRIER_CALLS", type(D._BARRIER_CALLS)())
    monkeypatch.setattr(D.dist, "get_world_size", lambda: 1)
    for name in ("compiled", "compiled", "other", "compiled"):
        D.barrier(name)
    assert store.counts == {"stpu/barrier/compiled#1": 1, "stpu/barrier/compiled#2": 1,
                            "stpu/barrier/other#1": 1, "stpu/barrier/compiled#3": 1}


def test_device_share():
    """Processes that all see the same cards split them, a contiguous
    share each; processes given cards of their own, or more processes
    than cards, drive all they see."""
    four = ["a", "b", "c", "d"]
    assert [D.device_share([four] * 4, r) for r in range(4)] == [[0], [1], [2], [3]]
    assert [D.device_share([four] * 2, r) for r in range(2)] == [[0, 1], [2, 3]]
    assert D.device_share([four], 0) == [0, 1, 2, 3]
    assert D.device_share([four] * 3, 2) == [0, 1, 2, 3]  # 4 cards do not split over 3
    assert D.device_share([["a"], ["b"]], 1) == [0]  # a card of its own each
    assert D.device_share([["a"], ["a"]], 1) == [0]  # two processes on one card
    assert D.device_share([[], []], 0) == []  # the CPU


class _KeyValueStore:
    """A stand-in for the TCPStore's set and get, shared by all ranks."""

    def __init__(self):
        self.kv = {}

    def set(self, key, value):
        self.kv[key] = value.encode()

    def get(self, key):
        return self.kv[key]


@pytest.mark.parametrize("seen,backends", [
    ([["a", "b", "c", "d"]] * 4, ["nccl"] * 4),  # one host, every card seen by all
    ([["a"], ["b"]], ["nccl"] * 2),  # a card each
    ([["a"], ["a"]], ["gloo"] * 2),  # one card shared
    ([[], []], ["gloo"] * 2),  # the CPU
])
def test_backend_follows_the_share(monkeypatch, seen, backends):
    monkeypatch.setattr(D.dist, "is_nccl_available", lambda: True)
    store = _KeyValueStore()
    for rank, ids in enumerate(seen):
        store.set(f"stpu/devices/{rank}", ",".join(ids))
    for rank, ids in enumerate(seen):
        monkeypatch.setattr(D, "_device_ids", lambda ids=ids: ids)
        share, backend = D._exchange_devices(store, rank, len(seen))
        assert share == D.device_share(seen, rank) and backend == backends[rank]


def test_only_the_process_axis_spans_processes():
    mesh = D.global_mesh(tp=2, devices=["cpu"] * 4)
    assert mesh.process_axis == "dp" and mesh.shape == {"dp": 2, "tp": 2}
    assert make_mesh(2, devices=["cpu"] * 2).process_axis is None
    with pytest.raises(ValueError, match="process axis"):
        Mesh(["cpu"] * 2, ("sp",), process_axis="dp")


def test_barrier_needs_the_process_group():
    with pytest.raises(RuntimeError, match="not initialized"):
        D.barrier("anything")


_SINGLE = """
from stark_symphony_tpu_torch.utils import distributed as D

D.initialize_single()
D.initialize_single()  # idempotent
assert D.initialize_from_env() is True and D.is_initialized()
assert D.process_count() == 1 and D.process_index() == 0
D.barrier("alone", timeout_s=5)
D.barrier("alone", timeout_s=5)
print("SINGLE_OK", dict(D._BARRIER_CALLS), flush=True)
"""


def test_initialize_single_process_group():
    """A process group of one process on localhost (in a fresh
    interpreter, so this one stays uninitialized): idempotent, and its
    barriers pass at once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    env.pop("STPU_COORDINATOR", None)
    out = subprocess.run([sys.executable, "-c", _SINGLE], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "backend gloo" in out.stdout and "SINGLE_OK {'alone': 2}" in out.stdout


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_pair(code: str, timeout: float) -> list:
    """Run `code` in two processes joined by the STPU_* variables; returns
    [(returncode, stdout, stderr)] by rank, killing both on a timeout."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
                   STPU_COORDINATOR=f"localhost:{port}", STPU_NUM_PROCESSES="2",
                   STPU_PROCESS_ID=str(rank), STPU_INIT_TIMEOUT="60")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
        return [(p.returncode,) + out for p, out in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


_TWO_PROCESS_DP = """
import torch

from stark_symphony_tpu_torch.models.stwo import proof as P
from stark_symphony_tpu_torch.models.stwo.config import TESTING
from stark_symphony_tpu_torch.parallel.batch import make_mesh, verify_batch_dp
from stark_symphony_tpu_torch.parallel.mesh import psum
from stark_symphony_tpu_torch.utils import distributed as D
from stark_symphony_tpu_torch.utils.proofcache import cached_stwo_proof

assert D.initialize_from_env() is True and D.initialize_from_env() is True
assert D.process_count() == 2
batch = P.replicate(cached_stwo_proof(TESTING), 16)
batch.trace_evals[3] += 1  # lane 3, in process 0's half: its rejection must cross
start, size = D.local_batch_slice(16)
local = P.map_fields(lambda x: x[start:start + size], batch)
bitmap, n_ok = verify_batch_dp(local, TESTING, D.global_mesh(devices=["cpu"] * 4))
print("LOCAL", int(bitmap.sum()), "GLOBAL", int(n_ok), flush=True)
# only the process axis crosses: a mesh without one, and another axis, stay local
ones = [torch.tensor(1), torch.tensor(1)]
print("PSUM", int(psum(make_mesh(2, devices=["cpu"] * 2), ones, "dp")[0]),
      int(psum(D.global_mesh(devices=["cpu"] * 2), ones, "dp")[0]),
      int(psum(D.global_mesh(tp=2, devices=["cpu"] * 2), ones, "tp")[0]), flush=True)
"""


def test_two_process_dp_counts_across_processes():
    runs = _run_pair(_TWO_PROCESS_DP, timeout=240)
    for rank, (rc, out, err) in enumerate(runs):
        assert rc == 0, (rank, out[-1000:], err[-3000:])
        assert "backend gloo" in out
        assert f"LOCAL {7 if rank == 0 else 8} GLOBAL 15" in out, out
        assert "PSUM 2 4 2" in out, out


_DEAD_PEER = """
import time
from stark_symphony_tpu_torch.utils import distributed as D

D.initialize_from_env()
if D.process_index() == 1:
    raise SystemExit(0)  # leaves before the barrier
t0 = time.monotonic()
try:
    D.barrier("after_exit", timeout_s=5)
except TimeoutError as e:
    print("FAILED", round(time.monotonic() - t0, 1), e, flush=True)
"""


def test_dead_peer_fails_the_barrier_in_bounded_time():
    t0 = time.monotonic()
    runs = _run_pair(_DEAD_PEER, timeout=60)
    rc, out, err = runs[0]
    assert rc == 0 and runs[1][0] == 0, (out, err[-3000:], runs[1][2][-3000:])
    assert "FAILED" in out and "barrier 'after_exit#1': 1 of 2 processes arrived" in out, out
    assert float(out.split("FAILED")[1].split()[0]) < 30
    assert time.monotonic() - t0 < 60
