"""The multi-process runtime: process group, batch slices and barriers.

Port of ``stark_symphony_tpu/utils/distributed.py``.  Every process runs
the same program; ``initialize_from_env`` joins them into one
``torch.distributed`` process group over a ``TCPStore`` that process 0
serves.  Within a process the mesh is single-controller
(``parallel/mesh.py``): only the dp accept count (the psum over the
process axis of ``global_mesh``) and the barriers cross processes.

Launch pattern (one command per process):

    STPU_COORDINATOR=host0:8476 STPU_NUM_PROCESSES=2 STPU_PROCESS_ID=$i \\
        python my_script.py

A run without ``STPU_COORDINATOR`` initializes nothing, so every entry
point works unchanged in one process.

Each process drives its share of the CUDA devices it sees
(``device_share``): started on one host without ``CUDA_VISIBLE_DEVICES``,
the processes split the cards, so one process a card needs no more than
``STPU_NUM_PROCESSES`` set to the number of cards.  The backend follows
the topology, and is printed with the share: ``nccl`` where every process
drives GPUs no other process drives, else ``gloo`` (processes that share
one card, or run on the CPU; gloo reduces CUDA tensors too).

Unlike the reference, a barrier's name is made unique per call by a
sequence number of its own, and a barrier that a peer never reaches fails
within its timeout, naming the barrier and how many processes arrived.
"""

from __future__ import annotations

import atexit
import collections
import datetime
import os
import socket
import time

import torch
import torch.distributed as dist

_STORE = None  # the TCPStore of this process's group, once initialized
_SHARE = None  # the positions of the CUDA devices this process drives, once initialized
_BARRIER_CALLS = collections.Counter()  # barrier name -> calls so far


def _device_ids() -> list:
    """The UUIDs of the CUDA devices this process sees (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [str(torch.cuda.get_device_properties(i).uuid)
            for i in range(torch.cuda.device_count())]


def device_share(seen: list, rank: int) -> list:
    """The positions, among the CUDA devices process `rank` sees, of those
    it drives; seen[r] lists the device UUIDs process r sees.

    Where every process sees the same devices and they divide evenly among
    the processes (one host, every process seeing every card), process r
    takes the r-th contiguous share: one process a card, each driving its
    own.  Otherwise each drives all it sees (processes given cards of their
    own, or more processes than cards, sharing them)."""
    mine, world = seen[rank], len(seen)
    if mine and all(s == mine for s in seen) and len(mine) % world == 0:
        k = len(mine) // world
        return list(range(rank * k, (rank + 1) * k))
    return list(range(len(mine)))


def _exchange_devices(store, rank: int, world: int) -> tuple:
    """(this process's device share, the backend): nccl where every
    process drives CUDA devices that no other process drives, else gloo.
    Each process publishes its device UUIDs in the store and reads the
    others'."""
    store.set(f"stpu/devices/{rank}", ",".join(_device_ids()))
    seen = []
    for r in range(world):
        ids = store.get(f"stpu/devices/{r}").decode()
        seen.append(ids.split(",") if ids else [])
    driven = [[s[i] for i in device_share(seen, r)] for r, s in enumerate(seen)]
    flat = [u for ids in driven for u in ids]
    every_one_owns = all(driven) and len(flat) == len(set(flat))
    backend = "nccl" if every_one_owns and dist.is_nccl_available() else "gloo"
    return device_share(seen, rank), backend


def _initialize(host: str, port: int, rank: int, world: int, timeout_s: int) -> None:
    global _STORE, _SHARE
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, port, world_size=world, is_master=(rank == 0),
                          timeout=timeout)
    share, backend = _exchange_devices(store, rank, world)
    if share:
        torch.cuda.set_device(share[0])  # nccl's communicator and the psum's device
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timeout)
    _STORE, _SHARE = store, share
    atexit.register(_shutdown)
    print(f"stpu distributed: process {rank} of {world}, backend {backend}, "
          f"cuda devices {share}", flush=True)


def _shutdown() -> None:
    """Tear the process group and its store down while the interpreter is
    whole: left to its own exit, the process may abort ("terminate called
    without an active exception") after its last collective."""
    global _STORE, _SHARE
    if _STORE is not None:
        dist.destroy_process_group()
        _STORE, _SHARE = None, None


def initialize_from_env() -> bool:
    """Join the process group that the STPU_* variables describe:
    STPU_COORDINATOR (host:port of process 0's store), STPU_NUM_PROCESSES,
    STPU_PROCESS_ID and STPU_INIT_TIMEOUT (seconds, default 900).

    Returns True if a multi-process runtime was (or already is) set up,
    False for single-process runs.  Idempotent."""
    if _STORE is not None:
        return True
    coord = os.environ.get("STPU_COORDINATOR")
    if not coord:
        return False
    host, port = coord.rsplit(":", 1)
    _initialize(host, int(port),
                rank=int(os.environ.get("STPU_PROCESS_ID", "0")),
                world=int(os.environ.get("STPU_NUM_PROCESSES", "1")),
                timeout_s=int(os.environ.get("STPU_INIT_TIMEOUT", "900")))
    return True


def initialize_single(port: int = 0) -> None:
    """A process group of this one process on localhost (the whole
    multi-process code path on one host).  Port 0 picks a free one."""
    if _STORE is not None:
        return
    if port == 0:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
    _initialize("localhost", port, rank=0, world=1, timeout_s=900)


def is_initialized() -> bool:
    return _STORE is not None


def process_count() -> int:
    return dist.get_world_size() if _STORE is not None else 1


def process_index() -> int:
    return dist.get_rank() if _STORE is not None else 0


def global_mesh(tp: int = 1, devices=None):
    """A (dp, tp) mesh whose dp axis also spans the process group, so a
    psum over it counts every process.  `devices` defaults to the CUDA
    devices this process drives (``device_share``: on one host whose
    processes all see every card, one card's share a process), or, with
    no process group, every CUDA device it sees."""
    from ..parallel.batch import make_mesh

    if devices is None and _SHARE:
        devices = [f"cuda:{i}" for i in _SHARE]
    return make_mesh(tp=tp, devices=devices, process_axis="dp")


def barrier(name: str, timeout_s: float = 600) -> None:
    """Block until every process reaches this barrier (a counter in the
    process group's store, not a device collective).

    Each call of a name is a barrier of its own (``name#k`` for the k-th
    call), so a barrier never sees the arrivals of an earlier one.  If the
    world has not arrived within `timeout_s`, raises TimeoutError naming
    the barrier and how many processes arrived."""
    if _STORE is None:
        raise RuntimeError(f"barrier {name!r}: the process group is not initialized")
    _BARRIER_CALLS[name] += 1
    label = f"{name}#{_BARRIER_CALLS[name]}"
    key = f"stpu/barrier/{label}"
    world = dist.get_world_size()
    deadline = time.monotonic() + timeout_s
    arrived = _STORE.add(key, 1)
    while arrived < world:
        if time.monotonic() > deadline:
            raise TimeoutError(f"barrier {label!r}: {arrived} of {world} processes "
                               f"arrived within {timeout_s} s")
        time.sleep(0.01)
        arrived = _STORE.add(key, 0)


def local_batch_slice(global_batch: int):
    """This process's slice of a global proof batch: (start, size)."""
    n, i = process_count(), process_index()
    if global_batch % n:
        raise ValueError(f"{n} processes do not divide a global batch of {global_batch}")
    per = global_batch // n
    return i * per, per
