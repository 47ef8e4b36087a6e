"""A device mesh for one controller: the port's stand-in for
``jax.sharding.Mesh``, ``shard_map`` and ``lax.{ppermute, psum,
all_gather, axis_index}``.

As in JAX, one process drives every shard.  A ``Mesh`` is a named grid of
``torch.device``s, such as ``("dp", "tp")`` or ``("sp",)``, and one device
may stand at several places of it, so 8 shards can share ``cuda:0`` as the
JAX tests put 8 on the CPU.  A sharded value is a list of per-shard
tensors (or proofs), one for each place of the grid in row-major order.

* ``Mesh.run(fn, *sharded)`` runs ``fn`` once a shard, each CUDA shard on
  a stream of its own device; the stream first waits for the work already
  queued on its device's current stream, and that stream waits for every
  shard stream when the run ends.  So the collectives below, which run on
  the devices' current streams between runs, see finished shards.  The
  calling thread issues every shard's work, so over several GPUs the
  shards take turns at the host (``batch.make_mesh`` says what that
  costs, and what to run instead).  Inside a CUDA graph capture on the
  shards' one device, those waits are the capture's fork and join: the
  shards' work and the collectives between runs all lie inside the one
  graph (``models/stwo/prover_sharded.graphed_prover``).
* ``Mesh.capture(fn, *sharded)`` captures ``fn`` as a CUDA graph once a
  shard, on the shard's stream, and replays them as ``run`` runs ``fn``
  (``GraphedShards``); the collectives stay outside the graphs.
* ``run(..., where=mask)`` runs ``fn`` on the shards the mask names
  alone (the others get None, and their streams are left alone);
  ``run_first`` runs it on the first shard, the mesh's first device.
* ``Mesh.graphed(key, args)``: the counterpart of ``jax.jit(shard_map(
  ...))`` for a sharded call that makes several runs with exchanges
  between them.  Inside it every ``run`` is one step of a
  ``ShardProgram``, kept in ``mesh.graphs`` by key and input specs: the
  first call captures each step's shard bodies (``capture``) and replays
  them; a later call replays the k-th step's graphs at its k-th run.
  The exchanges between the runs stay eager, on the devices' current
  streams.  A call that makes another sequence of runs raises.
* ``ppermute`` moves tensors between the shards of one axis: every
  destination gets a new tensor on its device (``Tensor.to(..., copy=True)``;
  between two GPUs a peer copy), never the source tensor itself.  A
  shard that receives nothing gets None (JAX fills zeros there).
* ``psum`` and ``all_gather`` reduce or concatenate over one axis; every
  member of a group gets the result on its own device.  Over the mesh's
  ``process_axis`` (``utils/distributed.global_mesh`` sets it to ``dp``)
  psum also adds the other processes' sums, with one ``all_reduce`` after
  a barrier, once the process group is initialized.
"""

from __future__ import annotations

import contextlib
import math

import torch

from ..tools import build as TB
from ..utils import distributed as D


class Mesh:
    """A grid of devices with named axes.

    devices: a nested list whose shape is the grid's (``[[d0, d1], [d2,
    d3]]`` for a 2 x 2 mesh over ("dp", "tp")); a flat list for one axis.
    process_axis: the axis that also spans the processes of the process
    group (its psum adds every process's sum), or None."""

    def __init__(self, devices, axis_names, process_axis: str | None = None):
        flat, dims = _flatten(devices)
        self.axis_names = tuple(axis_names)
        if len(dims) != len(self.axis_names) or math.prod(dims) != len(flat):
            raise ValueError(f"{len(flat)} devices do not form a {dims} mesh over "
                             f"axes {self.axis_names}")
        self.devices = [_indexed(torch.device(d)) for d in flat]
        self.dims = dims
        self.shape = dict(zip(self.axis_names, dims))
        self.size = len(flat)
        if process_axis is not None and process_axis not in self.axis_names:
            raise ValueError(f"process axis {process_axis!r} is not one of {self.axis_names}")
        self.process_axis = process_axis
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                         for d in self.devices]
        self.graphs = TB.GraphCache()  # the sharded paths' GraphedShards and ShardPrograms
        self.program = None  # the ShardProgram of the graphed call in progress

    def coords(self, i: int) -> dict:
        """The grid coordinates of shard i, by axis name."""
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.dims))):
            i, out[name] = divmod(i, n)
        return out

    def axis_index(self, axis: str) -> list:
        """Each shard's index along `axis` (``lax.axis_index``)."""
        return [self.coords(i)[axis] for i in range(self.size)]

    def groups(self, axis: str) -> list:
        """The shards that differ only in their index along `axis`, one
        list a group, each in axis order."""
        found = {}
        for i in range(self.size):
            c = self.coords(i)
            key = tuple(v for k, v in c.items() if k != axis)
            found.setdefault(key, []).append(i)
        return list(found.values())

    def _check_sharded(self, sharded) -> None:
        for a in sharded:
            if len(a) != self.size:
                raise ValueError(f"a sharded value of {len(a)} shards on a mesh of {self.size}")

    def run(self, fn, *sharded, where=None):
        """[fn(*args of shard i) for every shard i], each CUDA shard's work
        issued on its own stream (see the module docstring).  `where`: a
        bool a shard, the shards that run fn; the others give None.
        Inside a graphed call (``graphed``) this replays the call's next
        step."""
        self._check_sharded(sharded)
        if self.program is not None:
            return self.program.step(fn, sharded, where)
        return self._issue(fn, sharded, where)

    def run_first(self, fn, *args):
        """fn(*args) on the first shard alone, a ``run`` whose other shards
        idle: in a graphed call, a graph on the mesh's first device."""
        idle = [None] * (self.size - 1)
        return self.run(fn, *([a] + idle for a in args),
                        where=[True] + [False] * (self.size - 1))[0]

    def _active(self, where) -> list:
        """`where` (``run``'s) as a bool a shard: all True for None."""
        return [True] * self.size if where is None else [bool(w) for w in where]

    def _issue(self, fn, sharded, where):
        active = self._active(where)
        streams = [s for s, on in zip(self._streams, active) if on and s is not None]
        for s in streams:
            s.wait_stream(torch.cuda.current_stream(s.device))
        out = []
        for i, s in enumerate(self._streams):
            args = [a[i] for a in sharded]
            if not active[i]:
                out.append(None)
            elif s is None:
                out.append(fn(*args))
            else:
                with torch.cuda.stream(s):
                    out.append(fn(*args))
        for s in streams:
            torch.cuda.current_stream(s.device).wait_stream(s)
        return out

    def capture(self, fn, *sharded, where=None, pools=None) -> "GraphedShards":
        """`fn` captured as a CUDA graph once a shard (``tools/build.capture``
        on the shard's arguments of `sharded`, on the shard's own stream),
        the counterpart of compiling the body of JAX's ``shard_map``;
        ``GraphedShards.run`` replays each on that stream.  The shards are
        captured one after another, each into a pool of its own, since
        their replays overlap across streams.  One warm-up run a device,
        before its first shard's capture: it builds the device's tables
        and constants, which the device's other shards, running `fn` at
        the same shapes, share (a capture that would have to make one
        raises).  A CPU shard keeps no graph and runs `fn` at each call.
        `where`: the shards to capture, as ``run`` takes it (the others
        hold None).  `pools`: a dict, shard index -> the pool of an
        earlier graph of that shard that always replays before this one;
        each shard's new graph shares it, and leaves its own pool there."""
        self._check_sharded(sharded)
        graphs, warm = [], set()
        for i, (dev, s, on) in enumerate(zip(self.devices, self._streams, self._active(where))):
            if not on:
                graphs.append(None)
                continue
            g = TB.capture(fn, tuple(a[i] for a in sharded), warmup=int(dev not in warm),
                           stream=s, pool=None if pools is None else pools.get(i))
            if pools is not None:
                pools[i] = g.pool
            graphs.append(g)
            warm.add(dev)
        return GraphedShards(self, graphs)

    def graphed(self, key, args):
        """A context in which every ``run`` is a step of the ShardProgram
        of (key, the specs of `args`), made at the first such call and kept
        in ``self.graphs``; inside a graphed call already in progress, the
        call joins it (a null context)."""
        if self.program is not None:
            return contextlib.nullcontext()
        return self.graphs.get(key, args, lambda: ShardProgram(self))

    def shard(self, x: torch.Tensor, axis: str) -> list:
        """`x` split along its leading dimension over `axis` in contiguous
        chunks (replicated over the other axes), each on its shard's device."""
        n = self.shape[axis]
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {n} shards of {axis!r}")
        chunks = torch.chunk(x, n)
        return [chunks[self.coords(i)[axis]].to(self.devices[i]) for i in range(self.size)]


class GraphedShards:
    """One graphed function a shard of a mesh (``Mesh.capture``).

    ``run(*sharded)`` replays each shard's graph on the shard's stream,
    with ``Mesh.run``'s fences, after copying the shard's arguments into
    its static inputs; it returns the copies of each shard's outputs (None
    where the shard has no graph).  A shard called with other shapes than
    its capture's raises ValueError.  ``graphs``: the shards'
    ``GraphedVerifier``s, or None (their launches, capture and instantiate
    seconds and pools)."""

    def __init__(self, mesh: Mesh, graphs: list):
        self.mesh = mesh
        self.graphs = graphs

    def run(self, *sharded) -> list:
        return self.mesh._issue(lambda g, *args: g(*args), (self.graphs, *sharded),
                                [g is not None for g in self.graphs])


class ShardProgram:
    """The per-shard graphs of one graphed sharded call (``Mesh.graphed``),
    step by step: the k-th ``Mesh.run`` of the call is step k.

    Used as a context on its mesh.  At the first call every step is
    captured (``Mesh.capture``, one warm-up a device) and replayed; at a
    later one step k replays ``steps[k]``, whose static inputs take the
    run's arguments.  Each shard's graphs share one memory pool
    (``pools``, by shard index): a shard's steps replay in the order of
    their capture, one after another (``Mesh.run``'s fences), and the
    first device's later graphs (the provers' graph B) may share shard
    0's.  A call that runs another function at a step, runs another set of
    shards, or makes another number of runs than the first raises
    RuntimeError; a first call that raised is captured anew next time."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.steps = []  # (fn's code, GraphedShards)
        self.pools = {}
        self.complete = False
        self._next = 0

    @property
    def graphs(self) -> list:
        """Every shard graph of the program, step by step."""
        return [g for _, shards in self.steps for g in shards.graphs if g is not None]

    def __enter__(self):
        if not self.complete:
            self.steps, self.pools = [], {}
        self._next = 0
        self.mesh.program = self
        return self

    def __exit__(self, exc_type, exc, tb):
        self.mesh.program = None
        if exc_type is None:
            if self._next != len(self.steps):
                raise RuntimeError(f"a graphed sharded call made {self._next} runs; its "
                                   f"graphs hold {len(self.steps)}")
            self.complete = True
        return False

    def step(self, fn, sharded, where):
        code = getattr(fn, "__code__", fn)
        mask = self.mesh._active(where)
        if not self.complete:
            self.steps.append((code, self.mesh.capture(fn, *sharded, where=where,
                                                       pools=self.pools)))
        elif self._next >= len(self.steps):
            raise RuntimeError(f"a graphed sharded call made more runs than the "
                               f"{len(self.steps)} its graphs hold")
        want, shards = self.steps[self._next]
        if want is not code or mask != [g is not None for g in shards.graphs]:
            raise RuntimeError(f"step {self._next} of a graphed sharded call runs another "
                               "function or other shards than its graph")
        self._next += 1
        return shards.run(*sharded)


def _indexed(dev: torch.device) -> torch.device:
    """`dev` with its index: plain "cuda" is the current CUDA device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _flatten(devices):
    """(flat list, grid shape) of a nested list of devices."""
    if isinstance(devices, (list, tuple)) and devices and isinstance(devices[0], (list, tuple)):
        parts = [_flatten(d) for d in devices]
        if len({p[1] for p in parts}) != 1:
            raise ValueError("a ragged device grid")
        return [d for p in parts for d in p[0]], (len(parts),) + parts[0][1]
    return list(devices), (len(devices),)


def ppermute(mesh: Mesh, shards: list, axis: str, perm) -> list:
    """``lax.ppermute``: within every group of `axis`, the tensor of the
    member at axis index src goes to the member at dst, for each (src, dst)
    of `perm`, as a new tensor on dst's device.  Members that receive
    nothing get None."""
    out = [None] * mesh.size
    for group in mesh.groups(axis):
        for src, dst in perm:
            i, j = group[src], group[dst]
            out[j] = shards[i].to(mesh.devices[j], copy=True)
    return out


def _process_group_reduce(total: torch.Tensor) -> torch.Tensor:
    """`total` summed over the process group, if there is one: after a
    barrier, so a peer that never comes fails within the barrier's
    timeout, by name, instead of hanging the collective."""
    if D.process_count() > 1:
        D.barrier("psum over the process axis")
        torch.distributed.all_reduce(total)
    return total


def psum(mesh: Mesh, shards: list, axis: str) -> list:
    """``lax.psum`` over `axis`: every member of a group gets the sum of
    the group's tensors, on its own device.  Over the mesh's process axis,
    with the process group initialized, the sums of every process are
    added too, in one all_reduce for all groups."""
    groups = mesh.groups(axis)
    sums = []
    for group in groups:
        dev = mesh.devices[group[0]]
        total = shards[group[0]].to(dev, copy=True)
        for i in group[1:]:
            total += shards[i].to(dev)
        sums.append(total)
    if axis == mesh.process_axis:
        first = mesh.devices[groups[0][0]]
        reduced = _process_group_reduce(torch.stack([s.to(first) for s in sums]))
        sums = list(reduced.unbind(0))
    out = [None] * mesh.size
    for group, total in zip(groups, sums):
        for i in group:
            out[i] = total.to(mesh.devices[i])
    return out


def unshard(mesh: Mesh, shards: list, axis: str) -> torch.Tensor:
    """The whole array of a value sharded over `axis`: one group's shards
    concatenated in axis order on the mesh's first device."""
    return torch.cat([shards[i].to(mesh.devices[0]) for i in mesh.groups(axis)[0]])


def all_gather(mesh: Mesh, shards: list, axis: str) -> list:
    """``lax.all_gather`` over `axis` (along dimension 0, concatenated):
    every member of a group gets the group's tensors in axis order, on its
    own device."""
    out = [None] * mesh.size
    for group in mesh.groups(axis):
        dev = mesh.devices[group[0]]
        whole = torch.cat([shards[i].to(dev) for i in group])
        for i in group:
            out[i] = whole.to(mesh.devices[i])
    return out
