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
  costs, and what to run instead).
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

import math

import torch

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

    def run(self, fn, *sharded):
        """[fn(*args of shard i) for every shard i], each CUDA shard's work
        issued on its own stream (see the module docstring)."""
        for a in sharded:
            if len(a) != self.size:
                raise ValueError(f"a sharded value of {len(a)} shards on a mesh of {self.size}")
        for dev, s in zip(self.devices, self._streams):
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(dev))
        out = []
        for i, s in enumerate(self._streams):
            args = [a[i] for a in sharded]
            if s is None:
                out.append(fn(*args))
            else:
                with torch.cuda.stream(s):
                    out.append(fn(*args))
        for dev, s in zip(self.devices, self._streams):
            if s is not None:
                torch.cuda.current_stream(dev).wait_stream(s)
        return out

    def shard(self, x: torch.Tensor, axis: str) -> list:
        """`x` split along its leading dimension over `axis` in contiguous
        chunks (replicated over the other axes), each on its shard's device."""
        n = self.shape[axis]
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {n} shards of {axis!r}")
        chunks = torch.chunk(x, n)
        return [chunks[self.coords(i)[axis]].to(self.devices[i]) for i in range(self.size)]


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
