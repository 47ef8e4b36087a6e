"""Proof batches over a device mesh: data parallelism over proofs (DP) and
tensor parallelism over queries (TP).

Port of ``stark_symphony_tpu/parallel/batch.py`` onto the single-controller
mesh of ``parallel/mesh.py``:

* DP (``verify_batch_dp``): every shard verifies its contiguous slice of
  the batch with the standard ``verifier.verify``, so its SHA-256 and
  Merkle work runs in kernels K1-K3 on a CUDA device; the accept count is
  a psum over ``dp``, which also crosses processes where ``dp`` is the
  mesh's process axis (``utils/distributed.global_mesh``).
* TP (``verify_batch_tp``): every shard holds a (B/dp, Q/tp) slice of the
  per-query arrays and the whole per-proof arrays of its dp slice; it runs
  the transcript whole and every per-query stage on its own queries
  (``verify(query_slice=...)``).  A proof is accepted where all its query
  shards accept (a psum over ``tp`` equal to tp); the count is a psum
  over ``dp``.
* ``verify_batch_gspmd`` keeps the JAX package's signature and returns.
  PyTorch has no SPMD partitioner, so it runs the split of
  ``verify_batch_tp``: the partition that JAX's sharding constraints ask
  XLA for.  The kernels stay on; nothing stands for ``pallas_disabled``.

Each returns (bitmap (B,) bool on the mesh's first device, n_ok 0-d
int64), and with ``with_masks`` also the per-stage masks of the whole
verifier, each (B,) bool on the first device: a TP mask is the AND of its
query shards' masks, as the unsharded mask is the AND over all queries.
In a multi-process run the bitmap is this process's lanes and n_ok counts
every process's.  With ``graphed=True`` each shard replays its verify as
a CUDA graph (``Mesh.capture``), captured once per (path, cfg, air,
linkage, query slices and input specs) and cached on the mesh, as JAX
compiles its ``shard_map`` once; each process graphs its own shards.
"""

from __future__ import annotations

import torch

from ..models.stwo import proof as P
from ..models.stwo import verifier
from .mesh import Mesh, psum, unshard

# The per-query fields of a StwoProof: split over the query axis in TP
PER_QUERY = ("trace_evals", "trace_sibs", "cp_evals", "cp_sibs", "fri_witnesses", "fri_sibs")


def make_mesh(n_devices: int | None = None, tp: int = 1, devices=None,
              process_axis: str | None = None) -> Mesh:
    """A (dp, tp) mesh over the first n_devices of `devices` (by default
    every CUDA device; a device may repeat, e.g. ``["cuda:0"] * 8``).
    Raises where there is no CUDA device and no `devices`: the mesh never
    falls back to the CPU.  `process_axis` names the axis that also spans
    the process group (``utils/distributed.global_mesh`` passes "dp").

    One thread issues every shard's work, and a shard's eager verify is
    about a hundred thousand launches, so a mesh over several GPUs in one
    process is bound by the host's launch rate (PERF.md measures its
    scaling) unless each shard replays a CUDA graph (``graphed=True``).
    For DP over several GPUs run one process a GPU
    (``utils/distributed``: each process's ``global_mesh`` covers its own
    card)."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= to build a "
                               "mesh of other devices")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"make_mesh: {n} devices asked for, {len(devices)} given")
    if n % tp:
        raise ValueError(f"make_mesh: tp={tp} does not divide {n} devices")
    rows = n // tp
    return Mesh([devices[r * tp:(r + 1) * tp] for r in range(rows)], ("dp", "tp"),
                process_axis=process_axis)


def _slices(mesh: Mesh, n: int, axis: str) -> list:
    """Each shard's slice of n rows split contiguously over `axis`."""
    k = mesh.shape[axis]
    if n % k:
        raise ValueError(f"{n} proofs do not split over {k} shards of {axis!r}")
    per = n // k
    return [slice(c * per, (c + 1) * per) for c in mesh.axis_index(axis)]


def shard_batch(batch, mesh: Mesh, axis: str = "dp") -> list:
    """A stacked numpy proof batch as one port proof a shard: the shard's
    contiguous slice of the leading axis (split over `axis`, replicated
    over the others), ``proof.to_torch``'d onto its device."""
    rows = _slices(mesh, batch.commitments.shape[0], axis)
    return [P.to_torch(P.map_fields(lambda x, s=s: x[s], batch), dev)
            for s, dev in zip(rows, mesh.devices)]


def shard_rows(x, mesh: Mesh, axis: str = "dp") -> list:
    """An integer array (numpy or a tensor) of the batch's leading axis, one
    int64 tensor a shard on its device, split as shard_batch splits."""
    x = torch.as_tensor(x, dtype=torch.int64)
    return [x[s].to(dev) for s, dev in zip(_slices(mesh, x.shape[0], axis), mesh.devices)]


def accept_count(mesh: Mesh, bitmaps: list, axis: str) -> torch.Tensor:
    """The accept count over `axis` (and over processes, where `axis` is
    the mesh's process axis)."""
    counts = mesh.run(lambda ok: ok.sum(dtype=torch.int64), bitmaps)
    return psum(mesh, counts, axis)[0]


def _gathered_masks(mesh: Mesh, masks: list, axis: str) -> dict:
    """Each stage's mask over the batch: per key, the shards' masks
    concatenated over `axis` on the mesh's first device."""
    return {k: unshard(mesh, [m[k] for m in masks], axis) for k in masks[0]}


def run_shards(mesh: Mesh, graphed: bool, key, fn, *sharded) -> list:
    """``mesh.run(fn, *sharded)``, or with `graphed` the replay of fn's
    shard graphs (``Mesh.capture``), captured at the first call for `key`
    and these shards' input specs and kept in ``mesh.graphs``."""
    if not graphed:
        return mesh.run(fn, *sharded)
    return mesh.graphs.get(key, sharded, lambda: mesh.capture(fn, *sharded)).run(*sharded)


def verify_batch_dp(batch, cfg, mesh: Mesh, air="wide_fibonacci",
                    linkage: str = "reference", axis_name: str = "dp",
                    with_masks: bool = False, graphed: bool = False):
    """DP: `batch` (numpy, leading axis B) split over `axis_name`, each
    shard verified by the standard verifier, the count psum'd.  Returns
    (bitmap (B,), n_accepted), and the masks with `with_masks`.
    `graphed`: each shard replays its verify's CUDA graph, as JAX runs
    its compiled ``shard_map``; the ingestion and the collectives stay
    outside the graphs."""
    results = run_shards(mesh, graphed, ("dp", cfg, air, linkage),
                         lambda b: verifier.verify(b, cfg, air, linkage),
                         shard_batch(batch, mesh, axis_name))
    bitmaps = [ok for ok, _ in results]
    out = unshard(mesh, bitmaps, axis_name), accept_count(mesh, bitmaps, axis_name)
    if with_masks:
        out += (_gathered_masks(mesh, [m for _, m in results], axis_name),)
    return out


def _proof_slices(batch, mesh: Mesh, batch_axis: str, query_slices) -> list:
    """Each shard's proof: its batch slice over `batch_axis`, and of the
    per-query arrays its query slice (query_slices[i] = (q, n_local)) too,
    ``to_torch``'d onto its device."""
    rows = _slices(mesh, batch.commitments.shape[0], batch_axis)
    out = []
    for r, (q, n_local), dev in zip(rows, query_slices, mesh.devices):
        cols = slice(q * n_local, (q + 1) * n_local)
        fields = {}
        for name, val in batch._asdict().items():
            cut = (lambda x: x[r, cols]) if name in PER_QUERY else (lambda x: x[r])
            fields[name] = tuple(map(cut, val)) if isinstance(val, tuple) else cut(val)
        out.append(P.to_torch(P.StwoProof(**fields), dev))
    return out


def _all_shards(mesh: Mesh, oks: list, axis: str) -> list:
    """Per shard, where every shard of its `axis` group holds True (a psum
    of the votes equal to the axis size)."""
    n = mesh.shape[axis]
    votes = psum(mesh, [ok.to(torch.int64) for ok in oks], axis)
    return mesh.run(lambda v: v == n, votes)


def _verify_query_split(batch, cfg, mesh: Mesh, air, linkage, batch_axis, query_axis,
                        query_slices, with_masks, graphed):
    """(bitmap, n_accepted[, masks]) with shard i verifying query_slices[i]
    of its batch slice; a proof (and each stage's mask) holds where every
    shard of its query group holds it.  TP and GSPMD share their shard
    graphs where their query slices are the same."""
    results = run_shards(mesh, graphed, ("query_split", cfg, air, linkage),
                         lambda b, qs: verifier.verify(b, cfg, air, linkage, query_slice=qs),
                         _proof_slices(batch, mesh, batch_axis, query_slices), query_slices)
    ok_all = _all_shards(mesh, [ok for ok, _ in results], query_axis)
    out = unshard(mesh, ok_all, batch_axis), accept_count(mesh, ok_all, batch_axis)
    if with_masks:
        keys = results[0][1]
        masks = [dict(zip(keys, vals)) for vals in zip(*(
            _all_shards(mesh, [m[k] for _, m in results], query_axis) for k in keys))]
        out += (_gathered_masks(mesh, masks, batch_axis),)
    return out


def verify_batch_tp(batch, cfg, mesh: Mesh, air="wide_fibonacci",
                    linkage: str = "reference", batch_axis: str = "dp",
                    query_axis: str = "tp", with_masks: bool = False,
                    graphed: bool = False):
    """TP over the query axis: `batch` (numpy) split over (batch_axis,
    query_axis), every shard verifying its queries; a proof is accepted
    where every query shard accepts.  cfg.n_queries must be divisible by
    the query axis's size.  Returns (bitmap (B,), n_accepted), and the
    masks with `with_masks`; `graphed` as in verify_batch_dp."""
    tp = mesh.shape[query_axis]
    if cfg.n_queries % tp:
        raise ValueError(f"n_queries={cfg.n_queries} not divisible by tp={tp}")
    n_local = cfg.n_queries // tp
    slices = [(q, n_local) for q in mesh.axis_index(query_axis)]
    return _verify_query_split(batch, cfg, mesh, air, linkage, batch_axis, query_axis, slices,
                               with_masks, graphed)


def verify_batch_gspmd(batch, cfg, mesh: Mesh, air="wide_fibonacci",
                       linkage: str = "reference", batch_axis: str = "dp",
                       query_axis: str = "tp", with_masks: bool = False,
                       graphed: bool = False):
    """DP + TP as the JAX package's GSPMD path partitions it: the batch over
    `batch_axis`, the per-query work over `query_axis`.  PyTorch has no SPMD
    partitioner, so this runs the split of ``verify_batch_tp`` by hand, with
    the kernels on.  Where the axis does not divide the queries (TESTING's
    one query over tp = 2), which XLA splits unevenly, every shard of the
    query axis verifies all of them.  Returns (bitmap (B,), n_accepted),
    and the masks with `with_masks`; `graphed` as in verify_batch_dp."""
    tp = mesh.shape[query_axis]
    if cfg.n_queries % tp:
        slices = [(0, cfg.n_queries)] * mesh.size
    else:
        slices = [(q, cfg.n_queries // tp) for q in mesh.axis_index(query_axis)]
    return _verify_query_split(batch, cfg, mesh, air, linkage, batch_axis, query_axis, slices,
                               with_masks, graphed)
