"""Entry points of the port: the batched stwo verifier (the main path) and
the stark101 verifier and prover.

The PyTorch counterpart of ``__graft_entry__.entry()``: ``entry()`` returns
``(fn, (batch,))``, where ``batch`` is a stack of PRODUCTION proofs (trace
2^9 x 4 columns, LDE 2^13, 16 queries, 8 inner FRI layers, 5 PoW bits)
built from the 256 distinct committed fixtures and moved to `device`, and
``fn`` is ``verify_batch(..., linkage="reference")``; with
``graphed=True``, ``fn`` is that verifier captured once as a CUDA graph
(``tools.build.capture``) and replayed on each call, the counterpart of
jitting the function JAX's ``entry()`` returns.  ``entry_tiled()`` is
the same over the fast path: the batch is tiled once at ingestion
(``tiled.tile_batch``) and ``fn`` is ``verify_batch_tiled``.  On a CUDA
device every SHA-256, Merkle and fused-stage call of either path runs in
the kernels of ``ops/cuda``.  ``entry_stark101()`` is the same for the
batched stark101 verifier, and ``prove_stark101()`` runs the stark101
prover; ``prove_stwo()`` runs the stwo prover on the trace of a proof
cache entry, and ``prove_stwo_sharded()`` the same with its FRI phase
sharded over a mesh (all three provers take ``graphed=True``, as JAX
compiles them).  ``dryrun_multichip()`` drives the sharded verifiers
(DP, the GSPMD counterpart, TP) at TESTING size, the counterpart of
``__graft_entry__.dryrun_multichip``.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from .models.stark101 import proof as P101
from .models.stark101 import prover as prover101
from .models.stark101 import verifier as verifier101
from .models.stark101.config import Stark101Config
from .models.stwo import proof as P
from .models.stwo import prover, prover_sharded, tiled, verifier
from .models.stwo.config import PRODUCTION, TESTING, TESTING_Q4
from .parallel.batch import make_mesh, verify_batch_dp, verify_batch_gspmd, verify_batch_tp
from .parallel.mesh import Mesh
from .tools.build import capture
from .utils.proofcache import cached_stwo_proof

N_DISTINCT = 256
STARK101_GOLDEN = (pathlib.Path(__file__).resolve().parents[1] / "tests" / "fixtures"
                   / "stark101" / "golden_proof.json")


def production_proofs(n_distinct: int = N_DISTINCT):
    """The committed PRODUCTION fixtures s0 .. s{n_distinct-1}, as a list of
    numpy proofs."""
    return [cached_stwo_proof(PRODUCTION, seed=s) for s in range(n_distinct)]


def production_batch(n_proofs: int, proofs=None) -> P.StwoProof:
    """A numpy batch of n_proofs PRODUCTION proofs: lane b holds distinct
    proof b % len(proofs) (by default the first min(n_proofs, 256)
    fixtures)."""
    if proofs is None:
        proofs = production_proofs(min(n_proofs, N_DISTINCT))
    distinct = P.stack(proofs)
    reps = -(-n_proofs // len(proofs))
    return P.map_fields(
        lambda x: np.concatenate([x] * reps)[:n_proofs].copy(), distinct
    )


def _graph(fn, batch, graphed: bool):
    return (capture(fn, (batch,)) if graphed else fn), (batch,)


def entry(n_proofs: int = 4096, device: str = "cuda", proofs=None,
          graphed: bool = False):
    """(fn, (batch,)) over n_proofs PRODUCTION proofs on `device`; `proofs`
    as in production_batch; `graphed`: fn replays a captured graph."""
    batch = P.to_torch(production_batch(n_proofs, proofs), device)

    def fn(b):
        return verifier.verify_batch(b, PRODUCTION, linkage="reference")

    return _graph(fn, batch, graphed)


def entry_tiled(n_proofs: int = 4096, device: str = "cuda", proofs=None,
                graphed: bool = False):
    """(fn, (tb,)) over n_proofs PRODUCTION proofs tiled on `device`;
    `proofs` and `graphed` as in entry."""
    tb = tiled.tile_batch(production_batch(n_proofs, proofs), PRODUCTION, device)

    def fn(b):
        return verifier.verify_batch_tiled(b, PRODUCTION)

    return _graph(fn, tb, graphed)


def entry_stark101(n_proofs: int = 4096, device: str = "cuda", graphed: bool = False):
    """(fn, (batch,)): the stark101 verifier at the reference configuration
    (``Stark101Config()``) over n_proofs lanes on `device`; `graphed` as in
    entry.

    Every lane holds the same proof, the committed golden one: the
    statement, ``boundary1`` included, is a static part of the
    configuration and the prover is deterministic, so the reference
    configuration has exactly one honest proof (the JAX package's
    ``replicate`` batches it the same way)."""
    cfg = Stark101Config()
    batch = P101.to_torch(P101.replicate(P101.load_json(str(STARK101_GOLDEN)), n_proofs),
                          device)

    def fn(b):
        return verifier101.verify_batch(b, cfg)

    return _graph(fn, batch, graphed)


def prove_stark101(device: str = "cuda", graphed: bool = False):
    """The stark101 prover at the reference configuration on `device`:
    (Stark101Proof of numpy words, {"idx": the query index}); `graphed`:
    its body replays one CUDA graph, captured at the first call."""
    return prover101.prove(Stark101Config(), device=device, graphed=graphed)


def prove_stwo(cfg=PRODUCTION, seed=None, air: str = "wide_fibonacci", device: str = "cuda",
               graphed: bool = False):
    """The stwo prover on `device`, on the trace of the proof cache's (cfg,
    seed, air) entry (``prover.seeded_trace``): (StwoProof of numpy words,
    {}); `graphed`: two CUDA graphs around the PoW grind
    (``prover.GraphedProver``), captured once per (cfg, air, device)."""
    return prover.prove(cfg, prover.seeded_trace(cfg, seed, air), air, device, graphed)


@functools.lru_cache(maxsize=None)
def sharded_prover_mesh(device: str = "cuda", n_shards: int = 8) -> Mesh:
    """The ("sp",) mesh of n_shards shards on `device` that
    prove_stwo_sharded proves over, made once per (device, n_shards), so
    its graphs (``mesh.graphs``) serve every later call.  Its shards share
    one device, so a graphed proof over it takes graph A as one capture
    (``prover_sharded.graphed_prover``); a mesh over several devices,
    made with ``parallel.mesh.Mesh`` and passed to
    ``prover_sharded.prove_sharded``, takes the per-shard layout."""
    return Mesh([device] * n_shards, ("sp",))


def prove_stwo_sharded(cfg=PRODUCTION, seed=None, n_shards: int = 8, device: str = "cuda",
                       air: str = "wide_fibonacci", graphed: bool = False):
    """The stwo prover with its FRI phase sharded over n_shards shards, all
    on `device` (``models/stwo/prover_sharded.py``), on the trace of the
    proof cache's (cfg, seed, air) entry: (StwoProof of numpy words,
    {"n_sharded_layers": k}); `graphed`: two CUDA graphs around the PoW
    grind, every shard's work and the exchanges inside the first, since
    the shards share `device` (``prover_sharded.graphed_prover``; over
    several devices ``prove_sharded(graphed=True)`` replays a graph a
    shard body instead), captured once per (cfg, air) on the mesh of
    (device, n_shards)."""
    return prover_sharded.prove_sharded(cfg, sharded_prover_mesh(device, n_shards),
                                        trace=prover.seeded_trace(cfg, seed, air), air=air,
                                        graphed=graphed)


def _check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """DP, the GSPMD counterpart and TP over a mesh of n_devices shards on
    TESTING-size proofs, each required to accept every proof; raises on a
    failure.  `devices` defaults to the CUDA devices, repeated to fill
    n_devices shards (so one card holds them all)."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("dryrun_multichip: no CUDA device; pass devices=")
        devices = [f"cuda:{i % count}" for i in range(n_devices)]
    proof = cached_stwo_proof(TESTING)
    tp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(n_devices, tp=tp, devices=devices)
    batch = P.replicate(proof, 2 * n_devices)

    bitmap, n_ok = verify_batch_dp(batch, TESTING, mesh)
    _check(bool(bitmap.all()) and int(n_ok) == 2 * n_devices,
           f"dp: {int(n_ok)} of {2 * n_devices} valid proofs accepted")
    bitmap, n_ok = verify_batch_gspmd(batch, TESTING, mesh)
    _check(bool(bitmap.all()) and int(n_ok) == 2 * n_devices,
           f"gspmd: {int(n_ok)} of {2 * n_devices} valid proofs accepted")
    if n_devices % 4 == 0:
        mesh4 = make_mesh(n_devices, tp=4, devices=devices)
        batch4 = P.replicate(cached_stwo_proof(TESTING_Q4), n_devices // 2)
        bitmap, n_ok = verify_batch_tp(batch4, TESTING_Q4, mesh4)
        _check(bool(bitmap.all()) and int(n_ok) == n_devices // 2,
               f"tp: {int(n_ok)} of {n_devices // 2} valid proofs accepted")
