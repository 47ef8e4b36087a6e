"""Entry points of the port's main path: the batched stwo verifier.

The PyTorch counterpart of ``__graft_entry__.entry()``: ``entry()`` returns
``(fn, (batch,))``, where ``batch`` is a stack of PRODUCTION proofs (trace
2^9 x 4 columns, LDE 2^13, 16 queries, 8 inner FRI layers, 5 PoW bits)
built from the 256 distinct committed fixtures and moved to `device`, and
``fn`` is ``verify_batch(..., linkage="reference")``.  ``entry_tiled()`` is
the same over the fast path: the batch is tiled once at ingestion
(``tiled.tile_batch``) and ``fn`` is ``verify_batch_tiled``.  On a CUDA
device every SHA-256, Merkle and fused-stage call of either path runs in
the kernels of ``ops/cuda``.
"""

from __future__ import annotations

import numpy as np

from .models.stwo import proof as P
from .models.stwo import tiled, verifier
from .models.stwo.config import PRODUCTION
from .utils.proofcache import cached_stwo_proof

N_DISTINCT = 256


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


def entry(n_proofs: int = 4096, device: str = "cuda", proofs=None):
    """(fn, (batch,)) over n_proofs PRODUCTION proofs on `device`; `proofs`
    as in production_batch."""
    batch = P.to_torch(production_batch(n_proofs, proofs), device)

    def fn(b):
        return verifier.verify_batch(b, PRODUCTION, linkage="reference")

    return fn, (batch,)


def entry_tiled(n_proofs: int = 4096, device: str = "cuda", proofs=None):
    """(fn, (tb,)) over n_proofs PRODUCTION proofs tiled on `device`;
    `proofs` as in production_batch."""
    tb = tiled.tile_batch(production_batch(n_proofs, proofs), PRODUCTION, device)

    def fn(b):
        return verifier.verify_batch_tiled(b, PRODUCTION)

    return fn, (tb,)
