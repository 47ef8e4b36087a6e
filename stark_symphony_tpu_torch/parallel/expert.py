"""Routed AIRs: one batch of proofs of several constraint systems.

Port of ``verify_batch_routed`` of ``stark_symphony_tpu/parallel/expert.py``.
Every proof carries an ``air_id`` into ``airs`` (by default
``constraints.AIR_IDS``), and the batched verifier checks its composition
polynomial against that AIR.  Dispatch is dense: each lane evaluates
every AIR at its OODS point, a few QM31 operations against the proof's
thousands of SHA-256 compressions, and keeps its own AIR's value, so the
batch stays one pass over all lanes with no regrouping.  The JAX package
maps the verifier over the proofs one by one; here the whole batch is
verified at once, its SHA-256 and Merkle work in the kernels on a CUDA
device.
"""

from __future__ import annotations

import torch

from ..models.stwo import verifier
from ..models.stwo.config import StwoConfig
from ..models.stwo.constraints import AIR_IDS


def verify_batch_routed(proof_batch, air_ids, cfg: StwoConfig, airs=AIR_IDS,
                        linkage: str = "reference", with_masks: bool = False):
    """The accept bitmap (B,) of a mixed-AIR proof batch, or (bitmap,
    masks) with `with_masks`.

    proof_batch: a stacked proof of word tensors (``proof.to_torch``),
    leading axis B; air_ids: (B,) integers (numpy or a tensor), each an
    index into `airs`, a tuple of ``constraints.REGISTRY`` names."""
    ids = torch.as_tensor(air_ids, dtype=torch.int64, device=proof_batch.commitments.device)
    ok, masks = verifier.verify(proof_batch, cfg, tuple(airs), linkage, ids)
    return (ok, masks) if with_masks else ok
