"""stwo proof container, JSON / npz ingestion, and the move to tensors.

Port of ``stark_symphony_tpu/models/stwo/proof.py``.  ``parse``,
``load_json`` and ``load_npz`` use numpy alone and read the same JSON
schema and npz format, so the committed fixtures load unchanged.
``to_torch`` turns a proof of numpy uint32 arrays (this package's or the
JAX package's ``StwoProof``) into one of int64 word tensors on a device.

Array layout (single proof; batching stacks a leading axis):
  commitments:      (3, 8)    const/trace/cp roots
  trace_evals:      (Q, C)    queried trace values (M31)
  trace_sibs:       (Q, D, 8) Merkle siblings, leaf level first
  cp_evals:         (Q, 16)
  cp_sibs:          (Q, D, 8)
  oods_trace:       (C, 4)    QM31 coords [a,b,c,d]
  oods_cp:          (16, 4)
  fri_first_commit: (8,)
  fri_inner_commits:(L, 8)
  fri_last:         (4,)
  fri_witnesses:    tuple of L+1 arrays (Q, 4)      (first layer, then inner)
  fri_sibs:         tuple of L+1 arrays (Q, D_l, 8) ragged depths
  pow_nonce:        (2,)      (hi, lo) big-endian u32 pair
"""

from __future__ import annotations

import json
from typing import NamedTuple, Tuple

import numpy as np

from ...ops.u32 import from_numpy
from .config import StwoConfig, from_proof_json


class StwoProof(NamedTuple):
    commitments: np.ndarray
    trace_evals: np.ndarray
    trace_sibs: np.ndarray
    cp_evals: np.ndarray
    cp_sibs: np.ndarray
    oods_trace: np.ndarray
    oods_cp: np.ndarray
    fri_first_commit: np.ndarray
    fri_inner_commits: np.ndarray
    fri_last: np.ndarray
    fri_witnesses: Tuple[np.ndarray, ...]
    fri_sibs: Tuple[np.ndarray, ...]
    pow_nonce: np.ndarray


def _bytes32_words(byte_list) -> np.ndarray:
    if len(byte_list) != 32:
        raise ValueError(f"expected a 32-byte hash, got {len(byte_list)} bytes")
    return np.frombuffer(bytes(byte_list), dtype=">u4").astype(np.uint32)


def _qm31(node) -> np.ndarray:
    x = node
    while isinstance(x, list) and len(x) == 1 and isinstance(x[0], list):
        x = x[0]
    (ab, cd) = x
    return np.array([ab[0], ab[1], cd[0], cd[1]], dtype=np.uint32)


def _split_chunks(lst, n):
    if len(lst) % n != 0:
        raise ValueError("ragged witness split")
    k = len(lst) // n
    return [lst[i * k: (i + 1) * k] for i in range(n)]


def _sibs_from_hash_witness(hash_witness, n_queries) -> np.ndarray:
    """Concatenated hash witness -> (Q, D, 8), leaf level first per query."""
    chunks = _split_chunks(hash_witness, n_queries)
    return np.stack(
        [np.stack([_bytes32_words(h) for h in chunk]) for chunk in chunks]
    ).astype(np.uint32)


def load_json(path: str):
    with open(path) as f:
        data = json.load(f)
    return parse(data)


def parse(data: dict) -> Tuple[StwoProof, StwoConfig]:
    cfg = from_proof_json(data)
    q = cfg.n_queries

    commitments = np.stack([_bytes32_words(c) for c in data["commitments"]])

    oods_trace = np.stack([_qm31(c) for c in data["sampled_values"][1]])
    oods_cp = np.stack([_qm31(c) for c in data["sampled_values"][2]])

    queried = data["queried_values"]
    trace_evals = np.array(
        _split_chunks([int(x) for x in queried[1]], q), dtype=np.uint32
    )
    cp_evals = np.array(
        _split_chunks([int(x) for x in queried[2]], q), dtype=np.uint32
    )
    trace_sibs = _sibs_from_hash_witness(data["decommitments"][1]["hash_witness"], q)
    cp_sibs = _sibs_from_hash_witness(data["decommitments"][2]["hash_witness"], q)

    fri = data["fri_proof"]
    first = fri["first_layer"]
    inner = fri.get("inner_layers", [])

    fri_first_commit = _bytes32_words(first["commitment"])
    fri_inner_commits = (
        np.stack([_bytes32_words(l["commitment"]) for l in inner])
        if inner
        else np.zeros((0, 8), np.uint32)
    )
    fri_last = _qm31(fri["last_layer_poly"]["coeffs"][0])

    witnesses = []
    sibs = []
    for layer in [first] + list(inner):
        witnesses.append(
            np.stack([_qm31(w) for w in layer["fri_witness"]]).astype(np.uint32)
        )
        sibs.append(
            _sibs_from_hash_witness(layer["decommitment"]["hash_witness"], q)
        )

    nonce = int(data.get("proof_of_work", 0))
    pow_nonce = np.array([nonce >> 32, nonce & 0xFFFFFFFF], dtype=np.uint32)

    proof = StwoProof(
        commitments=commitments,
        trace_evals=trace_evals,
        trace_sibs=trace_sibs,
        cp_evals=cp_evals,
        cp_sibs=cp_sibs,
        oods_trace=oods_trace,
        oods_cp=oods_cp,
        fri_first_commit=fri_first_commit,
        fri_inner_commits=fri_inner_commits,
        fri_last=fri_last,
        fri_witnesses=tuple(witnesses),
        fri_sibs=tuple(sibs),
        pow_nonce=pow_nonce,
    )
    return proof, cfg


def load_npz(path: str) -> StwoProof:
    """Load a proof saved by the JAX package's ``save_npz`` (tuple fields
    are stored as ``{name}__n`` plus ``{name}__{i}`` keys)."""
    with np.load(path) as data:
        kwargs = {}
        for name in StwoProof._fields:
            if f"{name}__n" in data:
                n = int(data[f"{name}__n"])
                kwargs[name] = tuple(data[f"{name}__{i}"] for i in range(n))
            else:
                kwargs[name] = data[name]
    return StwoProof(**kwargs)


def map_fields(fn, *proofs) -> StwoProof:
    """Apply fn field by field (and element by element in tuple fields)."""
    out = {}
    for name in StwoProof._fields:
        vals = [getattr(p, name) for p in proofs]
        if isinstance(vals[0], tuple):
            out[name] = tuple(fn(*xs) for xs in zip(*vals))
        else:
            out[name] = fn(*vals)
    return StwoProof(**out)


def stack(proofs) -> StwoProof:
    """Stack N structurally identical proofs into a batch (leading axis)."""
    return map_fields(lambda *xs: np.stack(xs), *proofs)


def replicate(proof: StwoProof, n: int) -> StwoProof:
    """Tile one proof n times."""
    return map_fields(lambda x: np.broadcast_to(x, (n,) + x.shape).copy(), proof)


def to_torch(proof, device="cpu") -> StwoProof:
    """A proof of numpy uint32 arrays (either package's StwoProof) -> this
    package's StwoProof of int64 word tensors on `device`."""
    return map_fields(lambda x: from_numpy(x, device), StwoProof(*proof))
