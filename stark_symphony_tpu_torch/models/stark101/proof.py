"""stark101 proof container, JSON ingestion and export, and the move to
tensors.

Port of ``stark_symphony_tpu/models/stark101/proof.py``, plus the
``to_json_dict`` export that the JAX package keeps in its prover.  It
reads and writes the reference prover's ``proof.json`` schema with numpy
alone.  ``to_torch`` turns a proof of numpy uint32 words (this package's
or the JAX package's ``Stark101Proof``) into one of int64 word tensors on a
device.

Array layout (one proof; a batch stacks leading axes):
  p_mt_root:   (8,)
  evals:       (3,)        f(x), f(gx), f(ggx)
  eval_sibs:   (3, 13, 8)  Merkle siblings, leaf level first
  fri_roots:   (L, 8)
  fri_betas:   (L,)
  cpa_evals:   (L,)
  cpa_sibs:    tuple of L arrays (13 - i, 8)
  cpb_evals:   (L,)
  cpb_sibs:    tuple of L arrays (13 - i, 8)
  last:        ()          the degree-0 free term
"""

from __future__ import annotations

import json
from typing import NamedTuple, Tuple

import numpy as np

from ...ops.u32 import from_numpy
from ...utils.packing import u256_to_words, words_to_u256


class Stark101Proof(NamedTuple):
    p_mt_root: np.ndarray
    evals: np.ndarray
    eval_sibs: np.ndarray
    fri_roots: np.ndarray
    fri_betas: np.ndarray
    cpa_evals: np.ndarray
    cpa_sibs: Tuple[np.ndarray, ...]
    cpb_evals: np.ndarray
    cpb_sibs: Tuple[np.ndarray, ...]
    last: np.ndarray


def _digests(values) -> np.ndarray:
    return np.stack([u256_to_words(int(v)) for v in values])


def from_dict(res: dict) -> Stark101Proof:
    """Build from the reference prover's result dict (proof.json schema)."""
    evals = res["evals"]
    layers = res["fri_layers"]
    return Stark101Proof(
        p_mt_root=u256_to_words(int(res["p_mt_root"])),
        evals=np.array([int(e[0]) for e in evals], dtype=np.uint32),
        eval_sibs=np.stack([_digests(e[1]) for e in evals]),
        fri_roots=_digests(l[0] for l in layers),
        fri_betas=np.array([int(l[1]) for l in layers], dtype=np.uint32),
        cpa_evals=np.array([int(l[2]) for l in layers], dtype=np.uint32),
        cpa_sibs=tuple(_digests(l[3]) for l in layers),
        cpb_evals=np.array([int(l[4]) for l in layers], dtype=np.uint32),
        cpb_sibs=tuple(_digests(l[5]) for l in layers),
        last=np.uint32(int(res["fri_last_layer"])),
    )


def load_json(path: str) -> Stark101Proof:
    with open(path) as f:
        return from_dict(json.load(f))


def to_json_dict(proof: Stark101Proof) -> dict:
    """One proof of numpy words in the reference proof.json schema."""
    return {
        "p_mt_root": words_to_u256(proof.p_mt_root),
        "evals": [
            [int(proof.evals[k]), [words_to_u256(s) for s in proof.eval_sibs[k]]]
            for k in range(len(proof.evals))
        ],
        "fri_layers": [
            [
                words_to_u256(proof.fri_roots[i]),
                int(proof.fri_betas[i]),
                int(proof.cpa_evals[i]),
                [words_to_u256(s) for s in proof.cpa_sibs[i]],
                int(proof.cpb_evals[i]),
                [words_to_u256(s) for s in proof.cpb_sibs[i]],
            ]
            for i in range(len(proof.fri_betas))
        ],
        "fri_last_layer": int(proof.last),
    }


def map_fields(fn, *proofs) -> Stark101Proof:
    """Apply fn field by field (and element by element in tuple fields)."""
    out = {}
    for name in Stark101Proof._fields:
        vals = [getattr(p, name) for p in proofs]
        if isinstance(vals[0], tuple):
            out[name] = tuple(fn(*xs) for xs in zip(*vals))
        else:
            out[name] = fn(*vals)
    return Stark101Proof(**out)


def stack(proofs) -> Stark101Proof:
    """Stack N proofs into a batch (leading axis)."""
    return map_fields(lambda *xs: np.stack(xs), *proofs)


def replicate(proof: Stark101Proof, n: int) -> Stark101Proof:
    """Tile one proof n times (writable copies)."""
    return map_fields(lambda x: np.broadcast_to(x, (n,) + np.shape(x)).copy(), proof)


def to_torch(proof, device="cpu") -> Stark101Proof:
    """A proof of numpy uint32 words (either package's Stark101Proof, one
    proof or a batch) -> this package's Stark101Proof of int64 word tensors
    on `device`, tuple fields kept as tuples (and a 0-d ``last`` 0-d)."""
    return map_fields(lambda x: from_numpy(x, device).reshape(np.shape(x)),
                      Stark101Proof(*proof))
