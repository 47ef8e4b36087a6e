"""Own-prover stwo proofs: the committed fixtures, else the port's prover
with a disk cache.

The fixtures in ``tests/fixtures/own_proofs/`` are named
``stwo_{air}_{cfg_hash}[_s{seed}]_{source_hash}.npz`` by the JAX package's
proof cache; ``cfg_hash`` is the same hash over every config field.  A
(cfg, seed, air) with no fixture is proved by this package's prover
(``models/stwo/prover.py``) and written, atomically, to a cache directory
of its own, ``tests/.proof_cache_torch/``, keyed by a hash of this
package's prover sources: never into the fixtures, nor into the JAX
package's cache.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pathlib
import re
import tempfile

from ..models.stwo import proof as P
from ..models.stwo import prover

_PKG = pathlib.Path(__file__).resolve().parents[1]
_ROOT = _PKG.parent
FIXTURES = _ROOT / "tests" / "fixtures" / "own_proofs"
CACHE = _ROOT / "tests" / ".proof_cache_torch"

# What a proof of this package's prover depends on: the field, FFT, hash
# and Merkle code with its kernels, and the stwo model
_SOURCES = ("ops/*.py", "ops/cuda/*.py", "csrc/*", "models/stwo/*.py")


def source_hash() -> str:
    """Short hash over this package's prover sources."""
    h = hashlib.sha256()
    for pattern in _SOURCES:
        for path in sorted(_PKG.glob(pattern)):
            h.update(path.relative_to(_PKG).as_posix().encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _cfg_hash(cfg) -> str:
    """Short hash over every config field."""
    return hashlib.sha256(
        repr(sorted(dataclasses.asdict(cfg).items())).encode()
    ).hexdigest()[:12]


def _prefix(cfg, seed, air: str) -> str:
    seed_part = "" if seed is None else f"_s{int(seed)}"
    return f"stwo_{air}_{_cfg_hash(cfg)}{seed_part}_"


def fixture_path(cfg, seed=None, air: str = "wide_fibonacci") -> pathlib.Path:
    """Path of the committed fixture for (cfg, seed); raises if none."""
    prefix = _prefix(cfg, seed, air)
    # an unseeded prefix also matches seeded names ('..._s3_<hash>'): the
    # rest after the prefix must be the source hash, which never starts
    # with 's'
    found = sorted(
        p for p in FIXTURES.glob(f"{prefix}*.npz")
        if seed is not None or not re.match(r"s\d+_", p.name[len(prefix):])
    )
    if not found:
        raise FileNotFoundError(f"no committed proof fixture {prefix}*.npz in {FIXTURES}")
    return found[-1]


def cached_stwo_proof(cfg, seed=None, air: str = "wide_fibonacci",
                      device: str = "cuda") -> P.StwoProof:
    """The own-prover proof for (cfg, seed, air), as numpy arrays: the
    committed fixture where there is one, else the cached proof of this
    package's prover, else a new proof made on `device` (the trace of
    ``prover.seeded_trace``) and written to the cache."""
    try:
        return P.load_npz(str(fixture_path(cfg, seed, air)))
    except FileNotFoundError:
        pass
    path = CACHE / f"{_prefix(cfg, seed, air)}{source_hash()}.npz"
    if path.exists():
        return P.load_npz(str(path))
    proof, _ = prover.prove(cfg, prover.seeded_trace(cfg, seed, air), air, device)
    path.parent.mkdir(parents=True, exist_ok=True)
    # a private temporary file, then an atomic rename: a concurrent reader
    # sees the whole proof or none (the .npz suffix keeps np.savez from
    # appending one)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp.npz")
    os.close(fd)
    try:
        P.save_npz(tmp, proof)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proof
