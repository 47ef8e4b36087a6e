"""Read-only lookup of the committed own-prover proof fixtures.

The fixtures in ``tests/fixtures/own_proofs/`` are named
``stwo_{air}_{cfg_hash}[_s{seed}]_{source_hash}.npz`` by the JAX package's
proof cache; ``cfg_hash`` is the same hash over every config field.  The
port has no prover yet, so a missing proof raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
import pathlib
import re

from ..models.stwo import proof as P

_ROOT = pathlib.Path(__file__).resolve().parents[2]
FIXTURES = _ROOT / "tests" / "fixtures" / "own_proofs"


def _cfg_hash(cfg) -> str:
    """Short hash over every config field."""
    return hashlib.sha256(
        repr(sorted(dataclasses.asdict(cfg).items())).encode()
    ).hexdigest()[:12]


def fixture_path(cfg, seed=None, air: str = "wide_fibonacci") -> pathlib.Path:
    """Path of the committed fixture for (cfg, seed); raises if none."""
    seed_part = "" if seed is None else f"_s{int(seed)}"
    prefix = f"stwo_{air}_{_cfg_hash(cfg)}{seed_part}_"
    # an unseeded prefix also matches seeded names ('..._s3_<hash>'): the
    # rest after the prefix must be the source hash, which never starts
    # with 's'
    found = sorted(
        p for p in FIXTURES.glob(f"{prefix}*.npz")
        if seed is not None or not re.match(r"s\d+_", p.name[len(prefix):])
    )
    if not found:
        raise FileNotFoundError(
            f"no committed proof fixture {prefix}*.npz in {FIXTURES} "
            "(this package has no prover)"
        )
    return found[-1]


def cached_stwo_proof(cfg, seed=None, air: str = "wide_fibonacci") -> P.StwoProof:
    """The committed own-prover proof for (cfg, seed), as numpy arrays."""
    return P.load_npz(str(fixture_path(cfg, seed, air)))
