"""The verify cells' inputs: the committed proofs, host batches drawn from
them by the seed with tampered lanes planted, and each lane's verdict as
the plain reference works it out.

The proofs are data: ``tests/fixtures/own_proofs/`` (stwo, 256 seeds of
one configuration) and ``tests/fixtures/stark101/golden_proof.json`` (the
one honest stark101 proof of its reference configuration).  They are read
here with numpy and json alone, the same arrays handed to the program and
to the reference.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import re
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .reference import stark101 as ref101
from .reference import stwo as ref_stwo
from .tampers import TAMPERS, tamper_lane

STWO_FIELDS = ("commitments", "trace_evals", "trace_sibs", "cp_evals", "cp_sibs", "oods_trace",
               "oods_cp", "fri_first_commit", "fri_inner_commits", "fri_last", "fri_witnesses",
               "fri_sibs", "pow_nonce")


def seed_of(path) -> int:
    """The seed in a committed stwo proof's file name."""
    return int(re.search(r"_s(\d+)_", path.name).group(1))


def stwo_fixture(path) -> dict:
    """One committed stwo proof (``.npz``: a tuple field as ``{name}__n``
    and ``{name}__{i}``) as field arrays."""
    out = {}
    with np.load(str(path)) as data:
        for name in STWO_FIELDS:
            if f"{name}__n" in data:
                out[name] = tuple(data[f"{name}__{i}"] for i in range(int(data[f"{name}__n"])))
            else:
                out[name] = data[name]
    return out


def fixture_paths(root, config: dict) -> list:
    """The configuration's committed stwo proofs, by seed."""
    return sorted(root.glob(config["fixtures"]), key=seed_of)


def distinct_proofs(root, config: dict) -> list:
    """The distinct proofs a batch draws its lanes from, as field arrays."""
    if config["system"] == "stwo":
        return [stwo_fixture(p) for p in fixture_paths(root, config)]
    return [ref101.parse_json(json.loads((root / config["proof"]).read_text()))]


def stack(proofs) -> dict:
    """Distinct proofs stacked field by field (leading axis the proof)."""
    return {k: tuple(np.stack([p[k][i] for p in proofs]) for i in range(len(proofs[0][k])))
            if isinstance(proofs[0][k], tuple) else np.stack([p[k] for p in proofs])
            for k in proofs[0]}


class Batch:
    """One host batch: lane b holds distinct proof `source[b]`, and the
    lanes of `tampered` (lane -> class index) carry that tamper class.
    `fields`: the field arrays, leading axis the lane."""

    def __init__(self, stacked, source, tampered, system):
        self.source = source
        self.tampered = tampered
        self.system = system
        self.fields = {k: tuple(a[source] for a in v) if isinstance(v, tuple) else v[source]
                       for k, v in stacked.items()}
        for lane, cls in tampered.items():
            tamper_lane(self.fields, lane, TAMPERS[system][cls])

    @property
    def lanes(self) -> int:
        return len(self.source)

    def lane(self, b: int) -> dict:
        return {k: tuple(a[b] for a in v) if isinstance(v, tuple) else v[b]
                for k, v in self.fields.items()}


def draw_batch(rng, stacked, lanes: int, tampered_lanes: int, system: str) -> Batch:
    """A batch of `lanes` lanes: a seeded permutation of the distinct
    proofs repeated over the lanes, with `tampered_lanes` tampered lanes at
    seeded places, half in each half of the batch, the classes dealt so
    that every class appears before any repeats."""
    n = len(stacked["pow_nonce" if system == "stwo" else "p_mt_root"])
    source = rng.permutation(np.resize(np.arange(n), lanes))
    n_cls = len(TAMPERS[system])
    classes = list(rng.permutation(n_cls)) + list(rng.integers(0, n_cls, tampered_lanes))
    tampered = {}
    for h in range(2):
        k = tampered_lanes // 2 + (tampered_lanes % 2) * h
        for lane in rng.choice(lanes // 2, k, replace=False):
            tampered[int(h * (lanes // 2) + lane)] = int(classes.pop(0))
    return Batch(stacked, source, tampered, system)


def _verify(job) -> bool:
    system, proof, cfg = job
    return (ref_stwo.verify if system == "stwo" else ref101.verify)(proof, cfg)[0]


def verdicts(system: str, proofs: list, cfg: dict) -> list:
    """The reference's verdict on each proof, over a few worker processes
    (the reference is plain Python, a proof at a time)."""
    jobs = [(system, p, cfg) for p in proofs]
    workers = min(8, os.cpu_count() or 1, max(1, len(jobs) // 16))
    if workers == 1:
        return [_verify(j) for j in jobs]
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(_verify, jobs, chunksize=8))


def expected(batches, proofs, config: dict) -> list:
    """Each batch's verdicts (bool per lane) by the plain reference: every
    distinct proof the batches draw on once, every tampered lane alone."""
    used = sorted({int(s) for b in batches for s in np.unique(b.source)})
    tampered = [(i, lane) for i, b in enumerate(batches) for lane in sorted(b.tampered)]
    found = verdicts(config["system"], [proofs[s] for s in used]
                     + [batches[i].lane(lane) for i, lane in tampered], config["params"])
    clean = dict(zip(used, found))
    out = [np.array([clean[int(s)] for s in b.source]) for b in batches]
    for (i, lane), ok in zip(tampered, found[len(used):]):
        out[i][lane] = ok
    return out
