"""The tamper classes the verify cells plant in their batches.

Copied from ``chip_smoke.py`` (``PROD_TAMPERS``, ``STARK101_TAMPERS`` and
``tamper_lanes``), where the port's CPU tests check the lists against the
JAX suite's.  A class is (field, mutation, index into a tuple field or
None); ``tamper_lane`` applies one class to one lane of a batch of field
arrays in place, where ``tamper_lanes`` there applied class k to lane k.
"""

from __future__ import annotations

# The 15 stwo classes of tests/test_pow_production.py, one per verifier stage
# that must reject them.
PROD_TAMPERS = [
    ("trace_evals", lambda a: a + 1, None),
    ("trace_sibs", lambda a: a ^ 1, None),
    ("cp_evals", lambda a: a ^ 1, None),
    ("cp_sibs", lambda a: a ^ 4, None),
    ("oods_trace", lambda a: a ^ 1, None),
    ("oods_cp", lambda a: a ^ 2, None),
    ("fri_first_commit", lambda a: a ^ 1, None),
    ("fri_inner_commits", lambda a: a ^ 1, None),
    ("fri_last", lambda a: a ^ 1, None),
    ("fri_witnesses", lambda a: a ^ 1, 0),
    ("fri_witnesses", lambda a: a + 1, 4),
    ("fri_sibs", lambda a: a ^ 1, 0),
    ("fri_sibs", lambda a: a ^ 2, 5),
    ("pow_nonce", lambda a: a + 1, None),
    ("commitments", lambda a: a ^ 1, None),
]

# The stark101 classes: test_stark101.py's five, then one for each other
# field, a tuple field at one layer.
STARK101_TAMPERS = [
    ("evals", lambda a: a + 1, None),
    ("fri_betas", lambda a: a ^ 1, None),
    ("cpa_evals", lambda a: a ^ 1, None),
    ("last", lambda a: a ^ 1, None),
    ("p_mt_root", lambda a: a ^ 1, None),
    ("eval_sibs", lambda a: a ^ 1, None),
    ("fri_roots", lambda a: a ^ 1, None),
    ("cpb_evals", lambda a: a ^ 1, None),
    ("cpa_sibs", lambda a: a ^ 1, 3),
    ("cpb_sibs", lambda a: a ^ 2, 7),
]

TAMPERS = {"stwo": PROD_TAMPERS, "stark101": STARK101_TAMPERS}


def tamper_lane(fields: dict, lane: int, tamper) -> None:
    """Apply one class to `lane` of a batch of field arrays (leading axis
    the lane), in place; a tuple field's index is taken mod its length."""
    field, mutate, idx = tamper
    arr = fields[field] if idx is None else fields[field][idx % len(fields[field])]
    arr[lane] = mutate(arr[lane])
