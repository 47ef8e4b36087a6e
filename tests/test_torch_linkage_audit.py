"""The port's linkage audit (``tools/linkage_audit.py``) on the CPU.

The external fixture ``proof.json`` gives the JAX package's numbers (16
queries, 20 columns, rank 11, augmented rank 12: inconsistent, exit code
1); the port's own PRODUCTION proof is consistent; the exact QM31
arithmetic and the rank equal JAX's on seeded values.  Slow: the system
(M, rhs) itself against JAX's ``build_system``, entry by entry (about 37
s of eager JAX).
"""

import json

import numpy as np
import pytest

from stark_symphony_tpu.tools import linkage_audit as JA
from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION
from stark_symphony_tpu_torch.tools import linkage_audit as TA
from stark_symphony_tpu_torch.utils.proofcache import cached_stwo_proof

P = 0x7FFFFFFF


def test_fixture_is_inconsistent(fixtures_dir, capsys):
    path = str(fixtures_dir / "stwo" / "proof.json")
    assert TA.main([path, "--device", "cpu"]) == 1
    out = capsys.readouterr()
    res = json.loads(out.out.splitlines()[0])
    assert res == {"n_queries": 16, "n_columns": 20, "rank": 11, "rank_augmented": 12,
                   "consistent": False, "proof": path}
    assert "INCONSISTENT" in out.err


def test_own_production_proof_is_consistent():
    res = TA.audit(cached_stwo_proof(PRODUCTION), PRODUCTION, "cpu")
    assert res["consistent"] and res["n_queries"] == 16 and res["n_columns"] == 20


def test_exact_arithmetic_equals_jax():
    rng = np.random.default_rng(9)

    def qm():
        return tuple(int(v) for v in rng.integers(0, P, 4))

    for _ in range(50):
        x, y = qm(), qm()
        assert TA.qm_mul(x, y) == JA.qm_mul(x, y)
        assert TA.qm_add(x, y) == JA.qm_add(x, y)
        assert TA.qm_sub(x, y) == JA.qm_sub(x, y)
        assert TA.qm_inv(x) == JA.qm_inv(x)
        assert TA.qm_mul(x, TA.qm_inv(x)) == (1, 0, 0, 0)
    rows = [[qm() for _ in range(5)] for _ in range(4)]
    rows.append([TA.qm_add(a, b) for a, b in zip(rows[0], rows[1])])  # dependent row
    rows.append([TA.QM_ZERO] * 5)
    assert TA._rank(rows, 5) == JA._rank(rows, 5) == 4


def test_needs_a_gpu_unless_asked_for_the_cpu(fixtures_dir):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TA.main([str(fixtures_dir / "stwo" / "proof.json")])


@pytest.mark.slow
def test_system_equals_jax(fixtures_dir):
    path = str(fixtures_dir / "stwo" / "proof.json")
    m_t, rhs_t = TA.build_system(TP.load_json(path)[0], PRODUCTION, "cpu")
    from stark_symphony_tpu.models.stwo import proof as JP

    m_j, rhs_j = JA.build_system(*JP.load_json(path))
    assert m_t == m_j and rhs_t == rhs_j
