"""``STPU_CHECK`` in the port (``ops/checks.py`` and the hooks of
``m31_add``, ``m31_mul`` and ``f_add``) against the JAX package's.

Each hooked primitive, on each operand, raises ``FloatingPointError`` with
JAX's message exactly where JAX's raises, and passes where JAX's passes; a
bound the words cannot reach passes untested in both; with the checks off
nothing is tested; the flag is read once, at import; a check met during a
CUDA graph capture raises ``EagerOnlyError``; and an honest TESTING
verify accepts with the checks on.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stark_symphony_tpu.ops import checks as JK
from stark_symphony_tpu.ops import field as JF
from stark_symphony_tpu.ops import field101 as J101
from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.models.stwo import verifier as TV
from stark_symphony_tpu_torch.models.stwo.config import TESTING
from stark_symphony_tpu_torch.ops import checks as TK
from stark_symphony_tpu_torch.ops import field as TF
from stark_symphony_tpu_torch.ops import field101 as T101
from stark_symphony_tpu_torch.utils.proofcache import cached_stwo_proof

P, Q = 0x7FFFFFFF, 3221225473


def _words(values):
    return torch.tensor(values, dtype=torch.int64)


def _outcome(fn, *args):
    try:
        fn(*args)
    except FloatingPointError as e:
        return str(e)
    return None


@pytest.mark.parametrize("op,bound", [("m31_add", P), ("m31_mul", P), ("f_add", Q)])
def test_raises_where_jax_raises(monkeypatch, op, bound):
    """Clean lanes, then a lane at the bound and a lane at 2^32 - 1 on each
    operand in turn."""
    jfn, tfn = (getattr(J101, op), getattr(T101, op)) if op == "f_add" else \
        (getattr(JF, op), getattr(TF, op))
    monkeypatch.setenv("STPU_CHECK", "1")
    for side, bad in [(0, None), (0, bound), (0, 0xFFFFFFFF), (1, bound), (1, 0xFFFFFFFF)]:
        lanes = [[0, 1, bound - 1, 5], [bound - 1, 2, 3, 0]]
        if bad is not None:
            lanes[side][2] = bad
        want = _outcome(jfn, *(np.array(x, np.uint32) for x in lanes))
        with TK.checking():
            got = _outcome(tfn, *(_words(x) for x in lanes))
        assert got == want, (side, bad)
        assert (got is None) == (bad is None), (side, bad)


def test_unreachable_bound_passes_untested(monkeypatch):
    monkeypatch.setenv("STPU_CHECK", "1")
    JK.check_lt(np.array([0xFFFFFFFF], np.uint32), 1 << 32, "x")
    with TK.checking():
        TK.check_lt(_words([0xFFFFFFFF]), 1 << 32, "x")
        with pytest.raises(FloatingPointError, match=r"overflow check failed: x \(bound 0x5\)"):
            TK.check_lt(_words([5]), 5, "x")


def test_off_tests_nothing(monkeypatch):
    monkeypatch.delenv("STPU_CHECK", raising=False)
    with TK.checking(False):
        assert not TK.ON
        TF.m31_add(_words([P]), _words([0xFFFFFFFF]))
        T101.f_add(_words([Q]), _words([Q]))
    JF.m31_add(np.array([P], np.uint32), np.array([1], np.uint32))


def test_flag_read_once_at_import():
    code = ("import os; from stark_symphony_tpu_torch.ops import checks as c\n"
            "a = c.ON; os.environ['STPU_CHECK'] = '0'; print(a, c.ON)")
    env = dict(os.environ, STPU_CHECK="1", CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["True", "True"]


def test_check_under_capture_raises(monkeypatch):
    monkeypatch.setattr(TK, "capturing", lambda: True)
    with TK.checking():
        with pytest.raises(TK.EagerOnlyError, match="STPU_CHECK=1 needs eager mode"):
            TF.m31_mul(_words([1]), _words([2]))
    TF.m31_mul(_words([1]), _words([2]))  # off: no capture test either


def test_verify_accepts_with_checks_on():
    batch = TP.to_torch(TP.replicate(cached_stwo_proof(TESTING), 2))
    with TK.checking():
        ok, _ = TV.verify(batch, TESTING)
        assert ok.tolist() == [True, True]
        bad = TP.replicate(cached_stwo_proof(TESTING), 2)
        bad.trace_evals[1, 0, 0] = P
        with pytest.raises(FloatingPointError, match="m31_mul rhs"):
            TV.verify(TP.to_torch(bad), TESTING)
