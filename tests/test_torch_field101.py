"""The port's stark101 field (``ops/field101.py``) and ``u32.mullo32``
against the JAX package, word for word.

The inputs are seeded numpy u32 words that hold the edge values 0, 1,
q - 1, q, q + 1, 2^31 and 2^32 - 1 and random words in [q, 2^32) beside
random ones: a proof's words are arbitrary, and non-canonical ones reach
the field ops, where the port must give the JAX package's word.  Integer
arithmetic: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_symphony_tpu.ops import field101 as JF
from stark_symphony_tpu.ops import u32 as JU
from stark_symphony_tpu_torch.ops import field101 as TF
from stark_symphony_tpu_torch.ops import u32 as TU
from stark_symphony_tpu_torch.ops.u32 import from_numpy, to_numpy

Q = TF.Q
EDGES = np.array([0, 1, Q - 1, Q, Q + 1, 1 << 31, (1 << 32) - 1], dtype=np.uint32)


def _words(seed: int, n: int = 64) -> np.ndarray:
    """The edge values, then random words in [q, 2^32) and in [0, 2^32)."""
    rng = np.random.default_rng(seed)
    high = rng.integers(Q, 1 << 32, n // 2, dtype=np.uint64).astype(np.uint32)
    anyw = rng.integers(0, 1 << 32, n - n // 2, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([EDGES, high, anyw])


def _pairs(seed: int):
    """Every pair of edge values, then random pairs of _words."""
    a = np.repeat(EDGES, len(EDGES))
    b = np.tile(EDGES, len(EDGES))
    return np.concatenate([a, _words(seed)]), np.concatenate([b, _words(seed + 1)])


def _port(fn, *arrays):
    return to_numpy(fn(*[from_numpy(x) for x in arrays]))


def _jax(fn, *arrays):
    return np.asarray(fn(*[jnp.asarray(x) for x in arrays]))


def test_constants_equal_jax():
    assert (TF.Q, TF.GEN, TF.R2_MOD_Q, TF.NEG_QINV) == (JF.Q, JF.GEN, JF.R2_MOD_Q, JF.NEG_QINV)
    assert (TF.Q * TF.NEG_QINV + 1) % (1 << 32) == 0


def test_mullo32_equals_jax():
    a, b = _pairs(1)
    got = _port(TU.mullo32, a, b)
    np.testing.assert_array_equal(got, _jax(JU.mullo32, a, b))
    np.testing.assert_array_equal(got, (a.astype(np.uint64) * b) & 0xFFFFFFFF)
    # a Python-int operand is the same word
    np.testing.assert_array_equal(to_numpy(TU.mullo32(from_numpy(a), int(TF.NEG_QINV))),
                                  (a.astype(np.uint64) * TF.NEG_QINV) & 0xFFFFFFFF)


@pytest.mark.parametrize("name", ["mont_mul", "f_mul", "f_add", "f_sub", "f_div"])
def test_binary_op_equals_jax(name):
    a, b = _pairs(2)
    got = _port(getattr(TF, name), a, b)
    np.testing.assert_array_equal(got, _jax(getattr(JF, name), a, b))
    if name in ("f_mul", "f_add", "f_sub"):  # canonical inputs: the field's value
        ca, cb = a.astype(object) % Q, b.astype(object) % Q
        op = {"f_mul": lambda x, y: x * y, "f_add": lambda x, y: x + y,
              "f_sub": lambda x, y: x - y}[name]
        want = np.array([op(int(x), int(y)) % Q for x, y in zip(ca, cb)], np.uint32)
        np.testing.assert_array_equal(
            _port(getattr(TF, name), ca.astype(np.uint32), cb.astype(np.uint32)), want)


def test_mont_redc_equals_jax():
    """The reduction alone, on (hi, lo) pairs of any words: its overflow
    branch included (t = hi + mq_hi + carry past 2^32)."""
    hi, lo = _pairs(3)
    got = _port(TF._mont_redc, hi, lo)
    np.testing.assert_array_equal(got, _jax(JF._mont_redc, hi, lo))


@pytest.mark.parametrize("name", ["f_neg", "f_inv"])
def test_unary_op_equals_jax(name):
    a = _words(4)
    np.testing.assert_array_equal(_port(getattr(TF, name), a), _jax(getattr(JF, name), a))


@pytest.mark.parametrize("exponent", [0, 1, 2, 1024, Q - 2])
def test_f_pow_equals_jax(exponent):
    a = _words(5, 65).reshape(2, -1)
    got = _port(lambda x: TF.f_pow(x, exponent), a)
    assert got.shape == a.shape
    np.testing.assert_array_equal(got, _jax(lambda x: JF.f_pow(x, exponent), a))
    canon = (a.astype(object) % Q).astype(np.uint32)
    want = np.vectorize(lambda x: pow(int(x), exponent, Q))(canon).astype(np.uint32)
    np.testing.assert_array_equal(_port(lambda x: TF.f_pow(x, exponent), canon), want)


def test_f_inv_many_equals_jax_with_a_zero_lane():
    """Three rows of values; lane 3 of the second is zero, which zeroes
    every inverse of lane 3, in both packages."""
    vals = [_words(s, 16) for s in (6, 7, 8)]
    vals[1][3] = 0
    got = [to_numpy(x) for x in TF.f_inv_many([from_numpy(v) for v in vals])]
    want = [np.asarray(x) for x in JF.f_inv_many([jnp.asarray(v) for v in vals])]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert all(g[3] == 0 for g in got) and all(g[8:].all() for g in got)


@pytest.mark.parametrize("m", [Q, 8192, 1_000_003])
def test_mod_u64_equals_jax(m):
    hi, lo = _pairs(9)
    got = _port(lambda h, l: TF.mod_u64(h, l, m), hi, lo)
    np.testing.assert_array_equal(got, _jax(lambda h, l: JF.mod_u64(h, l, m), hi, lo))
    want = [((int(h) << 32) | int(l)) % m for h, l in zip(hi, lo)]
    np.testing.assert_array_equal(got, np.array(want, np.uint32))


@pytest.mark.parametrize("m", [Q, 97])
def test_umod_small_equals_jax(m):
    x = _words(10)
    got = _port(lambda v: TF._umod_small(v, m), x)
    np.testing.assert_array_equal(got, _jax(lambda v: JF._umod_small(v, m), x))
    np.testing.assert_array_equal(got, x.astype(np.uint64) % m)


@pytest.mark.parametrize("m", [Q, 8192, 1_000_003])
def test_mod_words_be_equals_jax_and_python(m):
    """Random 256-bit states (a draw's input), the all-ones and all-zero
    states among them: JAX's word, and int.from_bytes(state, "big") % m."""
    rng = np.random.default_rng(11)
    states = rng.integers(0, 1 << 32, (40, 8), dtype=np.uint64).astype(np.uint32)
    states[0], states[1] = 0xFFFFFFFF, 0
    states[2] = Q
    got = _port(lambda w: TF.mod_words_be(w, m), states)
    np.testing.assert_array_equal(got, _jax(lambda w: JF.mod_words_be(w, m), states))
    want = [int.from_bytes(s.astype(">u4").tobytes(), "big") % m for s in states]
    np.testing.assert_array_equal(got, np.array(want, np.uint32))


def test_batched_broadcast_and_int_operands():
    """A word tensor against a 0-d tensor and against a Python int, as the
    verifier and prover pass a drawn beta and the protocol constants."""
    a = _words(12)
    beta = np.uint32(3_000_000_000)
    np.testing.assert_array_equal(
        to_numpy(TF.f_mul(from_numpy(a), from_numpy(beta).reshape(()))),
        np.asarray(JF.f_mul(jnp.asarray(a), jnp.uint32(beta))))
    np.testing.assert_array_equal(to_numpy(TF.f_mul(TF.GEN, from_numpy(a))),
                                  np.asarray(JF.f_mul(jnp.uint32(JF.GEN), jnp.asarray(a))))
    np.testing.assert_array_equal(to_numpy(TF.f_sub(from_numpy(a), 1)),
                                  np.asarray(JF.f_sub(jnp.asarray(a), jnp.uint32(1))))
    assert TF.f_mul(from_numpy(a), 7).dtype == torch.int64
