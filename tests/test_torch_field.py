"""The port's u32 and M31/CM31/QM31 arithmetic against the JAX package.

Same seeded numpy words into both packages, compared bit for bit.  The
words include values >= P and >= 2^31 (tampered proofs carry such words),
where a formula that only agrees modulo P would differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_symphony_tpu.ops import field as JF
from stark_symphony_tpu.ops import u32 as JU
from stark_symphony_tpu_torch.ops import field as TF
from stark_symphony_tpu_torch.ops import u32 as TU

P = JF.P
EDGES = np.array([0, 1, 2, P - 1, P, P + 1, 1 << 31, (1 << 31) + 1,
                  0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint32)


@pytest.fixture(scope="module")
def words():
    """Random words over all of [0, 2^32) with the edge cases up front."""
    rng = np.random.default_rng(20261016)
    rand = rng.integers(0, 1 << 32, 4096 - EDGES.size, dtype=np.uint32)
    a = np.concatenate([EDGES, rand])
    b = np.concatenate([np.roll(EDGES, 3), rng.permutation(rand)])
    return a, b


def _jax(fn, *arrays):
    out = fn(*[jnp.asarray(a) for a in arrays])
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _torch(fn, *arrays):
    out = fn(*[TU.from_numpy(a) for a in arrays])
    if isinstance(out, tuple):
        return tuple(TU.to_numpy(o) for o in out)
    return TU.to_numpy(out) if out.dtype == TU.WORD else out.numpy()


def _same(jfn, tfn, *arrays):
    want, got = _jax(jfn, *arrays), _torch(tfn, *arrays)
    if isinstance(want, tuple):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)


# -- word conversions --------------------------------------------------------

def test_word_conversions_roundtrip(words):
    a, _ = words
    t = TU.from_numpy(a)
    assert t.dtype == torch.int64 and int(t.min()) >= 0 and int(t.max()) < 1 << 32
    np.testing.assert_array_equal(TU.to_numpy(t), a)
    i32 = TU.to_i32(t)
    assert i32.dtype == torch.int32
    # int32 bit patterns: words >= 2^31 become negative, bit for bit
    np.testing.assert_array_equal(i32.numpy(), a.view(np.int32))
    np.testing.assert_array_equal(TU.to_numpy(TU.from_i32(i32)), a)
    assert (a >= 1 << 31).any()


# -- u32 helpers ---------------------------------------------------------------

def test_mul32_wide(words):
    _same(JU.mul32_wide, TU.mul32_wide, *words)


def test_add64_lt64(words):
    a, b = words
    c, d = np.roll(a, 1), np.roll(b, 7)
    _same(JU.add64, TU.add64, a, b, c, d)
    want = _jax(JU.lt64, a, b, c, d)
    got = TU.lt64(*[TU.from_numpy(x) for x in (a, b, c, d)]).numpy()
    np.testing.assert_array_equal(got, want)
    # equal high words fall through to the low-word comparison
    got_eq = TU.lt64(*[TU.from_numpy(x) for x in (a, b, a, d)]).numpy()
    np.testing.assert_array_equal(got_eq, _jax(JU.lt64, a, b, a, d))


@pytest.mark.parametrize("n", [1, 2, 7, 13, 17, 22, 25, 31])
def test_rotr(words, n):
    _same(lambda x: JU.rotr(x, n), lambda x: TU.rotr(x, n), words[0])


def test_byte_swap32(words):
    _same(JU.byte_swap32, TU.byte_swap32, words[0])


@pytest.mark.parametrize("log_size", [1, 4, 13, 20, 31, 32])
def test_bit_reverse(words, log_size):
    _same(lambda x: JU.bit_reverse(x, log_size),
          lambda x: TU.bit_reverse(x, log_size), words[0])


# -- M31 ----------------------------------------------------------------------

M31_BINARY = ["m31_add", "m31_sub", "m31_mul", "m31_div"]
M31_UNARY = ["m31_reduce", "m31_neg", "m31_sqr", "m31_inv"]


@pytest.mark.parametrize("name", M31_BINARY)
def test_m31_binary(words, name):
    _same(getattr(JF, name), getattr(TF, name), *words)


@pytest.mark.parametrize("name", M31_UNARY)
def test_m31_unary(words, name):
    _same(getattr(JF, name), getattr(TF, name), words[0])


@pytest.mark.parametrize("exponent", [0, 1, 2, 5, 1 << 7, P - 2])
def test_m31_pow(words, exponent):
    _same(lambda x: JF.m31_pow(x, exponent),
          lambda x: TF.m31_pow(x, exponent), words[0][:512])


def test_m31_edge_rules():
    z = torch.zeros(1, dtype=torch.int64)
    assert int(TF.m31_neg(z)) == 0
    assert int(TF.m31_inv(z)) == 0
    # the sum wraps at 2^32 before the reduction, as the uint32 sum does
    a = TU.from_numpy(np.array([0xFFFFFFFF], np.uint32))
    assert int(TF.m31_add(a, a)) == int(np.asarray(
        JF.m31_add(np.uint32(0xFFFFFFFF), np.uint32(0xFFFFFFFF))))


# -- CM31 / QM31 ----------------------------------------------------------------

def _pairs(words, k):
    a, b = words
    n = a.size // k * k
    return a[:n].reshape(-1, k), b[:n].reshape(-1, k)


@pytest.mark.parametrize("name", ["cm31_add", "cm31_sub", "cm31_mul"])
def test_cm31_binary(words, name):
    _same(getattr(JF, name), getattr(TF, name), *_pairs(words, 2))


@pytest.mark.parametrize("name", ["cm31_neg", "cm31_conj", "cm31_inv"])
def test_cm31_unary(words, name):
    _same(getattr(JF, name), getattr(TF, name), _pairs(words, 2)[0])


def test_cm31_mixed(words):
    a, b = _pairs(words, 2)
    s = b[:, 0]
    _same(JF.cm31_mul_m31, TF.cm31_mul_m31, a, s)
    _same(JF.cm31_sub_m31, TF.cm31_sub_m31, a, s)


@pytest.mark.parametrize("name", ["qm31_add", "qm31_sub", "qm31_mul", "qm31_div"])
def test_qm31_binary(words, name):
    _same(getattr(JF, name), getattr(TF, name), *_pairs(words, 4))


@pytest.mark.parametrize("name", ["qm31_neg", "qm31_conj", "qm31_sqr", "qm31_inv"])
def test_qm31_unary(words, name):
    _same(getattr(JF, name), getattr(TF, name), _pairs(words, 4)[0])


def test_qm31_mixed(words):
    a, b = _pairs(words, 4)
    _same(JF.qm31_mul_m31, TF.qm31_mul_m31, a, b[:, 0])
    _same(JF.qm31_mul_cm31, TF.qm31_mul_cm31, a, b[:, :2])
    _same(JF.qm31_from_m31, TF.qm31_from_m31, b[:, 0])
    _same(JF.cm31, TF.cm31, a[:, 0], b[:, 1])
    _same(JF.qm31, TF.qm31, a[:, 0], a[:, 1], b[:, 2], b[:, 3])
    # equality: half the rows equal, half differing in one coordinate
    c = a.copy()
    c[::2, 3] ^= 1
    want = _jax(JF.qm31_eq, a, c)
    got = TF.qm31_eq(TU.from_numpy(a), TU.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


# -- goldens of tests/test_field.py --------------------------------------------

def _t(*xs):
    return torch.tensor(xs, dtype=torch.int64)


def test_goldens():
    assert int(TF.m31_add(_t(2147483646), _t(1))) == 0
    assert int(TF.m31_sub(_t(0), _t(1))) == 2147483646
    assert TF.cm31_mul(_t(1, 2), _t(5, 6)).tolist() == [2147483640, 16]
    assert TF.cm31_mul(TF.cm31_mul(_t(3, 4), _t(7, 8)), _t(2, 1)).tolist() == [
        2147483573, 93]
    assert TF.cm31_mul(_t(1, 2), TF.cm31_inv(_t(1, 2))).tolist() == [1, 0]
    assert TF.cm31_mul(_t(2147483641, 13), TF.cm31_inv(_t(4, 5))).tolist() == [1, 2]
    a, b = TF.qm31_scalar(1, 2, 3, 4), TF.qm31_scalar(4, 5, 6, 7)
    assert TF.qm31_mul(a, b).tolist() == [2147483576, 93, 2147483631, 50]
    assert TF.qm31_mul(a, TF.qm31_inv(a)).tolist() == [1, 0, 0, 0]
