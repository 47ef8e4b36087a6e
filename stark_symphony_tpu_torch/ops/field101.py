"""Batched arithmetic in F_q, q = 3 * 2^30 + 1 (the stark101 field).

Port of ``stark_symphony_tpu/ops/field101.py``, formula for formula, so
that every result is bit-equal to the JAX package on any word, not only on
canonical ones: a proof's evaluations, betas and digest words are arbitrary
u32 values, and words in [q, 2^32) reach ``f_mul``, ``f_add`` and
``mod_u64``.  ``(a * b) % Q`` would not do: the int64 product of two words
passes 2^63, and where it does not, it gives another word than the JAX
Montgomery reduction on a non-canonical input.

* Multiplication is Montgomery's with R = 2^32 (``_mont_redc``), and
  ``f_mul`` converts back with a second product by R^2 mod q.
* Inversion is Fermat's, a^(q-2) with a host-unrolled exponent; 0 -> 0.

Words follow ``ops/u32.py``: int64 tensors in [0, 2^32), masked after
every add and multiply.  Constants stay Python ints, so no tensor is made
for them.  All ops broadcast over batch dims.
"""

from __future__ import annotations

import torch

from . import checks as _checks
from .u32 import M32, WORD, mul32_wide, mullo32

Q = 3221225473  # 3 * 2^30 + 1
GEN = 5  # multiplicative generator
R2_MOD_Q = pow(1 << 32, 2, Q)  # R^2 mod q
NEG_QINV = (-pow(Q, -1, 1 << 32)) % (1 << 32)  # -q^{-1} mod 2^32
_2_32_MINUS_Q = (1 << 32) - Q


def _wide(a, b):
    """(hi, lo) of a * b, where either operand may be a Python int."""
    if isinstance(a, int):
        a, b = b, a
    return mul32_wide(a, b)


def _redc(hi, lo, m: int, neg_minv: int):
    """Montgomery reduction mod an odd m of t = hi * 2^32 + lo: t * 2^-32
    mod m, as the JAX package computes it.  Its two carries out of
    hi + mq_hi + (lo != 0) are one test here: whether that sum passes 2^32
    (exact in int64).  Canonical in [0, m) when t < m * 2^32."""
    mq_hi, _ = mul32_wide(mullo32(lo, neg_minv), m)
    full = hi + mq_hi + (lo != 0).to(WORD)
    t = full & M32
    res_overflow = (t + ((1 << 32) - m)) & M32  # t + 2^32 - m, as uint32
    res_plain = torch.where(t >= m, t - m, t)
    return torch.where(full > M32, res_overflow, res_plain)


def _mont_redc(hi, lo):
    """Montgomery reduction of t = hi * 2^32 + lo (t < q * 2^32):
    t * 2^-32 mod q, canonical in [0, q)."""
    return _redc(hi, lo, Q, NEG_QINV)


def mont_mul(a, b):
    """a * b * 2^-32 mod q."""
    hi, lo = _wide(a, b)
    return _mont_redc(hi, lo)


def f_mul(a, b):
    """a * b mod q (standard form in, standard form out)."""
    return mont_mul(mont_mul(a, b), R2_MOD_Q)


def f_add(a, b):
    """a + b mod q for a + b < 2q; on other words, the JAX package's word:
    a wrapped uint32 sum takes 2^32 - q, an unwrapped one at or above q
    loses q once."""
    if _checks.ON:  # STPU_CHECK=1: canonical inputs (ops/checks.py)
        _checks.check_lt(a, Q, "f_add lhs")
        _checks.check_lt(b, Q, "f_add rhs")
    s = a + b  # < 2^33, exact in int64
    s32 = s & M32
    s_w = (s32 + _2_32_MINUS_Q) & M32
    s_nw = torch.where(s32 >= Q, s32 - Q, s32)
    return torch.where(s > M32, s_w, s_nw)


def f_neg(a):
    """q - a, with neg(0) = 0 (wrapping as uint32 for words above q)."""
    if isinstance(a, int):
        return (Q - a) & M32 if a else 0
    return torch.where(a == 0, a, (Q - a) & M32)


def f_sub(a, b):
    return f_add(a, f_neg(b))


def f_pow(a, exponent: int):
    """a ** exponent for a static Python-int exponent (host-unrolled), in
    the Montgomery domain: one conversion in, one out.  f_pow(a, 0) is 1
    broadcast to a's shape."""
    e = int(exponent)
    if e == 0:
        return torch.ones_like(a)
    base = mont_mul(a, R2_MOD_Q)  # to Montgomery form
    result = None
    while e > 0:
        if e & 1:
            result = base if result is None else mont_mul(result, base)
        e >>= 1
        if e:
            base = mont_mul(base, base)
    return mont_mul(result, 1)  # back to standard form


def f_inv(a):
    """a^(q-2); maps 0 -> 0 (the callers' masks judge validity)."""
    return f_pow(a, Q - 2)


def f_div(a, b):
    return f_mul(a, f_inv(b))


def f_inv_many(values):
    """Batch inversion (Montgomery's trick): one f_inv for N values.

    `values` is a list of broadcast-compatible word tensors; returns their
    elementwise inverses.  A zero makes every inverse of its lane zero, as
    in the JAX package: the verifier's Merkle masks catch such a query."""
    prefix = [values[0]]
    for v in values[1:]:
        prefix.append(f_mul(prefix[-1], v))
    inv_all = f_inv(prefix[-1])
    out = [None] * len(values)
    for i in range(len(values) - 1, 0, -1):
        out[i] = f_mul(inv_all, prefix[i - 1])
        inv_all = f_mul(inv_all, values[i])
    out[0] = inv_all
    return out


def mod_u64(hi, lo, m: int):
    """(hi * 2^32 + lo) mod m for a static modulus m (word tensors in and
    out).  A power of two masks the low word; an odd m reduces hi first
    (``_umod_small``), then takes two Montgomery reductions by m's own
    constants.  An even m that is not a power of two is not supported, as
    in the JAX package."""
    m = int(m)
    if m & (m - 1) == 0:
        return lo & (m - 1)
    if m % 2 == 1:
        neg_minv = (-pow(m, -1, 1 << 32)) % (1 << 32)
        r2 = pow(1 << 32, 2, m)
        t = _redc(_umod_small(hi, m), lo, m, neg_minv)  # value * 2^-32 mod m
        th, tl = mul32_wide(t, r2)
        return _redc(th, tl, m, neg_minv)  # value mod m
    raise NotImplementedError("even non-power-of-two modulus")


def _umod_small(x, m: int):
    """x mod m for words x and a static word m: a Barrett quotient by the
    32-bit reciprocal floor(2^32 / m) (1 for q), then two corrective
    subtractions."""
    qh, _ = mul32_wide(x, (1 << 32) // m)
    r = (x - mullo32(qh, m)) & M32
    r = torch.where(r >= m, r - m, r)
    return torch.where(r >= m, r - m, r)


def mod_words_be(words, m: int):
    """A big-endian word array (..., n) read as one integer, mod m: Horner
    over the words, most significant first, r = (r * 2^32 + word) mod m."""
    r = torch.zeros(words.shape[:-1], dtype=WORD, device=words.device)
    for i in range(words.shape[-1]):
        r = mod_u64(r, words[..., i], m)
    return r
