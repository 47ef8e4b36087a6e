"""Batched M31 / CM31 / QM31 field arithmetic over int64 word tensors.

Port of ``stark_symphony_tpu/ops/field.py``, formula for formula, so that
every result is bit-equal to the JAX package even on non-canonical words
(values >= P, which tampered proofs carry):

* M31  = GF(p), p = 2^31 - 1.
* CM31 = M31[i] / (i^2 + 1), trailing axis of size 2: [re, im].
* QM31 = CM31[j] / (j^2 - (2 + i)), trailing axis of size 4: [a, b, c, d].

Words follow the convention of ``ops/u32.py``: int64 tensors in
[0, 2^32), masked after every add, multiply and left shift, so the sum in
``m31_add`` wraps at 2^32 exactly as the uint32 sum does in JAX.
"""

from __future__ import annotations

import torch

from . import checks as _checks
from .u32 import M32, WORD, const, mul32_wide

P = 0x7FFFFFFF  # 2^31 - 1


# ---------------------------------------------------------------------------
# M31
# ---------------------------------------------------------------------------

def m31_reduce(x):
    """Reduce a word in [0, 2^32) to [0, p)."""
    x = (x & P) + (x >> 31)  # <= p + 1
    return torch.where(x >= P, x - P, x)


def m31_add(a, b):
    if _checks.ON:  # STPU_CHECK=1: canonical inputs (ops/checks.py)
        _checks.check_lt(a, P, "m31_add lhs")
        _checks.check_lt(b, P, "m31_add rhs")
    return m31_reduce((a + b) & M32)


def m31_neg(a):
    """p - a, with neg(0) = 0 (the JAX package keeps canonical zero)."""
    return torch.where(a == 0, a, (P - a) & M32)


def m31_sub(a, b):
    return m31_add(a, m31_neg(b))


def m31_mul(a, b):
    """a * b mod p: the 64-bit product folded twice (2^31 = 1 mod p)."""
    if _checks.ON:
        _checks.check_lt(a, P, "m31_mul lhs")
        _checks.check_lt(b, P, "m31_mul rhs")
    hi, lo = mul32_wide(a, b)
    low31 = lo & P
    high = ((hi << 1) & M32) | (lo >> 31)
    return m31_reduce((low31 + high) & M32)


def m31_sqr(a):
    return m31_mul(a, a)


def m31_pow(a, exponent: int):
    """a ** exponent for a static Python-int exponent."""
    result = None
    base = a
    e = int(exponent)
    while e > 0:
        if e & 1:
            result = base if result is None else m31_mul(result, base)
        e >>= 1
        if e:
            base = m31_sqr(base)
    if result is None:
        return torch.ones_like(a)
    return result


def m31_inv(a):
    """a^(p-2) via the 37-multiplication addition chain; inv(0) = 0."""
    t0 = m31_mul(m31_pow(a, 4), a)          # a^5
    t1 = m31_mul(m31_sqr(t0), t0)           # a^15
    t2 = m31_mul(m31_pow(t1, 8), t0)        # a^125
    t3 = m31_mul(m31_sqr(t2), t0)           # a^255
    t4 = m31_mul(m31_pow(t3, 1 << 8), t3)   # a^65535
    t5 = m31_mul(m31_pow(t4, 1 << 8), t3)   # a^16777215
    return m31_mul(m31_pow(t5, 1 << 7), t2)  # a^2147483645


def m31_div(a, b):
    return m31_mul(a, m31_inv(b))


# ---------------------------------------------------------------------------
# CM31: trailing axis [re, im]
# ---------------------------------------------------------------------------

def cm31(re, im):
    return torch.stack([re, im], dim=-1)


def cm31_add(a, b):
    return m31_add(a, b)


def cm31_neg(a):
    return m31_neg(a)


def cm31_sub(a, b):
    return m31_sub(a, b)


def cm31_conj(a):
    return torch.stack([a[..., 0], m31_neg(a[..., 1])], dim=-1)


def cm31_mul(a, b):
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    re = m31_sub(m31_mul(ar, br), m31_mul(ai, bi))
    im = m31_add(m31_mul(ar, bi), m31_mul(ai, br))
    return torch.stack([re, im], dim=-1)


def cm31_mul_m31(a, s):
    return m31_mul(a, s[..., None])


def cm31_inv(a):
    ar, ai = a[..., 0], a[..., 1]
    norm = m31_add(m31_sqr(ar), m31_sqr(ai))
    ninv = m31_inv(norm)
    return cm31_mul_m31(cm31_conj(a), ninv)


def cm31_sub_m31(a, s):
    return torch.stack([m31_sub(a[..., 0], s), a[..., 1]], dim=-1)


# ---------------------------------------------------------------------------
# QM31: trailing axis [a, b, c, d]
# ---------------------------------------------------------------------------

def qm31(a, b, c, d):
    return torch.stack([a, b, c, d], dim=-1)


def qm31_scalar(a, b, c, d, device="cpu"):
    """A constant QM31 element on `device` (shared: never write to it)."""
    return const((a, b, c, d), device)


def qm31_zero(shape=(), device="cpu"):
    return torch.zeros(tuple(shape) + (4,), dtype=WORD, device=device)


def qm31_one(shape=(), device="cpu"):
    return qm31_scalar(1, 0, 0, 0, device).expand(tuple(shape) + (4,))


def qm31_re(x):
    """First CM31 coordinate (trailing axis 2)."""
    return x[..., 0:2]


def qm31_im(x):
    """Second CM31 coordinate (trailing axis 2)."""
    return x[..., 2:4]


def qm31_from_cm31(re, im=None):
    if im is None:
        im = torch.zeros_like(re)
    return torch.cat([re, im], dim=-1)


def qm31_from_m31(x):
    z = torch.zeros_like(x)
    return torch.stack([x, z, z, z], dim=-1)


def qm31_add(a, b):
    return m31_add(a, b)


def qm31_neg(a):
    return m31_neg(a)


def qm31_sub(a, b):
    return m31_sub(a, b)


def qm31_conj(a):
    return qm31_from_cm31(qm31_re(a), cm31_neg(qm31_im(a)))


def _two_plus_i(like):
    return const((2, 1), like.device)


def qm31_mul(x, y):
    """(ar + ai*j)(br + bi*j) = (ar*br + (2+i)*ai*bi) + (ar*bi + ai*br) j."""
    ar, ai = qm31_re(x), qm31_im(x)
    br, bi = qm31_re(y), qm31_im(y)
    aibi = cm31_mul(ai, bi)
    re = cm31_add(cm31_mul(ar, br), cm31_mul(aibi, _two_plus_i(aibi)))
    im = cm31_add(cm31_mul(ar, bi), cm31_mul(ai, br))
    return qm31_from_cm31(re, im)


def qm31_sqr(a):
    return qm31_mul(a, a)


def qm31_mul_m31(a, s):
    return m31_mul(a, s[..., None])


def qm31_mul_cm31(a, c):
    return qm31_from_cm31(cm31_mul(qm31_re(a), c), cm31_mul(qm31_im(a), c))


def qm31_inv(a):
    """Inverse via the CM31 norm: denom = ar^2 - (2+i) * ai^2, with
    (2+i)*ai_sq computed as ai_sq_dbl + i*ai_sq, i*(r, s) = (-s, r)."""
    ar, ai = qm31_re(a), qm31_im(a)
    ar_sq = cm31_mul(ar, ar)
    ai_sq = cm31_mul(ai, ai)
    ai_sq_dbl = cm31_add(ai_sq, ai_sq)
    ai_sq_rev = torch.stack([m31_neg(ai_sq[..., 1]), ai_sq[..., 0]], dim=-1)
    den = cm31_sub(ar_sq, cm31_add(ai_sq_dbl, ai_sq_rev))
    den_inv = cm31_inv(den)
    return qm31_from_cm31(cm31_mul(ar, den_inv), cm31_mul(cm31_neg(ai), den_inv))


def qm31_div(a, b):
    return qm31_mul(a, qm31_inv(b))


def qm31_eq(a, b):
    """Elementwise QM31 equality -> bool with the trailing axis reduced."""
    return (a == b).all(dim=-1)
