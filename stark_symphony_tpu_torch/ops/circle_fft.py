"""Circle FFT over M31: evaluation and interpolation on canonic circle
domains.

Port of ``stark_symphony_tpu/ops/circle_fft.py``, step for step, on int64
word tensors (``ops/field.py``).  For a canonic domain of size N in the
natural position order, positions i and i + N/2 are the point pair
(p, -p), and the squaring and projection maps send position i of a domain
to position i of the half-size domain: every butterfly is a contiguous
(first half, second half) split, with no gather and no bit reversal.

Coefficient layout (index bits, most significant first):
[y_bit | x_bit | pi bits ...], so b_index(x, y) = y^{y_bit} x^{x_bit}
pi(x)^{b2} pi^2(x)^{b3} ..., pi(x) = 2x^2 - 1.  The composition
decomposition F = F_a + y F_b + x F_c + x y F_d is then a contiguous
quarter split of the coefficients: quarter 0 -> F_a, 1 -> F_c, 2 -> F_b,
3 -> F_d.

The twiddles are host tables per log size (``twiddles``), sent to a
device once per (log size, device) through ``ops/u32.const``.  Values are
(..., N) M31 or, with ``qm31=True``, (..., N, 4) QM31; every transform
acts on the last (value) axis, so a leading batch axis gives each row the
result of its own transform.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import field as F
from .circle import GEN_POW2, CircleDomain, LineDomain
from .u32 import WORD, const

P = F.P
INV2 = (P + 1) // 2  # 1/2 mod P


def _host_point_at(index: int):
    """G * index on the host, with Python ints."""
    res = (1, 0)
    for k in range(31):
        if (index >> k) & 1:
            g = (int(GEN_POW2[k][0]), int(GEN_POW2[k][1]))
            res = (
                (res[0] * g[0] - res[1] * g[1]) % P,
                (res[0] * g[1] + res[1] * g[0]) % P,
            )
    return res


@functools.lru_cache(maxsize=None)
def twiddles(log_size: int):
    """Twiddle tables per butterfly level, outermost first.

    levels[0]: y(position i) of the size-2^log circle domain, i < N/2.
    levels[k>=1]: x(position i) of the size-2^(log-k) line domain,
                  i < 2^(log-k-1).
    Returns (levels, levels_inv) as numpy uint32 arrays."""
    n = 1 << log_size
    levels = []
    d = CircleDomain(log_size)
    ys = [
        _host_point_at((d.offset + d.step * i) & ((1 << 31) - 1))[1]
        for i in range(n // 2)
    ]
    levels.append(np.array(ys, dtype=np.uint32))
    log = log_size - 1
    while log >= 1:
        ld = LineDomain(log)
        xs = [
            _host_point_at((ld.offset + ld.step * i) & ((1 << 31) - 1))[0]
            for i in range(1 << (log - 1))
        ]
        levels.append(np.array(xs, dtype=np.uint32))
        log -= 1
    levels_inv = tuple(
        np.array([pow(int(t), P - 2, P) for t in lvl], dtype=np.uint32)
        for lvl in levels
    )
    return tuple(levels), levels_inv


@functools.lru_cache(maxsize=None)
def device_twiddles(log_size: int, device):
    """twiddles(log_size) as int64 tensors on `device`, sent there once."""
    return tuple(tuple(const(tuple(t.tolist()), device) for t in tables)
                 for tables in twiddles(log_size))


def _mul_tw(v, tw, qm31: bool):
    return F.m31_mul(v, tw[..., None] if qm31 else tw)


def _halves(vb, half: int, qm31: bool):
    if qm31:
        return vb[..., :half, :], vb[..., half:, :]
    return vb[..., :half], vb[..., half:]


def cfft_eval(coeffs, log_size: int, qm31: bool = False):
    """Coefficients -> evaluations at natural circle-domain positions.

    coeffs: (..., N) M31, or (..., N, 4) QM31 with qm31=True."""
    lvls, _ = device_twiddles(log_size, coeffs.device)
    n = 1 << log_size
    v = coeffs
    tail = (4,) if qm31 else ()
    lead = tuple(v.shape[: v.dim() - 1 - len(tail)])
    axis = -2 if qm31 else -1
    for k in reversed(range(log_size)):
        block = n >> k
        half = block >> 1
        e, o = _halves(v.reshape(lead + (n // block, block) + tail), half, qm31)
        to = _mul_tw(o, lvls[k], qm31)
        v = torch.cat([F.m31_add(e, to), F.m31_sub(e, to)], dim=axis).reshape(
            lead + (n,) + tail)
    return v


def cfft_interpolate(values, log_size: int, qm31: bool = False):
    """Evaluations at natural positions -> coefficients (inverse of
    cfft_eval)."""
    _, lvls_inv = device_twiddles(log_size, values.device)
    n = 1 << log_size
    v = values
    tail = (4,) if qm31 else ()
    lead = tuple(v.shape[: v.dim() - 1 - len(tail)])
    axis = -2 if qm31 else -1
    for k in range(log_size):
        block = n >> k
        half = block >> 1
        a, b = _halves(v.reshape(lead + (n // block, block) + tail), half, qm31)
        g = F.m31_mul(F.m31_add(a, b), INV2)
        h = _mul_tw(F.m31_mul(F.m31_sub(a, b), INV2), lvls_inv[k], qm31)
        v = torch.cat([g, h], dim=axis).reshape(lead + (n,) + tail)
    return v


def extend(values, log_size: int, log_size_out: int, qm31: bool = False):
    """Low-degree extension: evaluations on the size-2^log domain ->
    evaluations on the size-2^log_out domain (zero-padded coefficients,
    embedded as embed_coeffs says)."""
    coeffs = cfft_interpolate(values, log_size, qm31)
    return cfft_eval(
        embed_coeffs(coeffs, log_size, log_size_out, qm31), log_size_out, qm31
    )


def embed_coeffs(coeffs, log_size: int, log_size_out: int, qm31: bool = False):
    """Embed a size-2^log coefficient vector into the size-2^log_out basis.

    The bit layout is [y | x | pi^1 .. pi^(log-2)]; in the big basis each
    index R maps to R << (log_out - log): a strided embedding with zeros in
    the new low bits."""
    n = 1 << log_size
    m = 1 << log_size_out
    stride = m // n
    tail = (4,) if qm31 else ()
    lead = tuple(coeffs.shape[: coeffs.dim() - 1 - len(tail)])
    cb = coeffs.reshape(lead + (n, 1) + tail)
    pad = torch.zeros(lead + (n, stride - 1) + tail, dtype=WORD, device=coeffs.device)
    out = torch.cat([cb, pad], dim=-1 - len(tail))
    return out.reshape(lead + (m,) + tail)


def eval_at_point(coeffs, log_size: int, point, qm31_coeffs: bool = False):
    """Evaluate at one QM31 circle point: log N folds with scalar twiddles.

    coeffs: (..., N) M31 (or (..., N, 4) QM31); point: (..., 2, 4) QM31
    circle point.  Returns (..., 4) QM31."""
    x = point[..., 0, :]
    y = point[..., 1, :]
    # twiddle chain: y, x, pi(x), pi^2(x), ...
    tws = [y, x]
    cur = x
    for _ in range(log_size - 2):
        sq = F.qm31_sqr(cur)
        cur = F.qm31_sub(F.qm31_add(sq, sq), F.qm31_one(sq.shape[:-1], sq.device))
        tws.append(cur)
    v = coeffs if qm31_coeffs else F.qm31_from_m31(coeffs)
    for k in range(log_size):
        half = v.shape[-2] // 2
        lo = v[..., :half, :]
        hi = v[..., half:, :]
        tw = tws[k][..., None, :]
        v = F.qm31_add(lo, F.qm31_mul(tw.expand(hi.shape), hi))
    return v[..., 0, :]
