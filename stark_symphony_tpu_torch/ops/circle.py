"""Circle group over M31 and circle/line domains.

Port of ``stark_symphony_tpu/ops/circle.py``.  Points are a trailing axis
of size 2, [x, y]; QM31 circle points (OODS points) a trailing (2, 4) =
(x|y, qm31 coordinates).  Query points come from a host table
(``query_point_table``) up to 2^20 and from the 31-step scalar
multiplication (``circle_position_to_point``) above it.  Domains are
small named tuples of Python ints: they parameterize the code and never
live on a device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import field as F
from .u32 import M32, bit_reverse, const

M31_CIRCLE_GEN = (2, 1268011823)
M31_CIRCLE_LOG_ORDER = 31
ORDER_MASK = (1 << 31) - 1

P = F.P


def _host_point_add(p, q):
    x0, y0 = p
    x1, y1 = q
    return ((x0 * x1 - y0 * y1) % P, (x0 * y1 + y0 * x1) % P)


def _gen_pow2_table() -> np.ndarray:
    """G * 2^k for k in [0, 31), shape (31, 2)."""
    pts = []
    cur = M31_CIRCLE_GEN
    for _ in range(31):
        pts.append(cur)
        cur = _host_point_add(cur, cur)
    return np.array(pts, dtype=np.uint32)


GEN_POW2 = _gen_pow2_table()


def point_add(p, q):
    """Circle group law (x0x1 - y0y1, x0y1 + y0x1); p, q: (..., 2)."""
    x0, y0 = p[..., 0], p[..., 1]
    x1, y1 = q[..., 0], q[..., 1]
    x = F.m31_sub(F.m31_mul(x0, x1), F.m31_mul(y0, y1))
    y = F.m31_add(F.m31_mul(x0, y1), F.m31_mul(y0, x1))
    return torch.stack([x, y], dim=-1)


def point_neg(p):
    return torch.stack([p[..., 0], F.m31_neg(p[..., 1])], dim=-1)


def point_dbl(p):
    x, y = p[..., 0], p[..., 1]
    x2 = F.m31_sqr(x)
    xd = F.m31_sub(F.m31_add(x2, x2), torch.ones_like(x))
    xy = F.m31_mul(x, y)
    return torch.stack([xd, F.m31_add(xy, xy)], dim=-1)


def point_from_index(index):
    """index (word tensor) -> G * index: 31 conditional adds against the
    constant doubling table."""
    table = const(tuple(map(tuple, GEN_POW2.tolist())), index.device)
    identity = const((1, 0), index.device)
    res = torch.where(((index & 1) == 1)[..., None], table[0], identity)
    for k in range(1, 31):
        added = point_add(res, table[k].expand(res.shape))
        res = torch.where((((index >> k) & 1) == 1)[..., None], added, res)
    return res


def index_add(a, b):
    return (a + b) & ORDER_MASK


def index_mul(a, b):
    # the uint32 product wraps at 2^32 before the mask; only its low 31
    # bits survive, which the int64 product has as well (the callers' step
    # times position stays below 2^31 anyway)
    return (a * b) & ORDER_MASK


def index_neg(a):
    return ((1 << 31) - a) & ORDER_MASK


def subgroup_gen_index(log_size: int) -> int:
    """Generator index of the subgroup of size 2^log_size."""
    return 1 << (M31_CIRCLE_LOG_ORDER - log_size)


class CircleDomain(NamedTuple):
    """Canonic coset of size 2^log_size."""

    log_size: int

    @property
    def half_size(self) -> int:
        return 1 << (self.log_size - 1)

    @property
    def offset(self) -> int:
        return subgroup_gen_index(self.log_size + 1)

    @property
    def step(self) -> int:
        return subgroup_gen_index(self.log_size - 1)


class LineDomain(NamedTuple):
    """x-coordinates of a half-coset of size 2^log_size."""

    log_size: int

    @property
    def offset(self) -> int:
        return subgroup_gen_index(self.log_size + 2)

    @property
    def step(self) -> int:
        return subgroup_gen_index(self.log_size)


def circle_position_to_index(domain: CircleDomain, position):
    """Position in the canonic coset -> point index, negated for the second
    half."""
    in_first = position < domain.half_size
    pos2 = torch.where(in_first, position, (position - domain.half_size) & M32)
    idx = index_add(domain.offset, index_mul(domain.step, pos2))
    return torch.where(in_first, idx, index_neg(idx))


def circle_position_to_point(domain: CircleDomain, position):
    return point_from_index(circle_position_to_index(domain, position))


@functools.lru_cache(maxsize=None)
def query_point_table(log_size: int) -> np.ndarray:
    """LDE-domain points in query-index order, (2^log_size, 2) uint32.

    table[q] = the point at position bit_reverse(q, log_size) of the
    canonic coset of size 2^log_size: bit reversal, position map and
    31-step scalar multiplication folded into one host table.  The same
    computation as the JAX package's, copied as it is."""
    n = 1 << log_size
    d = CircleDomain(log_size)
    q = np.arange(n, dtype=np.uint64)
    pos = np.zeros(n, np.uint64)
    for b in range(log_size):
        pos |= ((q >> np.uint64(b)) & np.uint64(1)) << np.uint64(log_size - 1 - b)
    half = np.uint64(d.half_size)
    in_first = pos < half
    pos2 = np.where(in_first, pos, pos - half)
    mask31 = np.uint64((1 << 31) - 1)
    idx = (np.uint64(d.offset) + np.uint64(d.step) * pos2) & mask31
    x = np.ones(n, np.uint64)
    y = np.zeros(n, np.uint64)
    p64 = np.uint64(P)
    for k in range(31):
        gx, gy = np.uint64(GEN_POW2[k][0]), np.uint64(GEN_POW2[k][1])
        nx = ((x * gx) % p64 + p64 - (y * gy) % p64) % p64
        ny = ((x * gy) % p64 + (y * gx) % p64) % p64
        bit = ((idx >> np.uint64(k)) & np.uint64(1)).astype(bool)
        x = np.where(bit, nx, x)
        y = np.where(bit, ny, y)
    y = np.where(in_first, y, np.where(y == 0, y, p64 - y))
    return np.stack([x, y], axis=-1).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def query_point_table_on(log_size: int, device: str) -> torch.Tensor:
    """query_point_table as an int64 tensor, moved to `device` once."""
    return torch.from_numpy(query_point_table(log_size).astype(np.int64)).to(device)


def line_position_to_x(domain: LineDomain, position):
    idx = index_add(domain.offset, index_mul(domain.step, position))
    return point_from_index(idx)[..., 0]


def bit_reverse_position(position, log_size: int):
    return bit_reverse(position, log_size)


def qm31_point(x, y):
    return torch.stack([x, y], dim=-2)


def qm31_point_x(p):
    return p[..., 0, :]


def qm31_point_y(p):
    return p[..., 1, :]


def qm31_point_add(p, q):
    x0, y0 = qm31_point_x(p), qm31_point_y(p)
    x1, y1 = qm31_point_x(q), qm31_point_y(q)
    x = F.qm31_sub(F.qm31_mul(x0, x1), F.qm31_mul(y0, y1))
    y = F.qm31_add(F.qm31_mul(x0, y1), F.qm31_mul(y0, x1))
    return qm31_point(x, y)


def vanishing_poly_eval(log_size: int, point):
    """V_{2^log_size}(x, y) = pi^(log_size-1)(x), pi(x) = 2x^2 - 1."""
    x = qm31_point_x(point)
    one = F.qm31_one(x.shape[:-1], x.device)
    for _ in range(log_size - 1):
        x2 = F.qm31_sqr(x)
        x = F.qm31_sub(F.qm31_add(x2, x2), one)
    return x
