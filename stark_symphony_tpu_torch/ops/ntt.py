"""Radix-2 NTT over F_q (q = 3 * 2^30 + 1) for the stark101 prover.

Port of ``stark_symphony_tpu/ops/ntt.py``: O(n log n) batched butterflies
over word tensors, with Montgomery products (``ops/field101.py``).
Coefficient and evaluation vectors are (..., n) with n a power of two.
The twiddle tables, the bit-reversal permutation and the coset offsets are
built on the host, per (n, root) pair as in the JAX package, and each goes
to a device once (``_on_device``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import field101 as F


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, root: int, inverse: bool):
    """Per-stage twiddle tables of a DIT NTT of size n."""
    w = pow(root, F.Q - 2, F.Q) if inverse else root
    if pow(w, n, F.Q) != 1 or pow(w, n // 2, F.Q) == 1:
        raise ValueError(f"{root} is not a root of order {n}")
    stages = []
    m = 2
    while m <= n:
        wm = pow(w, n // m, F.Q)
        tw = np.empty(m // 2, dtype=np.uint32)
        cur = 1
        for j in range(m // 2):
            tw[j] = cur
            cur = (cur * wm) % F.Q
        stages.append(tw)
        m *= 2
    return stages


@functools.lru_cache(maxsize=None)
def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _coset_offsets(n: int, offset: int) -> np.ndarray:
    offs = np.empty(n, dtype=np.uint32)
    cur = 1
    for k in range(n):
        offs[k] = cur
        cur = (cur * offset) % F.Q
    return offs


_device_tables = {}  # (table key, device) -> int64 tensor on the device


def _on_device(key, make, device) -> torch.Tensor:
    """The host table make() as an int64 tensor on `device`, sent there
    once per (key, device)."""
    k = (key, str(device))
    if k not in _device_tables:
        _device_tables[k] = torch.from_numpy(np.asarray(make(), np.int64)).to(device)
    return _device_tables[k]


def ntt(values, root: int, inverse: bool = False):
    """NTT (or INTT) of (..., n) word tensors along the last axis, for a
    root of order n: X_k = sum_i x_i root^(ik).  The inverse includes the
    1/n factor."""
    n = values.shape[-1]
    if n & (n - 1):
        raise ValueError(f"ntt: size {n} is not a power of two")
    dev = values.device
    perm = _on_device(("perm", n), lambda: _bit_reverse_perm(n), dev)
    x = values[..., perm]
    for stage in range(len(_twiddles(n, root, inverse))):
        m = 2 << stage
        tw = _on_device(("tw", n, root, inverse, stage),
                        lambda s=stage: _twiddles(n, root, inverse)[s], dev)
        xb = x.reshape(x.shape[:-1] + (n // m, m))
        even = xb[..., : m // 2]
        t = F.f_mul(xb[..., m // 2:], tw)
        x = torch.cat([F.f_add(even, t), F.f_sub(even, t)], dim=-1).reshape(
            values.shape[:-1] + (n,))
    if inverse:
        x = F.f_mul(x, pow(n, F.Q - 2, F.Q))
    return x


def eval_on_coset(coeffs, offset: int, root: int, n_out: int | None = None):
    """Evaluate polynomials (..., n) on the coset {offset * root^i} of size
    n_out: p(offset * root^i) = NTT(c_k * offset^k)_i.  The coefficients are
    zero-padded to n_out, and root must have order n_out."""
    if n_out is not None and coeffs.shape[-1] < n_out:
        pad = n_out - coeffs.shape[-1]
        coeffs = torch.cat(
            [coeffs, coeffs.new_zeros(coeffs.shape[:-1] + (pad,))], dim=-1)
    n = coeffs.shape[-1]
    offs = _on_device(("coset", n, offset), lambda: _coset_offsets(n, offset),
                      coeffs.device)
    return ntt(F.f_mul(coeffs, offs), root)
