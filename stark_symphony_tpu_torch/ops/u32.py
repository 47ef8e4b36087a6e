"""uint32 word helpers for PyTorch tensors.

Word convention (the whole port follows it):

* Plain code holds u32 words in ``int64`` tensors with values in
  ``[0, 2**32)``.  torch's ``uint32`` has no add, shift or compare on the
  CPU, and ``int32 >> n`` sign-extends, so neither serves.  Every add,
  multiply and left shift is masked with ``0xFFFFFFFF`` right after it,
  which reproduces uint32 wrap-around bit for bit.
* At a CUDA kernel's boundary: K1 ``sha256_words``, K2 ``sha256_pair``
  and K3 ``merkle_walk`` read these int64 words in place, lane-major, and
  use the low 32 bits of each; K4 and K5 take word-major ``int32`` bit
  patterns, which the device code reads as ``uint32_t``.
* Conversions happen only at the edges: ``np.uint32`` <-> ``int64``
  (``from_numpy`` / ``to_numpy``) and ``int64`` <-> ``int32`` for the
  int32 kernels (``to_i32`` / ``from_i32``).

The helpers below mirror ``stark_symphony_tpu/ops/u32.py`` and are
shape-polymorphic over broadcastable batch dimensions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

M32 = 0xFFFFFFFF
MASK16 = 0xFFFF
WORD = torch.int64


@functools.lru_cache(maxsize=None)
def const(values: tuple, device, dtype=WORD) -> torch.Tensor:
    """The constant tensor `values` on `device`, made once per (values,
    device, dtype) and shared by every caller, which must not write to it.
    So a verifier's second call copies nothing from the host, and a CUDA
    graph can capture it (a capture may hold no host-to-device copy)."""
    return torch.tensor(values, dtype=dtype, device=device)


def host_i32(a) -> np.ndarray:
    """np.uint32 words -> contiguous int32 bit patterns (a view where `a`
    is already contiguous uint32; a 0-d array comes back 1-d): the form in
    which words travel to a device."""
    return np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).view(np.int32)


def from_numpy(a, device="cpu") -> torch.Tensor:
    """np.uint32 array -> int64 word tensor on `device`.

    The host copy travels as int32 bit patterns (half the bytes of int64)
    and is widened on the device."""
    return from_i32(torch.from_numpy(host_i32(a)).to(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 word tensor -> np.uint32 array (on the host)."""
    return t.detach().cpu().numpy().astype(np.uint32)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 bit patterns, without relying on
    the narrowing cast to wrap: words >= 2^31 map to x - 2^32."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def from_i32(y: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 words in [0, 2^32)."""
    return y.to(WORD) & M32


def mul32_wide(a, b):
    """Full 32x32 -> 64-bit product as a (hi, lo) pair of int64 words;
    `b` is a word tensor or a Python int.

    The int64 product of two words can pass 2^63, so `b` is split into
    16-bit limbs: each partial product stays below 2^48 and the 64-bit
    result is exact, the same (hi, lo) that the JAX limb schoolbook gives.
    """
    a = torch.as_tensor(a, dtype=WORD)
    if not isinstance(b, torch.Tensor):  # a Python or numpy integer stays a
        b = int(b)  # scalar: no tensor is made
    p0 = a * (b & MASK16)  # < 2^48
    p1 = a * (b >> 16)  # < 2^48
    low = p0 + ((p1 & MASK16) << 16)  # < 2^49
    lo = low & M32
    hi = ((p1 >> 16) + (low >> 32)) & M32
    return hi, lo


def mullo32(a, b):
    """Low 32 bits of the product (the wrapping uint32 multiply), by the
    16-bit split of mul32_wide: the int64 product of two words can pass
    2^63.  `b` is a word tensor or a Python int."""
    return (a * (b & MASK16) + (((a * (b >> 16)) & MASK16) << 16)) & M32


def add64(a_hi, a_lo, b_hi, b_lo):
    """Add two 64-bit values held as (hi, lo) word pairs (wrapping)."""
    lo = (a_lo + b_lo) & M32
    c = (lo < a_lo).to(WORD)
    hi = (a_hi + b_hi + c) & M32
    return hi, lo


def lt64(a_hi, a_lo, b_hi, b_lo):
    """Unsigned comparison of 64-bit (hi, lo) pairs: a < b."""
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))


def rotr(x, n: int):
    """Rotate right by a static amount (0 < n < 32)."""
    return (x >> n) | ((x << (32 - n)) & M32)


def byte_swap32(x):
    """Reverse the 4 bytes of each word."""
    return (
        ((x & 0x000000FF) << 24)
        | ((x & 0x0000FF00) << 8)
        | ((x & 0x00FF0000) >> 8)
        | ((x & 0xFF000000) >> 24)
    )


def bit_reverse(x, log_size: int):
    """Reverse the low `log_size` bits of x (all 32 bits reversed, then
    shifted right by 32 - log_size, as in the JAX package)."""
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = byte_swap32(x)
    return x >> (32 - log_size) if log_size < 32 else x
