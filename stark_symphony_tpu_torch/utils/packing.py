"""u256 digests, 32-byte strings, hex and u64 <-> big-endian u32 word
arrays (numpy in, numpy out).

The port's copy of ``stark_symphony_tpu/utils/packing.py``.
"""

from __future__ import annotations

import numpy as np


def u256_to_words(value: int) -> np.ndarray:
    """A 256-bit int -> 8 big-endian u32 words, most significant first."""
    return np.array(
        [(value >> (32 * (7 - i))) & 0xFFFFFFFF for i in range(8)],
        dtype=np.uint32,
    )


def words_to_u256(words) -> int:
    words = np.asarray(words, dtype=np.uint32).reshape(-1)
    if words.shape[-1] != 8:
        raise ValueError(f"expected 8 words, got {words.shape[-1]}")
    v = 0
    for w in words:
        v = (v << 32) | int(w)
    return v


def bytes32_to_words(b: bytes) -> np.ndarray:
    if len(b) != 32:
        raise ValueError(f"expected 32 bytes, got {len(b)}")
    return np.frombuffer(b, dtype=">u4").astype(np.uint32)


def words_to_bytes32(words) -> bytes:
    return np.asarray(words, dtype=np.uint32).astype(">u4").tobytes()


def hex_to_words(h: str) -> np.ndarray:
    if h.startswith("0x"):
        h = h[2:]
    return u256_to_words(int(h, 16))


def u64_to_words(value: int) -> np.ndarray:
    """u64 -> (hi, lo) big-endian u32 pair."""
    return np.array([value >> 32, value & 0xFFFFFFFF], dtype=np.uint32)
