"""u256 digests <-> big-endian u32 word arrays (numpy only).

The port's copy of the two helpers of ``stark_symphony_tpu/utils/packing.py``
that its stark101 proof ingestion and ``to_json_dict`` use.
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
