"""stark101 Fiat-Shamir channel: a SHA-256 state and modular draws.

Port of ``stark_symphony_tpu/models/stark101/channel.py``, bit-exact:

* state = a 32-byte digest, (..., 8) words
* mix   : state = H(state || payload)
* draw  : value = int_be(state) mod max; state = H(state)

Each hash is one ``sha256_words`` call, so on a CUDA tensor one launch of
kernel K1.
"""

from __future__ import annotations

import torch

from ...ops.field101 import mod_words_be
from ...ops.sha256 import sha256_words
from ...utils import trace as _trace


def mix_words(state, words):
    digest = sha256_words(torch.cat([state, words], dim=-1))
    _trace.emit("mix", digest)
    return digest


def mix_u32(state, value):
    return mix_words(state, value[..., None])


def draw(state, max_value: int):
    """Draw an integer in [0, max_value) and advance the state."""
    value = mod_words_be(state, max_value)
    _trace.emit("draw", value)
    return sha256_words(state), value
