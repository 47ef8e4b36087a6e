"""stwo Fiat-Shamir channel: SHA-256 "so-far digest" + draw counter.

Port of ``stark_symphony_tpu/models/stwo/channel.py``, bit-exact:

* state = (digest: (..., 8) words, counter: (...,) words)
* draw  = SHA-256(digest || counter_be32), counter += 1
* mix   = SHA-256(digest || payload), counter = 0
* M31 draws use rejection sampling (all words < 2P = 2^32 - 2) with a
  fixed K=2 attempt unroll: a lane whose two attempts are both rejected
  reports ok=False instead of looping.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops import field as F
from ...ops.sha256 import sha256_words
from ...ops.u32 import M32, WORD
from ...utils import trace as _trace

DBL_P = 0xFFFFFFFE  # 2 * (2^31 - 1) = 2^32 - 2


class ChannelState(NamedTuple):
    digest: torch.Tensor  # (..., 8) words
    counter: torch.Tensor  # (...,) words


def init(shape=(), device="cpu") -> ChannelState:
    return ChannelState(
        torch.zeros(tuple(shape) + (8,), dtype=WORD, device=device),
        torch.zeros(tuple(shape), dtype=WORD, device=device),
    )


def draw_words(state: ChannelState):
    """One draw: H(digest || counter) -> 8 words; counter += 1."""
    msg = torch.cat([state.digest, state.counter[..., None]], dim=-1)
    words = sha256_words(msg)
    _trace.emit("draw", words)
    return ChannelState(state.digest, (state.counter + 1) & M32), words


def mix_words(state: ChannelState, words) -> ChannelState:
    """Mix payload words: digest = H(digest || words); counter = 0."""
    msg = torch.cat([state.digest, words], dim=-1)
    digest = sha256_words(msg)
    _trace.emit("mix", digest)
    return ChannelState(digest, torch.zeros_like(state.counter))


def mix_root(state: ChannelState, root) -> ChannelState:
    """Mix a 32-byte commitment."""
    return mix_words(state, root)


def mix_u64(state: ChannelState, hi, lo) -> ChannelState:
    """Mix an 8-byte big-endian value."""
    return mix_words(state, torch.stack([hi, lo], dim=-1))


def _attempt_m31(state: ChannelState, n: int):
    state, words = draw_words(state)
    ok = (words[..., :n] < DBL_P).all(dim=-1)
    vals = F.m31_reduce(words[..., :n])
    return state, vals, ok


def draw_m31(state: ChannelState, n: int, attempts: int = 2):
    """Draw n (4 or 8) uniform M31 values with a K-attempt rejection unroll.

    Returns (state, vals (..., n), ok); ok is False where all K attempts
    were rejected."""
    if n not in (4, 8):
        raise ValueError(f"draw_m31 draws 4 or 8 values, not {n}")
    st1, vals, ok1 = _attempt_m31(state, n)
    accept = ok1
    out_state, out_vals = st1, vals
    ok_any = ok1
    for _ in range(attempts - 1):
        st2, vals2, ok2 = _attempt_m31(out_state, n)
        # lanes that already accepted keep their value and do not advance
        new_counter = torch.where(accept, out_state.counter, st2.counter)
        out_vals = torch.where(accept[..., None], out_vals, vals2)
        out_state = ChannelState(out_state.digest, new_counter)
        ok_any = ok_any | ok2
        accept = accept | ok2
    return out_state, out_vals, ok_any


def draw_qm31(state: ChannelState):
    return draw_m31(state, 4)


def draw_qm31_point(state: ChannelState):
    """t -> ((1 - t^2)/(1 + t^2), 2t/(1 + t^2))."""
    state, t, ok = draw_qm31(state)
    one = F.qm31_one(t.shape[:-1], t.device)
    t_sq = F.qm31_sqr(t)
    inv = F.qm31_inv(F.qm31_add(one, t_sq))
    x = F.qm31_mul(F.qm31_sub(one, t_sq), inv)
    y = F.qm31_mul(F.qm31_add(t, t), inv)
    return state, torch.stack([x, y], dim=-2), ok  # (..., 2, 4)


def draw_queries(state: ChannelState, n_queries: int, log_size: int):
    """Draw query positions: each digest yields 8 masked words (no sort,
    no dedup, as in the JAX package)."""
    mask = (1 << log_size) - 1
    chunks = []
    for _ in range((n_queries + 7) // 8):
        state, words = draw_words(state)
        chunks.append(words & mask)
    return state, torch.cat(chunks, dim=-1)[..., :n_queries]
