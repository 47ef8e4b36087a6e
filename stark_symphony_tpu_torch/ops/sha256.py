"""SHA-256 over int64 word tensors, with CUDA kernels for CUDA tensors.

Port of ``stark_symphony_tpu/ops/sha256.py``.  Messages are big-endian u32
word arrays ``(..., n)`` of static length; padding words are appended as
constants.

Dispatch is by device alone: a CUDA tensor always goes to the kernels
(K1 ``sha256_words``, K2 ``sha256_pair`` in ``ops/cuda/sha256_kernel.py``),
whatever the batch size, and a CPU tensor always takes the plain version
(``sha256_words_plain``, ``sha256_pair_plain``).  There is no lane-count
threshold and no switch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .cuda import sha256_kernel as _ck
from .u32 import M32, const, rotr

K = np.array([
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
], dtype=np.uint32)

IV = np.array([
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
], dtype=np.uint32)


def iv(shape=(), device="cpu") -> torch.Tensor:
    return const(tuple(IV.tolist()), device).expand(tuple(shape) + (8,))


def _small_sigma0(x):
    return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3)


def _small_sigma1(x):
    return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10)


def _big_sigma0(x):
    return rotr(x, 2) ^ rotr(x, 13) ^ rotr(x, 22)


def _big_sigma1(x):
    return rotr(x, 6) ^ rotr(x, 11) ^ rotr(x, 25)


def _round_fn(kw: int, w_t, vs):
    """One round; kw = K[t] (+ W[t] when the schedule word is constant)."""
    a, b, c, d, e, f, g, h = vs
    ch = g ^ (e & (f ^ g))
    maj = (a & (b | c)) | (b & c)
    t1 = h + _big_sigma1(e) + ch + kw
    if w_t is not None:
        t1 = t1 + w_t
    t1 = t1 & M32
    t2 = _big_sigma0(a) + maj
    return ((t1 + t2) & M32, a, b, c, (d + t1) & M32, e, f, g)


def compress(state, block):
    """One SHA-256 compression: state (..., 8), block (..., 16) -> (..., 8).

    The message schedule runs over a rolling 16-word window."""
    vs = tuple(state[..., i] for i in range(8))
    w = [block[..., i] for i in range(16)]
    for t in range(64):
        if t >= 16:
            w[t % 16] = (
                _small_sigma1(w[(t - 2) % 16]) + w[(t - 7) % 16]
                + _small_sigma0(w[(t - 15) % 16]) + w[t % 16]
            ) & M32
        vs = _round_fn(int(K[t]), w[t % 16], vs)
    return (state + torch.stack(vs, dim=-1)) & M32


def compress_const_schedule(state, w_const: np.ndarray):
    """Compression against a host-precomputed 64-word schedule."""
    vs = tuple(state[..., i] for i in range(8))
    for t in range(64):
        vs = _round_fn((int(K[t]) + int(w_const[t])) & M32, None, vs)
    return (state + torch.stack(vs, dim=-1)) & M32


def schedule_host(block16: np.ndarray) -> np.ndarray:
    """Host-side message schedule for a constant 16-word block."""
    w = [int(x) for x in block16]
    m = (1 << 32) - 1

    def rr(x, n):
        return ((x >> n) | (x << (32 - n))) & m

    for t in range(16, 64):
        s0 = rr(w[t - 15], 7) ^ rr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rr(w[t - 2], 17) ^ rr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & m)
    return np.array(w, dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _padding_words(n_words: int):
    """SHA-256 padding (as u32 words) for a message of n_words*4 bytes.

    Returns (pad, n_blocks): `pad` completes the message to a multiple of
    16 words."""
    bit_len = n_words * 32
    total = n_words + 1  # the 0x80000000 word (length multiple of 4 bytes)
    while (total + 2) % 16 != 0:
        total += 1
    pad = [0x80000000] + [0] * (total - n_words - 1)
    pad += [bit_len >> 32, bit_len & 0xFFFFFFFF]
    return np.array(pad, dtype=np.uint32), (total + 2) // 16


@functools.lru_cache(maxsize=None)
def _const_pad_block_schedule(n_words: int):
    """If the final block of an n_words message is pure padding, its
    host-precomputed schedule; else None."""
    pad, _ = _padding_words(n_words)
    if n_words % 16 == 0:
        return schedule_host(pad)
    return None


def on_cuda(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU one (plain)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {x.device}")


def sha256_words_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch SHA-256 of (..., n) word messages -> (..., 8)."""
    n = words.shape[-1]
    pad, n_blocks = _padding_words(n)
    const_sched = _const_pad_block_schedule(n)
    state = iv(words.shape[:-1], words.device)
    if const_sched is not None:
        # data fills whole blocks; the final block is constant padding
        for b in range(n // 16):
            state = compress(state, words[..., 16 * b: 16 * (b + 1)])
        return compress_const_schedule(state, const_sched)
    pad_t = const(tuple(pad.tolist()), words.device)
    full = torch.cat(
        [words, pad_t.expand(words.shape[:-1] + pad_t.shape)], dim=-1)
    for b in range(n_blocks):
        state = compress(state, full[..., 16 * b: 16 * (b + 1)])
    return state


def sha256_pair_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch Merkle node hash sha256(left || right)."""
    left, right = torch.broadcast_tensors(left, right)
    state = iv(left.shape[:-1], left.device)
    state = compress(state, torch.cat([left, right], dim=-1))
    return compress_const_schedule(state, _const_pad_block_schedule(16))


def sha256_words(words: torch.Tensor) -> torch.Tensor:
    """SHA-256 of a big-endian word array (..., n) -> (..., 8).

    Matches `sha_256_ctx_8_init / add / finalize` on the same 4n bytes."""
    if on_cuda(words, "sha256_words"):
        return _ck.sha256_words(words)
    return sha256_words_plain(words)


def sha256_pair(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """SHA-256 of two concatenated 8-word digests (the Merkle node hash)."""
    if on_cuda(left, "sha256_pair"):
        return _ck.sha256_pair(left, right)
    return sha256_pair_plain(left, right)
