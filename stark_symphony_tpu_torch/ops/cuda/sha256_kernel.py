"""Python wrappers of the CUDA SHA-256 kernels (``csrc/sha256.cu``).

Counterpart of the public wrappers of
``stark_symphony_tpu/ops/pallas/sha256_kernel.py`` (``sha256_words``,
``sha256_pair``, ``merkle_compute_root``):

* K1 ``sha256_words``        replaces ``sha256_words_tiled``
* K2 ``sha256_pair``         replaces ``sha256_pair_tiled``
* K3 ``merkle_compute_root`` replaces ``merkle_walk_tiled``

The kernels are bound by 32-bit integer issue, not by bytes: a compression
reads about 64 B and writes 32 B against some 1,300 integer operations.
They run one lane per thread, and each wrapper lays its ``(..., W)``
trailing input out word-major ``(W, lanes)`` on the device, so a warp's 32
threads read 128 consecutive bytes per word.

Each wrapper takes int64 word tensors on a CUDA device (``ops/u32.py``),
checks device, dtype and shape, passes int32 bit patterns to the kernel,
allocates its output with ``torch.empty``, and launches on
``torch.cuda.current_stream()``.  ``launches`` counts the launches of each
kernel; nothing else changes it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..u32 import WORD, from_i32, to_i32
from . import build

launches = {"sha256_words": 0, "sha256_pair": 0, "merkle_walk": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(x: torch.Tensor, what: str, device=None) -> None:
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor")
    if device is not None and x.device != device:
        raise ValueError(f"{what}: on {x.device}, the other operands on {device}")
    if x.dtype != WORD:
        raise TypeError(f"{what}: expected int64 words, got {x.dtype}")


def _word_major(x: torch.Tensor, w: int, lanes: int) -> torch.Tensor:
    """(..., w) int64 words -> contiguous (w, lanes) int32 bit patterns."""
    return to_i32(x.reshape(lanes, w)).t().contiguous()


def _from_word_major(out: torch.Tensor, bshape) -> torch.Tensor:
    """(8, lanes) int32 -> (*bshape, 8) int64 words."""
    return from_i32(out.t()).reshape(tuple(bshape) + (out.shape[0],))


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel `name` on `device`'s current stream and count it."""
    build.launch(name, device, *args)
    launches[name] += 1


def sha256_words(words: torch.Tensor) -> torch.Tensor:
    """K1: SHA-256 of big-endian word messages (..., n) -> (..., 8)."""
    _check(words, "sha256_words")
    if words.dim() < 1 or words.shape[-1] < 1:
        raise ValueError("sha256_words: need a trailing word axis of length >= 1")
    n = words.shape[-1]
    bshape = words.shape[:-1]
    lanes = math.prod(bshape)
    out = torch.empty((8, lanes), dtype=torch.int32, device=words.device)
    if lanes:
        msg = _word_major(words, n, lanes)
        _launch("sha256_words", words.device, msg, out, n, lanes)
    return _from_word_major(out, bshape)


def sha256_pair(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """K2: Merkle node hash sha256(left || right), (..., 8) x2 -> (..., 8)."""
    _check(left, "sha256_pair left")
    _check(right, "sha256_pair right", left.device)
    left, right = torch.broadcast_tensors(left, right)
    if left.shape[-1] != 8:
        raise ValueError("sha256_pair: digests need a trailing axis of 8 words")
    bshape = left.shape[:-1]
    lanes = math.prod(bshape)
    out = torch.empty((8, lanes), dtype=torch.int32, device=left.device)
    if lanes:
        lw = _word_major(left, 8, lanes)
        rw = _word_major(right, 8, lanes)
        _launch("sha256_pair", left.device, lw, rw, out, lanes)
    return _from_word_major(out, bshape)


def merkle_compute_root(leaf_digest: torch.Tensor, index: torch.Tensor,
                        siblings: torch.Tensor, depths=None) -> torch.Tensor:
    """K3: recompute Merkle roots from leaves and sibling paths.

    leaf_digest: (..., 8); index: (...,); siblings: (..., D, 8), leaf level
    first; depths: None (every path is D deep) or integers broadcastable to
    the batch shape giving each path's true depth (levels at or past it
    leave the lane unchanged).  Returns (..., 8).
    """
    _check(leaf_digest, "merkle leaf_digest")
    _check(index, "merkle index", leaf_digest.device)
    _check(siblings, "merkle siblings", leaf_digest.device)
    if leaf_digest.shape[-1] != 8 or siblings.dim() < 2 or siblings.shape[-1] != 8:
        raise ValueError("merkle: digests need a trailing axis of 8 words")
    dev = leaf_digest.device
    D = siblings.shape[-2]
    bshape = torch.broadcast_shapes(leaf_digest.shape[:-1], index.shape,
                                    siblings.shape[:-2])
    lanes = math.prod(bshape)
    if depths is None:
        dep = torch.full((lanes,), D, dtype=torch.int32, device=dev)
    else:
        if not isinstance(depths, torch.Tensor):
            depths = torch.from_numpy(np.asarray(depths, np.int64))
        dep = depths.to(device=dev, dtype=torch.int32)
        dep = dep.expand(bshape).reshape(lanes).contiguous()
    out = torch.empty((8, lanes), dtype=torch.int32, device=dev)
    if lanes:
        leaf = _word_major(leaf_digest.expand(bshape + (8,)), 8, lanes)
        idx = to_i32(index.expand(bshape).reshape(lanes)).contiguous()
        sibs = _word_major(siblings.expand(bshape + (D, 8)), D * 8, lanes)
        _launch("merkle_walk", dev, leaf, idx, dep, sibs, out, D, lanes)
    return _from_word_major(out, bshape)
