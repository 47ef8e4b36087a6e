"""Python wrappers of the CUDA SHA-256 kernels (``csrc/sha256.cu``).

Counterpart of the public wrappers of
``stark_symphony_tpu/ops/pallas/sha256_kernel.py`` (``sha256_words``,
``sha256_pair``, ``merkle_compute_root``):

* K1 ``sha256_words``        replaces ``sha256_words_tiled``
* K2 ``sha256_pair``         replaces ``sha256_pair_tiled``
* K3 ``merkle_compute_root`` replaces ``merkle_walk_tiled``

The kernels are bound by 32-bit integer issue, not by bytes: a compression
reads about 64 B and writes 32 B against some 1,300 integer operations.
They run one lane per thread.  Each wrapper takes int64 word tensors on a
CUDA device (``ops/u32.py``), checks device and dtype, allocates its
output with ``torch.empty``, and launches once on
``torch.cuda.current_stream()``.

All three read the caller's int64 words in place, lane-major (K1 the
``(..., n)`` messages, K2 the ``(..., 8)`` left and right digests, K3 the
``(..., 8)`` leaves, ``(...,)`` indices and ``(..., D, 8)`` siblings) and
write the int64 ``(..., 8)`` result.  An operand that is broadcast, not
contiguous or not 16-byte aligned is first made so (a copy); the
verifiers' operands never are.  K2 also reads in place an operand whose
8-word rows lie one even stride apart (the even or odd rows of a Merkle
tree level).  K3's per-path depths go to the card once
per distinct array and are read at ``lane % period``.

``launches`` counts the launches of each kernel; nothing else changes it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..u32 import WORD, const
from . import build

launches = {"sha256_words": 0, "sha256_pair": 0, "merkle_walk": 0}

# K1-K3 block sizes: blocks of 32 lanes below SMALL_LANES lanes, so a
# 4,096-lane call spreads over 128 SMs, and of 128 lanes above it (two
# blocks an SM and more).  132 SMs x 256 lanes.  K3 with per-path depths
# always takes blocks of 32 (walk_threads).
SMALL_LANES = 132 * 256
# Shared memory a K1 block may take (csrc/sha256.cu kMaxSmem): its lanes'
# messages, at least 8 words each, and one 8-byte barrier.
MAX_SMEM = 232448


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


def lane_threads(lanes: int, n: int = 8) -> int:
    """The block size of K1 (n-word messages), K2 or K3 (n = 8) for
    `lanes` lanes: 32 or 128 threads, halved while a K1 block's messages
    would not fit in shared memory."""
    threads = 32 if lanes < SMALL_LANES else 128
    while threads > 32 and threads * max(n, 8) * 8 + 8 > MAX_SMEM:
        threads //= 2
    if threads * max(n, 8) * 8 + 8 > MAX_SMEM:
        raise ValueError(f"sha256_words: {n}-word messages do not fit a block's "
                         "shared memory")
    return threads


def walk_threads(lanes: int, depths) -> int:
    """K3's block size: 32 threads where the paths have depths of their own,
    since a block walks to the depth of its deepest lane and small blocks
    idle least (the FRI walk: 0.81 ms a call in blocks of 32, 0.90 ms in
    blocks of 128; PERF.md), else as K1's."""
    return 32 if depths is not None else lane_threads(lanes)


def _lane_major(x: torch.Tensor, shape) -> torch.Tensor:
    """`x` itself if it is a contiguous, 16-byte-aligned tensor of `shape`,
    else a contiguous copy of it broadcast to `shape`."""
    if tuple(x.shape) == tuple(shape) and x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    return x.expand(shape).clone(memory_format=torch.contiguous_format)


def _row_stride(x: torch.Tensor, shape):
    """The elements between the 8-word rows of `x`, if it has `shape`, is
    16-byte aligned, and its rows lie one even stride of 8 or more apart
    (what a tensor map reads); else None."""
    if tuple(x.shape) != tuple(shape) or x.stride(-1) != 1 or x.data_ptr() % 16:
        return None
    row = span = None
    for size, stride in zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])):
        if size == 1:
            continue
        if row is None:
            row = span = stride
        elif stride != span:
            return None
        span *= size
    row = 8 if row is None else row
    return row if row >= 8 and row % 2 == 0 else None


def _pair_operand(x: torch.Tensor, shape):
    """(rows K2 reads, their stride): `x` in place where _row_stride allows,
    else a contiguous copy broadcast to `shape`."""
    stride = _row_stride(x, shape)
    if stride is None:
        return x.expand(shape).clone(memory_format=torch.contiguous_format), 8
    return x, stride


def _periodic_depths(depths, bshape, device):
    """(int32 depths on `device`, period): lane i of the flattened batch
    `bshape` has depth depths[i % period].  A depth array whose shape is a
    trailing part of `bshape` (after leading 1s) keeps its own size as the
    period; any other is broadcast to the whole batch.  Host arrays are
    copied to the card once per distinct array (``u32.const``, which
    never evicts, so a CUDA graph may read them)."""
    if not isinstance(depths, torch.Tensor):
        depths = torch.from_numpy(np.asarray(depths, np.int64))
    shape = tuple(depths.shape)
    while shape and shape[0] == 1:
        shape = shape[1:]
    if len(shape) <= len(bshape) and shape == bshape[len(bshape) - len(shape):]:
        depths = depths.reshape(shape)
    else:
        depths, shape = depths.expand(bshape), bshape
    period = max(1, math.prod(shape))
    if depths.device == device:
        return depths.to(torch.int32).contiguous().reshape(-1), period
    host = tuple(depths.cpu().numpy().astype(np.int32).reshape(-1).tolist())
    return const(host, device, torch.int32), period


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
    bshape = tuple(words.shape[:-1])
    lanes = math.prod(bshape)
    out = torch.empty(bshape + (8,), dtype=WORD, device=words.device)
    if lanes:
        msg = _lane_major(words, bshape + (n,))
        _launch("sha256_words", words.device, msg, out, n, lanes,
                lane_threads(lanes, n))
    return out


def sha256_pair(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """K2: Merkle node hash sha256(left || right), (..., 8) x2 -> (..., 8)."""
    _check(left, "sha256_pair left")
    _check(right, "sha256_pair right", left.device)
    shape = tuple(left.shape)
    if left.shape != right.shape:  # broadcast_shapes: more host time than K2 (PERF.md)
        shape = tuple(torch.broadcast_shapes(left.shape, right.shape))
    if not shape or shape[-1] != 8:
        raise ValueError("sha256_pair: digests need a trailing axis of 8 words")
    lanes = math.prod(shape[:-1])
    out = torch.empty(shape, dtype=WORD, device=left.device)
    if lanes:
        lrows, lstride = _pair_operand(left, shape)
        rrows, rstride = _pair_operand(right, shape)
        _launch("sha256_pair", left.device, lrows, rrows, out, lanes,
                lane_threads(lanes), lstride, rstride)
    return out


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
    bshape = tuple(torch.broadcast_shapes(leaf_digest.shape[:-1], index.shape,
                                          siblings.shape[:-2]))
    lanes = math.prod(bshape)
    out = torch.empty(bshape + (8,), dtype=WORD, device=dev)
    if lanes:
        dep, period = (None, 0) if depths is None else _periodic_depths(depths, bshape, dev)
        _launch("merkle_walk", dev, _lane_major(leaf_digest, bshape + (8,)),
                _lane_major(index, bshape), dep, period,
                _lane_major(siblings, bshape + (D, 8)), out, D, lanes,
                walk_threads(lanes, depths))
    return out
