"""Batched SHA-256 Merkle trees: path verification, tree building and
path extraction.

Port of ``stark_symphony_tpu/ops/merkle.py``.  At each level the low index
bit says whether the sibling is on the left (odd) or on the right (even),
then the index halves.  A CUDA tensor goes to kernel
K3 (``ops/cuda/sha256_kernel.merkle_compute_root``), a CPU tensor to the
plain version ``compute_root_plain``.  As in the JAX package, no
``index < 2^depth`` check is applied.  ``build_tree`` hashes each level
with one ``sha256_pair`` call (one launch of kernel K2 on a CUDA tensor).
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda import sha256_kernel as _ck
from .sha256 import on_cuda, sha256_pair, sha256_pair_plain


def compute_root_plain(leaf_digest, index, siblings, depths=None):
    """Plain-PyTorch walk: leaf (..., 8), index (...,), siblings (..., D, 8)
    leaf level first; depths None or per-path true depths broadcastable to
    the batch shape (levels at or past a path's depth leave it unchanged)."""
    D = siblings.shape[-2]
    bshape = torch.broadcast_shapes(leaf_digest.shape[:-1], index.shape,
                                    siblings.shape[:-2])
    cur = leaf_digest.expand(bshape + (8,))
    idx = index.expand(bshape)
    sibs = siblings.expand(bshape + (D, 8))
    if depths is not None and not isinstance(depths, torch.Tensor):
        depths = torch.from_numpy(np.asarray(depths, np.int64))
    if depths is not None:
        depths = depths.to(device=cur.device, dtype=idx.dtype)
    for d in range(D):
        sib = sibs[..., d, :]
        bit = ((idx & 1) == 1)[..., None]
        left = torch.where(bit, sib, cur)
        right = torch.where(bit, cur, sib)
        nxt = sha256_pair_plain(left, right)
        if depths is None:
            cur, idx = nxt, idx >> 1
        else:
            active = d < depths
            cur = torch.where(active[..., None], nxt, cur)
            idx = torch.where(active, idx >> 1, idx)
    return cur


def compute_root(leaf_digest, index, siblings, depths=None):
    """Recompute the root digest from leaf + sibling path (see
    compute_root_plain for the arguments)."""
    if on_cuda(leaf_digest, "compute_root"):
        return _ck.merkle_compute_root(leaf_digest, index, siblings, depths)
    return compute_root_plain(leaf_digest, index, siblings, depths)


def verify_path(leaf_digest, index, siblings, root):
    """Recompute the root from a leaf digest and sibling path; compare.

    leaf_digest (..., 8); index (...,); siblings (..., depth, 8), leaf
    level first; root (..., 8).  Returns ok (...,) bool."""
    recomputed = compute_root(leaf_digest, index, siblings)
    return (recomputed == root).all(dim=-1)


def verify_path_padded(leaf_digest, index, siblings, root, depths):
    """verify_path for paths of different depths zero-padded to a common D.

    leaf_digest (..., B, 8); index (..., B); siblings (..., B, D, 8);
    root (..., B, 8); depths (B,) integer true path depths."""
    recomputed = compute_root(leaf_digest, index, siblings, depths)
    return (recomputed == root).all(dim=-1)


def build_tree(leaf_digests):
    """A full Merkle tree over (..., n, 8) leaf digests, n a power of two.

    Returns the levels, leaves first: [(..., n, 8), (..., n/2, 8), ...,
    (..., 1, 8)]; the root is levels[-1][..., 0, :].  Each level's left and
    right children are the even and odd rows of the level below, handed
    to sha256_pair as strided views (K2 reads them in place)."""
    n = leaf_digests.shape[-2]
    if n & (n - 1):
        raise ValueError(f"build_tree: {n} leaves, not a power of two")
    levels = [leaf_digests]
    cur = leaf_digests
    while cur.shape[-2] > 1:
        cur = sha256_pair(cur[..., 0::2, :], cur[..., 1::2, :])
        levels.append(cur)
    return levels


def gather_path(levels, index):
    """The sibling digests of leaf `index` (...,) in tree `levels` (the
    output of build_tree; batch dims broadcast): (..., depth, 8), leaf
    level first."""
    idx = index
    out = []
    for lvl in levels[:-1]:
        bshape = torch.broadcast_shapes(lvl.shape[:-2], idx.shape)
        sib = (idx ^ 1).expand(bshape)[..., None, None]
        out.append(torch.take_along_dim(lvl.expand(bshape + lvl.shape[-2:]), sib,
                                        dim=-2)[..., 0, :])
        idx = idx >> 1
    return torch.stack(out, dim=-2)
