"""The tiled path's fused stages: stage V's leaf walk and stage VII's FRI
layers, with CUDA kernels for CUDA tensors.

Port of the functions of ``stark_symphony_tpu/ops/pallas/fri_kernel.py``:

* ``leafwalk``       (K4) <- ``leafwalk_tiled``
* ``fri_all_layers`` (K5) <- ``fri_all_layers_tiled``

Both take word-major arrays, one (proof, query) lane per column, lane =
b * Q + q, as the tiled batch holds them (int32 bit patterns), and per-proof
operands (roots, alphas) of B rows, where the JAX functions take them
broadcast to every lane.  Dispatch is by device alone: a CUDA tensor goes
to the kernel (``ops/cuda/fri_kernel.py``), a CPU tensor to the plain
version.  The plain versions ``leafwalk_plain`` and ``fri_all_layers_plain``
compute the same function on int64 words (``ops/u32.py``) from the plain
SHA-256, Merkle and field code; they are the counterparts of the JAX
package's CPU oracles ``_leafwalk_jnp`` and ``_fri_jnp``.
"""

from __future__ import annotations

import torch

from . import field as F
from .cuda import fri_kernel as _fk
from .merkle import compute_root_plain
from .sha256 import on_cuda, sha256_pair_plain, sha256_words_plain
from .u32 import WORD, from_i32, to_i32


def _per_lane(x: torch.Tensor, lanes: int) -> torch.Tensor:
    """Per-proof rows (B, ...) -> per-lane rows (lanes, ...), lane b*Q + q
    taking row b."""
    return x.repeat_interleave(lanes // x.shape[0], dim=0)


def leaf_roots_plain(evals, index, sibs):
    """The root each lane's leaf and path give: evals (n_words, lanes),
    index (lanes,), sibs (depth, 8, lanes), int64 words -> (lanes, 8)."""
    leaf = sha256_words_plain(evals.t())
    return compute_root_plain(leaf, index, sibs.permute(2, 0, 1))


def leafwalk_plain(evals, index, sibs, roots):
    """Plain K4 on int64 words: evals (n_words, lanes), index (lanes,), sibs
    (depth, 8, lanes), roots (B, 8) -> ok (lanes,) int64 in {0, 1}."""
    cur = leaf_roots_plain(evals, index, sibs)
    return (cur == _per_lane(roots, index.shape[0])).all(dim=-1).to(WORD)


def fri_roots_plain(queries, evals, wits, cinvs, alphas, sibs, depths):
    """The FRI chain of every lane on int64 words: per layer the root its
    node and path give, then the fold.  Arguments as fri_all_layers_plain;
    returns (roots (L, lanes, 8), folded (4, lanes), q_out (lanes,))."""
    lanes = queries.shape[0]
    q = queries
    e = evals.t()
    roots, off = [], 0
    for l, d in enumerate(depths):
        odd = ((q & 1) == 1)[:, None]
        w = wits[l].t()
        e0 = torch.where(odd, w, e)
        e1 = torch.where(odd, e, w)
        node = sha256_pair_plain(sha256_words_plain(e0), sha256_words_plain(e1))
        roots.append(compute_root_plain(node, q >> 1, sibs[off:off + d].permute(2, 0, 1)))
        f0 = F.qm31_add(e0, e1)
        f1 = F.qm31_mul_m31(F.qm31_sub(e0, e1), cinvs[l])
        e = F.qm31_add(f0, F.qm31_mul(_per_lane(alphas[:, l], lanes), f1))
        q = q >> 1
        off += d
    return torch.stack(roots), e.t().contiguous(), q


def fri_all_layers_plain(queries, evals, wits, cinvs, alphas, sibs, roots,
                         depths):
    """Plain K5 on int64 words; arguments and results as
    ``ops/cuda/fri_kernel.fri_all_layers``."""
    cur, folded, q_out = fri_roots_plain(queries, evals, wits, cinvs, alphas,
                                         sibs, depths)
    want = _per_lane(roots, queries.shape[0]).transpose(0, 1)  # (L, lanes, 8)
    return (cur == want).all(dim=-1).to(WORD), folded, q_out


def leafwalk(evals, index, sibs, roots):
    """Stage V for every lane (see leafwalk_plain); int32 arrays in, ok
    (lanes,) int32 out."""
    if on_cuda(evals, "leafwalk"):
        return _fk.leafwalk(evals, index, sibs, roots)
    args = (from_i32(a) for a in (evals, index, sibs, roots))
    return to_i32(leafwalk_plain(*args))


def fri_all_layers(queries, evals, wits, cinvs, alphas, sibs, roots, depths):
    """All FRI layers for every lane (see ``ops/cuda/fri_kernel``); int32
    arrays in, (ok, folded, q_out) int32 out."""
    if on_cuda(queries, "fri_all_layers"):
        return _fk.fri_all_layers(queries, evals, wits, cinvs, alphas, sibs,
                                  roots, depths)
    args = (from_i32(a) for a in (queries, evals, wits, cinvs, alphas, sibs, roots))
    return tuple(to_i32(r) for r in fri_all_layers_plain(*args, depths))
