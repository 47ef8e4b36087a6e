"""Fold-stage parallelism: FRI layers sharded across devices by position.

Port of ``stark_symphony_tpu/parallel/fri_shard.py`` onto the
single-controller mesh of ``parallel/mesh.py``.  One FRI layer's whole
evaluation array is split over a mesh axis in contiguous chunks (natural
position order), and every fold stage exchanges siblings between shards.

Exchange pattern (D shards, chunk C = N/D), the JAX package's:

* fold pairs (i, i + N/2): the sibling of every element of shard d's chunk
  lies in shard (d + D/2)'s chunk, so ONE ppermute (the rotation by D/2)
  delivers all siblings; shards d < D/2 hold the folded output.  JAX's
  SPMD body also folds on the upper half and drops the result; here the
  controller folds on the lower half alone.
* rebalance: the folded array (N/2 values on D/2 shards) is split back
  over all D shards: shard d < D/2 sends its lower and upper half-chunk
  to shards 2d and 2d+1 (two ppermutes).  Every stage stays balanced and
  the traffic halves with the domain.

``stwo_commit_sharded`` builds a layer's Merkle tree the same way: the
adjacent bit-reversed leaf slots (2t, 2t+1) are the natural positions
(i, i + N/2), so the tree rises in natural-index order with one sibling
ppermute, one K2 launch a shard and one rebalance a level; the top
log2(D) levels follow a gather of one digest a shard, computed once on
the mesh's first device.  Its root equals ``prover._commit_leaves``'s.

The sharded functions take a whole tensor (split over the axis first) or
an already sharded value, and return sharded values:
``mesh.unshard`` gathers one.  With ``graphed=True`` each is one graphed
sharded call (``Mesh.graphed``), as JAX compiles it with ``jax.jit(
shard_map(...))``: every fold stage's body, every leaf hash, every
level's nodes and the top levels replay from a graph on their shard's
device, captured at the first call of a key and input specs; the fold
randomness and the coordinates enter each graph as static inputs, copied
in at every replay; the exchanges run eagerly between the replays.  The
result is the eager call's, word for word.
"""

from __future__ import annotations

import contextlib

import torch

from ..models.stwo import prover
from ..ops import field as F
from ..ops import field101 as F101
from ..ops.sha256 import sha256_pair, sha256_words
from ..ops.u32 import WORD, from_numpy
from .mesh import Mesh, ppermute, unshard


def _sharded(mesh: Mesh, x, axis: str) -> list:
    return x if isinstance(x, list) else mesh.shard(x, axis)


def _call(mesh: Mesh, graphed: bool, key, args):
    """The context of a sharded call: a graphed one (``Mesh.graphed``) or
    none."""
    return mesh.graphed(key, args) if graphed else contextlib.nullcontext()


def _lower_half(mesh: Mesh, axis: str) -> list:
    """Per shard, whether it holds output after a fold (index < D/2)."""
    n_dev = mesh.shape[axis]
    return [d < n_dev // 2 for d in mesh.axis_index(axis)]


def _sibling_perm(n_dev: int) -> list:
    return [((d + n_dev // 2) % n_dev, d) for d in range(n_dev)]


def _rebalance(mesh: Mesh, chunks: list, axis: str) -> list:
    """Redistribute the folded halves (held by the shards d < D/2 of each
    group) so that every shard holds an equal contiguous chunk again."""
    n_dev = mesh.shape[axis]
    lo = [None if c is None else c[: c.shape[0] // 2] for c in chunks]
    hi = [None if c is None else c[c.shape[0] // 2:] for c in chunks]
    recv_lo = ppermute(mesh, lo, axis, [(d, 2 * d) for d in range(n_dev // 2)])
    recv_hi = ppermute(mesh, hi, axis, [(d, 2 * d + 1) for d in range(n_dev // 2)])
    return [recv_lo[i] if d % 2 == 0 else recv_hi[i]
            for i, d in enumerate(mesh.axis_index(axis))]


def sharded_fold(values, coords, betas, mesh: Mesh, *, fold_fn, coord_step,
                 n_stages: int, axis_name: str = "sp", graphed: bool = False):
    """Run `n_stages` FRI fold stages with the evaluation domain sharded
    over `mesh` axis `axis_name`.

    values: (N, ...) layer evaluations in natural position order; coords:
    (N, ...) a fold coordinate payload a position, folded alongside by
    `coord_step` (a whole tensor each, or sharded values); betas: one fold
    randomness a stage (tensors or ints).  fold_fn(a, b, coord, beta) with
    a = v[i], b = v[i + N/2], coord = coords[i]; coord_step(coords) ->
    the next layer's coords at the same positions.  Either may be a list of
    n_stages functions.  With coord_step None, coords is a list of one
    payload a stage instead, stage s's over the N/2^s positions of its
    layer, and nothing is carried from stage to stage.  Needs an even axis
    and N / D divisible by 2**n_stages.  Returns (values', coords') of
    N / 2**n_stages positions, sharded the same way (coords' None with
    coord_step None).  `graphed`: each stage's body replays from a graph a
    shard that keeps the fold, the betas and coords its static inputs;
    the graphs are kept by the functions, the stage count and the inputs'
    specs."""
    n_dev = mesh.shape[axis_name]
    v = _sharded(mesh, values, axis_name)
    per_stage = coord_step is None
    x = None if per_stage else _sharded(mesh, coords, axis_name)
    chunk = v[0].shape[0]
    if n_dev % 2:
        raise ValueError(f"sharded_fold: the {axis_name!r} axis has {n_dev} shards, not an "
                         "even number")
    if chunk % (1 << n_stages):
        raise ValueError(f"sharded_fold: chunk {chunk} not divisible by 2**{n_stages}; "
                         "fewer stages or fewer shards")
    fold_fns = list(fold_fn) if isinstance(fold_fn, (list, tuple)) else [fold_fn] * n_stages
    steps = (list(coord_step) if isinstance(coord_step, (list, tuple))
             else [coord_step] * n_stages)
    betas = [torch.as_tensor(b, dtype=WORD) for b in betas]
    low = _lower_half(mesh, axis_name)
    key = ("sharded_fold", axis_name, n_stages, tuple(fold_fns), tuple(steps))
    with _call(mesh, graphed, key, (v, coords if per_stage else x, betas)):
        for s in range(n_stages):
            if per_stage:
                x = _sharded(mesh, coords[s], axis_name)
            sib = ppermute(mesh, v, axis_name, _sibling_perm(n_dev))
            betas_s = [betas[s].to(dev) for dev in mesh.devices]

            def stage(a, b, pt, bt, s=s):
                return fold_fns[s](a, b, pt, bt), None if per_stage else steps[s](pt)

            out = mesh.run(stage, v, sib, x, betas_s, where=low)
            v = _rebalance(mesh, [None if o is None else o[0] for o in out], axis_name)
            if not per_stage:
                x = _rebalance(mesh, [None if o is None else o[1] for o in out], axis_name)
    return v, None if per_stage else x


# stark101: out[i] = (a+b)/2 + beta*(a-b)/(2*x_i), x <- x^2

_INV2 = pow(2, F101.Q - 2, F101.Q)


def _stark101_fold(a, b, x_inv, beta):
    op0 = F101.f_mul(F101.f_add(a, b), _INV2)
    op1 = F101.f_mul(F101.f_mul(F101.f_sub(a, b), _INV2), x_inv)
    return F101.f_add(op0, F101.f_mul(op1, beta))


def _stark101_square(x):
    return F101.f_mul(x, x)


def stark101_fold_reference(values, x_invs, betas, n_stages: int):
    """Single-device oracle of the sharded fold."""
    v, x = values, x_invs
    for s in range(n_stages):
        half = v.shape[0] // 2
        beta = torch.as_tensor(betas[s], dtype=WORD).to(v.device)
        v = _stark101_fold(v[:half], v[half:], x[:half], beta)
        x = _stark101_square(x)[:half]
    return v, x


def stark101_fold_sharded(values, x_invs, betas, mesh: Mesh, n_stages: int,
                          axis_name: str = "sp", graphed: bool = False):
    """The stark101 FRI fold with the LDE domain sharded over `axis_name`
    (`graphed`: as ``sharded_fold``'s)."""
    return sharded_fold(values, x_invs, betas, mesh, fold_fn=_stark101_fold,
                        coord_step=_stark101_square, n_stages=n_stages,
                        axis_name=axis_name, graphed=graphed)


# stwo: the circle fold (divide by y), then line folds (divide by x, with
# x <- pi(x) = 2x^2 - 1); the payload is the (x, y) M31 point a position.


def _stwo_fold(a, b, coord, alpha):
    f0 = F.qm31_add(a, b)
    f1 = F.qm31_mul_m31(F.qm31_sub(a, b), F.m31_inv(coord))
    return F.qm31_add(f0, F.qm31_mul(alpha.expand(f1.shape), f1))


def _stwo_circle_fold(a, b, pt, alpha):
    return _stwo_fold(a, b, pt[..., 1], alpha)


def _stwo_line_fold(a, b, pt, alpha):
    return _stwo_fold(a, b, pt[..., 0], alpha)


def _stwo_pi_step(pt):
    x = pt[..., 0]
    x2 = F.m31_sqr(x)
    pi_x = F.m31_sub(F.m31_add(x2, x2), torch.ones_like(x))
    return torch.stack([pi_x, pt[..., 1]], dim=-1)


def _same_points(pt):
    return pt


def stwo_domain_points(lde_log: int):
    """(N, 2) uint32 M31 points of the canonic circle domain, natural
    position order (the prover's host table)."""
    return prover._domain_points_host(lde_log)


def stwo_fold_reference(values, points, alphas, n_stages: int):
    """Single-device oracle of the sharded stwo fold, bit-equal to the
    prover's fold loop."""
    v = values
    pts = points.to(v.device) if isinstance(points, torch.Tensor) else from_numpy(points, v.device)
    for s in range(n_stages):
        half = v.shape[0] // 2
        alpha = torch.as_tensor(alphas[s], dtype=WORD).to(v.device)
        fold = _stwo_circle_fold if s == 0 else _stwo_line_fold
        v = fold(v[:half], v[half:], pts[:half], alpha)
        pts = pts[:half] if s == 0 else _stwo_pi_step(pts[:half])
    return v


def stwo_fold_sharded(values, alphas, lde_log: int, mesh: Mesh, n_stages: int,
                      axis_name: str = "sp", graphed: bool = False):
    """stwo FRI folds (circle, then line) with the LDE domain sharded over
    `axis_name`: a stage is one sibling ppermute and a rebalance.

    values: (N, 4) QM31 first-layer evaluations in natural position order
    (whole or sharded); alphas: n_stages (4,) fold randomness values.
    `graphed`: as ``sharded_fold``'s.  Returns the folded values, sharded."""
    v = _sharded(mesh, values, axis_name)
    n = sum(v[i].shape[0] for i in mesh.groups(axis_name)[0])
    if n != 1 << lde_log:
        raise ValueError(f"stwo_fold_sharded: {n} values on an LDE domain of 2^{lde_log}")
    points = prover._domain_points(lde_log, mesh.devices[0])
    fold_fns = [_stwo_circle_fold] + [_stwo_line_fold] * (n_stages - 1)
    steps = [_same_points] + [_stwo_pi_step] * (n_stages - 1)
    out, _ = sharded_fold(v, points, alphas, mesh, fold_fn=fold_fns, coord_step=steps,
                          n_stages=n_stages, axis_name=axis_name, graphed=graphed)
    return out


def _top_levels(top):
    """The levels above a (D, 8) row of digests, up to the (1, 8) root."""
    levels = []
    while top.shape[0] > 1:
        half = top.shape[0] // 2
        top = sha256_pair(top[:half], top[half:])
        levels.append(top)
    return levels


def stwo_commit_sharded(values, mesh: Mesh, axis_name: str = "sp",
                        return_levels: bool = False, graphed: bool = False):
    """Merkle root of a sharded stwo FRI or trace layer.

    values: (N, W) M31/QM31 leaf words in NATURAL position order (leaf s
    of the tree is the SHA-256 of values[bit_reverse(s)]), whole or
    sharded.  On a CUDA mesh: one K1 launch a shard for the leaves, then a
    level at a time one sibling ppermute, one K2 launch on each shard that
    keeps the level's nodes, and a rebalance; the top log2(D) levels are
    one K2 launch each on the mesh's first device.  `graphed`: the leaf
    hash, each level's nodes and the top levels replay from graphs, kept
    by the axis and the leaves' specs.

    Returns the (8,) root on the mesh's first device; with
    `return_levels` also the levels in NATURAL index order, leaves first:
    a level of N/2^l >= D digests as its D shards (axis order), a smaller
    one as one (N/2^l, 8) tensor on the first device
    (``natural_levels_to_tree`` gives the tree order)."""
    n_dev = mesh.shape[axis_name]
    shards = _sharded(mesh, values, axis_name)
    n = n_dev * shards[0].shape[0]
    if n_dev % 2 or n < 2 * n_dev:
        raise ValueError(f"stwo_commit_sharded: {n} leaves over {n_dev} shards; needs an "
                         "even axis and at least 2 leaves a shard")
    n_dist_levels = (n // n_dev).bit_length() - 1  # size n -> size n_dev
    low = _lower_half(mesh, axis_name)
    group = mesh.groups(axis_name)[0]

    with _call(mesh, graphed, ("stwo_commit_sharded", axis_name), (shards,)):
        cur = mesh.run(sha256_words, shards)
        levels = [[cur[i] for i in group]]
        for _ in range(n_dist_levels):
            sib = ppermute(mesh, cur, axis_name, _sibling_perm(n_dev))
            # natural-order node: left = this shard's chunk (d < D/2), right =
            # the sibling from shard d + D/2
            node = mesh.run(sha256_pair, cur, sib, where=low)
            cur = _rebalance(mesh, node, axis_name)
            levels.append([cur[i] for i in group])
        # JAX all_gathers one digest a shard; the first device's copy is the one read
        levels += mesh.run_first(_top_levels, unshard(mesh, cur, axis_name))
    root = levels[-1][0]
    return (root, levels) if return_levels else root


def natural_levels_to_tree(levels, log: int) -> list:
    """Natural-index-order levels (``stwo_commit_sharded``) in the
    bit-reversed-leaf tree order of ``merkle.build_tree``, each one tensor
    on the device of its first shard, so ``merkle.gather_path`` works
    unchanged."""
    out = []
    for l, lvl in enumerate(levels):
        arr = torch.cat([t.to(lvl[0].device) for t in lvl]) if isinstance(lvl, list) else lvl
        m_log = log - l
        out.append(arr[prover._leaf_perm(m_log, arr.device)] if m_log > 0 else arr)
    return out

