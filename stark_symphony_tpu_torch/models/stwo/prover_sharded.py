"""Domain-sharded stwo prover: the FRI phase with every layer's evaluation
array sharded over a mesh axis.

Port of ``stark_symphony_tpu/models/stwo/prover_sharded.py``.  Stages 1-6
(``prover._pre_fri``) run on the mesh's first device; then each FRI layer
is committed by ``parallel.fri_shard.stwo_commit_sharded`` and folded by
``sharded_fold``, one stage a layer, with the transcript (on the first
device) drawing each alpha from the root just mixed.  The fold is the
single-device prover's (``prover.fri_fold``): each shard multiplies by
its chunk of the layer's inverse twiddle table.  A layer is sharded
while it holds at least two values a shard and an even number of them
(n >= 2 D and n / D even); smaller layers commit and fold on the first
device, as the JAX package does.  The PoW grind, the query draw and the
decommitments are the single-device prover's, over the layers gathered
in tree order (``natural_levels_to_tree``).

The transcript is the single-device prover's, so the proof equals, word
for word, the committed fixture of the same (cfg, trace).  On a CUDA mesh
the leaves of a sharded layer take one K1 launch a shard and each of its
levels one K2 launch on each shard that keeps the level's nodes.

``prove_sharded(..., graphed=True)`` runs what the JAX package compiles
(``_pre_fri``, every sharded layer's commit and fold with their
exchanges, the grind) as the single-device prover's two CUDA graphs
around the grind (``prover.GraphedProver``): graph A from ``_pre_fri``
through the first PoW chunk, the shard streams of ``Mesh.run`` forked
from and joined to the capturing stream, so the exchanges and every
shard's launches lie inside it; graph B gathers the layers' levels in
tree order and decommits.  That needs every shard on one device; a mesh
over several devices raises ValueError.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.circle_fft import device_twiddles
from ...ops.u32 import from_numpy
from ...parallel.fri_shard import natural_levels_to_tree, sharded_fold, stwo_commit_sharded
from ...parallel.mesh import Mesh, unshard
from . import channel as ch
from .config import StwoConfig
from .prover import (
    GraphedProver,
    SegmentA,
    _commit_leaves,
    _decommit,
    _finish,
    _grind_chunk,
    _pre_fri,
    _to_numpy_proof,
    fri_fold,
    generate_trace,
)


def _sharded_layers(cfg: StwoConfig, n_dev: int) -> list:
    """For each FRI layer, whether it is sharded over n_dev shards: its n
    values hold at least two a shard and an even number of them."""
    ns = (1 << (cfg.lde_log_size - l) for l in range(1 + cfg.n_inner_layers))
    return [n >= 2 * n_dev and (n // n_dev) % 2 == 0 for n in ns]


def _commit_fri(cfg: StwoConfig, pre, mesh: Mesh, axis_name: str):
    """Stage 7 with each layer sharded where it is large enough: commit,
    draw alpha, fold.  Returns (state, layers, roots, last) as
    ``prover._commit_fri`` does, except that a sharded layer's levels are
    in natural index order (``_tree_layers`` gives the tree order)."""
    lde_log = cfg.lde_log_size
    dev = mesh.devices[0]

    def whole(x):
        return unshard(mesh, x, axis_name) if isinstance(x, list) else x

    state = ch.ChannelState(pre.state_digest, pre.state_counter)
    # the fold twiddles are the LDE domain's inverse tables, as in prove
    _, tw_inv = device_twiddles(lde_log, dev)
    cur = pre.first_layer  # (L, 4), natural order
    log = lde_log
    layers, roots = [], []
    for sharded in _sharded_layers(cfg, mesh.shape[axis_name]):
        n = 1 << log
        tw = tw_inv[lde_log - log][: n // 2]  # the fold pairs' twiddles, (n/2,)
        if sharded:
            root, levels = stwo_commit_sharded(cur, mesh, axis_name, return_levels=True)
        else:
            cur = whole(cur)
            levels, root = _commit_leaves(cur, log)
        layers.append((whole(cur), levels))
        roots.append(root)
        state = ch.mix_root(state, root)
        state, alpha, _ = ch.draw_qm31(state)
        if sharded:
            # a payload a position: shard d < D/2 folds positions of the
            # lower half, whose twiddles tw holds; the upper shards' chunk
            # (a second copy) goes unread
            cur, _ = sharded_fold(cur, [torch.cat([tw, tw])], [alpha], mesh, fold_fn=fri_fold,
                                  coord_step=None, n_stages=1, axis_name=axis_name)
        else:
            cur = fri_fold(cur[: n // 2], cur[n // 2:], tw, alpha)
        log -= 1
    return state, layers, roots, whole(cur)


def _tree_layers(cfg: StwoConfig, n_dev: int, layers) -> list:
    """``_commit_fri``'s layers with every sharded layer's levels in the
    tree order of ``merkle.build_tree``, as ``prover._decommit`` reads them."""
    out = []
    for l, ((values, levels), sharded) in enumerate(zip(layers, _sharded_layers(cfg, n_dev))):
        if sharded:
            levels = natural_levels_to_tree(levels, cfg.lde_log_size - l)
        out.append((values, levels))
    return out


def _segment_a(cfg: StwoConfig, mesh: Mesh, axis_name: str, trace, air: str) -> SegmentA:
    """Graph A of the sharded prover: stages 1-6, the sharded FRI loop,
    fri_last's mix and the first chunk of the PoW search."""
    pre = _pre_fri(cfg, trace, air)
    state, layers, roots, last = _commit_fri(cfg, pre, mesh, axis_name)
    state = ch.mix_words(state, last[0])
    return SegmentA(pre, state, layers, roots, last, _grind_chunk(cfg, state, 0))


def _segment_b(cfg: StwoConfig, n_dev: int, a: SegmentA, nonce):
    """Graph B: the levels in tree order, then stage 9 on A's outputs."""
    return _decommit(cfg, a.state, a.pre, _tree_layers(cfg, n_dev, a.layers), a.roots,
                     a.last[0], nonce)


def graphed_prover(cfg: StwoConfig, mesh: Mesh, axis_name: str, trace,
                   air: str = "wide_fibonacci") -> GraphedProver:
    """The sharded prover's GraphedProver of (cfg, air, axis_name) for
    `trace`'s shape and device, captured at its first use and cached in
    ``mesh.graphs``.  Raises ValueError where the mesh spans several
    devices: a shard stream of another device would not join the capture
    of the first."""
    if len(set(mesh.devices)) > 1:
        raise ValueError(
            f"prove_sharded(graphed=True) over devices {sorted(map(str, set(mesh.devices)))}: "
            "graph A is one capture on one device, and a shard stream of another device does "
            "not join it; run this mesh with graphed=False")
    n_dev = mesh.shape[axis_name]
    return mesh.graphs.get(
        ("stwo_prove_sharded", cfg, air, axis_name), (trace,),
        lambda: GraphedProver(cfg, trace, lambda t: _segment_a(cfg, mesh, axis_name, t, air),
                              lambda a, n: _segment_b(cfg, n_dev, a, n)))


def prove_sharded(cfg: StwoConfig, mesh: Mesh, axis_name: str = "sp",
                  trace: np.ndarray | None = None, air: str = "wide_fibonacci",
                  graphed: bool = False):
    """One stwo proof with the FRI phase domain-sharded over `mesh` axis
    `axis_name`.  `trace` (C, T) uint32 defaults to generate_trace(cfg,
    air=air).  `graphed`: replay the sharded prover's two graphs
    (``graphed_prover``), captured once per (cfg, air, axis_name) and
    trace spec on this mesh; the proof is the same.  Returns (StwoProof of
    numpy uint32 arrays, {"n_sharded_layers": k})."""
    if trace is None:
        trace = generate_trace(cfg, air=air)
    info = {"n_sharded_layers": sum(_sharded_layers(cfg, mesh.shape[axis_name]))}
    t = from_numpy(trace, mesh.devices[0])
    if graphed:
        return _to_numpy_proof(graphed_prover(cfg, mesh, axis_name, t, air)(t)), info
    pre = _pre_fri(cfg, t, air)
    state, layers, roots, last = _commit_fri(cfg, pre, mesh, axis_name)
    layers = _tree_layers(cfg, mesh.shape[axis_name], layers)
    return _to_numpy_proof(_finish(cfg, state, pre, layers, roots, last)), info
