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
around the grind (``prover.GraphedProver``), in one of two layouts
(``graphed_prover``):

* every shard on one device: graph A from ``_pre_fri`` through the first
  PoW chunk, the shard streams of ``Mesh.run`` forked from and joined to
  the capturing stream, so the exchanges and every shard's launches lie
  inside it; graph B gathers the layers' levels in tree order and
  decommits;
* a mesh over several devices (``per_shard_prover``; a shard stream of
  another device cannot join one capture): A is one graphed sharded call
  (``Mesh.graphed``), ``_pre_fri`` a graph on the first device, each
  sharded layer's leaf hash, levels and fold a graph on each shard that
  runs them, each transcript step a graph on the first device, and the
  small layers, ``fri_last``'s mix and the first PoW chunk one more
  there; the exchanges run eagerly between the replays.  B is the same
  graph on the first device, its inputs gathered there.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from ...ops.circle_fft import device_twiddles
from ...ops.u32 import from_numpy
from ...parallel.fri_shard import natural_levels_to_tree, sharded_fold, stwo_commit_sharded
from ...parallel.mesh import Mesh, ShardProgram, unshard
from ...tools import build as TB
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
    """For each FRI layer, whether it is sharded over n_dev shards: it and
    every layer before it hold at least two values a shard and an even
    number of them (n >= 2 D and n / D even)."""
    ns = (1 << (cfg.lde_log_size - l) for l in range(1 + cfg.n_inner_layers))
    sharded = list(itertools.takewhile(lambda n: n >= 2 * n_dev and (n // n_dev) % 2 == 0, ns))
    return [True] * len(sharded) + [False] * (1 + cfg.n_inner_layers - len(sharded))


def _draw_alpha(state: ch.ChannelState, root):
    """The transcript step after a layer's commit: mix its root, draw the
    fold's alpha.  Returns (state, alpha)."""
    state, alpha, _ = ch.draw_qm31(ch.mix_root(state, root))
    return state, alpha


@functools.lru_cache(maxsize=None)
def _fold_payload(lde_log: int, log: int, device) -> torch.Tensor:
    """The fold twiddles of a sharded layer of log `log`, a payload a
    position: shard d < D/2 folds positions of the lower half, whose
    twiddles the first half holds; the upper shards' chunk (a second
    copy) goes unread."""
    tw = device_twiddles(lde_log, device)[1][lde_log - log][: 1 << (log - 1)]
    return torch.cat([tw, tw])


def _sharded_fri(cfg: StwoConfig, pre, mesh: Mesh, axis_name: str, graphed: bool = False):
    """Stage 7's sharded layers, the large ones at its start: commit, draw
    alpha, fold.  Returns (state, layers, roots, cur, log): layers as
    ``prover._commit_fri`` gives them, except that their levels are in
    natural index order (``_tree_layers`` gives the tree order); cur the
    sharded values left, of log `log`.  `graphed`: the per-shard layout's,
    each commit and fold a graphed sharded call and each transcript step a
    graph on the first device."""
    lde_log = cfg.lde_log_size
    state = ch.ChannelState(pre.state_digest, pre.state_counter)
    draw = functools.partial(mesh.run_first, _draw_alpha) if graphed else _draw_alpha
    cur, log = pre.first_layer, lde_log  # (L, 4), natural order
    layers, roots = [], []
    for _ in range(sum(_sharded_layers(cfg, mesh.shape[axis_name]))):
        root, levels = stwo_commit_sharded(cur, mesh, axis_name, return_levels=True,
                                           graphed=graphed)
        layers.append((_whole(mesh, cur, axis_name), levels))
        roots.append(root)
        state, alpha = draw(state, root)
        cur, _ = sharded_fold(cur, [_fold_payload(lde_log, log, mesh.devices[0])], [alpha], mesh,
                              fold_fn=fri_fold, coord_step=None, n_stages=1,
                              axis_name=axis_name, graphed=graphed)
        log -= 1
    return state, layers, roots, cur, log


def _whole(mesh: Mesh, x, axis_name: str):
    return unshard(mesh, x, axis_name) if isinstance(x, list) else x


def _small_fri(cfg: StwoConfig, state, cur, log: int):
    """Stage 7's layers too small to shard, after the sharded ones, on
    the first device as the single-device prover runs them: (state,
    layers, roots, last)."""
    lde_log = cfg.lde_log_size
    _, tw_inv = device_twiddles(lde_log, cur.device)
    layers, roots = [], []
    for log in range(log, lde_log - cfg.n_inner_layers - 1, -1):
        n = 1 << log
        levels, root = _commit_leaves(cur, log)
        layers.append((cur, levels))
        roots.append(root)
        state, alpha = _draw_alpha(state, root)
        cur = fri_fold(cur[: n // 2], cur[n // 2:], tw_inv[lde_log - log][: n // 2], alpha)
    return state, layers, roots, cur


def _commit_fri(cfg: StwoConfig, pre, mesh: Mesh, axis_name: str):
    """Stage 7 with each layer sharded where it is large enough.  Returns
    (state, layers, roots, last) as ``prover._commit_fri`` does, except
    that a sharded layer's levels are in natural index order."""
    state, layers, roots, cur, log = _sharded_fri(cfg, pre, mesh, axis_name)
    state, small, small_roots, last = _small_fri(cfg, state, _whole(mesh, cur, axis_name), log)
    return state, layers + small, roots + small_roots, last


def _fri_tail(cfg: StwoConfig, state, cur, log: int):
    """The small layers, fri_last's mix and the first chunk of the PoW
    search: (state, layers, roots, last, the chunk's (found, hi, lo))."""
    state, layers, roots, last = _small_fri(cfg, state, cur, log)
    state = ch.mix_words(state, last[0])
    return state, layers, roots, last, _grind_chunk(cfg, state, 0)


def _tree_layers(cfg: StwoConfig, n_dev: int, layers) -> list:
    """``_commit_fri``'s layers with every sharded layer's levels in the
    tree order of ``merkle.build_tree``, as ``prover._decommit`` reads them."""
    out = []
    for l, ((values, levels), sharded) in enumerate(zip(layers, _sharded_layers(cfg, n_dev))):
        if sharded:
            levels = natural_levels_to_tree(levels, cfg.lde_log_size - l)
        out.append((values, levels))
    return out


def _segment_a(cfg: StwoConfig, mesh: Mesh, axis_name: str, trace, air: str,
               per_shard: bool = False) -> SegmentA:
    """Graph A's work: stages 1-6, the sharded FRI loop, the small layers,
    fri_last's mix and the first chunk of the PoW search.  `per_shard`:
    the layout over several devices, inside a graphed sharded call: the
    work on the first device in graphs there (``Mesh.run_first``), the
    commits and folds graphed."""
    def first(fn, *args):
        return mesh.run_first(fn, *args) if per_shard else fn(*args)

    pre = first(lambda t: _pre_fri(cfg, t, air), trace)
    state, layers, roots, cur, log = _sharded_fri(cfg, pre, mesh, axis_name, per_shard)
    state, small, small_roots, last, grind = first(lambda st, c: _fri_tail(cfg, st, c, log),
                                                   state, _whole(mesh, cur, axis_name))
    return SegmentA(pre, state, layers + small, roots + small_roots, last, grind)


def _segment_b(cfg: StwoConfig, n_dev: int, a: SegmentA, nonce):
    """Graph B: the levels in tree order, then stage 9 on A's outputs."""
    return _decommit(cfg, a.state, a.pre, _tree_layers(cfg, n_dev, a.layers), a.roots,
                     a.last[0], nonce)


class _PerShardA:
    """Graph A of the per-shard layout: ``_segment_a(per_shard=True)`` as
    one graphed sharded call, a ShardProgram of its own, captured at its
    first ``replay`` (which also replays it: that call's result is
    whole).  ``replay(trace)`` runs it and copies what it leaves into
    ``out``, a SegmentA on the first device whose tensors stay in place
    from call to call, so graph B reads them in place: that copy is the
    gather of the sharded layers' levels.  ``pool``: shard 0's, which B
    shares, replaying after all of A."""

    def __init__(self, cfg: StwoConfig, mesh: Mesh, axis_name: str, air: str):
        self.segment = lambda t: _segment_a(cfg, mesh, axis_name, t, air, per_shard=True)
        self.program = ShardProgram(mesh)
        self.device = mesh.devices[0]
        self.out = None

    @property
    def pool(self):
        return self.program.pools.get(0)

    def replay(self, trace) -> SegmentA:
        with self.program:
            a = self.segment(trace)
        if self.out is None:
            self.out = TB.tree_map(lambda x: x.to(self.device, copy=True)
                                   if isinstance(x, torch.Tensor) else x, a)
        else:
            TB.tree_map(lambda o, x: o.copy_(x) if isinstance(o, torch.Tensor) else None,
                        self.out, a)
        return self.out


def per_shard_layout(mesh: Mesh) -> bool:
    """Whether ``graphed_prover`` takes the per-shard layout on `mesh`:
    where its shards span several devices."""
    return len(set(mesh.devices)) > 1


def graphed_prover(cfg: StwoConfig, mesh: Mesh, axis_name: str, trace,
                   air: str = "wide_fibonacci") -> GraphedProver:
    """The sharded prover's GraphedProver of (cfg, air, axis_name) for
    `trace`'s shape and device, captured at its first use and cached in
    ``mesh.graphs``: graph A as one capture where every shard is on one
    device, else ``per_shard_prover``'s layout."""
    if per_shard_layout(mesh):
        return per_shard_prover(cfg, mesh, axis_name, trace, air)
    n_dev = mesh.shape[axis_name]
    return mesh.graphs.get(
        ("stwo_prove_sharded", cfg, air, axis_name), (trace,),
        lambda: GraphedProver(cfg, TB.capture(lambda t: _segment_a(cfg, mesh, axis_name, t, air),
                                              (trace,), warmup=1),
                              lambda a, n: _segment_b(cfg, n_dev, a, n)))


def per_shard_prover(cfg: StwoConfig, mesh: Mesh, axis_name: str, trace,
                     air: str = "wide_fibonacci") -> GraphedProver:
    """The sharded prover's GraphedProver in the per-shard layout (see the
    module docstring), on any mesh, its shards on one device or several:
    ``graphed_prover`` takes it over several.  Captured at its first use
    and cached in ``mesh.graphs`` by (cfg, air, axis_name) and `trace`'s
    spec."""
    n_dev = mesh.shape[axis_name]
    return mesh.graphs.get(
        ("stwo_prove_sharded_per_shard", cfg, air, axis_name), (trace,),
        lambda: GraphedProver(cfg, _PerShardA(cfg, mesh, axis_name, air),
                              lambda a, n: _segment_b(cfg, n_dev, a, n)))


def prove_sharded(cfg: StwoConfig, mesh: Mesh, axis_name: str = "sp",
                  trace: np.ndarray | None = None, air: str = "wide_fibonacci",
                  graphed: bool = False):
    """One stwo proof with the FRI phase domain-sharded over `mesh` axis
    `axis_name`.  `trace` (C, T) uint32 defaults to generate_trace(cfg,
    air=air).  `graphed`: replay the sharded prover's graphs
    (``graphed_prover``: graph A as one capture on a mesh of one device,
    the per-shard layout over several), captured once per (cfg, air,
    axis_name) and trace spec on this mesh; the proof is the same; a
    capture that fails on CUDA raises.  Returns (StwoProof of
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
