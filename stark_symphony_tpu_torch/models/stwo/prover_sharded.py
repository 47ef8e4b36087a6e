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
decommitments are the single-device prover's (``prover._finish``), over
the layers gathered in tree order (``natural_levels_to_tree``).

The transcript is the single-device prover's, so the proof equals, word
for word, the committed fixture of the same (cfg, trace).  On a CUDA mesh
the leaves of a sharded layer take one K1 launch a shard and each of its
levels one K2 launch on each shard that keeps the level's nodes.
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
    _commit_leaves,
    _finish,
    _pre_fri,
    _to_numpy_proof,
    fri_fold,
    generate_trace,
)


def prove_sharded(cfg: StwoConfig, mesh: Mesh, axis_name: str = "sp",
                  trace: np.ndarray | None = None, air: str = "wide_fibonacci"):
    """One stwo proof with the FRI phase domain-sharded over `mesh` axis
    `axis_name`.  `trace` (C, T) uint32 defaults to generate_trace(cfg,
    air=air).  Returns (StwoProof of numpy uint32 arrays,
    {"n_sharded_layers": k})."""
    if trace is None:
        trace = generate_trace(cfg, air=air)
    lde_log = cfg.lde_log_size
    n_dev = mesh.shape[axis_name]
    dev = mesh.devices[0]

    def whole(x):
        return unshard(mesh, x, axis_name) if isinstance(x, list) else x

    pre = _pre_fri(cfg, from_numpy(trace, dev), air)
    state = ch.ChannelState(pre.state_digest, pre.state_counter)

    # FRI: a sharded commit and fold a layer, the transcript interleaved;
    # the fold twiddles are the LDE domain's inverse tables, as in prove
    _, tw_inv = device_twiddles(lde_log, dev)
    cur = pre.first_layer  # (L, 4), natural order
    log = lde_log
    layers, roots = [], []
    n_sharded = 0
    for _ in range(1 + cfg.n_inner_layers):
        n = 1 << log
        tw = tw_inv[lde_log - log][: n // 2]  # the fold pairs' twiddles, (n/2,)
        sharded = n >= 2 * n_dev and (n // n_dev) % 2 == 0
        if sharded:
            n_sharded += 1
            root, levels_nat = stwo_commit_sharded(cur, mesh, axis_name, return_levels=True)
            levels = natural_levels_to_tree(levels_nat, log)
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
    proof = _finish(cfg, state, pre, layers, roots, whole(cur))
    return _to_numpy_proof(proof), {"n_sharded_layers": n_sharded}
