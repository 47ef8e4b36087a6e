"""Word-major (tiled) stwo proof batches for the fused-kernel fast path.

Port of ``stark_symphony_tpu/models/stwo/tiled.py``.  ``tile_batch`` carries
a stacked (B, ...) numpy proof batch to a device once, at ingestion, in the
layout the fused stages of ``ops/fri.py`` read:

* the small per-proof arrays (the transcript's inputs) as int64 words, as
  ``proof.to_torch`` sends them;
* every per-query array word-major, ``(..., W, lanes)`` contiguous int32
  bit patterns with lane = b * Q + q, so a (B, Q) <-> lane conversion is a
  free reshape.

The per-query arrays travel as they are stored, (B, Q, ..., W), viewed as
int32 without a host copy, and are permuted into the word-major layout on
the device.  There is no host transpose and no lane padding: the kernels
mask their own ragged edge.  The field names are the JAX package's, so the
transcript stages read either package's batch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...ops.u32 import from_numpy
from .config import StwoConfig


class StwoTiledBatch(NamedTuple):
    # small per-proof arrays, int64 words: transcript + OODS stages
    commitments: torch.Tensor        # (B, 3, 8)
    oods_trace: torch.Tensor         # (B, C, 4)
    oods_cp: torch.Tensor            # (B, 16, 4)
    fri_first_commit: torch.Tensor   # (B, 8)
    fri_inner_commits: torch.Tensor  # (B, L-1, 8)
    fri_last: torch.Tensor           # (B, 4)
    pow_nonce: torch.Tensor          # (B, 2)
    # per-query arrays, int32 word-major: lane = b * n_queries + q
    trace_evals_t: torch.Tensor      # (C, lanes)
    cp_evals_t: torch.Tensor         # (16, lanes)
    trace_sibs_t: torch.Tensor       # (D, 8, lanes)
    cp_sibs_t: torch.Tensor          # (D, 8, lanes)
    fri_wits_t: torch.Tensor         # (L, 4, lanes)
    fri_sibs_t: torch.Tensor         # (sum of layer depths, 8, lanes)


def _word_major(xs, device) -> torch.Tensor:
    """Numpy word arrays (B, Q, d_i, ...) -> their word-major forms stacked
    along the first word axis, (sum d_i, ..., B*Q) int32 on `device`.  Each
    array travels as it is stored and is permuted on the device."""
    lanes = xs[0].shape[0] * xs[0].shape[1]
    rows = sum(x.shape[2] for x in xs)
    out = torch.empty((rows,) + xs[0].shape[3:] + (lanes,), dtype=torch.int32,
                      device=device)
    off = 0
    for x in xs:
        raw = np.ascontiguousarray(x, dtype=np.uint32).view(np.int32)
        raw = torch.from_numpy(raw).to(device)
        out[off:off + x.shape[2]].view(-1, lanes).copy_(raw.reshape(lanes, -1).t())
        off += x.shape[2]
    return out


def tile_batch(proof, cfg: StwoConfig, device="cuda") -> StwoTiledBatch:
    """A stacked (B, ...) numpy proof batch (either package's StwoProof) ->
    a StwoTiledBatch on `device`."""
    if proof.trace_evals.shape[1] != cfg.n_queries:
        raise ValueError(f"batch has {proof.trace_evals.shape[1]} queries per "
                         f"proof, the config {cfg.n_queries}")
    small = lambda x: from_numpy(x, device)  # noqa: E731
    return StwoTiledBatch(
        commitments=small(proof.commitments),
        oods_trace=small(proof.oods_trace),
        oods_cp=small(proof.oods_cp),
        fri_first_commit=small(proof.fri_first_commit),
        fri_inner_commits=small(proof.fri_inner_commits),
        fri_last=small(proof.fri_last),
        pow_nonce=small(proof.pow_nonce),
        trace_evals_t=_word_major([proof.trace_evals], device),
        cp_evals_t=_word_major([proof.cp_evals], device),
        trace_sibs_t=_word_major([proof.trace_sibs], device),
        cp_sibs_t=_word_major([proof.cp_sibs], device),
        # each witness (B, Q, 4) as (B, Q, 1, 4): one row of (L, 4, lanes)
        fri_wits_t=_word_major([np.asarray(w)[:, :, None] for w in proof.fri_witnesses],
                               device),
        fri_sibs_t=_word_major(proof.fri_sibs, device),
    )
