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
the device (``relayout``, the device half of ``tile_batch``, which the
port's stream, ``parallel/pipeline.py``, runs on its compute stream after
its own copy from pinned memory).  There is no host transpose and no lane padding: the kernels
mask their own ragged edge.  The field names are the JAX package's, so the
transcript stages read either package's batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops.u32 import from_i32, host_i32
from . import proof as P
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


def _word_major(xs) -> torch.Tensor:
    """int32 word tensors (B, Q, d_i, ...) on a device -> their word-major
    forms stacked along the first word axis, (sum d_i, ..., B*Q) int32 on
    that device: each is permuted by one device copy."""
    lanes = xs[0].shape[0] * xs[0].shape[1]
    rows = sum(x.shape[2] for x in xs)
    out = torch.empty((rows,) + tuple(xs[0].shape[3:]) + (lanes,), dtype=torch.int32,
                      device=xs[0].device)
    off = 0
    for x in xs:
        out[off:off + x.shape[2]].view(-1, lanes).copy_(x.reshape(lanes, -1).t())
        off += x.shape[2]
    return out


def relayout(words, cfg: StwoConfig) -> StwoTiledBatch:
    """A stacked (B, ...) proof batch of int32 word tensors on a device, as
    a proof's arrays travel from the host (``u32.host_i32``), -> a
    StwoTiledBatch on that device.  Only device work: the small arrays are
    widened, the per-query arrays permuted into the word-major layout."""
    if words.trace_evals.shape[1] != cfg.n_queries:
        raise ValueError(f"batch has {words.trace_evals.shape[1]} queries per "
                         f"proof, the config {cfg.n_queries}")
    return StwoTiledBatch(
        commitments=from_i32(words.commitments),
        oods_trace=from_i32(words.oods_trace),
        oods_cp=from_i32(words.oods_cp),
        fri_first_commit=from_i32(words.fri_first_commit),
        fri_inner_commits=from_i32(words.fri_inner_commits),
        fri_last=from_i32(words.fri_last),
        pow_nonce=from_i32(words.pow_nonce),
        trace_evals_t=_word_major([words.trace_evals]),
        cp_evals_t=_word_major([words.cp_evals]),
        trace_sibs_t=_word_major([words.trace_sibs]),
        cp_sibs_t=_word_major([words.cp_sibs]),
        # each witness (B, Q, 4) as (B, Q, 1, 4): one row of (L, 4, lanes)
        fri_wits_t=_word_major([w[:, :, None] for w in words.fri_witnesses]),
        fri_sibs_t=_word_major(words.fri_sibs),
    )


def tile_batch(proof, cfg: StwoConfig, device="cuda") -> StwoTiledBatch:
    """A stacked (B, ...) numpy proof batch (either package's StwoProof) ->
    a StwoTiledBatch on `device`: each array travels as it is stored, then
    ``relayout`` runs on the device."""
    return relayout(P.map_fields(lambda x: torch.from_numpy(host_i32(x)).to(device),
                                 P.StwoProof(*proof)), cfg)
