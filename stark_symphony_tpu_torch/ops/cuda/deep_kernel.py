"""Python wrapper of the CUDA kernel K6 (``csrc/deep.cu``): stage VI of the
stwo verifier, the DEEP quotients of every (proof, query) lane.

K6 replaces no Pallas kernel: the JAX package leaves stage VI
(``models/stwo/verifier.py`` ``fri_answers``) to XLA's fusion of its field
code.  It computes what ``verifier.fri_answers_plain`` does, bit for bit,
on the verifier's int64 words read in place, lane-major, lane = b * Q + q,
with the leading batch axes flattened into B.  The wrapper checks device,
dtype, shape and contiguity, allocates the output with ``torch.empty`` and
launches once on ``torch.cuda.current_stream()``: no host sync, so the
launch captures into a CUDA graph.  ``launches`` counts its launches;
nothing else changes it.
"""

from __future__ import annotations

import math

import torch

from ..u32 import WORD
from . import build

launches = {"deep_quotients": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_device(x: torch.Tensor, what: str, device=None) -> None:
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor")
    if device is not None and x.device != device:
        raise ValueError(f"{what}: on {x.device}, the other operands on {device}")


def _check(x: torch.Tensor, what: str, shape, device=None) -> None:
    _check_device(x, what, device)
    if x.dtype != WORD:
        raise TypeError(f"{what}: expected int64 words, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel `name` on `device`'s current stream and count it."""
    build.launch(name, device, *args)
    launches[name] += 1


def deep_quotients(pts, trace_evals, cp_evals, random_coeff, oods_point,
                   oods_trace, oods_cp) -> torch.Tensor:
    """K6: the DEEP quotients of stage VI, ``fri_answers``' (..., Q, 4).

    pts (..., Q, 2), the query points; trace_evals (..., Q, C); cp_evals
    (..., Q, K); per proof random_coeff (..., 4), oods_point (..., 2, 4),
    oods_trace (..., C, 4), oods_cp (..., K, 4).  All int64 words on one
    CUDA device, contiguous.  Returns int64 words in [0, 2^32)."""
    if not isinstance(pts, torch.Tensor) or pts.dim() < 2 or pts.shape[-1] != 2:
        raise ValueError("deep_quotients pts: expected (..., Q, 2)")
    lead, n_q = tuple(pts.shape[:-2]), pts.shape[-2]
    if trace_evals.dim() != len(lead) + 2 or cp_evals.dim() != len(lead) + 2:
        raise ValueError("deep_quotients evals: expected (..., Q, C) and (..., Q, K)")
    n_cols, n_parts = trace_evals.shape[-1], cp_evals.shape[-1]
    dev = pts.device
    _check(pts, "deep_quotients pts", lead + (n_q, 2))
    _check(trace_evals, "deep_quotients trace_evals", lead + (n_q, n_cols), dev)
    _check(cp_evals, "deep_quotients cp_evals", lead + (n_q, n_parts), dev)
    _check(random_coeff, "deep_quotients random_coeff", lead + (4,), dev)
    _check(oods_point, "deep_quotients oods_point", lead + (2, 4), dev)
    _check(oods_trace, "deep_quotients oods_trace", lead + (n_cols, 4), dev)
    _check(oods_cp, "deep_quotients oods_cp", lead + (n_parts, 4), dev)
    lanes = math.prod(lead) * n_q
    out = torch.empty(lead + (n_q, 4), dtype=WORD, device=dev)
    if lanes:
        _launch("deep_quotients", dev, pts, trace_evals, cp_evals, random_coeff,
                oods_point, oods_trace, oods_cp, out, n_cols, n_parts, n_q, lanes)
    return out
