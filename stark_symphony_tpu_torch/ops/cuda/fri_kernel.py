"""Python wrappers of the fused CUDA kernels K4 and K5 (``csrc/fri.cu``).

Counterpart of the public functions of
``stark_symphony_tpu/ops/pallas/fri_kernel.py``:

* K4 ``leafwalk``       replaces ``leafwalk_tiled``
* K5 ``fri_all_layers`` replaces ``fri_all_layers_tiled``

Both kernels are bound by 32-bit integer issue (see ``csrc/fri.cu``).
The wrappers do no relayout: they take the int32 word-major ``(W, lanes)``
arrays that a tiled batch (``models/stwo/tiled.py``) holds, lane =
b * Q + q, and per-proof roots and alphas ``(B, ...)`` that the kernels
read at b = lane // Q.  Each wrapper
checks device, dtype, shape and contiguity, allocates its outputs with
``torch.empty``, and launches on ``torch.cuda.current_stream()``.
``launches`` counts the launches of each kernel; nothing else changes it.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = {"leafwalk": 0, "fri_all_layers": 0}

MAX_LAYERS = 32  # csrc/fri.cu kMaxLayers


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(x: torch.Tensor, what: str, shape=None, device=None) -> None:
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor")
    if device is not None and x.device != device:
        raise ValueError(f"{what}: on {x.device}, the other operands on {device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32 word bit patterns, got {x.dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _queries_per_proof(lanes: int, n_proofs: int, what: str) -> int:
    if n_proofs < 1 or lanes % n_proofs:
        raise ValueError(f"{what}: {lanes} lanes are not {n_proofs} proofs of equal size")
    return lanes // n_proofs


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel `name` on `device`'s current stream and count it."""
    build.launch(name, device, *args)
    launches[name] += 1


def leafwalk(evals: torch.Tensor, index: torch.Tensor, sibs: torch.Tensor,
             roots: torch.Tensor) -> torch.Tensor:
    """K4: stage V for every lane: leaf = SHA-256 of the lane's column
    evals, walk its authentication path, compare with its proof's root.

    evals (n_words, lanes); index (lanes,); sibs (depth, 8, lanes), leaf
    level first; roots (B, 8) with lanes = B * Q.  All int32.  Returns ok
    (lanes,) int32 in {0, 1}."""
    _check(evals, "leafwalk evals")
    if evals.dim() != 2 or evals.shape[0] < 1:
        raise ValueError("leafwalk evals: expected (n_words >= 1, lanes)")
    n_words, lanes = evals.shape
    dev = evals.device
    _check(sibs, "leafwalk sibs", tuple(sibs.shape[:1]) + (8, lanes), dev)
    _check(index, "leafwalk index", (lanes,), dev)
    _check(roots, "leafwalk roots", tuple(roots.shape[:1]) + (8,), dev)
    depth = sibs.shape[0]
    n_q = _queries_per_proof(lanes, roots.shape[0], "leafwalk")
    ok = torch.empty(lanes, dtype=torch.int32, device=dev)
    if lanes:
        _launch("leafwalk", dev, evals, index, sibs, roots, ok,
                n_words, depth, n_q, lanes)
    return ok


def fri_all_layers(queries: torch.Tensor, evals: torch.Tensor,
                   wits: torch.Tensor, cinvs: torch.Tensor,
                   alphas: torch.Tensor, sibs: torch.Tensor,
                   roots: torch.Tensor, depths):
    """K5: all FRI layers of stage VII for every lane.

    queries (lanes,); evals (4, lanes), the stage-VI answers; wits
    (L, 4, lanes); cinvs (L, lanes), 1 / fold coordinate; alphas (B, L, 4);
    sibs (sum(depths), 8, lanes), layer after layer, leaf level first;
    roots (B, L, 8); depths: L per-layer path depths.  All int32, lanes =
    B * Q.  Returns (ok (L, lanes) in {0, 1}, folded (4, lanes),
    q_out (lanes,)), int32."""
    depths = tuple(int(d) for d in depths)
    n_layers = len(depths)
    if not 1 <= n_layers <= MAX_LAYERS or min(depths) < 0:
        raise ValueError(f"fri_all_layers: bad layer depths {depths}")
    _check(queries, "fri queries")
    if queries.dim() != 1:
        raise ValueError("fri queries: expected (lanes,)")
    lanes = queries.shape[0]
    dev = queries.device
    _check(evals, "fri evals", (4, lanes), dev)
    _check(wits, "fri wits", (n_layers, 4, lanes), dev)
    _check(cinvs, "fri cinvs", (n_layers, lanes), dev)
    _check(sibs, "fri sibs", (sum(depths), 8, lanes), dev)
    _check(roots, "fri roots", tuple(roots.shape[:1]) + (n_layers, 8), dev)
    n_proofs = roots.shape[0]
    _check(alphas, "fri alphas", (n_proofs, n_layers, 4), dev)
    n_q = _queries_per_proof(lanes, n_proofs, "fri_all_layers")
    ok = torch.empty((n_layers, lanes), dtype=torch.int32, device=dev)
    folded = torch.empty((4, lanes), dtype=torch.int32, device=dev)
    q_out = torch.empty(lanes, dtype=torch.int32, device=dev)
    if lanes:
        host_depths = (ctypes.c_int * n_layers)(*depths)
        _launch("fri_all_layers", dev, queries, evals, wits, cinvs, alphas,
                sibs, roots, ok, folded, q_out, ctypes.addressof(host_depths),
                n_layers, n_q, lanes)
    return ok, folded, q_out
