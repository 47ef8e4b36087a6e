"""Batched stark101 (FibonacciSq) verifier over int64 word tensors.

Port of ``stark_symphony_tpu/models/stark101/verifier.py``, mask for mask:
mix the trace root -> draw 3 CP coefficients -> replay the FRI commitments
(mix each root, draw and check each beta) -> draw the query index ->
Merkle-checked trace reads -> composition polynomial at x -> FRI layer
walk.  A proof's tensors carry leading batch axes (as the JAX function
does under vmap), and every check is a mask, so a bad proof never stops the
batch.

On a CUDA device the SHA-256 calls run in kernel K1 (31 launches a batch:
the transcript and the two leaf batches) and the two Merkle walks in K3
(the trace walk at depth 13 on 3 lanes a proof; the FRI walk on 20 lanes a
proof at depths 13..4, read by the kernel at lane % 20).  The field
arithmetic is eager PyTorch.

``verify`` runs in four device spans (``utils/trace.device_span``) that
cover its body: ``dev.stark101.transcript`` (genesis through the query
draw), ``dev.stark101.trace_merkle`` (the trace leaves, the walk and its
three mixes), ``dev.stark101.fold`` (``x``, ``compose`` and the fold
loop) and ``dev.stark101.fri_merkle`` (the leaf digests, the padded walk
and ``fri_last``).
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops import field101 as F
from ...ops import merkle
from ...ops.sha256 import sha256_words
from ...ops.u32 import WORD, const
from ...utils.trace import device_span
from . import channel as ch
from .config import Stark101Config


def _pow_dyn(base: int, exponent, n_bits: int):
    """base^exponent for a host-constant base and a word-tensor exponent
    below 2^n_bits: n_bits conditional multiplies by host powers
    base^(2^k)."""
    table = [pow(base, 1 << k, F.Q) for k in range(n_bits)]
    res = (exponent & 1) * (table[0] - 1) + 1  # table[0] where bit 0 is set, else 1
    for k in range(1, n_bits):
        bit = ((exponent >> k) & 1) == 1
        res = torch.where(bit, F.f_mul(res, table[k]), res)
    return res


def compose(cfg: Stark101Config, x, coeffs, f_x, f_gx, f_ggx):
    """The composition polynomial at x.  Its three constraint divisions
    share one batched inversion (f_inv_many)."""
    a0, a1, a2 = coeffs
    g1021, g1022, g1023 = cfg.g_pow(1021), cfg.g_pow(1022), cfg.g_pow(1023)
    den0 = F.f_sub(x, 1)
    den1 = F.f_sub(x, g1022)
    den2 = F.f_sub(F.f_pow(x, cfg.domain_size), 1)
    inv0, inv1, inv2 = F.f_inv_many([den0, den1, den2])
    p0 = F.f_mul(F.f_sub(f_x, 1), inv0)
    p1 = F.f_mul(F.f_sub(f_x, cfg.boundary1), inv1)
    num0 = F.f_sub(f_ggx, F.f_add(F.f_mul(f_x, f_x), F.f_mul(f_gx, f_gx)))
    num1 = F.f_mul(F.f_mul(F.f_sub(x, g1021), den1), F.f_sub(x, g1023))
    p2 = F.f_mul(F.f_mul(num0, num1), inv2)
    return F.f_add(F.f_add(F.f_mul(p0, a0), F.f_mul(p1, a1)), F.f_mul(p2, a2))


def _fri_depths(cfg: Stark101Config) -> np.ndarray:
    """The true depths of the 2L FRI paths, two a layer: 13, 13, 12, ..."""
    return np.repeat(cfg.log_domain_ex - np.arange(cfg.n_fri_layers), 2)


def verify(proof, cfg: Stark101Config = Stark101Config()):
    """Verify a batch of stark101 proofs (word tensors with leading batch
    axes).  Returns (ok, masks): masks in the JAX package's order,
    fri_beta_0..L-1, trace_merkle, fri_carry_0..L-1, fri_merkle, fri_last."""
    masks = {}
    n_ex = cfg.domain_ex_size
    log_ex = cfg.log_domain_ex
    n_layers = cfg.n_fri_layers

    dev = proof.p_mt_root.device
    with device_span("dev.stark101.transcript", dev):
        # Channel genesis: state = H(root)
        state = sha256_words(proof.p_mt_root)
        state, a0 = ch.draw(state, F.Q)
        state, a1 = ch.draw(state, F.Q)
        state, a2 = ch.draw(state, F.Q)

        # FRI commitment replay
        for i in range(n_layers):
            state = ch.mix_words(state, proof.fri_roots[..., i, :])
            state, beta = ch.draw(state, F.Q)
            masks[f"fri_beta_{i}"] = beta == proof.fri_betas[..., i]
        state = ch.mix_u32(state, proof.last)

        # Query index
        state, idx = ch.draw(state, n_ex)

    with device_span("dev.stark101.trace_merkle", dev):
        # Trace decommitments at idx, idx + 8, idx + 16 in one walk; the walk
        # reads the low 13 bits of each position, i.e. (idx + k) mod 8192
        offsets = torch.arange(3, dtype=WORD, device=idx.device) * cfg.idx_offset
        trace_pos = idx[..., None] + offsets
        trace_leaves = sha256_words(proof.evals[..., :, None])  # (..., 3, 8)
        masks["trace_merkle"] = merkle.verify_path(
            trace_leaves, trace_pos, proof.eval_sibs, proof.p_mt_root[..., None, :],
        ).all(dim=-1)
        for k in range(3):
            state = ch.mix_u32(state, proof.evals[..., k])

    with device_span("dev.stark101.fold", dev):
        # x = GEN * h^idx
        x = F.f_mul(F.GEN, _pow_dyn(cfg.coset_gen, idx, log_ex))
        cp_ev = compose(cfg, x, (a0, a1, a2),
                        proof.evals[..., 0], proof.evals[..., 1], proof.evals[..., 2])

        # FRI walk.  1/(2 x_i) comes from one inversion: x_i = x_0^(2^i).  The
        # 2L paths, cpa and cpb of each layer, are zero-padded into one
        # (..., 2L, 13, 8) tensor and verified in one walk at their own depths.
        inv2 = pow(2, F.Q - 2, F.Q)
        x_inv = F.f_inv(x)
        bshape = proof.fri_betas.shape[:-1]
        sibs = proof.eval_sibs.new_zeros(bshape + (2 * n_layers, log_ex, 8))
        leaves, indices = [], []
        for i in range(n_layers):
            ds = n_ex >> i
            masks[f"fri_carry_{i}"] = cp_ev == proof.cpa_evals[..., i]
            cpa_ev = proof.cpa_evals[..., i]
            cpb_ev = proof.cpb_evals[..., i]
            sibs[..., 2 * i, : log_ex - i, :] = proof.cpa_sibs[i]
            sibs[..., 2 * i + 1, : log_ex - i, :] = proof.cpb_sibs[i]
            indices += [idx & (ds - 1), (idx + ds // 2) & (ds - 1)]
            leaves += [cpa_ev, cpb_ev]
            op0 = F.f_mul(F.f_add(cpa_ev, cpb_ev), inv2)
            op1 = F.f_mul(F.f_mul(F.f_sub(cpa_ev, cpb_ev), inv2), x_inv)
            cp_ev = F.f_add(op0, F.f_mul(op1, proof.fri_betas[..., i]))
            x_inv = F.f_mul(x_inv, x_inv)

    with device_span("dev.stark101.fri_merkle", dev):
        leaf_digests = sha256_words(torch.stack(leaves, dim=-1)[..., None])  # (..., 2L, 8)
        masks["fri_merkle"] = merkle.verify_path_padded(
            leaf_digests,
            torch.stack(indices, dim=-1),
            sibs,
            proof.fri_roots.repeat_interleave(2, dim=-2),
            const(tuple(_fri_depths(cfg).tolist()), idx.device, torch.int32),
        ).all(dim=-1)

        masks["fri_last"] = cp_ev == proof.last

        ok = None
        for m in masks.values():
            ok = m if ok is None else (ok & m)
    return ok, masks


def verify_batch(proof_batch, cfg: Stark101Config = Stark101Config()):
    """The accept bitmap of a batch."""
    return verify(proof_batch, cfg)[0]
