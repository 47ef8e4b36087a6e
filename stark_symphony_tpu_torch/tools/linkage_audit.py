"""Executable evidence for the stage-VI linkage decision (see the
``verify`` docstring of ``models/stwo/verifier.py``).

Port of ``stark_symphony_tpu/tools/linkage_audit.py``.  The claim: the
external fixtures' prover committed a first FRI layer that cannot be any
per-column weighting of the written DEEP-quotient numerators, i.e. the
linear system

    first_layer(q) * denominator(q) = sum_k  w_k * numerator_k(q)

over the queries q and the columns k (trace columns and CP partitions) is
inconsistent: rank([M | rhs]) = rank(M) + 1.  Proofs of this package's
prover (``models/stwo/prover.py``), which implements the written
semantics, make the system consistent.

The transcript values come from the port's channel and the committed
first-layer values from the fold-chain unwind (``unfold_first_layer``),
both run on `device` (on the card by default: K1 hashes the transcript);
the linear algebra runs over QM31 in exact Python integers, on the host.

Run:  python -m stark_symphony_tpu_torch.tools.linkage_audit [proof.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

from ..models.stwo import channel as ch
from ..models.stwo import proof as Pf
from ..models.stwo.verifier import deep_interpolant_coefficients, unfold_first_layer
from ..ops.circle import CircleDomain, circle_position_to_point
from ..ops.u32 import bit_reverse, const, to_numpy
from .build import require_device

P = (1 << 31) - 1


# --------------------------------------------------------------------------
# Exact QM31 arithmetic on 4-tuples of Python ints (a + bi) + (c + di) j,
# j^2 = 2 + i: ops/field.py's formulas in arbitrary precision, on the host.
# --------------------------------------------------------------------------

def _cm_mul(a, b):
    (ar, ai), (br, bi) = a, b
    return ((ar * br - ai * bi) % P, (ar * bi + ai * br) % P)


def _cm_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def _cm_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def qm_mul(x, y):
    ar, ai = (x[0], x[1]), (x[2], x[3])
    br, bi = (y[0], y[1]), (y[2], y[3])
    aibi = _cm_mul(ai, bi)
    re = _cm_add(_cm_mul(ar, br), _cm_mul(aibi, (2, 1)))
    im = _cm_add(_cm_mul(ar, bi), _cm_mul(ai, br))
    return (re[0], re[1], im[0], im[1])


def qm_add(x, y):
    return tuple((a + b) % P for a, b in zip(x, y))


def qm_sub(x, y):
    return tuple((a - b) % P for a, b in zip(x, y))


def qm_inv(x):
    ar, ai = (x[0], x[1]), (x[2], x[3])
    ar_sq = _cm_mul(ar, ar)
    ai_sq = _cm_mul(ai, ai)
    den = _cm_sub(ar_sq, _cm_add(_cm_add(ai_sq, ai_sq), (-ai_sq[1] % P, ai_sq[0])))
    norm = (den[0] * den[0] + den[1] * den[1]) % P
    ninv = pow(norm, P - 2, P)
    den_inv = ((den[0] * ninv) % P, (-den[1] * ninv) % P)
    re = _cm_mul(ar, den_inv)
    im = _cm_mul((-ai[0] % P, -ai[1] % P), den_inv)
    return (re[0], re[1], im[0], im[1])


QM_ZERO = (0, 0, 0, 0)


def _rank(rows, ncols):
    """Row-echelon rank of a QM31 matrix given as lists of 4-tuples."""
    rows = [list(r) for r in rows]
    rank = 0
    col = 0
    nrows = len(rows)
    while rank < nrows and col < ncols:
        piv = next(
            (r for r in range(rank, nrows) if rows[r][col] != QM_ZERO), None
        )
        if piv is None:
            col += 1
            continue
        rows[rank], rows[piv] = rows[piv], rows[rank]
        inv = qm_inv(rows[rank][col])
        rows[rank] = [qm_mul(inv, v) for v in rows[rank]]
        for r in range(nrows):
            if r != rank and rows[r][col] != QM_ZERO:
                f = rows[r][col]
                rows[r] = [
                    qm_sub(v, qm_mul(f, p)) for v, p in zip(rows[r], rows[rank])
                ]
        rank += 1
        col += 1
    return rank


# --------------------------------------------------------------------------
# System construction over the port's channel, unwind and circle code
# --------------------------------------------------------------------------

def build_system(proof, cfg, device="cuda"):
    """Return (M, rhs) for a numpy proof: M[q][k] = numerator_k(q),
    rhs[q] = first_layer(q) * pair_line_denominator(q), all exact QM31
    tuples.  The transcript and the unwind run on `device`."""
    p = Pf.to_torch(proof, device)

    # transcript (stages I-V, as verifier.verify runs them)
    state = ch.init((), device)
    state = ch.mix_root(state, p.commitments[0])
    state = ch.mix_root(state, p.commitments[1])
    state, _cp_alpha, _ = ch.draw_qm31(state)
    state = ch.mix_root(state, p.commitments[2])
    state, oods_point, _ = ch.draw_qm31_point(state)
    state = ch.mix_words(state, torch.cat([p.oods_trace.reshape(-1), p.oods_cp.reshape(-1)]))
    state, _deep_alpha, _ = ch.draw_qm31(state)
    fri_alphas = []
    state = ch.mix_root(state, p.fri_first_commit)
    state, alpha, _ = ch.draw_qm31(state)
    fri_alphas.append(alpha)
    for i in range(cfg.n_inner_layers):
        state = ch.mix_root(state, p.fri_inner_commits[i])
        state, alpha, _ = ch.draw_qm31(state)
        fri_alphas.append(alpha)
    state = ch.mix_words(state, p.fri_last)
    state = ch.mix_u64(state, p.pow_nonce[0], p.pow_nonce[1])
    state, queries = ch.draw_queries(state, cfg.n_queries, cfg.lde_log_size)

    # committed first-layer values: fold chain unwound from the last-layer
    # constant through every Merkle-checked witness
    first_layer = to_numpy(unfold_first_layer(p, cfg, queries, fri_alphas))  # (Q, 4)

    # query points and the pair-line denominator
    positions = bit_reverse(queries, cfg.lde_log_size)
    pts = to_numpy(circle_position_to_point(CircleDomain(cfg.lde_log_size), positions))
    oods_host = to_numpy(oods_point)
    px, py = oods_host[0], oods_host[1]  # (4,) [re0, re1, im0, im1]
    q_n = cfg.n_queries

    def cm(t):
        return (int(t[0]), int(t[1]))

    prx, pix = cm(px[0:2]), cm(px[2:4])
    pry, piy = cm(py[0:2]), cm(py[2:4])
    denominators = []
    for q in range(q_n):
        x, y = int(pts[q, 0]), int(pts[q, 1])
        dx = _cm_sub(prx, (x, 0))
        dy = _cm_sub(pry, (y, 0))
        d = _cm_sub(_cm_mul(dx, piy), _cm_mul(dy, pix))
        denominators.append((d[0], d[1], 0, 0))

    # numerators per column, unweighted (alpha_i = 1)
    one = const((1, 0, 0, 0), device)
    cols = [(p.oods_trace[c], proof.trace_evals[:, c]) for c in range(cfg.n_columns)]
    cols += [(p.oods_cp[k], proof.cp_evals[:, k]) for k in range(cfg.n_cp_partitions)]
    M = [[None] * len(cols) for _ in range(q_n)]
    for k, (oods_val, vals) in enumerate(cols):
        a, b, c = (to_numpy(v) for v in deep_interpolant_coefficients(oods_point, oods_val, one))
        a_t, b_t, c_t = tuple(map(int, a)), tuple(map(int, b)), tuple(map(int, c))
        for q in range(q_n):
            v = int(vals[q])
            y_q = int(pts[q, 1])
            num = qm_sub(
                tuple((x * v) % P for x in b_t),
                qm_add(tuple((x * y_q) % P for x in a_t), c_t),
            )
            M[q][k] = num

    rhs = [
        qm_mul(tuple(int(v) for v in first_layer[q]), denominators[q])
        for q in range(q_n)
    ]
    return M, rhs


def audit(proof, cfg, device="cuda") -> dict:
    M, rhs = build_system(proof, cfg, device)
    r = _rank(M, len(M[0]))
    ra = _rank([row + [v] for row, v in zip(M, rhs)], len(M[0]) + 1)
    return {
        "n_queries": len(M),
        "n_columns": len(M[0]),
        "rank": r,
        "rank_augmented": ra,
        "consistent": r == ra,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="linkage-audit")
    ap.add_argument("proof_json", nargs="?", default=str(
        pathlib.Path(__file__).resolve().parents[2] / "tests/fixtures/stwo/proof.json"))
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    proof, cfg = Pf.load_json(args.proof_json)
    res = audit(proof, cfg, device)
    res["proof"] = args.proof_json
    print(json.dumps(res))
    if not res["consistent"]:
        print(
            "=> INCONSISTENT: no per-column weights reproduce the committed "
            "first FRI layer from the written DEEP-quotient numerators; the "
            "fixture prover used a different stage-VI aggregation.",
            file=sys.stderr,
        )
    return 0 if res["consistent"] else 1


if __name__ == "__main__":
    sys.exit(main())
