"""Batched stwo circle-STARK verifier (PyTorch): standard and tiled paths.

Port of ``stark_symphony_tpu/models/stwo/verifier.py``:
commit -> OODS -> FRI commit -> PoW -> decommit -> DEEP quotients -> FRI.
``verify`` is the standard path, for one AIR or for a batch routed over
several (``air`` a tuple, ``air_id`` per proof); ``verify_batch_tiled``
the fast path over a tiled batch (``tiled.tile_batch``) of one AIR, whose
stages V and VII run fused (``ops/fri.py``).
Every function is polymorphic over an optional leading proof-batch axis,
so ``verify`` on stacked (B, ...) tensors checks the whole batch at once:
SHA-256 and Merkle calls see B*Q lanes, and on a CUDA device they run in
the kernels of ``ops/cuda``.  Failures are boolean masks, never aborts;
``verify`` returns the same masks, under the same keys and in the same
order, as the JAX package's ``verify``.

As in the JAX package, the terminal FRI check compares the folded value
with the last-layer constant, plus ``folded_query == 0`` only when the
config folds all the way down.
"""

from __future__ import annotations

import torch

from ...ops import field as F
from ...ops import fri, merkle
from ...ops.circle import (
    CircleDomain,
    circle_position_to_point,
    qm31_point_x,
    qm31_point_y,
    query_point_table_on,
)
from ...ops.sha256 import sha256_pair, sha256_words
from ...ops.u32 import M32, bit_reverse, byte_swap32, const, from_i32, lt64, to_i32
from . import channel as ch
from .config import StwoConfig
from .constraints import REGISTRY

LINKAGES = ("reference", "unfold")


def _per_query(v, n: int):
    """(..., k) -> (..., n, k): broadcast a per-proof value over queries."""
    v = v[..., None, :]
    return v.expand(v.shape[:-2] + (n,) + v.shape[-1:])


def _combine_partitions(p0, p1, p2, p3):
    """p0 + p1*i + p2*j + p3*ij."""
    i, j, ij = (F.qm31_scalar(*u, p0.device)
                for u in ((0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1)))
    res = F.qm31_add(p0, F.qm31_mul(p1, i))
    res = F.qm31_add(res, F.qm31_mul(p2, j))
    return F.qm31_add(res, F.qm31_mul(p3, ij))


def composition_from_decomposed(oods_cp, oods_point):
    """Reconstruct the CP evaluation from the 16 decomposed partitions:
    F = F_a + y*F_b + x*F_c + x*y*F_d."""
    cpa = _combine_partitions(*[oods_cp[..., 4 * k + 0, :] for k in range(4)])
    cpb = _combine_partitions(*[oods_cp[..., 4 * k + 1, :] for k in range(4)])
    cpc = _combine_partitions(*[oods_cp[..., 4 * k + 2, :] for k in range(4)])
    cpd = _combine_partitions(*[oods_cp[..., 4 * k + 3, :] for k in range(4)])
    x = qm31_point_x(oods_point)
    y = qm31_point_y(oods_point)
    res = F.qm31_add(cpa, F.qm31_mul(cpb, y))
    res = F.qm31_add(res, F.qm31_mul(cpc, x))
    return F.qm31_add(res, F.qm31_mul(cpd, F.qm31_mul(x, y)))


def deep_denominator_inverse(oods_point, query_points):
    """CM31 inverse of the DEEP quotient denominator; query_points (..., Q, 2)."""
    px = qm31_point_x(oods_point)
    py = qm31_point_y(oods_point)
    prx, pix = px[..., 0:2], px[..., 2:4]
    pry, piy = py[..., 0:2], py[..., 2:4]
    x = query_points[..., 0]
    y = query_points[..., 1]
    q = query_points.shape[-2]
    dx = F.cm31_sub_m31(_per_query(prx, q), x)
    dy = F.cm31_sub_m31(_per_query(pry, q), y)
    d = F.cm31_sub(F.cm31_mul(dx, _per_query(piy, q)),
                   F.cm31_mul(dy, _per_query(pix, q)))
    return F.cm31_inv(d)


def deep_interpolant_coefficients(oods_point, sample_value, alpha_i):
    """(a, b, c) of the complex-conjugate line interpolant, scaled by alpha^i
    (sample values and alphas may carry batch axes of their own)."""
    py = qm31_point_y(oods_point)
    im_py = py[..., 2:4]
    im_val = sample_value[..., 2:4]
    a = torch.cat([torch.zeros_like(im_val), F.cm31_neg(F.cm31_add(im_val, im_val))], dim=-1)
    b = torch.cat([torch.zeros_like(im_py), F.cm31_neg(F.cm31_add(im_py, im_py))], dim=-1)
    c = F.qm31_sub(F.qm31_mul(b, sample_value), F.qm31_mul(a, py))
    return F.qm31_mul(alpha_i, a), F.qm31_mul(alpha_i, b), F.qm31_mul(alpha_i, c)


# Up to this domain size query points come from a host table (2^log * 8 B);
# above it from the 31-step scalar multiplication.
_POINT_TABLE_MAX_LOG = 20


def query_points(cfg: StwoConfig, queries):
    """The LDE-domain circle points at the (bit-reversed) query positions,
    (..., Q, 2); shared by stage VI and stage VII."""
    if cfg.lde_log_size <= _POINT_TABLE_MAX_LOG:
        table = query_point_table_on(cfg.lde_log_size, str(queries.device))
        return table[queries]
    domain = CircleDomain(cfg.lde_log_size)
    positions = bit_reverse(queries, cfg.lde_log_size)
    return circle_position_to_point(domain, positions)


def fri_fold_coords(cfg: StwoConfig, queries, pts):
    """Per-layer FRI fold coordinates [c_0, ..., c_{L-1}] from the layer-0
    query point: y (negated for odd q) for the circle fold, then x mapped
    by pi(x) = 2x^2 - 1 per line fold, negated where bit l of q is set."""
    x = pts[..., 0]
    y = pts[..., 1]
    odd0 = (queries & 1) == 1
    coords = [torch.where(odd0, F.m31_neg(y), y)]
    u = x
    one = torch.ones_like(x)
    for l in range(1, 1 + cfg.n_inner_layers):
        bit = ((queries >> l) & 1) == 1
        coords.append(torch.where(bit, F.m31_neg(u), u))
        u2 = F.m31_sqr(u)
        u = F.m31_sub(F.m31_add(u2, u2), one)
    return coords


def batch_inv_m31(xs):
    """Montgomery batch inversion over a list of same-shape M31 tensors,
    keeping inv(0) = 0 per element."""
    ones = torch.ones_like(xs[0])
    safe = [torch.where(x == 0, ones, x) for x in xs]
    prefix = [safe[0]]
    for x in safe[1:]:
        prefix.append(F.m31_mul(prefix[-1], x))
    inv_run = F.m31_inv(prefix[-1])
    invs = [None] * len(xs)
    for i in range(len(xs) - 1, 0, -1):
        invs[i] = F.m31_mul(inv_run, prefix[i - 1])
        inv_run = F.m31_mul(inv_run, safe[i])
    invs[0] = inv_run
    return [torch.where(x == 0, torch.zeros_like(inv), inv)
            for x, inv in zip(xs, invs)]


def fri_answers(cfg: StwoConfig, queries, trace_evals, cp_evals, random_coeff,
                oods_point, oods_trace, oods_cp, pts=None):
    """DEEP quotient aggregation per query.

    queries (..., Q); trace_evals (..., Q, C); cp_evals (..., Q, 16).
    Returns (..., Q, 4) QM31 quotients."""
    if pts is None:
        pts = query_points(cfg, queries)
    denom_inv = deep_denominator_inverse(oods_point, pts)
    py_query = pts[..., 1]

    nq = queries.shape[-1]
    acc = F.qm31_zero(queries.shape, queries.device)
    alpha_i = random_coeff
    items = [(oods_trace[..., c, :], trace_evals[..., c]) for c in range(cfg.n_columns)]
    items += [(oods_cp[..., k, :], cp_evals[..., k]) for k in range(cfg.n_cp_partitions)]
    for oods_val, vals in items:
        a, b, c = deep_interpolant_coefficients(oods_point, oods_val, alpha_i)
        num = F.qm31_sub(
            F.qm31_mul_m31(_per_query(b, nq), vals),
            F.qm31_add(
                F.qm31_mul_m31(_per_query(a, nq), py_query),
                _per_query(c, nq),
            ),
        )
        acc = F.qm31_add(acc, num)
        alpha_i = F.qm31_mul(alpha_i, random_coeff)
    return F.qm31_mul(
        F.qm31_mul_cm31(acc, denom_inv), _per_query(alpha_i, nq)
    )


def _fold(eval0, eval1, coord_inv, alpha):
    """Circle/line fold against a precomputed 1/coordinate."""
    f0 = F.qm31_add(eval0, eval1)
    f1 = F.qm31_mul_m31(F.qm31_sub(eval0, eval1), coord_inv)
    return F.qm31_add(f0, F.qm31_mul(_per_query(alpha, f1.shape[-2]), f1))


def _fri_layer(queries, evals, witness, coord_inv, alpha):
    """Fold one FRI layer for all queries; return (folded_queries, folded,
    node_digest).  The node's Merkle check is batched by the caller."""
    is_even = (queries & 1) == 0
    position = queries & 0xFFFFFFFE
    eval0 = torch.where(is_even[..., None], evals, witness)
    eval1 = torch.where(is_even[..., None], witness, evals)
    leaf0 = sha256_words(eval0)
    leaf1 = sha256_words(eval1)
    node = sha256_pair(leaf0, leaf1)
    folded = _fold(eval0, eval1, coord_inv, alpha)
    return position >> 1, folded, node


def unfold_first_layer(proof, cfg: StwoConfig, queries, fri_alphas):
    """Recover the committed first-FRI-layer evaluations at `queries` by
    walking the fold chain backward from the last-layer constant with the
    per-layer witnesses (the 'unfold' linkage)."""
    v_next = proof.fri_last[..., None, :].expand(queries.shape + (4,))
    n_layers = 1 + cfg.n_inner_layers
    coords = fri_fold_coords(cfg, queries, query_points(cfg, queries))
    coord_invs = batch_inv_m31(coords)
    for l in reversed(range(n_layers)):
        q_l = queries >> l
        cinv = coord_invs[l]
        alpha = _per_query(fri_alphas[l], v_next.shape[-2])
        t1 = F.qm31_mul_m31(alpha, cinv)
        one = F.qm31_one(v_next.shape[:-1], v_next.device)
        w = proof.fri_witnesses[l]
        odd = ((q_l & 1) == 1)[..., None]
        b_val = F.qm31_mul(
            F.qm31_sub(v_next, F.qm31_mul(w, F.qm31_add(one, t1))),
            F.qm31_inv(F.qm31_sub(one, t1)),
        )
        a_val = F.qm31_mul(
            F.qm31_sub(v_next, F.qm31_mul(w, F.qm31_sub(one, t1))),
            F.qm31_inv(F.qm31_add(one, t1)),
        )
        v_next = torch.where(odd, b_val, a_val)
    return v_next


def _stages_i_to_iv(proof, cfg: StwoConfig, eval_cp, masks):
    """Transcript stages I-IV + the stage-V query draw.  Fills `masks` in
    place; returns (queries, cp_alpha, oods_point, deep_alpha, fri_alphas)."""
    # Stage I: commitments
    state = ch.init(proof.commitments.shape[:-2], proof.commitments.device)
    state = ch.mix_root(state, proof.commitments[..., 0, :])
    state = ch.mix_root(state, proof.commitments[..., 1, :])
    state, cp_alpha, ok = ch.draw_qm31(state)
    masks["draw_cp_alpha"] = ok
    state = ch.mix_root(state, proof.commitments[..., 2, :])

    # Stage II: OODS
    state, oods_point, ok = ch.draw_qm31_point(state)
    masks["draw_oods_point"] = ok
    oods_words = torch.cat(
        [
            proof.oods_trace.reshape(proof.oods_trace.shape[:-2] + (-1,)),
            proof.oods_cp.reshape(proof.oods_cp.shape[:-2] + (-1,)),
        ],
        dim=-1,
    )
    state = ch.mix_words(state, oods_words)
    cp_eval = eval_cp(cfg.trace_log_size, oods_point, proof.oods_trace, cp_alpha)
    sampled_cp = composition_from_decomposed(proof.oods_cp, oods_point)
    masks["oods_cp_match"] = F.qm31_eq(cp_eval, sampled_cp)
    state, deep_alpha, ok = ch.draw_qm31(state)
    masks["draw_deep_alpha"] = ok

    # Stage III: FRI commit
    fri_alphas = []
    state = ch.mix_root(state, proof.fri_first_commit)
    state, alpha, ok = ch.draw_qm31(state)
    masks["draw_fri_alpha_first"] = ok
    fri_alphas.append(alpha)
    for i in range(cfg.n_inner_layers):
        state = ch.mix_root(state, proof.fri_inner_commits[..., i, :])
        state, alpha, ok = ch.draw_qm31(state)
        masks[f"draw_fri_alpha_{i}"] = ok
        fri_alphas.append(alpha)
    state = ch.mix_words(state, proof.fri_last)

    # Stage IV: proof of work
    state = ch.mix_u64(state, proof.pow_nonce[..., 0], proof.pow_nonce[..., 1])
    val_hi = byte_swap32(state.digest[..., 7])
    val_lo = byte_swap32(state.digest[..., 6])
    target = cfg.pow_target
    masks["pow"] = lt64(val_hi, val_lo, target >> 32, target & 0xFFFFFFFF)

    # Stage V query draw
    state, queries = ch.draw_queries(state, cfg.n_queries, cfg.lde_log_size)
    return queries, cp_alpha, oods_point, deep_alpha, fri_alphas


def _routed(airs, air_id):
    """The composition check of routed AIRs: every AIR in `airs` evaluated
    on the whole batch, then each lane's value selected by its air_id
    (dense dispatch).  As JAX's ``take`` does, a negative id counts from
    the end and an id out of range selects the value 2^32 - 1 in every
    coordinate, which no composition value equals."""
    branches = [REGISTRY[name] for name in airs]

    def eval_cp(*args):
        values = torch.stack([f(*args) for f in branches])  # (n_airs, ..., 4)
        n = len(branches)
        ids = air_id.to(values.device, torch.int64)
        ids = torch.where(ids < 0, ids + n, ids)
        inside = (ids >= 0) & (ids < n)
        index = torch.where(inside, ids, 0).reshape((1,) + ids.shape + (1,))
        picked = torch.gather(values, 0, index.expand((1,) + values.shape[1:]))[0]
        return torch.where(inside[..., None], picked, M32)

    return eval_cp


def verify(proof, cfg: StwoConfig, air="wide_fibonacci",
           linkage: str = "reference", air_id=None, query_slice=None):
    """Verify one proof, or a stacked batch; returns (ok, masks).

    `proof` holds int64 word tensors (``proof.to_torch``), all on one
    device.  `air` names an AIR of ``constraints.REGISTRY``, or is a tuple
    of names: then `air_id` (a tensor of the batch shape) gives each
    proof's index into it, and each lane's composition check uses its own
    AIR.  linkage 'reference' feeds the stage-VI DEEP quotients into the
    FRI walk; 'unfold' starts the walk from the values recovered by
    unfolding the FRI chain backward (stage VI is computed, not enforced).

    query_slice: None, or (shard_index, n_local) for a query shard of
    ``parallel/batch.verify_batch_tp``: the proof's per-query arrays hold
    queries shard_index * n_local .. + n_local only.  The transcript runs
    whole; every stage after the query draw runs on that slice.
    """
    if linkage not in LINKAGES:
        raise ValueError(f"linkage must be one of {LINKAGES}, not {linkage!r}")
    if isinstance(air, (tuple, list)):
        if air_id is None:
            raise ValueError("routed AIRs need a per-proof air_id")
        eval_cp = _routed(air, air_id)
    else:
        eval_cp = REGISTRY[air]

    masks = {}
    queries, cp_alpha, oods_point, deep_alpha, fri_alphas = _stages_i_to_iv(
        proof, cfg, eval_cp, masks
    )
    if query_slice is not None:
        shard, n_local = query_slice
        queries = queries[..., shard * n_local:(shard + 1) * n_local]
    n_q = queries.shape[-1]  # cfg.n_queries, or the shard's n_local

    # Stage V: trace and CP decommitments, one batched walk
    trace_leaf = sha256_words(proof.trace_evals)  # (..., Q, 8)
    cp_leaf = sha256_words(proof.cp_evals)
    leaves = torch.cat([trace_leaf, cp_leaf], dim=-2)
    sibs = torch.cat([proof.trace_sibs, proof.cp_sibs], dim=-3)
    roots = torch.cat(
        [
            proof.commitments[..., None, 1, :].expand(trace_leaf.shape),
            proof.commitments[..., None, 2, :].expand(cp_leaf.shape),
        ],
        dim=-2,
    )
    both = merkle.verify_path(
        leaves, torch.cat([queries, queries], dim=-1), sibs, roots
    )
    masks["trace_merkle"] = both[..., :n_q].all(dim=-1)
    masks["cp_merkle"] = both[..., n_q:].all(dim=-1)

    # Stage VI: DEEP quotients
    pts = query_points(cfg, queries)
    answers = fri_answers(
        cfg, queries, proof.trace_evals, proof.cp_evals, deep_alpha,
        oods_point, proof.oods_trace, proof.oods_cp, pts=pts,
    )
    fri_start = answers
    if linkage == "unfold":
        fri_start = unfold_first_layer(proof, cfg, queries, fri_alphas)

    # Stage VII: FRI folds; all layers' node paths in one padded walk
    cur_q, cur_e = queries, fri_start
    coord_invs = batch_inv_m31(fri_fold_coords(cfg, queries, pts))
    roots = [proof.fri_first_commit] + [
        proof.fri_inner_commits[..., i, :] for i in range(cfg.n_inner_layers)
    ]
    max_depth = cfg.fri_layer_depth(0)
    m_nodes, m_idx, m_sibs, m_roots, m_depths = [], [], [], [], []
    for l, root in enumerate(roots):
        node_idx = (cur_q & 0xFFFFFFFE) >> 1  # before the layer halves q
        cur_q, cur_e, node = _fri_layer(
            cur_q, cur_e, proof.fri_witnesses[l], coord_invs[l], fri_alphas[l],
        )
        depth = cfg.fri_layer_depth(l)
        sib = proof.fri_sibs[l]
        if depth < max_depth:
            zeros = sib.new_zeros(sib.shape[:-2] + (max_depth - depth, 8))
            sib = torch.cat([sib, zeros], dim=-2)
        m_nodes.append(node)
        m_idx.append(node_idx)
        m_sibs.append(sib)
        m_roots.append(root[..., None, :].expand(node.shape))
        m_depths.extend([depth] * n_q)
    ok_paths = merkle.verify_path_padded(
        torch.cat(m_nodes, dim=-2),
        torch.cat(m_idx, dim=-1),
        torch.cat(m_sibs, dim=-3),
        torch.cat(m_roots, dim=-2),
        const(tuple(m_depths), queries.device, torch.int32),
    )
    for l in range(len(roots)):
        masks[f"fri_merkle_{l}"] = ok_paths[..., l * n_q: (l + 1) * n_q].all(dim=-1)

    last = proof.fri_last[..., None, :].expand(cur_e.shape)
    masks["fri_last_eval"] = F.qm31_eq(cur_e, last).all(dim=-1)
    if cfg.final_log_size == 0:
        masks["fri_last_query"] = (cur_q == 0).all(dim=-1)

    ok_all = None
    for m in masks.values():
        ok_all = m if ok_all is None else (ok_all & m)
    return ok_all, masks


def verify_batch(proof_batch, cfg: StwoConfig, air="wide_fibonacci",
                 linkage: str = "reference", air_id=None):
    """Verify a stacked proof batch; returns the accept bitmap (B,).  `air`
    and `air_id` as in verify."""
    return verify(proof_batch, cfg, air, linkage, air_id)[0]


def _i32(x):
    """int64 words -> contiguous int32 bit patterns, as the fused stages
    take them."""
    return to_i32(x).contiguous()


def verify_batch_tiled(tb, cfg: StwoConfig, air: str = "wide_fibonacci",
                       linkage: str = "reference", with_masks: bool = False):
    """Fast path: verify a tiled proof batch (``tiled.tile_batch``).

    The same masks, under the same keys and in the same order, as
    ``verify(..., linkage="reference")``, but the per-query stages run fused
    (``ops/fri.py``): stage V is one leaf-hash + walk + root compare per
    tree (K4 on a CUDA device), stage VII one pass over all FRI layers (K5).
    Per-query words stay in the batch's word-major int32 layout, lane =
    b * Q + q, so moving between (B, Q) and lanes is a reshape.

    Returns the accept bitmap (B,), or (bitmap, masks) if with_masks."""
    if linkage != "reference":
        raise ValueError(f"the tiled path enforces linkage 'reference', not {linkage!r}")
    eval_cp = REGISTRY[air]
    b, q_n = tb.commitments.shape[0], cfg.n_queries
    lanes = b * q_n
    n_layers = 1 + cfg.n_inner_layers

    masks = {}
    queries, cp_alpha, oods_point, deep_alpha, fri_alphas = _stages_i_to_iv(
        tb, cfg, eval_cp, masks
    )
    q_lanes = _i32(queries.reshape(lanes))

    def proof_mask(ok):  # (lanes,) 0/1 -> (B,) all queries of the proof ok
        return (ok.reshape(b, q_n) == 1).all(dim=-1)

    # Stage V: fused leaf hash + walk + root compare, trace then CP
    ok_t = fri.leafwalk(tb.trace_evals_t, q_lanes, tb.trace_sibs_t,
                        _i32(tb.commitments[:, 1]))
    ok_c = fri.leafwalk(tb.cp_evals_t, q_lanes, tb.cp_sibs_t,
                        _i32(tb.commitments[:, 2]))
    masks["trace_merkle"] = proof_mask(ok_t)
    masks["cp_merkle"] = proof_mask(ok_c)

    # Stage VI: DEEP quotients on the eval columns, widened to (B, Q, W)
    def unlane(x):  # (W, lanes) int32 -> (B, Q, W) int64 words
        return from_i32(x).reshape(-1, b, q_n).permute(1, 2, 0)

    pts = query_points(cfg, queries)
    answers = fri_answers(
        cfg, queries, unlane(tb.trace_evals_t), unlane(tb.cp_evals_t),
        deep_alpha, oods_point, tb.oods_trace, tb.oods_cp, pts=pts,
    )

    # Stage VII: all FRI layers in one pass
    cinvs = batch_inv_m31(fri_fold_coords(cfg, queries, pts))
    roots = torch.cat([tb.fri_first_commit[:, None], tb.fri_inner_commits], dim=1)
    ok_l, folded, q_out = fri.fri_all_layers(
        q_lanes,
        _i32(answers.reshape(lanes, 4).t()),
        tb.fri_wits_t,
        _i32(torch.stack(cinvs).reshape(n_layers, lanes)),
        _i32(torch.stack(fri_alphas, dim=1)),
        tb.fri_sibs_t,
        _i32(roots),
        [cfg.fri_layer_depth(l) for l in range(n_layers)],
    )
    for l in range(n_layers):
        masks[f"fri_merkle_{l}"] = proof_mask(ok_l[l])
    masks["fri_last_eval"] = F.qm31_eq(
        unlane(folded), tb.fri_last[:, None, :]).all(dim=-1)
    if cfg.final_log_size == 0:
        masks["fri_last_query"] = (q_out.reshape(b, q_n) == 0).all(dim=-1)

    ok_all = None
    for m in masks.values():
        ok_all = m if ok_all is None else (ok_all & m)
    return (ok_all, masks) if with_masks else ok_all
