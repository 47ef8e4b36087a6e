"""stwo circle-STARK prover over int64 word tensors.

Port of ``stark_symphony_tpu/models/stwo/prover.py``: the same transcript,
the same commitments and the same decommitments, so on the same trace it
emits the JAX prover's proof word for word (the committed fixtures in
``tests/fixtures/own_proofs/``).  All value arrays are in natural
circle-domain position order; Merkle leaves are in bit-reversed position
order, the verifier's query convention.

1. trace columns (C, T) -> circle-FFT low-degree extension (C, L);
2. commit the trace (leaf = the C column values of a position);
3. draw cp_alpha; the composition polynomial on the LDE domain,
   CP = sum_k alpha^.. (c_k - rule(c_{k-2}, c_{k-1})) / V_T(x);
4. interpolate CP (QM31) and split its coefficients into quarters, the
   decomposition F = F_a + y F_b + x F_c + x y F_d; the 16 M31 coordinate
   columns, each re-based into quarter 0, are evaluated on the LDE domain
   (one batched FFT) and committed (leaf = 16 values);
5. OODS: draw the point, evaluate all 20 column polynomials at it (one
   batched evaluation), mix; draw deep_alpha;
6. the first FRI layer = the DEEP quotients over the whole LDE domain;
7. FRI: commit, draw alpha, fold (circle fold, then line folds);
8. grind the PoW nonce (``pow_grind``: one K1 launch a chunk of
   candidates and one read of the result to the host);
9. draw the queries and gather the decommitments.

Every value is a canonical field element, so a computation that is exact
in the field gives the JAX prover's words whatever its order: the 20
DEEP terms are evaluated as one batch and summed at once, and alpha's
powers are made by doubling, where the JAX prover loops.

On a CUDA device every SHA-256 runs in kernel K1 (leaves, transcript,
PoW candidates) and every Merkle tree level in K2: at PRODUCTION, 53 K1
launches (with one PoW chunk) and 107 K2 launches a proof.  The host
tables (twiddles, domain points, 1/V_T, the leaf permutation) are built
once per size and sent to each device once (``ops/u32.const``).  The
proof leaves the device only at the end.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ...ops import field as F
from ...ops import merkle
from ...ops.circle import CircleDomain
from ...ops.circle_fft import (
    _host_point_at,
    cfft_eval,
    cfft_interpolate,
    device_twiddles,
    embed_coeffs,
    eval_at_point,
)
from ...ops.sha256 import sha256_words
from ...ops.u32 import M32, WORD, bit_reverse, byte_swap32, const, from_numpy, lt64, to_numpy
from ...tools import build as TB
from . import channel as ch
from .config import StwoConfig
from .constraints import TRACE_RULES, lde_rule
from .proof import StwoProof
from .verifier import deep_denominator_inverse, deep_interpolant_coefficients

P = F.P

EMPTY_ROOT_WORDS = np.frombuffer(
    bytes.fromhex(
        "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"
    ),
    dtype=">u4",
).astype(np.uint32)  # sha256(""): the empty preprocessed tree's commitment


def generate_trace(cfg: StwoConfig, seeds=None,
                   air: str = "wide_fibonacci") -> np.ndarray:
    """An AIR-satisfying trace (C, T) uint32: per row, col_k =
    rule(col_{k-2}, col_{k-1}) with col0 = 1 and col1 = seed (by default
    the row index + 1)."""
    rule = TRACE_RULES[air]
    t = 1 << cfg.trace_log_size
    if seeds is None:
        seeds = np.arange(1, t + 1, dtype=np.uint64)
    cols = [np.ones(t, np.uint64), np.asarray(seeds, np.uint64) % P]
    for _ in range(2, cfg.n_columns):
        cols.append(rule(cols[-2], cols[-1]) % P)
    return np.stack(cols).astype(np.uint32)


def seeded_trace(cfg: StwoConfig, seed=None, air: str = "wide_fibonacci") -> np.ndarray:
    """The trace of the proof cache's (cfg, seed) entry: the default trace
    for seed None, else seeds = (row * (2 seed + 1)) mod (2^31 - 1) + 1 over
    rows 1..T, the JAX package's rule."""
    if seed is None:
        return generate_trace(cfg, air=air)
    row = np.arange(1, (1 << cfg.trace_log_size) + 1, dtype=np.uint64)
    seeds = (row * np.uint64(2 * int(seed) + 1)) % np.uint64((1 << 31) - 1) + 1
    return generate_trace(cfg, seeds=seeds, air=air)


@functools.lru_cache(maxsize=None)
def _host_vanishing_inv(trace_log_size: int, lde_log_size: int) -> np.ndarray:
    """1 / V_T(x) on the LDE domain, V_T = pi^(T_log - 1)(x): nonzero there,
    since canonic cosets of different sizes are disjoint.  Built once per
    (trace size, LDE size)."""
    d = CircleDomain(lde_log_size)
    n = 1 << lde_log_size
    out = np.empty(n, np.uint32)
    for i in range(n):
        if i < n // 2:
            idx = (d.offset + d.step * i) & ((1 << 31) - 1)
        else:
            idx = (1 << 31) - ((d.offset + d.step * (i - n // 2)) & ((1 << 31) - 1))
            idx &= (1 << 31) - 1
        x = _host_point_at(idx)[0]
        for _ in range(trace_log_size - 1):
            x = (2 * x * x - 1) % P
        out[i] = pow(x, P - 2, P)
    return out


@functools.lru_cache(maxsize=None)
def _domain_points_host(lde_log: int) -> np.ndarray:
    """The LDE domain's points in natural position order, (L, 2) uint32."""
    d = CircleDomain(lde_log)
    n = 1 << lde_log
    pts = np.empty((n, 2), np.uint32)
    for i in range(n):
        if i < n // 2:
            idx = (d.offset + d.step * i) & ((1 << 31) - 1)
            x, y = _host_point_at(idx)
        else:
            idx = (d.offset + d.step * (i - n // 2)) & ((1 << 31) - 1)
            x, y = _host_point_at(idx)
            y = (P - y) % P
        pts[i] = (x, y)
    return pts


@functools.lru_cache(maxsize=None)
def _bit_reverse_perm(log: int) -> np.ndarray:
    n = 1 << log
    perm = np.zeros(n, np.int64)
    idx = np.arange(n)
    for b in range(log):
        perm |= ((idx >> b) & 1) << (log - 1 - b)
    return perm


def _device_table(table: np.ndarray, device) -> torch.Tensor:
    """A host table as an int64 tensor on `device`, sent there once
    (``u32.const`` keeps it per (values, device))."""
    return const(tuple(table.reshape(-1).tolist()), device).view(table.shape)


@functools.lru_cache(maxsize=None)
def _domain_points(lde_log: int, device) -> torch.Tensor:
    return _device_table(_domain_points_host(lde_log), device)


@functools.lru_cache(maxsize=None)
def _vanishing_inv(trace_log: int, lde_log: int, device) -> torch.Tensor:
    return _device_table(_host_vanishing_inv(trace_log, lde_log), device)


@functools.lru_cache(maxsize=None)
def _leaf_perm(log: int, device) -> torch.Tensor:
    return _device_table(_bit_reverse_perm(log), device)


def _commit_leaves(leaf_words_natural, log: int):
    """Leaf words (L, W) in natural position order -> (Merkle levels with
    the leaves in bit-reversed order, root): one K1 launch for the leaves
    and one K2 launch a level on a CUDA device."""
    leaves_br = leaf_words_natural[_leaf_perm(log, leaf_words_natural.device)]
    levels = merkle.build_tree(sha256_words(leaves_br))
    return levels, levels[-1][0]


def n_candidates(cfg: StwoConfig) -> int:
    """The PoW candidates a chunk: 8 << pow_bits, within [4096, 65536]."""
    return min(1 << 16, max(4096, 8 << cfg.pow_bits))


def _grind_chunk(cfg: StwoConfig, state: ch.ChannelState, start: int) -> torch.Tensor:
    """One chunk of the PoW search, nonces start .. start + n_cand - 1 (lo
    wrapping within its word, as JAX's uint32 add does): one SHA-256 of
    (digest || hi || lo) over n_cand lanes.  Returns (found, hi, lo) as 3
    words on the state's device, (hi, lo) the first hit where found is 1;
    it reads nothing to the host."""
    n_cand = n_candidates(cfg)
    target = cfg.pow_target
    dev = state.digest.device
    nonces = (torch.arange(n_cand, dtype=WORD, device=dev) + (start & M32)) & M32
    his = torch.full((n_cand,), (start >> 32) & M32, dtype=WORD, device=dev)
    cand = ch.ChannelState(state.digest.expand(n_cand, 8), state.counter.expand(n_cand))
    digest = ch.mix_u64(cand, his, nonces).digest
    ok = lt64(byte_swap32(digest[:, 7]), byte_swap32(digest[:, 6]),
              target >> 32, target & M32)
    # gather, not nonces[first]: indexing by a 0-d tensor reads it to the host
    first = torch.argmax(ok.to(torch.int32), dim=0, keepdim=True)
    return torch.cat([ok.any().to(WORD)[None], his[:1], nonces.gather(0, first)])


def pow_grind(cfg: StwoConfig, state: ch.ChannelState, start: int = 0) -> torch.Tensor:
    """The smallest 64-bit nonce from `start` on whose mix into `state`
    meets the PoW target, as (hi, lo) words on the state's device.

    Candidates go in chunks of n_cand nonces (``_grind_chunk``), each with
    one read of its found flag to the host; the search carries lo into hi
    when lo wraps, so the whole 2^64 space is searched, in the JAX
    prover's order.  JAX's search starts at 0; the graphed prover, whose
    first chunk ran in its graph, carries on from n_cand."""
    n_cand = n_candidates(cfg)
    while True:
        word = _grind_chunk(cfg, state, start)
        if bool(word[0]):
            return word[1:]
        start = (start + n_cand) & ((1 << 64) - 1)


def _qm31_powers(alpha, n: int):
    """alpha^1 .. alpha^n as (n, 4), by doubling."""
    pw = alpha[None]
    while pw.shape[0] < n:
        pw = torch.cat([pw, F.qm31_mul(pw, pw[-1].expand(pw.shape))])
    return pw[:n]


class PreFri(NamedTuple):
    """What the prover knows after stage 6: the transcript state, the
    commitments and their trees, the LDE values, the OODS samples and the
    first FRI layer (the DEEP quotients)."""

    state_digest: torch.Tensor
    state_counter: torch.Tensor
    trace_root: torch.Tensor
    cp_root: torch.Tensor
    trace_levels: tuple
    cp_levels: tuple
    trace_lde: torch.Tensor
    cp_col_vals: torch.Tensor
    oods_trace: torch.Tensor
    oods_cp: torch.Tensor
    first_layer: torch.Tensor


def _pre_fri(cfg: StwoConfig, trace, air: str = "wide_fibonacci") -> PreFri:
    """Prover stages 1-6 on `trace` (C, T) words: trace LDE and commit,
    CP, OODS, DEEP quotients."""
    lde_log = cfg.lde_log_size
    t_log = cfg.trace_log_size
    L = 1 << lde_log
    C = cfg.n_columns
    dev = trace.device

    # 1. LDE of the trace columns (natural position order)
    t_coeffs = cfft_interpolate(trace, t_log)  # (C, T)
    lde_coeffs = embed_coeffs(t_coeffs, t_log, lde_log)  # (C, L)
    trace_lde = cfft_eval(lde_coeffs, lde_log)  # (C, L)

    # 2. commit the trace
    trace_levels, trace_root = _commit_leaves(trace_lde.t(), lde_log)
    state = ch.init(device=dev)
    state = ch.mix_root(state, const(tuple(EMPTY_ROOT_WORDS.tolist()), dev))
    state = ch.mix_root(state, trace_root)
    state, cp_alpha, _ = ch.draw_qm31(state)

    # 3. the composition polynomial on the LDE domain, (L, 4)
    rule = lde_rule(air)
    acc = F.qm31_zero((L,), dev)
    for k in range(2, C):
        constraint = F.m31_sub(trace_lde[k], rule(trace_lde[k - 2], trace_lde[k - 1]))
        acc = F.qm31_add(F.qm31_mul(acc, cp_alpha.expand(acc.shape)),
                         F.qm31_from_m31(constraint))
    cp_vals = F.qm31_mul_m31(acc, _vanishing_inv(t_log, lde_log, dev))

    # 4. the decomposition: 16 M31 columns on the LDE domain.  The
    # coefficient bit layout is [y | x | pi tower], so the quarters hold
    # F_a, x F_c, y F_b, x y F_d; each committed column is its polynomial
    # without the monomial factor, re-based into quarter 0.  Columns in
    # hasher order: coordinate g outer, polynomial a, b, c, d inner.
    cp_coeffs = cfft_interpolate(cp_vals, lde_log, qm31=True)  # (L, 4)
    q = L // 4
    quarter = cp_coeffs.reshape(4, q, 4)
    quarters = torch.stack([quarter[0], quarter[2], quarter[1], quarter[3]])  # a, b, c, d
    col_coeffs = torch.zeros((16, L), dtype=WORD, device=dev)
    col_coeffs[:, :q] = quarters.permute(2, 0, 1).reshape(16, q)
    cp_col_vals = cfft_eval(col_coeffs, lde_log)  # (16, L), one batched FFT

    cp_levels, cp_root = _commit_leaves(cp_col_vals.t(), lde_log)
    state = ch.mix_root(state, cp_root)

    # 5. OODS: all 20 column polynomials at the point, in one evaluation
    state, oods_point, _ = ch.draw_qm31_point(state)
    oods = eval_at_point(torch.cat([lde_coeffs, col_coeffs]), lde_log, oods_point)
    oods_trace, oods_cp = oods[:C], oods[C:]
    state = ch.mix_words(state, oods.reshape(-1))
    state, deep_alpha, _ = ch.draw_qm31(state)

    # 6. DEEP quotients over the whole LDE domain (natural order): term k
    # (trace columns, then CP columns) weighted by deep_alpha^(k+1), the
    # sum times deep_alpha^(K+1)
    pts = _domain_points(lde_log, dev)  # (L, 2)
    denom_inv = deep_denominator_inverse(oods_point, pts)  # (L, 2)
    values = torch.cat([trace_lde, cp_col_vals])  # (K, L)
    n_terms = values.shape[0]
    powers = _qm31_powers(deep_alpha, n_terms + 1)
    a, b, c = deep_interpolant_coefficients(oods_point, oods, powers[:n_terms])
    num = F.qm31_sub(
        F.qm31_mul_m31(b[:, None, :], values),
        F.qm31_add(F.qm31_mul_m31(a[:, None, :], pts[:, 1]), c[:, None, :]),
    )  # (K, L, 4)
    acc = num.sum(dim=0) % P  # canonical terms: the field sum
    first_layer = F.qm31_mul(F.qm31_mul_cm31(acc, denom_inv),
                             powers[n_terms].expand(acc.shape))  # (L, 4)
    return PreFri(
        state_digest=state.digest,
        state_counter=state.counter,
        trace_root=trace_root,
        cp_root=cp_root,
        trace_levels=tuple(trace_levels),
        cp_levels=tuple(cp_levels),
        trace_lde=trace_lde,
        cp_col_vals=cp_col_vals,
        oods_trace=oods_trace,
        oods_cp=oods_cp,
        first_layer=first_layer,
    )


def _finish(cfg: StwoConfig, state: ch.ChannelState, pre: PreFri, layers, roots,
            last) -> StwoProof:
    """Stages 8-9 after the FRI commitments: mix the last layer's constant,
    grind the PoW nonce, draw the queries and gather the decommitments.

    layers: per committed FRI layer, (its values (n, 4) in natural position
    order, its tree levels as ``merkle.build_tree`` gives them), on the
    transcript's device; roots: their roots; last: the values after the
    last fold.  Returns the StwoProof of word tensors."""
    state = ch.mix_words(state, last[0])
    return _decommit(cfg, state, pre, layers, roots, last[0], pow_grind(cfg, state))


def _decommit(cfg: StwoConfig, state: ch.ChannelState, pre: PreFri, layers, roots,
              fri_last, nonce) -> StwoProof:
    """Stage 9 after the grind: mix the nonce (hi, lo) into `state` (the
    transcript after fri_last's mix), draw the queries and gather the
    decommitments; the StwoProof of word tensors."""
    lde_log = cfg.lde_log_size
    dev = pre.trace_lde.device
    state = ch.mix_u64(state, nonce[0], nonce[1])

    # 9. queries and decommitments (bit-reversed leaf indices)
    state, queries = ch.draw_queries(state, cfg.n_queries, lde_log)
    nat_pos = bit_reverse(queries, lde_log)
    fri_wits, fri_sibs = [], []
    cur_q = queries
    log = lde_log
    for values, levels in layers:
        # the sibling leaf's value, then the path from the paired node up
        fri_wits.append(values[bit_reverse(cur_q ^ 1, log)])  # (Q, 4)
        node_idx = (cur_q & 0xFFFFFFFE) >> 1
        fri_sibs.append(merkle.gather_path(levels[1:], node_idx))
        cur_q = node_idx
        log -= 1

    return StwoProof(
        commitments=torch.stack([const(tuple(EMPTY_ROOT_WORDS.tolist()), dev),
                                 pre.trace_root, pre.cp_root]),
        trace_evals=pre.trace_lde[:, nat_pos].t(),  # (Q, C)
        trace_sibs=merkle.gather_path(pre.trace_levels, queries),
        cp_evals=pre.cp_col_vals[:, nat_pos].t(),  # (Q, 16)
        cp_sibs=merkle.gather_path(pre.cp_levels, queries),
        oods_trace=pre.oods_trace,
        oods_cp=pre.oods_cp,
        fri_first_commit=roots[0],
        fri_inner_commits=(torch.stack(roots[1:]) if len(roots) > 1
                           else torch.zeros((0, 8), dtype=WORD, device=dev)),
        fri_last=fri_last,
        fri_witnesses=tuple(fri_wits),
        fri_sibs=tuple(fri_sibs),
        pow_nonce=nonce,
    )


def fri_fold(a, b, tw_inv, alpha):
    """One FRI fold of the position pairs (i, i + n/2) of a layer: a, b
    (m, 4) their QM31 values, tw_inv (m,) the layer's inverse fold
    twiddles at i (1/y at the circle fold, 1/x at a line fold), alpha the
    fold randomness.  (a + b) + alpha (a - b) tw_inv, (m, 4)."""
    f0 = F.qm31_add(a, b)
    f1 = F.qm31_mul_m31(F.qm31_sub(a, b), tw_inv)
    return F.qm31_add(f0, F.qm31_mul(alpha.expand(f1.shape), f1))


def _commit_fri(cfg: StwoConfig, pre: PreFri):
    """Stage 7: commit each FRI layer, draw its alpha and fold.  Returns
    (state, layers, roots, last) as ``_finish`` takes them."""
    lde_log = cfg.lde_log_size
    state = ch.ChannelState(pre.state_digest, pre.state_counter)
    # the fold twiddles are the LDE domain's inverse tables at every layer
    # (y at the circle fold, the line levels after it)
    _, tw_inv = device_twiddles(lde_log, pre.first_layer.device)
    layers, roots = [], []
    cur = pre.first_layer
    log = lde_log
    for _ in range(1 + cfg.n_inner_layers):
        levels, root = _commit_leaves(cur, log)
        layers.append((cur, levels))
        roots.append(root)
        state = ch.mix_root(state, root)
        state, alpha, _ = ch.draw_qm31(state)
        half = cur.shape[0] // 2
        cur = fri_fold(cur[:half], cur[half:], tw_inv[lde_log - log][:half], alpha)
        log -= 1
    # last layer: a constant polynomial
    return state, layers, roots, cur


def _prove(cfg: StwoConfig, trace, air: str) -> StwoProof:
    """Stages 1-9 on `trace` (C, T) words; a StwoProof of word tensors on
    the trace's device."""
    pre = _pre_fri(cfg, trace, air)
    state, layers, roots, last = _commit_fri(cfg, pre)
    return _finish(cfg, state, pre, layers, roots, last)


class SegmentA(NamedTuple):
    """What graph A leaves for the grind and for graph B."""

    pre: PreFri
    state: ch.ChannelState  # after fri_last's mix
    layers: list
    roots: list
    last: torch.Tensor
    grind: torch.Tensor  # the first chunk's (found, hi, lo)


def _segment_a(cfg: StwoConfig, trace, air: str) -> SegmentA:
    """Stages 1-7, fri_last's mix and the first chunk of the PoW search:
    everything before the prover's one host read."""
    pre = _pre_fri(cfg, trace, air)
    state, layers, roots, last = _commit_fri(cfg, pre)
    state = ch.mix_words(state, last[0])
    return SegmentA(pre, state, layers, roots, last, _grind_chunk(cfg, state, 0))


def _segment_b(cfg: StwoConfig, a: SegmentA, nonce) -> StwoProof:
    """Stage 9 on segment A's outputs and the nonce (hi, lo)."""
    return _decommit(cfg, a.state, a.pre, a.layers, a.roots, a.last[0], nonce)


class GraphedProver:
    """The prover as two CUDA graphs around the grind, as the JAX package
    compiles ``_prove_jit`` with its grind inside (a graph cannot hold
    the grind's data-dependent loop).

    Graph A (`a`, captured: ``a.replay(trace) -> SegmentA``) runs on the
    trace through the first PoW chunk; one host read takes its 3 words
    (found, hi, lo); where the chunk found nothing, ``pow_grind`` carries
    on eagerly from chunk 2; graph B (`segment_b(a, nonce) -> StwoProof`)
    reads A's outputs (``a.out``) in place, shares A's memory pool
    (``a.pool``) and takes the nonce as its static input.  B is captured
    at the first call, once A has run.  ``continued`` counts the calls
    whose first chunk missed.  On the CPU the same segments run without
    graphs.  ``graphed_prover`` passes this module's ``_segment_a``
    captured and ``_segment_b``; ``prover_sharded`` its own."""

    def __init__(self, cfg: StwoConfig, a, segment_b):
        self.cfg = cfg
        self.segment_b = segment_b
        self.a = a
        self.b = None
        self.continued = 0

    def __call__(self, trace) -> StwoProof:
        a = self.a.replay(trace)
        found, _, _ = a.grind.tolist()  # the one host read
        if found:
            nonce = a.grind[1:]
        else:
            self.continued += 1
            nonce = pow_grind(self.cfg, a.state, start=n_candidates(self.cfg))
        if self.b is None:
            # self.a.out: A's graph outputs on the card, its last result on the CPU
            self.b = TB.capture(lambda n: self.segment_b(self.a.out, n), (nonce,),
                                warmup=1, pool=self.a.pool)
        return self.b.replay(nonce)


GRAPHS = TB.GraphCache()  # GraphedProver by (cfg, air) and the trace's spec


def graphed_prover(cfg: StwoConfig, trace, air: str = "wide_fibonacci") -> GraphedProver:
    """The GraphedProver of (cfg, air) for `trace`'s shape and device,
    captured at its first use."""
    return GRAPHS.get((cfg, air), (trace,), lambda: GraphedProver(
        cfg, TB.capture(lambda t: _segment_a(cfg, t, air), (trace,), warmup=1),
        lambda a, n: _segment_b(cfg, a, n)))


def _to_numpy_proof(proof: StwoProof) -> StwoProof:
    """A StwoProof of word tensors as one of numpy uint32 arrays."""
    return StwoProof(*(tuple(to_numpy(t) for t in x) if isinstance(x, tuple) else to_numpy(x)
                       for x in proof))


def prove(cfg: StwoConfig, trace=None, air: str = "wide_fibonacci", device="cuda",
          graphed: bool = False):
    """Make one stwo proof on `device`.  Returns (StwoProof of numpy uint32
    arrays, {}), as the JAX package's prove does; `trace` (C, T) uint32
    defaults to generate_trace(cfg, air=air).  `graphed`: replay the
    prover's graphs (``GraphedProver``), captured once per (cfg, air,
    device); the proof is the same."""
    if trace is None:
        trace = generate_trace(cfg, air=air)
    t = from_numpy(trace, device)
    if graphed:
        return _to_numpy_proof(graphed_prover(cfg, t, air)(t)), {}
    return _to_numpy_proof(_prove(cfg, t, air)), {}
