"""Per-stage time of the batched stwo verifier, both paths.

Port of ``stark_symphony_tpu/tools/profile_verify.py``.  Times each
verification stage as its own function with PRODUCTION shapes, so the
end-to-end proofs/s can be attributed to hashing, field code and
transcript.  The stage bodies mirror the port's ``verifier.verify``
(standard path: ``stages_i_iv``, ``stage_v``, ``stage_vi``,
``stage_vi_points_only``, ``stage_vii``, ``full``) and
``verifier.verify_batch_tiled`` (tiled path: ``stage_v_trace``,
``stage_v_cp``, ``fri_fused``, ``points_only``, ``stage_vi``, ``full``),
same ops, same shapes; measured in isolation, they localize time and need
not sum to the end-to-end time.

On the card each stage is timed with CUDA events twice: eagerly, and as a
CUDA graph captured once through ``tools/build.capture`` (the counterpart
of each stage's ``jax.jit`` in the JAX package), whose outputs must equal
the eager run's bit for bit; each graph is freed before the next stage is
captured.  Each stage's kernel launches (K1-K5) are counted over its
first eager call.  On the CPU (``--device cpu``) the stages run eagerly
only, timed by the host clock.

Usage:
    python -m stark_symphony_tpu_torch.tools.profile_verify [--tiled] [batch] [iters]
        [--device cuda|cpu]

Prints a first line with the card's name and power limit, then one JSON
line per stage: {"stage", "ms_per_batch" (the graph's replay; null on the
CPU), "batch", "proofs_per_sec", "compile_s" (capture plus instantiate),
"eager_ms_per_batch", "launches"}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..entry import production_batch
from ..models.stwo import channel as ch
from ..models.stwo import proof as P
from ..models.stwo import tiled, verifier
from ..models.stwo.config import PRODUCTION
from ..ops import fri, merkle, sha256
from ..ops.u32 import WORD, const, from_i32
from .build import capture, launch_counts, require_device, tree_leaves

STAGES = ("stages_i_iv", "stage_v", "stage_vi", "stage_vi_points_only", "stage_vii", "full")
TILED_STAGES = ("stage_v_trace", "stage_v_cp", "fri_fused", "points_only", "stage_vi", "full")


def card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu" on
    the CPU)."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        return out.strip().splitlines()[torch.device(device).index or 0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def _log(msg):
    print(f"[profile {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _device_of(args) -> torch.device:
    return next(x for x in tree_leaves(args) if isinstance(x, torch.Tensor)).device


def _cuda_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _same(a, b) -> bool:
    xs, ys = tree_leaves(a), tree_leaves(b)
    return len(xs) == len(ys) and all(torch.equal(x, y) for x, y in zip(xs, ys))


def time_stage(name: str, fn, args: tuple, iters: int, batch: int, extra=None) -> dict:
    """One stage's line: launches over a first eager call, then the eager
    time and, on the card, the graphed time: the replay alone, as a jitted
    stage runs on arguments already on the device (the graph's outputs,
    copied in and out once, held to the eager call's; the graph freed on
    return).  `extra(out)` adds keys computed from the eager output."""
    cuda = _device_of(args).type == "cuda"
    before = launch_counts()
    eager_out = fn(*args)
    if cuda:
        torch.cuda.synchronize()
    launches = {k: n - before[k] for k, n in launch_counts().items() if n - before[k]}
    ms = compile_s = None
    if cuda:
        eager_ms = _cuda_ms(lambda: fn(*args), iters)
        _log(f"capturing {name} ...")
        graphed = capture(fn, args, warmup=1)  # the eager runs above warmed it up
        compile_s = graphed.capture_s + graphed.instantiate_s
        if not _same(graphed(*args), eager_out):
            raise RuntimeError(f"profile_verify: the graphed {name} differs from its eager run")
        ms = _cuda_ms(graphed.graph.replay, iters)
        del graphed
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        eager_ms = 1e3 * (time.perf_counter() - t0) / iters
    line = {
        "stage": name,
        "ms_per_batch": None if ms is None else round(ms, 3),
        "batch": batch,
        "proofs_per_sec": None if ms is None else round(batch / (ms / 1e3), 1),
        "compile_s": None if compile_s is None else round(compile_s, 3),
        "eager_ms_per_batch": round(eager_ms, 3),
        "launches": launches,
    }
    if extra is not None:
        line.update(extra(eager_out))
    _log(f"{name}: {line}")
    return line


def _accepted(bitmap) -> dict:
    return {"accepted": int(bitmap.sum())}


def standard_calls(proof, cfg) -> list:
    """(name, fn, args) of each standard-path stage over a proof batch of
    word tensors, in STAGES order; the transcript runs once here for the
    queries the later stages take."""
    batch, device = proof.commitments.shape[0], proof.commitments.device
    n_layers = 1 + cfg.n_inner_layers

    # transcript stages I-IV: the sequential channel SHA chain over B lanes
    def stages_i_iv(p):
        state = ch.init(p.commitments.shape[:-2], p.commitments.device)
        state = ch.mix_root(state, p.commitments[..., 0, :])
        state = ch.mix_root(state, p.commitments[..., 1, :])
        state, _, _ = ch.draw_qm31(state)
        state = ch.mix_root(state, p.commitments[..., 2, :])
        state, _, _ = ch.draw_qm31_point(state)
        ow = torch.cat([p.oods_trace.reshape(p.oods_trace.shape[:-2] + (-1,)),
                        p.oods_cp.reshape(p.oods_cp.shape[:-2] + (-1,))], dim=-1)
        state = ch.mix_words(state, ow)
        state, _, _ = ch.draw_qm31(state)
        state = ch.mix_root(state, p.fri_first_commit)
        state, _, _ = ch.draw_qm31(state)
        for i in range(cfg.n_inner_layers):
            state = ch.mix_root(state, p.fri_inner_commits[..., i, :])
            state, _, _ = ch.draw_qm31(state)
        state = ch.mix_words(state, p.fri_last)
        state = ch.mix_u64(state, p.pow_nonce[..., 0], p.pow_nonce[..., 1])
        state, queries = ch.draw_queries(state, cfg.n_queries, cfg.lde_log_size)
        return state.digest, queries

    # stage V: leaf hashing and 2Q Merkle paths
    def stage_v(p, q):
        trace_leaf = sha256.sha256_words(p.trace_evals)
        cp_leaf = sha256.sha256_words(p.cp_evals)
        leaves = torch.cat([trace_leaf, cp_leaf], dim=-2)
        sibs = torch.cat([p.trace_sibs, p.cp_sibs], dim=-3)
        roots = torch.cat([p.commitments[..., None, 1, :].expand(trace_leaf.shape),
                           p.commitments[..., None, 2, :].expand(cp_leaf.shape)], dim=-2)
        return merkle.verify_path(leaves, torch.cat([q, q], dim=-1), sibs, roots)

    # stage VI: query points and DEEP quotients
    def stage_vi(p, q):
        pts = verifier.query_points(cfg, q)
        oods_point = torch.stack([p.oods_trace[..., 0, :], p.oods_trace[..., 1, :]], dim=-2)
        return verifier.fri_answers(cfg, q, p.trace_evals, p.cp_evals, p.oods_cp[..., 0, :],
                                    oods_point, p.oods_trace, p.oods_cp, pts=pts)

    def stage_vi_points_only(q):
        return verifier.query_points(cfg, q)

    # stage VII: folds and layer Merkle walks (alphas faked as constants;
    # the real stage's op mix and shapes)
    def stage_vii(p, q, als):
        pts = verifier.query_points(cfg, q)
        coord_invs = verifier.batch_inv_m31(verifier.fri_fold_coords(cfg, q, pts))
        cur_q, cur_e = q, q.new_zeros(q.shape + (4,))
        roots = [p.fri_first_commit] + [p.fri_inner_commits[..., i, :]
                                        for i in range(cfg.n_inner_layers)]
        max_depth = cfg.fri_layer_depth(0)
        m_nodes, m_idx, m_sibs, m_roots, m_depths = [], [], [], [], []
        for l, root in enumerate(roots):
            node_idx = (cur_q & 0xFFFFFFFE) >> 1
            cur_q, cur_e, node = verifier._fri_layer(
                cur_q, cur_e, p.fri_witnesses[l], coord_invs[l], als[l])
            depth = cfg.fri_layer_depth(l)
            sib = p.fri_sibs[l]
            if depth < max_depth:
                sib = torch.cat([sib, sib.new_zeros(sib.shape[:-2] + (max_depth - depth, 8))],
                                dim=-2)
            m_nodes.append(node)
            m_idx.append(node_idx)
            m_sibs.append(sib)
            m_roots.append(root[..., None, :].expand(node.shape))
            m_depths.extend([depth] * cfg.n_queries)
        ok = merkle.verify_path_padded(
            torch.cat(m_nodes, dim=-2), torch.cat(m_idx, dim=-1), torch.cat(m_sibs, dim=-3),
            torch.cat(m_roots, dim=-2), const(tuple(m_depths), q.device, torch.int32))
        return ok, cur_e

    def full(p):
        return verifier.verify_batch(p, cfg, linkage="reference")

    queries = stages_i_iv(proof)[1]
    alphas = [torch.full((batch, 4), 7 + i, dtype=WORD, device=device) for i in range(n_layers)]
    return [
        ("stages_i_iv", stages_i_iv, (proof,)),
        ("stage_v", stage_v, (proof, queries)),
        ("stage_vi", stage_vi, (proof, queries)),
        ("stage_vi_points_only", stage_vi_points_only, (queries,)),
        ("stage_vii", stage_vii, (proof, queries, alphas)),
        ("full", full, (proof,)),
    ]


def tiled_calls(tb, cfg) -> list:
    """(name, fn, args) of each tiled-path stage over a tiled batch, in
    TILED_STAGES order, with seeded synthetic queries, roots and fold
    inputs."""
    batch, q_n = tb.commitments.shape[0], cfg.n_queries
    lanes, n_layers = batch * q_n, 1 + cfg.n_inner_layers
    device = tb.commitments.device
    rng = np.random.default_rng(0)

    def i32(a):  # seeded words -> int32 bit patterns on the device
        return torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(device)

    # synthetic per-lane inputs (shape-correct; values irrelevant to cost)
    q_t = i32(rng.integers(0, 1 << cfg.lde_log_size, lanes))
    root8 = i32(rng.integers(0, 1 << 32, (batch, 8)))
    depths = [cfg.fri_layer_depth(l) for l in range(n_layers)]
    ev4 = i32(rng.integers(0, (1 << 31) - 1, (4, lanes)))
    cinvs = i32(rng.integers(1, (1 << 31) - 1, (n_layers, lanes)))
    alphas = i32(rng.integers(0, (1 << 31) - 1, (batch, n_layers, 4)))
    roots_t = i32(rng.integers(0, 1 << 32, (batch, n_layers, 8)))
    queries = torch.from_numpy(
        rng.integers(0, 1 << cfg.lde_log_size, (batch, q_n))).to(device)

    def stage_v_trace(ev, qq):
        return fri.leafwalk(ev, qq, tb.trace_sibs_t, root8)

    def stage_v_cp(ev, qq):
        return fri.leafwalk(ev, qq, tb.cp_sibs_t, root8)

    def fri_fused(qq, ev):
        return fri.fri_all_layers(qq, ev, tb.fri_wits_t, cinvs, alphas, tb.fri_sibs_t,
                                  roots_t, depths)

    def points_only(qq):
        return verifier.query_points(cfg, qq)

    # stage VI with the point-table gather, on the tiled eval columns
    def stage_vi(qq):
        def unlane(x):  # (W, lanes) int32 -> (B, Q, W) int64 words
            return from_i32(x).reshape(-1, batch, q_n).permute(1, 2, 0)

        pts = verifier.query_points(cfg, qq)
        oods_point = torch.stack([tb.oods_trace[..., 0, :], tb.oods_trace[..., 1, :]], dim=-2)
        return verifier.fri_answers(cfg, qq, unlane(tb.trace_evals_t), unlane(tb.cp_evals_t),
                                    tb.oods_cp[..., 0, :], oods_point, tb.oods_trace,
                                    tb.oods_cp, pts=pts)

    def full(t):
        return verifier.verify_batch_tiled(t, cfg, linkage="reference")

    return [
        ("stage_v_trace", stage_v_trace, (tb.trace_evals_t, q_t)),
        ("stage_v_cp", stage_v_cp, (tb.cp_evals_t, q_t)),
        ("fri_fused", fri_fused, (q_t, ev4)),
        ("points_only", points_only, (queries,)),
        ("stage_vi", stage_vi, (queries,)),
        ("full", full, (tb,)),
    ]


def _profile(calls, iters: int, batch: int) -> list:
    return [time_stage(name, fn, args, iters, batch, _accepted if name == "full" else None)
            for name, fn, args in calls]


def profile_standard(proof_batch, cfg=PRODUCTION, iters: int = 5, device="cuda") -> list:
    """Per-stage lines of the standard path over a numpy proof batch."""
    return _profile(standard_calls(P.to_torch(proof_batch, device), cfg), iters,
                    proof_batch.commitments.shape[0])


def profile_tiled(proof_batch, cfg=PRODUCTION, iters: int = 5, device="cuda") -> list:
    """Per-stage lines of the tiled path over a numpy proof batch."""
    return _profile(tiled_calls(tiled.tile_batch(proof_batch, cfg, device), cfg), iters,
                    proof_batch.commitments.shape[0])


def main_tiled(batch: int, iters: int, device="cuda") -> int:
    """Per-stage profile of the tiled path (verify_batch_tiled)."""
    for line in profile_tiled(production_batch(batch), PRODUCTION, iters, device):
        print(json.dumps(line))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile-verify")
    ap.add_argument("--tiled", action="store_true", help="profile the tiled path")
    ap.add_argument("batch", nargs="?", type=int, default=2048)
    ap.add_argument("iters", nargs="?", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    print(json.dumps({"card": card(device), "device": device}))
    if args.tiled:
        return main_tiled(args.batch, args.iters, device)
    for line in profile_standard(production_batch(args.batch), PRODUCTION, args.iters, device):
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
