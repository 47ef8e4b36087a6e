#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python chip_smoke.py

Drives the port's paths through the entry points of
``stark_symphony_tpu_torch.entry``: the main path, the batched stwo
verifier at the PRODUCTION config, through ``entry()`` (the standard path,
kernels K1-K3) and ``entry_tiled()`` (the tiled fast path, kernels K1, K4
and K5); then the stark101 family at the reference configuration, its
prover through ``prove_stark101()`` (K1, K2) and its batched verifier
through ``entry_stark101()`` (K1, K3); then the stwo prover through
``prove_stwo()`` (K1, K2) and routed verification of its wide_product
proofs beside the fixtures (``parallel.expert.verify_batch_routed``, K1-K3);
then the sharded layer on 8 shards of one card: DP, TP and routed
verification (K1-K3 in every shard), the domain-sharded FRI fold and
commit, the sharded prover through ``prove_stwo_sharded()`` (K1, K2) and
two processes counting one batch; then the tools: the debug CLI's
verifies (K1-K3), the linkage audit's transcript (K1) and the per-stage
profiler over both paths (K1-K6); then what the JAX package compiles, as
CUDA graphs: the three provers (``graphed=True``; K1, K2; the sharded
one's shards inside its graph), routed verify and DP, TP, GSPMD and
routed-sharded with a graph a shard (K1-K3).  Each
path's launches are counted from 0 just before it runs and read just
after.  In phases:

  (a) device: needs CUDA (exits non-zero without it) and prints the card's
      name and power limit as nvidia-smi reports them;
  (b) build: compiles the kernels K1-K6 from ``stark_symphony_tpu_torch/csrc``
      (one nvcc process per source, all at once) and prints ptxas's
      registers, shared memory and spills for each;
  (c) kernels: each kernel against its plain PyTorch version on the card, bit
      for bit, on seeded random words at ragged lane counts (words >= P and
      >= 2^31 included; K1-K3 at both of their block sizes, K2 with a
      broadcast and a misaligned operand, K3 with per-lane and per-query
      depths and a broadcast sibling path; about half the K4/K5 lanes carry
      valid paths), and a few lanes against hashlib; and the stark101
      shapes: K1 on 1-word messages at 4,097 lanes and on 1 lane and on
      unbatched 8-, 9- and 16-word messages, K2 on the even and odd rows of a
      tree level (read in place) at 1, 2 and 4,097 lanes, K3 at depths
      13..4 repeated with period 20 on 4,100 lanes; and the stwo prover's
      shapes: K1 on 8,192 4-word leaves and K2 on every level of their
      tree (rows in place), against plain level by level and a hashlib
      tree, and K1 on the 4,096-lane PoW message (n = 10);
  (d) standard path: 4,096 PRODUCTION proofs (the 256 committed fixtures, 16
      times each) must all be accepted; a 16-proof batch carrying the 15
      tamper classes in lanes 1-15 must reject exactly those lanes, with every
      mask equal to the port's own CPU run;
  (d') tiled path: the same 4,096 proofs through ``entry_tiled()`` must all be
      accepted, and the tamper batch, tiled on the card, must give every mask
      of the CPU run; the time of ``tile_batch`` (H2D and the on-device
      relayout) is printed;
  (e) launch counts, per path, each counted from 0 over one run: standard K1,
      K2, K3 > 0, K6 = 1 and no K4/K5; tiled K1 > 0, K4 = 2, K5 = 1, K6 = 1
      and no K2/K3 (K6 once in every stwo verify, graphed ones included);
  (f) at the shapes each path gives each kernel: kernel and plain version
      compared bit for bit again (K4/K5 on inputs where both ok values
      occur, as in (c)), then timed with CUDA events, beside each
      path's proofs/s (median of 3 batches, each timed alone); K6, stage
      VI's DEEP quotients (``verifier.fri_answers`` on the card), against
      ``fri_answers_plain`` on the card word for word: the 4,096-proof
      batch with the 15 tamper classes, the same with non-canonical words
      (x + P, 2^31 + k, 2^32 - 1, 0) in its evals, OODS values and alpha,
      a TP slice (Q = 4) and batches of 1 and 257 proofs, one launch a
      call, then timed beside its plain version and bound; for every
      kernel, torch.profiler over one wrapper call must show one device
      activity, the stpu:: kernel itself, and K3 is timed in blocks of 32
      and of 128 threads;
      torch.profiler over one batch of each path gives the device's busy
      share and each kernel's own device time, with the launches it saw
      beside those counted, and where it saw fewer, which ones it missed;
  (g) stark101: ``prove_stark101()`` on the card must give the golden
      fixture word for word, field by field, and the CPU run's query
      index; ``entry_stark101()`` must accept all 4,096 lanes; a batch of
      lane 0 clean and the STARK101_TAMPERS classes in lanes 1-10 must
      reject exactly those lanes, every mask equal to the port's CPU run;
      the launches of one prove and of one verifier batch must equal
      PATHS; K1-K3 at the stark101 shapes are compared and timed as in
      (f); the verifications/s (median of 3 batches of 4,096, each timed
      alone), the device's busy share of a profiled batch and the seconds
      of one prove are printed;
  (h) graphs: K1 at n = 88 in 128-lane blocks (its launcher sets the
      shared-memory attribute inside the capture) captured and replayed
      against eager; then each verifier captured once as a CUDA graph
      through its entry point with ``graphed=True``
      (``tools/build.capture``) and replayed:
      launches at capture equal the eager run's; the bitmap and every mask
      equal the eager run's, bit for bit, on the valid batch and on the
      batch with the tamper classes in lanes 1-15 (stark101 1-10); eager
      and graphed batch ms, the busy share of a profiled replay, capture
      and instantiate seconds and the graph pool's memory, each with the
      card's name and power limit; then ``make_chained`` (chain 2), the
      stream (``parallel/pipeline.StreamVerifier``, 8 host batches) and
      ``tools.build``'s build and ``--load --check``, each against eager;
  (i) stwo prover and routed verify: ``prove_stwo()`` at PRODUCTION,
      unseeded and seeds 0-3, each proof equal to its committed fixture
      in every field (a mismatch names the field and the first differing
      index), K1 and K2 counted over each proof, equal to PATHS, the
      seconds of the first proof and the median of the others; a
      wide_product proof accepted by ``verify`` under its AIR and rejected
      under wide_fibonacci (oods_cp_match alone); ``verify_batch_routed``
      over 4,096 lanes alternating the fixtures (air_id 0) and that proof
      (air_id 1): all accepted, all rejected with swapped ids, every mask
      equal to the single-AIR verify of its lanes, its launches counted
      and its batch ms; K1 and K2 at the prover's shapes compared and
      timed as in (f); torch.profiler over one proof;
  (j) the sharded layer, 8 shards on cuda:0 (``phase_parallel``):
      ``verify_batch_dp`` over the 4,096-lane batch with the tamper classes
      in lanes 1-15, equal to the unsharded ``verify`` in the bitmap and
      every stage's mask (4,081 accepted); ``verify_batch_tp`` and the
      GSPMD counterpart at dp2 x tp4 on 512 of those lanes, likewise; K3
      at a TP shard's FRI walk (256 proofs x 9 layers x 4 queries, depth
      period 36) against plain and hashlib, and timed beside its plain
      version and bound, its device time profiled;
      ``verify_batch_routed_sharded`` on phase (i)'s routed batch, equal
      to ``verify_batch_routed``; the stwo fold and commit (every level)
      at lde 13 and 18 and the stark101 fold at 8,192 over 10 stages,
      against their single-device oracles, then each with
      ``graphed=True`` (a graph a shard body, captured once; the
      exchanges eager), equal to the eager call three times, the lde-18
      commit's graphs launching 8 K1 and 63 K2;
      ``prove_stwo_sharded()`` at PRODUCTION s0, equal to its fixture (the
      bound of one proof's K1 and K2 launches printed), and the lde-18 BIG
      proof accepted by ``verify`` and rejected with one FRI
      witness word flipped; two processes (gloo, one card), each verifying
      half the DP batch, both counting 4,081; ``dryrun_multichip(4)``; the
      launches of each path equal PATHS; torch.profiler over one sharded
      proof (device busy, K1/K2 device ms); with two or more devices
      (``phase_multi_gpu``), the DP weak scaling efficiency over them, in
      one process and in one process a device (nccl, each process's
      share of the cards it sees), and TP, the SP
      blocks and the sharded prover across them, eager and graphed (the
      prover in its per-shard layout), else "not measured";
  (k) the tools (``phase_tools``): ``tools/debug`` on proof_test.json,
      proof.json and the golden stark101 proof, and with ``--ops
      --ops-filter m31_mul,sha256_pair --limit 50``, each output and exit
      code equal to the CPU run's, text for text, and proof.json's verify
      under the transcript recorder launching what a plain verify does
      (61 / 9 / 2); the linkage audit of proof.json (rank 11 against 12,
      inconsistent) and of the own PRODUCTION proof (consistent);
      ``tools/profile_verify`` over both paths at B = 4,096, every stage
      graphed equal to eager, ``full`` accepting all, each stage's K1-K6
      launches as PROFILE_LAUNCHES, the per-stage lines printed;
      ``STPU_CHECK=1``: a TESTING verify accepts, ``m31_add`` on a lane
      holding P raises FloatingPointError, a capture of the verify raises
      EagerOnlyError; ``BatchCheckpointer`` over 8 graphed tiled batches,
      stopped after 4 and resumed, counting what the run never stopped
      counts;
  (l) compiled (``phase_compiled``): ``prove_stwo(graphed=True)`` at
      PRODUCTION, unseeded and seeds 0-3 (graph A through the first PoW
      chunk, one read of 3 words, graph B), each proof equal to its
      fixture and to phase (i)'s eager proof word for word, A's and B's
      launches together PATHS' (53 K1, 107 K2), the counts over all 5
      proofs those of one warm-up and one capture; capture, instantiate
      and pool of A and B, the first call and the median of 4 replays,
      the device's busy share of a profiled graphed proof; TESTING at 20
      PoW bits, where A's chunk misses and the eager grind carries on,
      equal to its eager proof; ``prove_stark101(graphed=True)`` equal to
      the golden proof and to eager, 37 K1 and 98 K2 in its graph;
      routed verify captured (``tools/build.capture``), phase (i)'s bitmap
      and masks; DP, TP, GSPMD and routed-sharded with ``graphed=True`` on
      8 shards of cuda:0, twice each, phase (j)'s bitmaps, counts and
      masks, each shard's capture seconds, the shard graphs' launches
      against PATHS (8 x 61 / 9 / 2; GSPMD replays TP's graphs), the
      seconds of a call with its ingestion, a graphed DP call split into
      its graph replays' host ms and their span on the device;
      ``prove_stwo_sharded(graphed=True)`` over 8 shards of cuda:0 (graph
      A through the first PoW chunk with every shard's launches and
      exchanges inside it, one read of 3 words, graph B), PRODUCTION s0
      equal to its fixture and to phase (j)'s eager proof, s1 through the
      same graphs equal to its fixture, the graphs' launches PATHS' (116
      K1, 269 K2), the first call, the median of 5 replays, the graphs'
      capture, instantiate and pool, the busy share and the host launches
      outside the graphs of a profiled call; TESTING at 20 PoW bits over 8
      shards, continued, equal to eager.  The per-shard layout, which a
      mesh over several devices takes, over 8 shards of cuda:0 through
      ``prover_sharded.per_shard_prover`` (graph A as one graphed sharded
      call: ``_pre_fri``, each transcript step and the small layers with
      the first PoW chunk in graphs on the first shard, every leaf hash,
      level and fold in a graph a shard; graph B): PRODUCTION s0 equal
      to its fixture four times and s1 through the same graphs, one
      capture, its graphs' launches PATHS' (116 K1, 269 K2) and none
      through the wrappers on the replays, its time beside graph A's, the
      graphs' capture, instantiate and pools, a call split by its graph
      replays.  With several devices, ``phase_multi_gpu`` runs the same
      over 8 shards spread over them through ``prove_sharded(graphed=
      True)``.

Any failure raises and exits non-zero.  The last line is the JSON object
``{"ok": true, "device": {...}}``; the line before it lists the kernels,
each with its launches on the main path and on every path that runs it,
its time, its plain version's time and its bound: the larger of
the bytes its inputs and outputs move at the card's memory rate and the
integer ALU instructions its SHA-256 compressions need at the card's
issue rate for them (``bound()``).
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
CARD = "not read"  # the card's name and power limit, as nvidia-smi gives them
PACKAGE = "stark_symphony_tpu_torch"
N_PROOFS = 4096
LANES = 4097  # not a multiple of any block size: the ragged edge runs
PROVER_SEEDS = [None] + list(range(4))  # the PRODUCTION proofs (i) and (l) make
BIG_LANES = 33_793  # K1-K3 take 128-lane blocks from 33,792 lanes: 264 and 1

# The 15 tamper classes of tests/test_pow_production.py (PROD_TAMPERS):
# (field, mutation, index into a tuple field or None).  The port's CPU tests
# apply this list, and check it against the JAX suite's.
PROD_TAMPERS = [
    ("trace_evals", lambda a: a + 1, None),
    ("trace_sibs", lambda a: a ^ 1, None),
    ("cp_evals", lambda a: a ^ 1, None),
    ("cp_sibs", lambda a: a ^ 4, None),
    ("oods_trace", lambda a: a ^ 1, None),
    ("oods_cp", lambda a: a ^ 2, None),
    ("fri_first_commit", lambda a: a ^ 1, None),
    ("fri_inner_commits", lambda a: a ^ 1, None),
    ("fri_last", lambda a: a ^ 1, None),
    ("fri_witnesses", lambda a: a ^ 1, 0),
    ("fri_witnesses", lambda a: a + 1, 4),
    ("fri_sibs", lambda a: a ^ 1, 0),
    ("fri_sibs", lambda a: a ^ 2, 5),
    ("pow_nonce", lambda a: a + 1, None),
    ("commitments", lambda a: a ^ 1, None),
]


# The stark101 tamper classes: test_stark101.py's five (evals + 1,
# fri_betas ^ 1, cpa_evals ^ 1, last ^ 1, p_mt_root ^ 1), then one class for
# each other field, a tuple field at one layer.  Same layout as PROD_TAMPERS.
STARK101_TAMPERS = [
    ("evals", lambda a: a + 1, None),
    ("fri_betas", lambda a: a ^ 1, None),
    ("cpa_evals", lambda a: a ^ 1, None),
    ("last", lambda a: a ^ 1, None),
    ("p_mt_root", lambda a: a ^ 1, None),
    ("eval_sibs", lambda a: a ^ 1, None),
    ("fri_roots", lambda a: a ^ 1, None),
    ("cpb_evals", lambda a: a ^ 1, None),
    ("cpa_sibs", lambda a: a ^ 1, 3),
    ("cpb_sibs", lambda a: a ^ 2, 7),
]


def tamper_lanes(batch, tampers):
    """A copy of a numpy proof batch (either proof system) with lane k
    tampered by the k-th class of `tampers`, k = 1, 2, ...; a tuple field's
    index is taken mod the field's length (the proof's FRI layer count)."""
    batch = type(batch)(*(tuple(a.copy() for a in x) if isinstance(x, tuple) else x.copy()
                          for x in batch))
    fields = batch._asdict()
    for lane, (field, mutate, idx) in enumerate(tampers, 1):
        arr = fields[field] if idx is None else fields[field][idx % len(fields[field])]
        arr[lane] = mutate(arr[lane])
    return batch


def stark101_tamper_batch(proof):
    """A batch of 1 + len(STARK101_TAMPERS) copies of a numpy stark101
    proof: lane 0 clean, lane k tampered by the k-th class."""
    from stark_symphony_tpu_torch.models.stark101 import proof as P101

    return tamper_lanes(P101.replicate(proof, 1 + len(STARK101_TAMPERS)), STARK101_TAMPERS)


def tamper_batch(proof, n_layers: int):
    """A batch of 1 + 15 copies of a numpy proof: lane 0 clean, lane k
    tampered by the k-th class.  A tuple field's index is taken mod
    `n_layers`, the proof's FRI layer count (9 at PRODUCTION)."""
    from stark_symphony_tpu_torch.models.stwo import proof as P

    if len(proof.fri_witnesses) != n_layers:
        raise ValueError(f"the proof has {len(proof.fri_witnesses)} FRI layers, not {n_layers}")
    return tamper_lanes(P.replicate(proof, 1 + len(PROD_TAMPERS)), PROD_TAMPERS)


KERNELS = {  # wrapper name -> (kernel, source, Pallas function it replaces,
    #                           its device function)
    "sha256_words": ("K1", "csrc/sha256.cu",
                     "stark_symphony_tpu/ops/pallas/sha256_kernel.py:221",
                     "sha256_words_kernel"),
    "sha256_pair": ("K2", "csrc/sha256.cu",
                    "stark_symphony_tpu/ops/pallas/sha256_kernel.py:265",
                    "sha256_pair_kernel"),
    "merkle_walk": ("K3", "csrc/sha256.cu",
                    "stark_symphony_tpu/ops/pallas/sha256_kernel.py:312",
                    "merkle_walk_kernel"),
    "leafwalk": ("K4", "csrc/fri.cu", "stark_symphony_tpu/ops/pallas/fri_kernel.py:200",
                 "leafwalk_kernel"),
    "fri_all_layers": ("K5", "csrc/fri.cu", "stark_symphony_tpu/ops/pallas/fri_kernel.py:314",
                       "fri_kernel"),
    "deep_quotients": ("K6", "csrc/deep.cu",
                       "none (stark_symphony_tpu/models/stwo/verifier.py fri_answers, "
                       "XLA's fusion)", "deep_quotients_kernel"),
}
# Each path's launch counts expected on one batch (stark101_prove: one
# proof); a count of None means "more than 0".  A verifier path's profile
# must show the device function of every kernel it launches.  stark101: the
# transcript's 29 K1 hashes (genesis, 14 draws, 10 root mixes, 4 mix_u32)
# and the two leaf batches, the trace walk and the FRI walk.
# stark101_prove: 11 leaf batches and 26 transcript hashes on K1, one K2
# launch a tree level (13 + 13 + 12 + ... + 4 = 98).  stwo_prover (one
# PRODUCTION proof): K1 on the trace, CP and 9 FRI leaf batches, 41
# transcript hashes and one chunk of PoW candidates; K2 one launch a
# level (13 + 13 + 13 + 12 + ... + 5 = 107).  routed: the standard path's
# stwo verifier over a mixed batch.  dp, tp and routed_sharded (phase j):
# that verifier once on each of 8 shards of one card (a TP shard runs the
# whole transcript and launches as many kernels over fewer queries).
# stwo_prover_sharded (one PRODUCTION proof over 8 shards, every FRI layer
# of log 13..5 sharded): K1 on the trace and CP leaves, one leaf batch a
# shard a FRI layer, the 41 transcript hashes and one PoW chunk; K2 on
# the trace and CP trees' 13 levels each, and on a FRI layer of log n its
# n - 3 sharded levels on the 4 shards that keep their nodes, then 3 top
# levels on the first shard.
PATHS = {
    "standard": {"sha256_words": None, "sha256_pair": None, "merkle_walk": None,
                 "leafwalk": 0, "fri_all_layers": 0},
    "tiled": {"sha256_words": None, "sha256_pair": 0, "merkle_walk": 0,
              "leafwalk": 2, "fri_all_layers": 1},
    "stark101": {"sha256_words": 31, "sha256_pair": 0, "merkle_walk": 2,
                 "leafwalk": 0, "fri_all_layers": 0},
    "stark101_prove": {"sha256_words": 37, "sha256_pair": 98, "merkle_walk": 0,
                       "leafwalk": 0, "fri_all_layers": 0},
    "stwo_prover": {"sha256_words": 53, "sha256_pair": 107, "merkle_walk": 0,
                    "leafwalk": 0, "fri_all_layers": 0},
    "routed": {"sha256_words": 61, "sha256_pair": 9, "merkle_walk": 2,
               "leafwalk": 0, "fri_all_layers": 0},
    "dp": {"sha256_words": 8 * 61, "sha256_pair": 8 * 9, "merkle_walk": 8 * 2,
           "leafwalk": 0, "fri_all_layers": 0},
    "tp": {"sha256_words": 8 * 61, "sha256_pair": 8 * 9, "merkle_walk": 8 * 2,
           "leafwalk": 0, "fri_all_layers": 0},
    "routed_sharded": {"sha256_words": 8 * 61, "sha256_pair": 8 * 9, "merkle_walk": 8 * 2,
                       "leafwalk": 0, "fri_all_layers": 0},
    "stwo_prover_sharded": {"sha256_words": 2 + 9 * 8 + 41 + 1,
                            "sha256_pair": 26 + sum(4 * (log - 3) + 3 for log in range(5, 14)),
                            "merkle_walk": 0, "leafwalk": 0, "fri_all_layers": 0},
    "debug": {"sha256_words": 61, "sha256_pair": 9, "merkle_walk": 2,
              "leafwalk": 0, "fri_all_layers": 0},
    "linkage_audit": {"sha256_words": 41, "sha256_pair": 0, "merkle_walk": 0,
                      "leafwalk": 0, "fri_all_layers": 0},
    "profile_standard": {"sha256_words": 41 + 2 + 18 + 61, "sha256_pair": 9 + 9,
                         "merkle_walk": 1 + 1 + 2, "leafwalk": 0, "fri_all_layers": 0},
    "profile_tiled": {"sha256_words": 41, "sha256_pair": 0, "merkle_walk": 0,
                      "leafwalk": 1 + 1 + 2, "fri_all_layers": 1 + 1},
}
# K6 runs once in every stwo verify, on the card's stage VI: once a batch
# of the standard, tiled and routed paths and of debug's verify, once a
# shard of dp, tp and routed_sharded, once in each of the per-stage
# profiler's stage VI and full (both paths).
_DEEP = {"standard": 1, "tiled": 1, "routed": 1, "dp": 8, "tp": 8, "routed_sharded": 8,
         "debug": 1, "profile_standard": 2, "profile_tiled": 2}
for _path, _row in PATHS.items():
    _row["deep_quotients"] = _DEEP.get(_path, 0)
# (l): JAX's compiled programs as CUDA graphs launch what their eager runs
# do: the stwo prover's graphs A and B together (the first PoW chunk in A),
# stark101's body, routed verify, one graph a shard of dp, tp and
# routed_sharded (gspmd replays tp's), and the sharded prover's A and B
# (every shard's launches inside A)
PATHS.update({f"{path}_graphed": dict(PATHS[path]) for path in (
    "stwo_prover", "stark101_prove", "routed", "dp", "tp", "routed_sharded",
    "stwo_prover_sharded")})
# (j), (l): the graphed sharded calls' per-shard graphs launch what the
# eager calls do: the lde-18 commit over 8 shards one K1 a shard for the
# leaves, 15 levels of 4 K2 and 3 top levels on the first device; the
# sharded prover's per-shard layout the eager sharded proof's launches,
# over its program's graphs and graph B
PATHS["sp_commit_graphed"] = {"sha256_words": 8, "sha256_pair": 15 * 4 + 3, "merkle_walk": 0,
                              "leafwalk": 0, "fri_all_layers": 0, "deep_quotients": 0}
PATHS["stwo_prover_per_shard_graphed"] = dict(PATHS["stwo_prover_sharded"])
# (k): each profiled stage's launches over one eager call (tools/profile_verify);
# PATHS' profile_* rows are their sums.  debug (proof.json, PRODUCTION):
# one standard verify; linkage_audit: its transcript, stages I-IV's 41 K1.
PROFILE_LAUNCHES = {
    "profile_standard": {
        "stages_i_iv": {"sha256_words": 41},
        "stage_v": {"sha256_words": 2, "merkle_walk": 1},
        "stage_vi": {"deep_quotients": 1}, "stage_vi_points_only": {},
        "stage_vii": {"sha256_words": 18, "sha256_pair": 9, "merkle_walk": 1},
        "full": {"sha256_words": 61, "sha256_pair": 9, "merkle_walk": 2,
                 "deep_quotients": 1}},
    "profile_tiled": {
        "stage_v_trace": {"leafwalk": 1}, "stage_v_cp": {"leafwalk": 1},
        "fri_fused": {"fri_all_layers": 1}, "points_only": {},
        "stage_vi": {"deep_quotients": 1},
        "full": {"sha256_words": 41, "leafwalk": 2, "fri_all_layers": 1,
                 "deep_quotients": 1}},
}
PROFILE_ITERS = 1

# The bound of a kernel call: the larger of bytes / memory rate and integer
# instructions / integer issue rate, on an H100 SXM.  The memory rate and
# the clock are the published ones (3.35 TB/s; 67 TFLOP/s float32 is
# 132 SMs x 128 lanes x 2 x 1.98 GHz).  The instructions counted are the
# funnel shifts, shifts and three-input logic ops (LOP3) of SHA-256, which
# issue on the integer ALU pipe alone, 64 lanes per SM: a round has 10
# (Sigma0 and Sigma1 three shifts and a LOP3 each, ch and maj a LOP3 each),
# a schedule word 8, so a compression over data has 1,024 and one whose
# schedule is a constant (a block of padding alone) 640.  The additions are
# left out, since the compiler may issue them on the FMA pipe, and so are
# the fold's field arithmetic and the compares: the bound is a lower one.
MEM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9
OPS_DATA_COMPRESS = 1024
OPS_CONST_COMPRESS = 640
OPS_NODE = OPS_DATA_COMPRESS + OPS_CONST_COMPRESS
# K6 (stage VI) does M31 arithmetic, no SHA-256: an M31 multiply
# (csrc/m31.cuh m31_mul) takes on that pipe at least two LOP3 (lo & P,
# x & P) and two shifts (the funnel of hi:lo, x >> 31); its 32 x 32 -> 64
# multiply, the additions and the compares are left out, and so are all
# additions outside the multiplies.
OPS_M31_MUL = 4


def deep_multiplies(lanes: int, proofs: int, samples: int) -> int:
    """M31 multiplies stage VI needs at the least: a lane the denominator
    (two CM31 products, 8, and its inverse: two squares, the 37 of m31_inv
    and 2), a QM31-by-M31 product twice a sample (8) and the closing
    QM31-by-CM31 and QM31 products (8 + 16); a proof, a sample's
    interpolant (two QM31 products for c, three for the alpha scaling) and
    the next power of alpha, six QM31 products of 16."""
    return lanes * (8 + 41 + 8 * samples + 24) + proofs * samples * 6 * 16


def _ops_sha_words(n: int) -> int:
    """Integer instructions of SHA-256 over an n-word message."""
    blocks = (n + 3 + 15) // 16
    const = 1 if n % 16 == 0 else 0  # a last block of padding alone
    return (blocks - const) * OPS_DATA_COMPRESS + const * OPS_CONST_COMPRESS


def bound(name: str, args, outs):
    """(bound_ms, bound_by, compressions) of one call of kernel `name` on
    these arguments: each input tensor read once and each output written
    once, against the instructions this call's data needs."""
    import numpy as np
    import torch

    tensors = [a for a in args if isinstance(a, torch.Tensor)] + list(outs)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    if name == "sha256_words":
        lanes, n = args[0].numel() // args[0].shape[-1], args[0].shape[-1]
        ops, compr = lanes * _ops_sha_words(n), lanes * ((n + 3 + 15) // 16)
    elif name == "sha256_pair":
        lanes = args[0].numel() // 8
        ops, compr = lanes * OPS_NODE, lanes * 2
    elif name == "merkle_walk":
        leaf, _, sibs, depths = args
        lanes = leaf.numel() // 8
        if depths is None:
            levels = lanes * sibs.shape[-2]
        else:  # per-path depths broadcast over the leading batch axes
            levels = int(np.sum(depths)) * (lanes // np.size(depths))
        ops, compr = levels * OPS_NODE, levels * 2
    elif name == "deep_quotients":
        lanes, proofs = args[0].numel() // 2, args[3].numel() // 4
        ops = OPS_M31_MUL * deep_multiplies(lanes, proofs, args[1].shape[-1] + args[2].shape[-1])
        compr = 0
    elif name == "leafwalk":
        evals, _, sibs, _ = args
        lanes, n, depth = evals.shape[1], evals.shape[0], sibs.shape[0]
        ops = lanes * (_ops_sha_words(n) + depth * OPS_NODE)
        compr = lanes * ((n + 3 + 15) // 16 + 2 * depth)
    else:
        depths = args[-1]
        lanes = args[0].shape[0]
        per_layer = [2 * OPS_DATA_COMPRESS + OPS_NODE + d * OPS_NODE for d in depths]
        ops = lanes * sum(per_layer)
        compr = lanes * sum(4 + 2 * d for d in depths)
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / INT_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations",
            compr)


def _words(rng, *shape):
    """Seeded random words with the edge values of M31 and of uint32 mixed
    in: 0, 1, P - 1, P, 2^31, 2^32 - 2, 2^32 - 1."""
    import numpy as np

    x = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    flat = x.reshape(-1)
    k = flat.size // 16
    edges = np.array([0, 1, 0x7FFFFFFE, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                      0xFFFFFFFF], dtype=np.uint32)
    flat[rng.integers(0, flat.size, k)] = rng.choice(edges, k)
    return x


def _valid_proofs(arrays, n_proofs: int, n_queries: int):
    """Give every even proof's lanes the words of its first lane, so that
    one root serves them all (per-lane arrays: lanes on the last axis)."""
    for a in arrays:
        v = a.reshape(a.shape[:-1] + (n_proofs, n_queries))
        v[..., ::2, :] = v[..., ::2, :1].clone()


def leafwalk_case(rng, n_proofs: int, n_queries: int, n_words: int,
                  depth: int, device="cpu", valid: bool = True):
    """Seeded inputs of K4, int64 word tensors on `device`: evals
    (n_words, lanes), index (lanes,), sibs (depth, 8, lanes), roots
    (n_proofs, 8).  With `valid`, every even proof's root is the one its
    lanes' path gives (plain Merkle code), except one word of proof 2's."""
    import numpy as np

    from stark_symphony_tpu_torch.ops import fri
    from stark_symphony_tpu_torch.ops.u32 import from_numpy

    lanes = n_proofs * n_queries
    evals = _words(rng, n_words, lanes)
    index = rng.integers(0, 1 << depth, lanes, dtype=np.uint32) if depth else \
        np.zeros(lanes, np.uint32)
    sibs = _words(rng, depth, 8, lanes)
    roots = _words(rng, n_proofs, 8)
    arrays = [from_numpy(a, device) for a in (evals, index, sibs, roots)]
    if valid:
        _valid_proofs(arrays[:3], n_proofs, n_queries)
        made = fri.leaf_roots_plain(*arrays[:3])[::n_queries]
        arrays[3][::2] = made[::2]
        if n_proofs > 2:
            arrays[3][2, 5] ^= 1
    return arrays


def fri_case(rng, n_proofs: int, n_queries: int, depths, device="cpu",
             valid: bool = True):
    """Seeded inputs of K5, int64 word tensors on `device`: queries, evals,
    wits, cinvs, alphas, sibs, roots (see ``ops/fri.py``).  With `valid`,
    every even proof's layer roots are the ones its lanes give (plain FRI
    chain), except one word of proof 2's layer-1 root."""
    import numpy as np

    from stark_symphony_tpu_torch.ops import fri
    from stark_symphony_tpu_torch.ops.u32 import from_numpy

    lanes, n_layers = n_proofs * n_queries, len(depths)
    queries = rng.integers(0, 1 << (depths[0] + 1), lanes, dtype=np.uint32)
    queries[::97] = _words(rng, queries[::97].size)
    arrays = [from_numpy(a, device) for a in (
        queries, _words(rng, 4, lanes), _words(rng, n_layers, 4, lanes),
        _words(rng, n_layers, lanes), _words(rng, n_proofs, n_layers, 4),
        _words(rng, sum(depths), 8, lanes), _words(rng, n_proofs, n_layers, 8))]
    if valid:
        per_lane = [arrays[i] for i in (0, 1, 2, 3, 5)]
        _valid_proofs(per_lane, n_proofs, n_queries)
        made = fri.fri_roots_plain(*arrays[:6], depths)[0]  # (L, lanes, 8)
        arrays[6][::2] = made.transpose(0, 1)[::n_queries][::2]
        if n_proofs > 2 and n_layers > 1:
            arrays[6][2, 1, 0] ^= 1
    return arrays


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def _hashlib_words(words) -> list:
    import numpy as np

    raw = np.asarray(words, dtype=">u4").tobytes()
    return list(np.frombuffer(hashlib.sha256(raw).digest(), dtype=">u4"))


def _hashlib_root(leaf, idx, sibs, depth) -> list:
    cur = list(leaf)
    for lvl in range(depth):
        sib = list(sibs[lvl])
        pair = sib + cur if idx & 1 else cur + sib
        cur = _hashlib_words(pair)
        idx >>= 1
    return cur


def cuda_ms(fn, iters: int, warm: bool = False) -> float:
    """Mean milliseconds of fn() over iters runs, by CUDA events, after
    one warm-up run (none where the caller has just run fn: `warm`)."""
    import torch

    if not warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_call(fn):
    """(fn(), its milliseconds by CUDA events): one run, timed where it
    runs, with no warm-up (a plain version's comparison run, timed as it
    is made)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def reset_counts() -> None:
    from stark_symphony_tpu_torch.ops.cuda import deep_kernel as dk
    from stark_symphony_tpu_torch.ops.cuda import fri_kernel as fk
    from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck

    ck.reset_launches()
    fk.reset_launches()
    dk.reset_launches()


def launch_counts() -> dict:
    from stark_symphony_tpu_torch.tools.build import launch_counts as counts

    return counts()


def check_counts(path: str, counts: dict) -> None:
    """(e): the kernels launched in one batch of `path` are its own."""
    for name, want in PATHS[path].items():
        n = counts[name]
        if want is None:
            check(n > 0, f"{path} path: kernel {name} was not launched")
        else:
            check(n == want, f"{path} path: kernel {name} launched {n} times, want {want}")


def batch_ms(fn, batch, runs: int = 5):
    """(median, sorted runs) of fn(batch) in ms, each run timed alone with
    CUDA events."""
    import torch

    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2], times


def phase_device():
    import torch

    # torch.profiler tears CUPTI down after each session and sets it up
    # again for the next.  PyTorch keeps CUPTI up where its own CUDA graphs
    # run, as this script's do; so keep it up here too, before any session.
    # (The sessions that recorded no device activity late in a run did so
    # with or without the teardown; _pad_session is what keeps them whole.)
    os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"
    os.environ["TEARDOWN_CUPTI"] = "0"
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script runs "
                         "the port on an NVIDIA GPU and has no CPU mode")
    if not (ROOT / PACKAGE / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke: {PACKAGE}/ not found beside this "
                         "script; run it from a checkout of the repository")
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    CARD = smi[0].strip()
    log(CARD)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device_count {torch.cuda.device_count()}")


def phase_build():
    from stark_symphony_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    kern = build.load()
    seconds = time.perf_counter() - t0
    log(f"build: {kern.path.name} in {seconds:.2f} s (nvcc {kern.build_seconds:.2f} s)")
    for line in kern.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")


def phase_kernels(rng):
    """Each kernel against its plain version on the card, bit for bit."""
    import numpy as np
    import torch

    from stark_symphony_tpu_torch.ops import fri, merkle, sha256
    from stark_symphony_tpu_torch.ops.cuda import fri_kernel as fk
    from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
    from stark_symphony_tpu_torch.ops.u32 import from_i32, from_numpy, to_i32, to_numpy

    err = {name: 0 for name in KERNELS}
    check(ck.lane_threads(LANES) == 32 and ck.lane_threads(BIG_LANES) == 128,
          "K1-K3 block sizes at LANES and BIG_LANES are not 32 and 128")

    def compare(name, got, want, what):
        diff = int((got - want).abs().max().item()) if got.numel() else 0
        err[name] = max(err[name], diff)
        check(torch.equal(got, want), f"{name} != plain ({what}), max |diff| {diff}")

    # 4,097 lanes run 32-lane blocks; BIG_LANES run 128-lane ones (n = 88
    # with 90 KB of shared memory a block); both leave a ragged last block,
    # with an odd word count at odd n
    for lanes, ns in ((LANES, (4, 9, 10, 12, 16, 88)), (BIG_LANES, (9, 88))):
        for n in ns:
            msgs = _words(rng, lanes, n)
            t = from_numpy(msgs, "cuda")
            got = ck.sha256_words(t)
            compare("sha256_words", got, sha256.sha256_words_plain(t), f"n={n}, {lanes} lanes")
            host = to_numpy(got)
            for lane in (0, 1, lanes // 2, lanes - 1):
                check(list(host[lane]) == _hashlib_words(msgs[lane]),
                      f"sha256_words n={n} lane {lane} != hashlib")
    log(f"K1 sha256_words: bit-equal to plain and hashlib, n in 4,9,10,12,16,88 at "
        f"{LANES} lanes and 9,88 at {BIG_LANES}")

    # K2 in blocks of 32 (LANES) and of 128 (BIG_LANES), both ragged; then
    # one digest broadcast to every lane, against a left operand that lies
    # 8 bytes off a 16-byte boundary (both copied by the wrapper)
    for lanes in (LANES, BIG_LANES):
        left, right = _words(rng, lanes, 8), _words(rng, lanes, 8)
        lt, rt = from_numpy(left, "cuda"), from_numpy(right, "cuda")
        got = ck.sha256_pair(lt, rt)
        compare("sha256_pair", got, sha256.sha256_pair_plain(lt, rt), f"{lanes} lanes")
        host = to_numpy(got)
        for lane in (0, 1, lanes // 2, lanes - 1):
            check(list(host[lane]) == _hashlib_words(np.concatenate([left[lane], right[lane]])),
                  f"sha256_pair {lanes} lanes, lane {lane} != hashlib")
    left = _words(rng, LANES * 8 + 1)
    lt = from_numpy(left, "cuda")[1:].view(LANES, 8)
    check(lt.data_ptr() % 16 == 8, "sha256_pair: the misaligned operand is aligned")
    one = right[0]
    got = ck.sha256_pair(lt, from_numpy(one, "cuda"))
    compare("sha256_pair", got, sha256.sha256_pair_plain(lt, from_numpy(one, "cuda")),
            "misaligned left, broadcast right")
    host = to_numpy(got)
    for lane in (0, 1, LANES // 2, LANES - 1):
        check(list(host[lane]) == _hashlib_words(np.concatenate([left[1:].reshape(LANES, 8)[lane],
                                                                 one])),
              f"sha256_pair misaligned/broadcast lane {lane} != hashlib")
    log(f"K2 sha256_pair: bit-equal to plain and hashlib at {LANES} and {BIG_LANES} "
        f"lanes, and at {LANES} with a misaligned left and a broadcast right operand")

    # (batch shape, depth, per-path depths, sibling path shared by all
    # lanes): full depth; per-lane depths 0..D; depths per query, periodic
    # over the proofs as the FRI walk's are; a broadcast operand; 128-lane
    # blocks (paths of one depth at BIG_LANES)
    n_proofs, n_q = 241, 17  # LANES = 241 x 17
    k3_cases = (
        ((LANES,), 13, None, False),
        ((LANES,), 12, rng.integers(0, 13, LANES), False),
        ((n_proofs, n_q), 12, rng.integers(0, 13, n_q), False),
        ((n_proofs, n_q), 12, rng.integers(0, 13, n_q), True),
        ((BIG_LANES,), 13, None, False),
    )
    for bshape, depth, deps, shared in k3_cases:
        lanes = int(np.prod(bshape))
        leaf = _words(rng, *bshape, 8)
        sibs = _words(rng, *((depth, 8) if shared else bshape + (depth, 8)))
        idx = rng.integers(0, 1 << depth, bshape, dtype=np.uint32)
        args = (from_numpy(leaf, "cuda"), from_numpy(idx, "cuda"), from_numpy(sibs, "cuda"))
        got = ck.merkle_compute_root(*args, deps)
        want = merkle.compute_root_plain(*args, deps)
        what = (f"{bshape} depth {depth}, depths "
                f"{'none' if deps is None else np.shape(deps)}, shared path {shared}")
        compare("merkle_walk", got, want, what)
        host = to_numpy(got).reshape(lanes, 8)
        lane_deps = np.broadcast_to(depth if deps is None else deps, bshape).reshape(-1)
        flat_sibs = np.broadcast_to(sibs, bshape + (depth, 8)).reshape(lanes, depth, 8)
        for lane in (0, 1, lanes // 2, lanes - 1):
            check(list(host[lane]) == _hashlib_root(leaf.reshape(lanes, 8)[lane],
                                                    int(idx.reshape(-1)[lane]),
                                                    flat_sibs[lane], int(lane_deps[lane])),
                  f"merkle_walk ({what}) lane {lane} != hashlib")
    log(f"K3 merkle_walk: bit-equal to plain and hashlib at {LANES} lanes (depth 13; "
        f"per-lane depths 0..12; per-query depths over {n_proofs} x {n_q}, with and "
        f"without a shared sibling path) and at {BIG_LANES} lanes")

    # the stark101 shapes: K1 on 1-word messages (8-byte rows) at a ragged
    # lane count and on 1 lane, and on the prover's unbatched transcript
    # messages; K2 on the even and odd rows of a tree level, read in place;
    # K3 at depths 13..4, two paths a layer, period 20
    for shape in ((LANES, 1), (1, 1), (8,), (9,), (16,)):
        msgs = _words(rng, *shape)
        t = from_numpy(msgs, "cuda")
        got = ck.sha256_words(t)
        compare("sha256_words", got, sha256.sha256_words_plain(t), f"shape {shape}")
        host, rows = to_numpy(got).reshape(-1, 8), msgs.reshape(-1, shape[-1])
        for lane in sorted({0, len(rows) // 2, len(rows) - 1}):
            check(list(host[lane]) == _hashlib_words(rows[lane]),
                  f"sha256_words shape {shape} lane {lane} != hashlib")
    log(f"K1 sha256_words: bit-equal to plain and hashlib, n=1 at {LANES} lanes and "
        "1 lane, unbatched n in 8,9,16")
    for lanes in (1, 2, LANES):
        level = _words(rng, 2 * lanes, 8)
        t = from_numpy(level, "cuda")
        left, right = t[0::2], t[1::2]
        check(all(ck._pair_operand(x, tuple(x.shape))[0].data_ptr() == x.data_ptr()
                  for x in (left, right)), f"sha256_pair copies a tree level's rows")
        got = ck.sha256_pair(left, right)
        compare("sha256_pair", got, sha256.sha256_pair_plain(left, right),
                f"every other row, {lanes} lanes")
        host = to_numpy(got)
        for lane in sorted({0, lanes // 2, lanes - 1}):
            check(list(host[lane]) == _hashlib_words(level[2 * lane: 2 * lane + 2].reshape(-1)),
                  f"sha256_pair tree level of {lanes} lanes, lane {lane} != hashlib")
    log(f"K2 sha256_pair: bit-equal to plain and hashlib on the even and odd rows of "
        f"a tree level, read in place, at 1, 2 and {LANES} lanes")
    deps = np.repeat(np.arange(13, 3, -1), 2)
    bshape = (205, 20)
    leaf, sibs = _words(rng, *bshape, 8), _words(rng, *bshape, 13, 8)
    idx = rng.integers(0, 1 << 14, bshape, dtype=np.uint32)  # above 2^13 too
    args = (from_numpy(leaf, "cuda"), from_numpy(idx, "cuda"), from_numpy(sibs, "cuda"))
    got = ck.merkle_compute_root(*args, deps)
    compare("merkle_walk", got, merkle.compute_root_plain(*args, deps),
            "depths 13..4 with period 20")
    host = to_numpy(got).reshape(-1, 8)
    for lane in (0, 1, 19, 2050, 4099):
        check(list(host[lane]) == _hashlib_root(leaf.reshape(-1, 8)[lane],
                                                int(idx.reshape(-1)[lane]),
                                                sibs.reshape(-1, 13, 8)[lane],
                                                int(deps[lane % 20])),
              f"merkle_walk period-20 depths, lane {lane} != hashlib")
    log("K3 merkle_walk: bit-equal to plain and hashlib at depths 13..4 with period 20, "
        f"{205 * 20} lanes")

    # K4, K5: LANES = 241 proofs x 17 queries; even proofs carry valid paths
    for n_words in (4, 16):
        args = leafwalk_case(rng, n_proofs, n_q, n_words, 13, "cuda")
        got = from_i32(fk.leafwalk(*[to_i32(a).contiguous() for a in args]))
        compare("leafwalk", got, fri.leafwalk_plain(*args), f"n_words={n_words}")
        n_ok = int(got.sum().item())
        check(0 < n_ok < LANES, f"leafwalk n_words={n_words}: {n_ok} of {LANES} lanes ok")
        evals, idx, sibs, roots = (to_numpy(a) for a in args)
        host = to_numpy(got)
        # proof 0 valid, 1 random, 2 valid with a root word flipped, 4 valid
        for lane in (0, n_q + 1, 2 * n_q + 3, 4 * n_q + 5, LANES - 1):
            root = _hashlib_root(_hashlib_words(evals[:, lane]), int(idx[lane]),
                                 sibs[:, :, lane], 13)
            want = root == list(roots[lane // n_q])
            check(bool(host[lane]) == want, f"leafwalk lane {lane} != hashlib")
        log(f"K4 leafwalk: bit-equal to plain and hashlib, n_words={n_words}, "
            f"depth 13, {LANES} lanes, {n_ok} ok")

    depths = tuple(range(12, 3, -1))
    args = fri_case(rng, n_proofs, n_q, depths, "cuda")
    got = fk.fri_all_layers(*[to_i32(a).contiguous() for a in args], depths)
    want = fri.fri_all_layers_plain(*args, depths)
    for g, w, what in zip(got, want, ("ok", "folded", "q_out")):
        compare("fri_all_layers", from_i32(g), w, what)
    ok = to_numpy(from_i32(got[0]))
    check(ok[:, :n_q].all() and not ok[:, n_q:2 * n_q].any()
          and not ok[1, 2 * n_q:3 * n_q].any() and ok[0, 2 * n_q:3 * n_q].all(),
          "fri_all_layers: valid and broken proofs not told apart")
    log(f"K5 fri_all_layers: bit-equal to plain (ok, folded, q_out), depths "
        f"12..4, {LANES} lanes, {int(ok.sum())} of {ok.size} layer checks ok")
    return err


def phase_prover_kernels(rng, err):
    """(c), the stwo prover's shapes: K1 on the trace tree's 8,192 4-word
    leaves and K2 on every level of that tree, each level's even and odd
    rows read in place, against the plain versions level by level and
    against a hashlib tree; K1 on the 4,096-lane PoW message (a digest
    broadcast to every lane, then hi and lo) against plain and hashlib."""
    import numpy as np
    import torch

    from stark_symphony_tpu_torch.ops import merkle, sha256
    from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
    from stark_symphony_tpu_torch.ops.u32 import from_numpy, to_numpy

    def compare(name, got, want, what):
        diff = int((got - want).abs().max().item()) if got.numel() else 0
        err[name] = max(err[name], diff)
        check(torch.equal(got, want), f"{name} != plain ({what}), max |diff| {diff}")

    leaves = _words(rng, 8192, 4)
    digests = ck.sha256_words(from_numpy(leaves, "cuda"))
    compare("sha256_words", digests, sha256.sha256_words_plain(from_numpy(leaves, "cuda")),
            "trace leaves n=4, 8192 lanes")
    host = [_hashlib_words(row) for row in leaves]
    check(to_numpy(digests).tolist() == host, "sha256_words trace leaves != hashlib")
    levels = merkle.build_tree(digests)  # K2 on each level's even and odd rows
    check(len(levels) == 14, f"the trace tree has {len(levels)} levels, want 14")
    plain = digests
    for depth, level in enumerate(levels[1:], 1):
        plain = sha256.sha256_pair_plain(plain[0::2], plain[1::2])
        compare("sha256_pair", level, plain, f"trace tree level {depth}, {plain.shape[0]} lanes")
        host = [_hashlib_words(host[2 * i] + host[2 * i + 1]) for i in range(len(host) // 2)]
        check(to_numpy(level).tolist() == host, f"sha256_pair trace tree level {depth} != hashlib")
    log("K1/K2 at the stwo prover's trace tree: 8,192 4-word leaves and all 13 levels "
        "(4,096 to 1 lanes, rows in place) bit-equal to plain and to a hashlib tree")

    digest = _words(rng, 8)
    nonces = np.arange(4096, dtype=np.uint32) + np.uint32(1 << 20)
    lo = from_numpy(nonces, "cuda")[:, None]
    msg = torch.cat([from_numpy(digest, "cuda").expand(4096, 8),
                     torch.full_like(lo, 7), lo], dim=-1)
    got = ck.sha256_words(msg)
    compare("sha256_words", got, sha256.sha256_words_plain(msg), "PoW n=10, 4096 lanes")
    host = to_numpy(got)
    for lane in (0, 1, 2048, 4095):
        check(list(host[lane]) == _hashlib_words(list(digest) + [7, int(nonces[lane])]),
              f"sha256_words PoW lane {lane} != hashlib")
    log("K1 at the stwo prover's PoW message: n=10 (digest, hi, lo) at 4,096 lanes "
        "bit-equal to plain and hashlib")


def phase_slice(proofs):
    """(d), (e): the standard path at B = 4,096 through entry(); then the
    tamper matrix against the port's own CPU run.  Returns (launch counts,
    the median batch ms, the entry function, its batch, the CPU run's
    (bitmap, masks) of the tamper batch)."""
    import numpy as np
    import torch

    from stark_symphony_tpu_torch import entry as E
    from stark_symphony_tpu_torch.models.stwo import proof as P
    from stark_symphony_tpu_torch.models.stwo import verifier
    from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION

    t0 = time.perf_counter()
    fn, (batch,) = E.entry(N_PROOFS, "cuda", proofs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    nbytes = 4 * sum(t.numel() for f in batch
                     for t in (f if isinstance(f, tuple) else (f,)))
    log(f"batch: {N_PROOFS} proofs, {nbytes / 1e6:.1f} MB as uint32; entry() "
        f"set-up (stack, H2D, widen) {setup_s:.3f} s")

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bitmap = fn(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    log(f"standard path: verify_batch(B={N_PROOFS}) first run {first_s:.3f} s, "
        f"launches {counts}")
    check(tuple(bitmap.shape) == (N_PROOFS,), f"bitmap shape {tuple(bitmap.shape)}")
    n_ok = int(bitmap.sum().item())
    check(n_ok == N_PROOFS, f"{N_PROOFS - n_ok} of {N_PROOFS} valid proofs rejected")
    log(f"standard path: all {N_PROOFS} proofs accepted")
    check_counts("standard", counts)

    slice_ms, runs = batch_ms(fn, batch, runs=3)  # the first run above was the warm-up
    log(f"standard slice: {slice_ms:.3f} ms per {N_PROOFS}-proof batch "
        f"({N_PROOFS / (slice_ms / 1e3):.1f} proofs/s; CUDA events, median of "
        f"{len(runs)} runs: {', '.join(f'{r:.1f}' for r in runs)} ms)")

    # tamper matrix: lane 0 clean, lanes 1..15 one class each
    tb = tamper_batch(proofs[0], 1 + PRODUCTION.n_inner_layers)
    ok_g, masks_g = verifier.verify(P.to_torch(tb, "cuda"), PRODUCTION)
    ok_c, masks_c = verifier.verify(P.to_torch(tb, "cpu"), PRODUCTION)
    check_tamper("standard", ok_g, masks_g, ok_c, masks_c)
    return counts, slice_ms, fn, batch, (ok_c, masks_c)


def check_tamper(path, ok_g, masks_g, ok_c, masks_c) -> None:
    """Every lane but lane 0 rejected, lane 0 accepted, every mask of the
    card's run equal to the CPU run's, keys in the same order."""
    import numpy as np
    import torch

    bm = ok_g.cpu().numpy()
    check(bm[0] and not bm[1:].any(),
          f"{path} tamper matrix: accepted lanes {np.flatnonzero(bm).tolist()}, want [0]")
    check(list(masks_g) == list(masks_c), f"{path}: mask keys differ from the CPU run's")
    for k in masks_g:
        check(torch.equal(masks_g[k].cpu(), masks_c[k]), f"{path} mask {k}: GPU != CPU")
    check(torch.equal(ok_g.cpu(), ok_c), f"{path} accept bitmap: GPU != CPU")
    log(f"{path} tamper matrix: lanes 1-{len(bm) - 1} rejected, lane 0 accepted; all "
        f"{len(masks_g)} masks equal to the CPU run")


def phase_tiled(proofs, tamper_cpu):
    """(d'), (e): the tiled path at B = 4,096 through entry_tiled(); the
    tamper batch tiled on the card against the CPU run of the standard
    path.  Returns (launch counts, the median batch ms, fn, its batch)."""
    import torch

    from stark_symphony_tpu_torch import entry as E
    from stark_symphony_tpu_torch.models.stwo import tiled, verifier
    from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION

    t0 = time.perf_counter()
    fn, (tb,) = E.entry_tiled(N_PROOFS, "cuda", proofs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in tb)
    numpy_batch = E.production_batch(N_PROOFS, proofs)
    tile_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tiled.tile_batch(numpy_batch, PRODUCTION, "cuda")
        torch.cuda.synchronize()
        tile_s.append(time.perf_counter() - t0)
    tile_s.sort()
    log(f"tiled batch: {N_PROOFS} proofs, {nbytes / 1e6:.1f} MB on the card; "
        f"entry_tiled() set-up (stack, H2D, relayout) {setup_s:.3f} s; "
        f"tile_batch alone (H2D + on-device relayout) median {tile_s[1] * 1e3:.1f} ms "
        f"of {', '.join(f'{s * 1e3:.1f}' for s in tile_s)} ms")

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bitmap = fn(tb)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    log(f"tiled path: verify_batch_tiled(B={N_PROOFS}) first run {first_s:.3f} s, "
        f"launches {counts}")
    check(tuple(bitmap.shape) == (N_PROOFS,), f"tiled bitmap shape {tuple(bitmap.shape)}")
    n_ok = int(bitmap.sum().item())
    check(n_ok == N_PROOFS, f"tiled: {N_PROOFS - n_ok} of {N_PROOFS} valid proofs rejected")
    log(f"tiled path: all {N_PROOFS} proofs accepted")
    check_counts("tiled", counts)

    slice_ms, runs = batch_ms(fn, tb, runs=3)
    log(f"tiled slice: {slice_ms:.3f} ms per {N_PROOFS}-proof batch "
        f"({N_PROOFS / (slice_ms / 1e3):.1f} proofs/s; CUDA events, median of "
        f"{len(runs)} runs: {', '.join(f'{r:.1f}' for r in runs)} ms)")

    tamper = tiled.tile_batch(tamper_batch(proofs[0], 1 + PRODUCTION.n_inner_layers),
                              PRODUCTION, "cuda")
    ok_g, masks_g = verifier.verify_batch_tiled(tamper, PRODUCTION, with_masks=True)
    check_tamper("tiled", ok_g, masks_g, *tamper_cpu)
    return counts, slice_ms, fn, tb


def phase_stark101():
    """(g): the stark101 family on the card.  The prover through
    prove_stark101(), its proof equal to the golden fixture field by field
    and its query index to the CPU run's, its launches counted from 0; the
    verifier through entry_stark101() at B = 4,096, every lane accepted, its
    launches counted from 0; the tamper batch against the port's CPU run;
    then the batch timed.  Returns (launch counts by path, the median batch
    ms, fn, its batch)."""
    import numpy as np
    import torch

    from stark_symphony_tpu_torch import entry as E
    from stark_symphony_tpu_torch.models.stark101 import proof as P101
    from stark_symphony_tpu_torch.models.stark101 import verifier as V101

    golden = P101.load_json(str(E.STARK101_GOLDEN))
    counts = {}
    prove_s = []
    for run in range(2):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof, info = E.prove_stark101()
        torch.cuda.synchronize()
        prove_s.append(time.perf_counter() - t0)
        if run == 0:
            counts["stark101_prove"] = launch_counts()
            check_counts("stark101_prove", counts["stark101_prove"])
        for name in P101.Stark101Proof._fields:
            got, want = getattr(proof, name), getattr(golden, name)
            pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
            check(all(np.array_equal(a, b) for a, b in pairs),
                  f"stark101 proof made on the card: {name} != the golden fixture")
    _, cpu_info = E.prove_stark101("cpu")
    check(info == cpu_info, f"stark101 prover: {info} on the card, {cpu_info} on the CPU")
    log(f"stark101 prover: proof equal to the golden fixture in every field, "
        f"idx {info['idx']} as on the CPU; launches {counts['stark101_prove']}; "
        f"one prove {prove_s[0]:.3f} s (first call, host tables included), "
        f"{prove_s[1]:.3f} s (second call)")

    t0 = time.perf_counter()
    fn, (batch,) = E.entry_stark101(N_PROOFS)
    torch.cuda.synchronize()
    log(f"stark101 batch: {N_PROOFS} lanes of the golden proof; entry_stark101() "
        f"set-up {time.perf_counter() - t0:.3f} s")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bitmap = fn(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts["stark101"] = launch_counts()
    log(f"stark101 path: verify_batch(B={N_PROOFS}) first run {first_s:.3f} s, "
        f"launches {counts['stark101']}")
    check(tuple(bitmap.shape) == (N_PROOFS,), f"stark101 bitmap shape {tuple(bitmap.shape)}")
    n_ok = int(bitmap.sum().item())
    check(n_ok == N_PROOFS, f"stark101: {N_PROOFS - n_ok} of {N_PROOFS} proofs rejected")
    log(f"stark101 path: all {N_PROOFS} lanes accepted")
    check_counts("stark101", counts["stark101"])

    tb = stark101_tamper_batch(golden)
    ok_g, masks_g = V101.verify(P101.to_torch(tb, "cuda"))
    ok_c, masks_c = V101.verify(P101.to_torch(tb, "cpu"))
    check_tamper("stark101", ok_g, masks_g, ok_c, masks_c)

    batch_med, runs = batch_ms(fn, batch, runs=3)  # the first run above was the warm-up
    log(f"stark101 slice: {batch_med:.3f} ms per {N_PROOFS}-lane batch "
        f"({N_PROOFS / (batch_med / 1e3):.1f} verifications/s; CUDA events, median of "
        f"{len(runs)} runs: {', '.join(f'{r:.1f}' for r in runs)} ms)")
    return counts, batch_med, fn, batch


def phase_stark101_timings(rng, err):
    """(g): K1, K2 and K3 at the shapes the stark101 paths give them at
    B = 4,096, as time_cases does them.  Returns its rows."""
    import numpy as np

    from stark_symphony_tpu_torch.ops.u32 import from_numpy

    def words(*shape):
        return from_numpy(rng.integers(0, 1 << 32, shape, dtype=np.uint32), "cuda")

    b = N_PROOFS
    level = words(8192, 8)  # the prover's leaf level: 4,096 nodes above it
    pos = from_numpy(rng.integers(0, 8192 + 17, (b, 3), dtype=np.uint32), "cuda")
    cases = [
        ("sha256_words", f"transcript n=8, {b} lanes", (words(b, 8),)),
        ("sha256_words", f"transcript n=16, {b} lanes", (words(b, 16),)),
        ("sha256_words", f"transcript n=9, {b} lanes", (words(b, 9),)),
        ("sha256_words", f"trace leaves n=1, {3 * b} lanes", (words(b, 3, 1),)),
        ("sha256_words", f"FRI leaves n=1, {20 * b} lanes", (words(b, 20, 1),)),
        ("sha256_pair", "tree level, every other row, 4096 lanes",
         (level[0::2], level[1::2])),
        ("sha256_pair", "the same rows as contiguous copies, 4096 lanes",
         (level[0::2].contiguous(), level[1::2].contiguous())),
        ("merkle_walk", f"trace walk depth 13, {3 * b} lanes",
         (words(b, 3, 8), pos, words(b, 3, 13, 8), None)),
        ("merkle_walk", f"FRI walk depths 13..4, period 20, {20 * b} lanes",
         (words(b, 20, 8), words(b, 20) & 0x1FFF, words(b, 20, 13, 8),
          np.repeat(np.arange(13, 3, -1), 2))),
    ]
    return time_cases(cases, err)[0]


def phase_timings(rng, err):
    """(f): each kernel against its plain version at the shapes the paths
    give it at B = 4,096 (Q = 16, 9 FRI layers): compared bit for bit
    (largest difference into `err`; K4/K5's even proofs carry valid paths,
    so both ok values must occur), then timed; K1-K3 through their
    wrappers on int64 words, K4-K5 on the tiled batch's int32 arrays; each
    wrapper must launch one kernel a call and nothing else
    (``one_kernel_each``).  Returns rows (name, what, kernel ms, plain ms,
    bound ms, bound by, compressions, device ms a call)."""
    import numpy as np

    from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
    from stark_symphony_tpu_torch.ops.u32 import from_numpy

    bq = N_PROOFS * 16

    def words(*shape):
        return from_numpy(rng.integers(0, 1 << 32, shape, dtype=np.uint32), "cuda")

    # per-proof FRI layer depths 12..4, 16 queries each, as the slice pads them
    fri_depths = np.repeat(np.arange(12, 3, -1), 16)
    depths = tuple(range(12, 3, -1))
    lw_trace = leafwalk_case(rng, N_PROOFS, 16, 4, 13, "cuda")
    lw_cp = leafwalk_case(rng, N_PROOFS, 16, 16, 13, "cuda")
    fri_args = fri_case(rng, N_PROOFS, 16, depths, "cuda") + [depths]
    cases = [  # (name, what, arguments; K4/K5's kernel takes them as int32)
        ("sha256_words", "transcript n=9", (words(N_PROOFS, 9),)),
        ("sha256_words", "transcript n=88", (words(N_PROOFS, 88),)),
        ("sha256_words", f"trace leaf n=4, {bq} lanes", (words(bq, 4),)),
        ("sha256_words", f"cp leaf n=16, {bq} lanes", (words(bq, 16),)),
        ("sha256_pair", f"FRI node, {bq} lanes", (words(bq, 8), words(bq, 8))),
        ("merkle_walk", f"stage V walk depth 13, {2 * bq} lanes",
         (words(N_PROOFS, 32, 8), words(N_PROOFS, 32) & 0x1FFF,
          words(N_PROOFS, 32, 13, 8), None)),
        ("merkle_walk", f"FRI walk depths 12..4, {9 * bq} lanes",
         (words(N_PROOFS, 144, 8), words(N_PROOFS, 144) & 0xFFF,
          words(N_PROOFS, 144, 12, 8), fri_depths)),
        ("leafwalk", f"trace n_words=4, depth 13, {bq} lanes", lw_trace),
        ("leafwalk", f"cp n_words=16, depth 13, {bq} lanes", lw_cp),
        ("fri_all_layers", f"9 layers, depths 12..4, {bq} lanes", fri_args),
    ]
    rows, calls = time_cases(cases, err)
    # K3's block size at the main path's shapes: the wrapper's choice
    # (ck.walk_threads) against the other one
    rule = ck.walk_threads
    try:
        for (name, fn), row in zip(calls, rows):
            if name == "merkle_walk":
                times = []
                for threads in (32, 128):
                    ck.walk_threads = lambda lanes, depths, t=threads: t
                    times.append(f"{threads} threads {cuda_ms(fn, 20):.4f} ms")
                log(f"K3 block size [{row[1]}]: {', '.join(times)} a call")
    finally:
        ck.walk_threads = rule
    return rows


def time_cases(cases, err):
    """Each case (kernel name, what, arguments) through its wrapper and its
    plain version: bit for bit (largest difference into `err`), the plain
    version timed with CUDA events on that comparison run and the wrapper
    over 20 more, then one wrapper call of each profiled
    (``one_kernel_each``).  Returns (rows, calls): rows (name, what, kernel
    ms, plain ms, bound ms, bound by, compressions, device ms a call) and
    one (name, call) a case."""
    import torch

    from stark_symphony_tpu_torch.ops import fri, merkle, sha256
    from stark_symphony_tpu_torch.ops.cuda import fri_kernel as fk
    from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
    from stark_symphony_tpu_torch.ops.u32 import from_i32, to_i32

    def i32(args):
        return [to_i32(a).contiguous() if isinstance(a, torch.Tensor) else a
                for a in args]

    kern = {"sha256_words": ck.sha256_words, "sha256_pair": ck.sha256_pair,
            "merkle_walk": ck.merkle_compute_root, "leafwalk": fk.leafwalk,
            "fri_all_layers": fk.fri_all_layers}
    plain = {"sha256_words": sha256.sha256_words_plain,
             "sha256_pair": sha256.sha256_pair_plain,
             "merkle_walk": merkle.compute_root_plain,
             "leafwalk": fri.leafwalk_plain,
             "fri_all_layers": fri.fri_all_layers_plain}
    rows, calls = [], []  # calls: one wrapper call a case, for one_kernel_each
    for name, what, args in cases:
        kargs = i32(args) if name in ("leafwalk", "fri_all_layers") else args
        outs = kern[name](*kargs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        want, p_ms = cuda_call(lambda: plain[name](*args))
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(outs, want):
            g = from_i32(g) if g.dtype == torch.int32 else g
            diff = int((g - w).abs().max().item())
            err[name] = max(err[name], diff)
            check(torch.equal(g, w), f"{name} != plain ({what}), max |diff| {diff}")
        if name in ("leafwalk", "fri_all_layers"):
            n_ok, size = int(outs[0].sum().item()), outs[0].numel()
            check(0 < n_ok < size, f"{name} ({what}): {n_ok} of {size} checks ok, "
                  "want both values")
        b_ms, b_by, compr = bound(name, kargs, outs)
        k_ms = cuda_ms(lambda: kern[name](*kargs), 20)
        calls.append((name, lambda f=kern[name], a=kargs: f(*a)))
        rows.append([name, what, k_ms, p_ms, b_ms, b_by, compr])
        log(f"time {name} [{what}]: bit-equal; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.3f} ms ({p_ms / k_ms:.1f}x); bound {b_ms:.6f} ms by {b_by}; "
            f"{compr} compressions, {compr / (k_ms / 1e3) / 1e9:.2f} G/s")
    for row, ms in zip(rows, one_kernel_each(calls)):
        row.append(ms)
        log(f"profile {row[0]} [{row[1]}]: one launch a call, {ms:.4f} ms on the device")
    return rows, calls


def deep_operands(batch, cfg):
    """Stage VI's operands of a numpy proof batch on the card, as ``verify``
    computes them: [queries, trace_evals, cp_evals, random_coeff,
    oods_point, oods_trace, oods_cp, pts], ``fri_answers``' order."""
    from stark_symphony_tpu_torch.models.stwo import proof as P
    from stark_symphony_tpu_torch.models.stwo import verifier
    from stark_symphony_tpu_torch.models.stwo.constraints import REGISTRY

    t = P.to_torch(batch, "cuda")
    queries, _, oods_point, deep_alpha, _ = verifier._stages_i_to_iv(
        t, cfg, REGISTRY["wide_fibonacci"], {})
    return [queries, t.trace_evals, t.cp_evals, deep_alpha, oods_point, t.oods_trace,
            t.oods_cp, verifier.query_points(cfg, queries)]


def _non_canonical(rng, x):
    """A copy of word tensor x with one word in 8 replaced by a word that is
    not canonical: an x + P alias, 2^31 + k, 2^32 - 1, or 0."""
    import numpy as np
    import torch

    flat = x.cpu().numpy().reshape(-1).copy()
    k = max(1, flat.size // 8)
    at = rng.integers(0, flat.size, k)
    kind = rng.integers(0, 4, k)
    flat[at] = np.select(
        [kind == 0, kind == 1, kind == 2],
        [flat[at] % 0x7FFFFFFF + 0x7FFFFFFF, 0x80000000 + rng.integers(0, 1 << 16, k),
         np.full(k, 0xFFFFFFFF)], 0)
    return torch.from_numpy(flat.reshape(x.shape)).to(x.device)


def phase_deep(rng, proofs, err):
    """(f), K6: stage VI's DEEP quotients (``verifier.fri_answers`` on the
    card) against ``fri_answers_plain`` on the card, word for word: the
    4,096-proof PRODUCTION batch with the 15 tamper classes; the same with
    non-canonical words in trace_evals, cp_evals, oods_trace, oods_cp and
    random_coeff; a TP slice (Q = 4); ragged batches of 1 and 257 proofs.
    One launch a call.  Then K6 timed at 4,096 proofs beside the plain
    version's comparison run and its bound, and one call profiled.
    Returns its row as ``time_cases`` gives them."""
    import torch

    from stark_symphony_tpu_torch import entry as E
    from stark_symphony_tpu_torch.models.stwo import verifier
    from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION
    from stark_symphony_tpu_torch.ops.cuda import deep_kernel as dk

    ops = deep_operands(tamper_lanes(E.production_batch(N_PROOFS, proofs), PROD_TAMPERS),
                        PRODUCTION)
    noisy = list(ops)
    for i in (1, 2, 3, 5, 6):  # the evals, random_coeff and the OODS values
        noisy[i] = _non_canonical(rng, ops[i])
    n_changed = sum(int((noisy[i] != ops[i]).sum()) for i in (1, 2, 3, 5, 6))
    per_query = (0, 1, 2, 7)  # queries, trace_evals, cp_evals, pts
    cases = [("tamper classes", ops), ("non-canonical words", noisy),
             ("TP slice Q=4", [x[:, 4:8].contiguous() if i in per_query else x
                               for i, x in enumerate(noisy)]),
             ("1 proof", [x[:1] for x in noisy]), ("257 proofs", [x[:257] for x in noisy])]
    p_ms = None
    for what, args in cases:
        before = dk.launches["deep_quotients"]
        got = verifier.fri_answers(PRODUCTION, *args[:7], pts=args[7])
        check(dk.launches["deep_quotients"] == before + 1,
              f"deep_quotients ({what}): {dk.launches['deep_quotients'] - before} launches")
        want, ms = cuda_call(
            lambda a=args: verifier.fri_answers_plain(PRODUCTION, *a[:7], pts=a[7]))
        p_ms = ms if p_ms is None else p_ms
        diff = int((got - want).abs().max().item())
        err["deep_quotients"] = max(err["deep_quotients"], diff)
        check(torch.equal(got, want), f"deep_quotients != plain ({what}), max |diff| {diff}")
    log(f"K6 deep_quotients: bit-equal to fri_answers_plain on the card: "
        f"{', '.join(w for w, _ in cases)} ({n_changed} words changed)")

    kargs = [x.contiguous() for x in [ops[7]] + ops[1:7]]  # the wrapper's order
    out = dk.deep_quotients(*kargs)
    b_ms, b_by, _ = bound("deep_quotients", kargs, (out,))
    k_ms = cuda_ms(lambda: dk.deep_quotients(*kargs), 20)
    (dev_ms,) = one_kernel_each([("deep_quotients", lambda: dk.deep_quotients(*kargs))])
    mults = deep_multiplies(kargs[0].numel() // 2, N_PROOFS, 20)
    what = f"{N_PROOFS} proofs x 16 queries, 20 samples"
    log(f"time deep_quotients [{what}]: kernel {k_ms:.4f} ms ({dev_ms:.4f} ms on the "
        f"device), plain {p_ms:.3f} ms ({p_ms / k_ms:.1f}x); bound {b_ms:.6f} ms by "
        f"{b_by}; {mults} M31 multiplies [{CARD}]")
    return ["deep_quotients", what, k_ms, p_ms, b_ms, b_by, mults, dev_ms]


# torch.profiler on the card drops device activities at the start of a
# session, more of them the longer the process has run: ten kernels each
# followed by a synchronize were all recorded in a fresh process and none
# three minutes later, whether CUPTI was torn down between sessions or
# not, and waiting a second before or after them did not help; the same
# ten kernels after 20,000 others and a synchronize in the same session
# were all recorded at every age (PERF.md).  So every session here
# opens with PAD_KERNELS launches of a kernel that no path runs (cos of a
# float), and every count and sum below leaves them out.
PAD_KERNELS = 20_000


def _pad_session() -> None:
    import torch

    x = torch.empty(1, device="cuda")  # no kernel: the session holds the cos launches alone
    for _ in range(PAD_KERNELS):
        x.cos_()
    torch.cuda.synchronize()


def _is_pad(name: str) -> bool:
    return "cos_kernel" in name


WINDOW = "stpu_graphed_call"  # graph_profile's record_function range
CLOCK_TOL = 0.01  # the profiler's clock against CUDA events over one call


def _device_events(prof) -> list:
    """The device activities of a torch.profiler run, in start order,
    without the session's padding and without the device-side annotation
    that a ``record_function`` range (WINDOW) leaves: it spans the range's
    work and is none of it."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA and not _is_pad(e.name)
           and not getattr(e, "is_user_annotation", False) and e.name != WINDOW]
    return sorted(dev, key=lambda e: e.time_range.start)


def _profiled(fn, complete):
    """torch.profiler over fn(), taken again, up to three times in all,
    while complete(profile) is false: on the card the profiler has been
    seen to miss a kernel now and then (PERF.md).  Each retry is logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        if attempt:
            log(f"profiler: session {attempt} incomplete ({len(_device_events(prof))} device "
                "activities); taking it again")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _pad_session()
            fn()
            torch.cuda.synchronize()
        if complete(prof):
            break
    return prof


def one_kernel_each(calls) -> list:
    """(f): torch.profiler over one call of each wrapper in `calls`, a list
    of (kernel name, fn), each after a warm-up call and each followed by a
    synchronize: the device ran exactly one activity a call, that call's
    stpu:: kernel, and no other kernel or copy.  Returns each call's device
    ms."""
    import torch

    def run_all():
        for _, fn in calls:
            fn()
            torch.cuda.synchronize()

    run_all()
    dev = _device_events(_profiled(run_all, lambda p: len(_device_events(p)) >= len(calls)))
    seen = [e.name for e in dev]
    check(len(dev) == len(calls) and all(
        f"stpu::{KERNELS[name][3]}(" in e.name for (name, _), e in zip(calls, dev)),
        f"{len(calls)} wrapper calls ran {seen} on the device, want one stpu:: "
        "kernel a call")
    return [e.time_range.elapsed_us() / 1e3 for e in dev]


def _launch_shape(name, args):
    """(blocks, dynamic shared-memory bytes) of one launch of kernel `name`
    made with the launcher arguments `args`, as its launcher in csrc/
    computes them: what the profiler's trace shows of each launch; None
    where the launcher derives it from the shapes alone (K6)."""
    if name == "sha256_words":
        _, _, n, lanes, threads = args
        return -(-lanes // threads), threads * max(n, 8) * 8 + 8
    if name == "sha256_pair":
        lanes, threads = args[3], args[4]
        return -(-lanes // threads), 512 + threads * 128 + 8
    if name == "merkle_walk":
        lanes, threads = args[7], args[8]
        return -(-lanes // threads), threads * 200 + 32
    if name == "deep_quotients":  # its launcher picks both from the shapes: matched by order
        return None, None
    return -(-args[-1] // 256), 0  # K4, K5: blocks of 256, lanes last


def _missed(made, seen) -> list:
    """Indices into `made` (launch shapes, in launch order) of the launches
    that `seen` (the shapes the profiler saw, in start order) lacks, walked
    greedily: of equal neighbours, the first is named."""
    missed, j = [], 0
    for i, shape in enumerate(made):
        if j < len(seen) and seen[j] == shape:
            j += 1
        else:
            missed.append(i)
    return missed


def _locate_missed(path, prof, record, short) -> None:
    """For each device function in `short`, which the profiler saw fewer
    times than it was launched, log which of its launches the trace lacks,
    matched by grid and shared memory, and the profile's first device
    activities."""
    trace = ROOT / "build" / f"trace_{path}.json"
    try:
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    except (OSError, ValueError, KeyError) as exc:
        log(f"profile {path}: trace not read ({exc!r}); missed launches not located")
        return
    finally:
        trace.unlink(missing_ok=True)
    dev = sorted((e for e in events if e.get("cat") == "kernel" and not _is_pad(e["name"])),
                 key=lambda e: e["ts"])
    log(f"profile {path}: the trace's first device activities: "
        f"{[e['name'][:40] for e in dev[:3]]}")
    for name, fn_name in short:
        made = [shape for n, shape in record if n == name]
        seen = [(e["args"]["grid"][0], e["args"].get("shared memory"))
                for e in dev if f"stpu::{fn_name}(" in e["name"]]
        if seen and seen[0][1] is None:  # no shared memory in the trace
            made = [(blocks, None) for blocks, _ in made]
        # a part of a launch's shape that the record leaves open (None) matches any
        seen = [tuple(None if m is None else v for m, v in zip(made[0], shape))
                for shape in seen]
        for i in _missed(made, seen):
            where = "the first of the batch" if i == 0 else "inside the batch"
            log(f"profile {path}: {fn_name}: launch {i + 1} of {len(made)} "
                f"(blocks, shared bytes {made[i]}) not in the trace: {where}")


def phase_profile(path, fn, batch, slice_ms):
    """(f): torch.profiler over one batch of `path` at B = 4,096: the
    device-time table, the device's busy share of the unprofiled batch
    time, and the path's kernels' own device time, with the launches the
    profiler saw beside those made in the profiled batch; for a kernel it
    saw fewer times, which launches it missed."""
    from torch.autograd import DeviceType

    from stark_symphony_tpu_torch.ops.cuda import build

    want = [KERNELS[name][3] for name, n in PATHS[path].items() if n != 0]

    def ours(events):
        return [e for e in events if e.device_type == DeviceType.CUDA and "stpu" in e.key]

    def complete(prof):
        keys = [e.key for e in ours(prof.key_averages())]
        return all(any(f"stpu::{w}(" in k for k in keys) for w in want)

    record = []  # (kernel name, launch shape) of every launch, in order
    launch = build.launch

    def recording(name, device, *args):
        record.append((name, _launch_shape(name, args)))
        launch(name, device, *args)

    def run():
        record.clear()
        fn(batch)

    build.launch = recording
    try:
        prof = _profiled(run, complete)
    finally:
        build.launch = launch
    events = prof.key_averages()
    log(events.table(sort_by="self_cuda_time_total", row_limit=15))
    # device-side rows only: an operator's row repeats its kernels' time;
    # the cos rows are the session's padding (_pad_session)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not _is_pad(e.key)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile {path}: device busy {busy_ms:.1f} ms in "
        f"{sum(e.count for e in kernels)} launches, "
        f"{100 * busy_ms / slice_ms:.1f} % of the {slice_ms:.1f} ms unprofiled run")
    mine = ours(events)
    short = []
    for name, (_, _, _, fn_name) in KERNELS.items():
        made = sum(1 for n, _ in record if n == name)
        seen = [e for e in mine if f"stpu::{fn_name}(" in e.key]
        profiled = sum(e.count for e in seen)
        if made or profiled:
            dev_ms = sum(e.self_device_time_total for e in seen) / 1e3
            log(f"profile {path}: stpu::{fn_name}: {dev_ms:.3f} ms device in "
                f"{profiled} launches (counted: {made})")
        if profiled < made:
            short.append((name, fn_name))
    if short:
        _locate_missed(path, prof, record, short)
    seen = [w for w in want if any(f"stpu::{w}(" in e.key for e in mine)]
    check(busy_ms > 0 and len(seen) == len(want) == len(mine),
          f"profile {path} saw {[e.key for e in mine]}, want {list(want)}")


def host_calls(prof, window: str) -> dict:
    """The CUDA runtime's launch, copy and set calls that the host made
    inside the profiled range `window` (``record_function``), by name:
    (count, host ms)."""
    from torch.autograd import DeviceType

    events = prof.events()
    span = next(e for e in events if e.name == window).time_range
    out = {}
    for e in events:
        if (e.device_type == DeviceType.CPU and e.name.startswith("cu")
                and any(k in e.name for k in ("Launch", "Memcpy", "Memset"))
                and span.start <= e.time_range.start <= span.end):
            n, ms = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return out


def _union(spans) -> float:
    """The length of the union of (start, end) spans: their summed length
    where none overlap, less where they run side by side."""
    total, reach = 0.0, None
    for lo, hi in sorted(spans):
        if reach is None or lo > reach:
            total += hi - lo
            reach = hi
        elif hi > reach:
            total += hi - reach
            reach = hi
    return total


def replay_split(fn) -> dict:
    """One unprofiled fn(), timed with CUDA events, split by its graph
    replays: `call_ms`; `replays`, their count; `host_ms`, the host time
    spent inside their ``CUDAGraph.replay`` calls; `device_ms`, the union
    of the graphs' spans on the device (CUDA events recorded around each
    replay on its stream, so a shard graph's span is its own stream's)
    and `device_sum_ms`, those spans summed."""
    import torch

    spent, spans = [], []
    replay = torch.cuda.CUDAGraph.replay

    def timed_replay(graph):
        before, after = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        before.record()
        t0 = time.perf_counter()
        replay(graph)
        spent.append(time.perf_counter() - t0)
        after.record()
        spans.append((before, after))

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.CUDAGraph.replay = timed_replay
    try:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        torch.cuda.CUDAGraph.replay = replay
    ms = [(start.elapsed_time(a), start.elapsed_time(b)) for a, b in spans]
    return {"call_ms": start.elapsed_time(end), "replays": len(spent),
            "host_ms": 1e3 * sum(spent), "device_ms": _union(ms),
            "device_sum_ms": sum(b - a for a, b in ms)}


def graph_split(path, fn) -> dict:
    """(l): ``replay_split`` of fn(), one graphed call of `path`, logged:
    its graph replays' host ms against their span on the device."""
    split = replay_split(fn)
    log(f"graph split {path}: an unprofiled call {split['call_ms']:.3f} ms (CUDA events); "
        f"its {split['replays']} graph replays held the host {split['host_ms']:.3f} ms and "
        f"spanned {split['device_ms']:.3f} ms of the device (their spans summed "
        f"{split['device_sum_ms']:.3f} ms) [{CARD}]")
    return split


def graph_profile(path, fn, batch) -> float:
    """(h): one graphed call of `path` unprofiled and split by its graph
    replays (``graph_split``: their host ms against their device span);
    then torch.profiler over one more, itself timed with CUDA events: the
    device's busy time, the union of its kernels, copies and sets (the
    profiled window's own annotation is no device work), which fails above
    the CUDA-event call by more than CLOCK_TOL (the two clocks differ), as
    a share of that call, their summed time beside it (larger where graph
    branches run side by side); the stpu:: kernels the profiler saw inside
    the replayed graph (logged, not required: what the profiler shows of a
    graph is its own), and the host's runtime calls in the call: the
    graph launches with their host ms (CUPTI slows them and the call), and
    every launch and copy made outside them.  Returns the busy ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    graph_split(path, lambda: fn(batch))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _pad_session()
        start.record()
        with record_function(WINDOW):
            fn(batch)
        end.record()
        torch.cuda.synchronize()
    call_ms = start.elapsed_time(end)
    calls = host_calls(prof, WINDOW)
    graph_n, graph_ms = calls.pop("cudaGraphLaunch", (0, 0.0))
    outside = sum(n for k, (n, _) in calls.items() if "Launch" in k)
    log(f"graph profile {path}: in the profiled call cudaGraphLaunch {graph_n} "
        f"({graph_ms:.3f} ms host), outside the graphs {outside} kernel launches and "
        f"{sum(n for k, (n, _) in calls.items() if 'Launch' not in k)} copies or sets "
        f"{ {k: n for k, (n, _) in sorted(calls.items())} } [{CARD}]")
    dev = _device_events(prof)
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    busy_ms = _union(spans) / 1e3
    summed_ms = sum(b - a for a, b in spans) / 1e3
    seen = {w: sum(f"stpu::{w}(" in e.name for e in dev) for _, _, _, w in KERNELS.values()}
    check(0 < busy_ms <= (1 + CLOCK_TOL) * call_ms,
          f"graph profile {path}: device busy {busy_ms:.3f} ms in a {call_ms:.3f} ms call")
    log(f"graph profile {path}: device busy {busy_ms:.3f} ms (the union of {len(dev)} "
        f"device activities; their summed time {summed_ms:.3f} ms), "
        f"{100 * busy_ms / call_ms:.1f} % of the profiled graphed call's {call_ms:.3f} ms "
        f"(CUDA events); stpu:: kernels seen inside the graph {seen} [{CARD}]")
    return busy_ms


def phase_graphs(proofs) -> dict:
    """(h): each verifier captured once as a CUDA graph through its entry
    point (``graphed=True``) at B = 4,096, and replayed.  For each path:
    the launches recorded at capture equal an eager run's and PATHS; a
    graph of the verifier with its masks, fed the valid batch and
    then the valid batch with the tamper classes in lanes 1-15 (stark101
    1-10), gives the eager bitmap and every eager mask bit for bit, and so
    does the entry's graph its bitmap: exactly those lanes are rejected,
    so replay reads new inputs; eager and graphed batch ms (one run and
    the median of 3, each timed alone), the device's busy share of a profiled graphed call,
    capture and instantiate seconds and the graph pool's memory are
    printed with the card's name and power limit.  Then, on the tiled
    path: make_chained at chain 2 gives the eager bitmaps; StreamVerifier
    over 8 host batches gives the eager bitmaps, with its proofs/s; and
    tools.build's build, then load --check, round-trip with stale false.
    Returns the launches of each graph, by path."""
    import contextlib
    import functools
    import io

    import numpy as np
    import torch

    from stark_symphony_tpu_torch import entry as E
    from stark_symphony_tpu_torch.models.stark101 import proof as P101
    from stark_symphony_tpu_torch.models.stark101 import verifier as V101
    from stark_symphony_tpu_torch.models.stwo import proof as P
    from stark_symphony_tpu_torch.models.stwo import tiled, verifier
    from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION
    from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
    from stark_symphony_tpu_torch.ops.u32 import from_numpy
    from stark_symphony_tpu_torch.parallel import pipeline
    from stark_symphony_tpu_torch.tools import build as TB

    # K1 above 48 KB of shared memory a block (n = 88 in 128-lane blocks)
    # sets its attribute on every launch, and every launcher sets the
    # device: both legal under a capture, or this raises
    msgs = from_numpy(np.random.default_rng(6).integers(0, 1 << 32, (BIG_LANES, 88),
                                                        dtype=np.uint32), "cuda")
    k1 = TB.capture(ck.sha256_words, (msgs,), warmup=1)
    check(torch.equal(k1(msgs), ck.sha256_words(msgs)), "K1 captured at n = 88 != eager")
    log(f"graph K1 at n = 88, {BIG_LANES} lanes (cudaFuncSetAttribute in the capture): "
        "replay equal to eager")
    del k1, msgs

    valid = E.production_batch(N_PROOFS, proofs)
    golden = P101.replicate(P101.load_json(str(E.STARK101_GOLDEN)), N_PROOFS)
    paths = [  # (path, its graphed entry, numpy batch, tamper classes, to the card,
        #         the verifier with its masks)
        ("standard", lambda: E.entry(N_PROOFS, "cuda", proofs, graphed=True), valid,
         PROD_TAMPERS, lambda b: P.to_torch(b, "cuda"),
         lambda b: verifier.verify(b, PRODUCTION, linkage="reference")),
        ("tiled", lambda: E.entry_tiled(N_PROOFS, "cuda", proofs, graphed=True), valid,
         PROD_TAMPERS, lambda b: tiled.tile_batch(b, PRODUCTION, "cuda"),
         lambda b: verifier.verify_batch_tiled(b, PRODUCTION, with_masks=True)),
        ("stark101", lambda: E.entry_stark101(N_PROOFS, graphed=True), golden,
         STARK101_TAMPERS, lambda b: P101.to_torch(b, "cuda"), V101.verify),
    ]
    graphed, eager_bitmaps = {}, {}
    for path, make, host, tampers, to_card, masks_fn in paths:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn, (batch,) = make()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        check(all(n >= fn.launches[k] for k, n in launch_counts().items()),
              f"{path} graph: the counts do not hold the capture's launches")
        reset_counts()
        eager_ms, eager_runs = batch_ms(fn.fn, batch, runs=1)
        eager = {k: n // len(eager_runs) for k, n in launch_counts().items()}
        check(fn.launches == eager and all(n % len(eager_runs) == 0
                                           for n in launch_counts().values()),
              f"{path} graph: {fn.launches} launches at capture, eager "
              f"{launch_counts()} in {len(eager_runs)} runs")
        check_counts(path, fn.launches)
        graphed[f"{path}_graphed"] = fn.launches
        log(f"graph {path}: entry(graphed=True) set-up {setup_s:.3f} s (batch, 2 warm-up "
            f"runs, capture); capture {fn.capture_s:.3f} s, instantiate "
            f"{fn.instantiate_s:.3f} s; graph pool {fn.pool_bytes / 2**20:.1f} MiB; "
            f"launches at capture {fn.launches}, as in each eager run [{CARD}]")

        n_bad = len(tampers)
        tampered = to_card(tamper_lanes(host, tampers))
        eager = [masks_fn(b) for b in (batch, tampered)]
        ok_v, ok_t = (ok.cpu().numpy() for ok, _ in eager)
        check(ok_v.all(), f"{path}: eager run rejected valid lanes")
        check(ok_t[0] and not ok_t[1:1 + n_bad].any() and ok_t[1 + n_bad:].all(),
              f"{path}: eager tampered batch accepts lanes {ok_t.nonzero()[0][:20]}")
        eager_bitmaps[path] = [ok for ok, _ in eager]
        gm = TB.capture(masks_fn, (batch,), warmup=1)
        for what, b, (ok_e, masks_e) in (("valid", batch, eager[0]),
                                         ("tampered", tampered, eager[1])):
            ok_g, masks_g = gm(b)
            check(list(masks_g) == list(masks_e), f"{path} {what}: graphed mask keys")
            for k in masks_e:
                check(torch.equal(masks_g[k], masks_e[k]),
                      f"{path} {what}: graphed mask {k} != eager")
            check(torch.equal(ok_g, ok_e), f"{path} {what}: graphed bitmap != eager")
            check(torch.equal(fn(b), ok_e), f"{path} {what}: entry graph's bitmap != eager")
        log(f"graph {path}: replay equal to eager, bit for bit, in the bitmap and all "
            f"{len(eager[0][1])} masks, on the valid batch and on the batch with lanes "
            f"1-{n_bad} tampered (exactly those rejected); the entry's graph gives both "
            "bitmaps")
        del gm, tampered, eager

        graph_ms, graph_runs = batch_ms(fn, batch, runs=3)
        replay_ms, _ = batch_ms(lambda _: fn.graph.replay(), batch, runs=3)
        submit_ms = []  # how long the replay call holds the host
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn.graph.replay()
            submit_ms.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        submit_ms.sort()
        unit = "verifications" if path == "stark101" else "proofs"
        log(f"graph {path}: {N_PROOFS}-lane batch eager {eager_ms:.3f} ms "
            f"({', '.join(f'{r:.1f}' for r in eager_runs)}), graphed {graph_ms:.3f} ms "
            f"({', '.join(f'{r:.2f}' for r in graph_runs)}), "
            f"{N_PROOFS / (graph_ms / 1e3):.1f} {unit}/s, {eager_ms / graph_ms:.2f}x; "
            f"replay alone {replay_ms:.3f} ms (CUDA events, median of 3); the replay "
            f"call holds the host {submit_ms[1]:.3f} ms (host clock, median of 3: "
            f"{', '.join(f'{t:.2f}' for t in submit_ms)}) [{CARD}]")
        graph_profile(path, fn, batch)
        del fn, batch
        torch.cuda.empty_cache()

    tb_valid = tiled.tile_batch(valid, PRODUCTION, "cuda")
    tb_bad = tiled.tile_batch(tamper_lanes(valid, PROD_TAMPERS), PRODUCTION, "cuda")
    ones = torch.ones(N_PROOFS, dtype=torch.int64, device="cuda")
    chained = TB.capture(TB.make_chained(PRODUCTION, 2, True), (tb_valid, ones), warmup=1)
    for b, want in zip((tb_valid, tb_bad), eager_bitmaps["tiled"]):
        check(torch.equal(chained(b, ones), want.to(torch.int64)),
              "make_chained(chain=2) != the eager bitmap")
    log(f"make_chained (tiled, chain 2, one graph): the eager bitmaps of the valid and "
        f"the tampered batch; capture {chained.capture_s:.3f} s, instantiate "
        f"{chained.instantiate_s:.3f} s, launches {chained.launches} [{CARD}]")
    del chained, tb_valid, tb_bad
    torch.cuda.empty_cache()

    stream = pipeline.StreamVerifier(
        lambda b: verifier.verify_batch_tiled(b, PRODUCTION), depth=2,
        layout=functools.partial(tiled.relayout, cfg=PRODUCTION))
    t0 = time.perf_counter()
    stream.feed(valid)
    first = stream.finish()
    first_s = time.perf_counter() - t0
    hosts = [valid, tamper_lanes(valid, PROD_TAMPERS)] * 4
    t0 = time.perf_counter()
    for h in hosts:
        stream.feed(h)
    got = stream.finish()
    stream_s = time.perf_counter() - t0
    want = eager_bitmaps["tiled"]
    check(len(got) == len(hosts) and torch.equal(first[0], want[0])
          and all(torch.equal(g, want[i % 2]) for i, g in enumerate(got)),
          "StreamVerifier bitmaps != eager")
    log(f"stream (tiled, depth 2, pinned staging, copy stream): {len(hosts)} host batches "
        f"of {N_PROOFS} in {stream_s:.3f} s, {len(hosts) * N_PROOFS / stream_s:.1f} proofs/s, "
        f"bitmaps equal to eager; first batch with the capture {first_s:.3f} s [{CARD}]")
    del stream
    torch.cuda.empty_cache()

    def cli(*argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            TB.main(list(argv))
        return [json.loads(line) for line in out.getvalue().splitlines()]

    built = cli("--path", "tiled", "--batch", str(N_PROOFS), "--out",
                str(ROOT / "build" / "graphs"))[-1]
    loaded = cli("--load", built["artifact"], "--check")
    check(loaded[0]["stale"] is False and loaded[-1].get("check") == "ok",
          f"tools.build --load --check: {loaded}")
    log(f"tools.build: build {built}; load --check {loaded} [{CARD}]")
    return graphed


def first_difference(got, want):
    """(field, index) of the first word where two numpy stwo proofs differ,
    or None where they are equal in every field."""
    import numpy as np

    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, tuple) and len(g) != len(w):
            return name, f"{len(g)} arrays, want {len(w)}"
        pairs = zip(g, w) if isinstance(w, tuple) else [(g, w)]
        for i, (a, b) in enumerate(pairs):
            label = f"{name}[{i}]" if isinstance(w, tuple) else name
            a, b = np.asarray(a), np.asarray(b)
            if a.shape != b.shape or a.dtype != b.dtype:
                return label, f"{a.dtype}{a.shape}, want {b.dtype}{b.shape}"
            diff = np.flatnonzero(a.reshape(-1) != b.reshape(-1))
            if diff.size:
                return label, tuple(int(k) for k in np.unravel_index(diff[0], a.shape))
    return None


def launch_bound(name, args) -> float:
    """bound() in ms of one K1 or K2 launch made with launcher arguments
    `args`: its lanes' messages (or digests) read once, digests written."""
    import torch

    if name == "sha256_words":
        _, out, n, lanes, _ = args
        return bound(name, [torch.empty((lanes, n), dtype=torch.int64, device="meta")], [out])[0]
    out = args[2]
    return bound(name, [out, out], [out])[0]


def phase_stwo_prover(proofs):
    """(i): the stwo prover and routed verification on the card.

    ``prove_stwo()`` at PRODUCTION, unseeded and seeds 0-3: each proof
    equal to its committed fixture in every field, word for word (a
    mismatch names the field and the first differing index); the first
    call (host tables included) and the median of the others by the host
    clock; K1 and K2 counted from 0 over each proof, equal to PATHS and
    the same for every proof, with the bound of that proof's launches.
    Then a PRODUCTION wide_product proof: verify accepts it under
    wide_product and rejects it under wide_fibonacci, oods_cp_match
    false.  Then verify_batch_routed over 4,096 lanes alternating the
    committed fixtures (air_id 0) with copies of that proof (air_id 1):
    every lane accepted, every lane rejected with the ids swapped, every
    mask equal to the single-AIR verify of its lanes, the batch timed with
    CUDA events.  Returns (launch counts by path, the median ms of a
    proof, (the routed batch as numpy, its air_ids, its bitmap, its
    masks), the eager proofs by seed)."""
    import statistics

    import numpy as np
    import torch

    from stark_symphony_tpu_torch import entry as E
    from stark_symphony_tpu_torch.models.stwo import proof as P
    from stark_symphony_tpu_torch.models.stwo import verifier
    from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION
    from stark_symphony_tpu_torch.ops.cuda import build
    from stark_symphony_tpu_torch.parallel.expert import verify_batch_routed
    from stark_symphony_tpu_torch.utils.proofcache import fixture_path

    counts, seconds, made_proofs = {}, [], {}
    record = []
    launch = build.launch

    def recording(name, device, *args):
        record.append((name, launch_bound(name, args)))
        launch(name, device, *args)

    build.launch = recording
    try:
        for seed in PROVER_SEEDS:
            record.clear()
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            proof, _ = E.prove_stwo(PRODUCTION, seed)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            want = P.load_npz(str(fixture_path(PRODUCTION, seed)))
            diff = first_difference(proof, want)
            check(diff is None, f"stwo proof (PRODUCTION, seed {seed}) made on the card: "
                  f"{diff and diff[0]} differs from the fixture first at index "
                  f"{diff and diff[1]}")
            made_proofs[seed] = proof
            made = launch_counts()
            check(made == counts.get("stwo_prover", made),
                  f"stwo prover: seed {seed} launched {made}, seed None {counts.get('stwo_prover')}")
            counts["stwo_prover"] = made
    finally:
        build.launch = launch
    check_counts("stwo_prover", counts["stwo_prover"])
    bounds = {n: sum(b for k, b in record if k == n) for n in ("sha256_words", "sha256_pair")}
    steady = statistics.median(seconds[1:])
    log(f"stwo prover: PRODUCTION unseeded and seeds 0-{len(PROVER_SEEDS) - 2} made on the "
        f"card, each equal "
        f"to its fixture in every field; one proof {seconds[0]:.3f} s (first call, host "
        f"tables included), median {steady:.4f} s of the next {len(seconds) - 1} "
        f"({min(seconds[1:]):.4f}-{max(seconds[1:]):.4f} s; host clock, synchronized); "
        f"launches a proof {counts['stwo_prover']}; their bound K1 "
        f"{bounds['sha256_words']:.6f} ms, K2 {bounds['sha256_pair']:.6f} ms [{CARD}]")

    product, _ = E.prove_stwo(PRODUCTION, air="wide_product")
    one = P.to_torch(P.stack([product]), "cuda")
    ok_p, _ = verifier.verify(one, PRODUCTION, "wide_product")
    ok_f, masks_f = verifier.verify(one, PRODUCTION, "wide_fibonacci")
    check(bool(ok_p.item()), "the wide_product proof is rejected under wide_product")
    check(not ok_f.item() and not masks_f["oods_cp_match"].item()
          and all(m.item() for k, m in masks_f.items() if k != "oods_cp_match"),
          "the wide_product proof under wide_fibonacci: want oods_cp_match alone false")
    log("stwo prover: a PRODUCTION wide_product proof made on the card is accepted "
        "under wide_product and rejected under wide_fibonacci by oods_cp_match alone")

    half = N_PROOFS // 2
    mixed = P.map_fields(lambda f, p: np.stack([f, p], 1).reshape((N_PROOFS,) + f.shape[1:]),
                         E.production_batch(half, proofs), P.replicate(product, half))
    batch = P.to_torch(mixed, "cuda")
    ids = torch.arange(N_PROOFS, device=batch.commitments.device) % 2
    reset_counts()
    torch.cuda.synchronize()
    ok, masks = verify_batch_routed(batch, ids, PRODUCTION, with_masks=True)
    torch.cuda.synchronize()
    counts["routed"] = launch_counts()
    check_counts("routed", counts["routed"])
    check(bool(ok.all().item()), f"routed: {int((~ok).sum())} of {N_PROOFS} lanes rejected")
    bad = verify_batch_routed(batch, 1 - ids, PRODUCTION)
    check(not bad.any().item(), f"routed, ids swapped: {int(bad.sum())} lanes accepted")
    single = [verifier.verify(batch, PRODUCTION, air)[1] for air in ("wide_fibonacci",
                                                                     "wide_product")]
    for air_id, want in enumerate(single):
        check(list(masks) == list(want), "routed mask keys differ from verify's")
        for k in want:
            check(torch.equal(masks[k][air_id::2], want[k][air_id::2]),
                  f"routed mask {k} != the single-AIR verify on air_id {air_id} lanes")
    routed_ms, runs = batch_ms(lambda b: verify_batch_routed(b, ids, PRODUCTION), batch, runs=1)
    log(f"routed: {N_PROOFS} lanes (fixtures air_id 0, wide_product air_id 1) all "
        f"accepted, all rejected with the ids swapped, all {len(masks)} masks equal to "
        f"the single-AIR verify of their lanes; launches {counts['routed']}; batch "
        f"{routed_ms:.3f} ms ({N_PROOFS / (routed_ms / 1e3):.1f} proofs/s; CUDA events, "
        f"median of {len(runs)}: {', '.join(f'{r:.1f}' for r in runs)} ms) [{CARD}]")
    return counts, 1e3 * steady, (mixed, ids.cpu().numpy(), ok, masks), made_proofs


def phase_prover_timings(rng, err):
    """(f) at the stwo prover's shapes: K1 and K2 against their plain
    versions, timed and profiled as time_cases does them."""
    import numpy as np

    from stark_symphony_tpu_torch.ops.u32 import from_numpy

    def words(*shape):
        return from_numpy(rng.integers(0, 1 << 32, shape, dtype=np.uint32), "cuda")

    level, top = words(8192, 8), words(2, 8)
    cases = [
        ("sha256_words", "stwo prover trace leaves n=4, 8192 lanes", (words(8192, 4),)),
        ("sha256_words", "stwo prover CP leaves n=16, 8192 lanes", (words(8192, 16),)),
        ("sha256_words", "stwo prover last FRI leaves n=4, 32 lanes", (words(32, 4),)),
        ("sha256_words", "stwo prover transcript n=16, 1 lane", (words(16),)),
        ("sha256_words", "stwo prover PoW n=10, 4096 lanes", (words(4096, 10),)),
        ("sha256_pair", "stwo prover tree level, every other row, 4096 lanes",
         (level[0::2], level[1::2])),
        ("sha256_pair", "stwo prover tree root, 1 lane", (top[0::2], top[1::2])),
    ]
    return time_cases(cases, err)[0]


# The JAX suite's big-domain configuration (tests/test_sharded_prover.py):
# LDE 2^18, blowup 2^4 as at PRODUCTION, 14 FRI layers, 4 queries.
BIG = dict(trace_log_size=14, lde_log_size=18, n_queries=4, n_inner_layers=13, pow_bits=5)
SHARDS = 8
MULTI_PROCESS_DP = """
import sys, time
sys.path.insert(0, {root!r})
import torch
from chip_smoke import PROD_TAMPERS, tamper_lanes
from stark_symphony_tpu_torch import entry as E
from stark_symphony_tpu_torch.models.stwo import proof as P
from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION
from stark_symphony_tpu_torch.parallel.batch import verify_batch_dp
from stark_symphony_tpu_torch.utils import distributed as D

assert D.initialize_from_env() and D.process_count() == {procs}
batch = tamper_lanes(E.production_batch({n}), PROD_TAMPERS)
start, size = D.local_batch_slice({n})
local = P.map_fields(lambda x: x[start:start + size], batch)
mesh = D.global_mesh(devices={devices!r})
for _ in range({runs}):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bitmap, n_ok = verify_batch_dp(local, PRODUCTION, mesh)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
print("LOCAL", int(bitmap.sum()), "GLOBAL", int(n_ok), "SECONDS", seconds, flush=True)
"""


def timed(fn):
    """(fn(), seconds) by the host clock, every device synchronized before
    and after."""
    import torch

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def counted(path, fn):
    """(fn(), seconds, launch counts) with the counts set to 0 just before
    and read just after, held to PATHS[path]."""
    reset_counts()
    out, seconds = timed(fn)
    made = launch_counts()
    check_counts(path, made)
    return out, seconds, made


def multi_process_dp(n: int, procs: int, devices=None, runs: int = 1) -> list:
    """`procs` processes joined by the STPU_* variables, each verifying its
    slice of the n-lane tamper batch with verify_batch_dp over a
    ``global_mesh`` whose dp axis spans the processes (the last of `runs`
    calls timed): a shard on each of `devices`, by default one on each
    card of the process's device share.  Returns each process's (backend,
    local accepted, global accepted, seconds, its device share)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    code = MULTI_PROCESS_DP.format(root=str(ROOT), n=n, procs=procs, devices=devices,
                                   runs=runs)
    children = []
    for rank in range(procs):
        env = dict(os.environ, PYTHONPATH=str(ROOT), STPU_COORDINATOR=f"localhost:{port}",
                   STPU_NUM_PROCESSES=str(procs), STPU_PROCESS_ID=str(rank),
                   STPU_INIT_TIMEOUT="300")
        children.append(subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT),
                                         env=env, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=600) for p in children]
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for rank, (p, (out, err)) in enumerate(zip(children, outs)):
        check(p.returncode == 0, f"{procs}-process dp: process {rank} exited {p.returncode}: "
              f"{out[-1000:]} {err[-3000:]}")
        backend = out.split("backend ")[1].split(",")[0]
        share = out.split("cuda devices ")[1].splitlines()[0]
        words = out.split("LOCAL ")[1].split()
        results.append((backend, int(words[0]), int(words[2]), float(words[4]), share))
    return results


def phase_parallel(proofs, routed, err=None):
    """(j): the sharded layer on the card, 8 shards on cuda:0.

    DP (``verify_batch_dp``) over the 4,096-lane PRODUCTION batch with the
    15 tamper classes in lanes 1-15: the bitmap and every stage's mask of
    the unsharded ``verify`` and 4,081 accepted.  TP (``verify_batch_tp``)
    at dp2 x tp4 on 512 of those lanes, and the GSPMD counterpart beside
    it: the unsharded bitmap and masks of those lanes.  K3 at a TP shard's
    FRI walk (256 proofs x 9 layers x 4 local queries, per-path depths of
    period 36) against plain and hashlib, its error into `err` (a dict of
    each kernel's largest error, where given).
    ``verify_batch_routed_sharded``
    over phase (i)'s routed batch: its ``verify_batch_routed`` bitmap.  The
    SP blocks (``phase_sp``), eager and graphed.  ``prove_stwo_sharded()`` at PRODUCTION s0: its
    fixture, word for word; the lde-18 BIG proof accepted by the standard
    verify and rejected with one FRI witness word flipped.  Two processes
    verifying half the DP batch each: 4,081 in both.  The entry point's dry
    run over 4 shards.  Each path's launches counted from 0 and held to PATHS;
    each time by the host clock with the device synchronized.  Returns (the
    launch counts by path, the median ms of a sharded proof, the eager
    (bitmap, n_ok[, masks]) of dp, tp, gspmd and routed_sharded and the
    eager sharded proof of s0)."""
    import statistics

    import numpy as np
    import torch

    from stark_symphony_tpu_torch import entry as E
    from stark_symphony_tpu_torch.models.stwo import proof as P
    from stark_symphony_tpu_torch.models.stwo import verifier
    from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION, StwoConfig
    from stark_symphony_tpu_torch.ops import merkle
    from stark_symphony_tpu_torch.ops.cuda import build as kbuild
    from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
    from stark_symphony_tpu_torch.ops.u32 import from_numpy, to_numpy
    from stark_symphony_tpu_torch.parallel.batch import (
        make_mesh,
        verify_batch_dp,
        verify_batch_gspmd,
        verify_batch_tp,
    )
    from stark_symphony_tpu_torch.parallel.expert import verify_batch_routed_sharded
    from stark_symphony_tpu_torch.utils.proofcache import fixture_path

    counts = {}
    card = ["cuda:0"] * SHARDS
    n_bad = len(PROD_TAMPERS)
    batch = tamper_lanes(E.production_batch(N_PROOFS, proofs), PROD_TAMPERS)
    (want, want_masks), ref_s = timed(
        lambda: verifier.verify(P.to_torch(batch, "cuda"), PRODUCTION))
    check(not want[1:1 + n_bad].any() and want[0] and want[1 + n_bad:].all(),
          "unsharded verify of the tamper batch: want lanes 1-15 alone rejected")

    def same_masks(masks, lanes):
        return list(masks) == list(want_masks) and all(
            torch.equal(m, want_masks[k][lanes]) for k, m in masks.items())

    (bitmap, n_ok, masks), dp_s, counts["dp"] = counted(
        "dp", lambda: verify_batch_dp(batch, PRODUCTION, make_mesh(SHARDS, devices=card),
                                      with_masks=True))
    check(torch.equal(bitmap, want), "dp bitmap != the unsharded verify")
    check(same_masks(masks, slice(None)), "dp masks != the unsharded verify's")
    check(int(n_ok) == N_PROOFS - n_bad, f"dp: {int(n_ok)} accepted, want {N_PROOFS - n_bad}")
    eager = {"dp": (bitmap, n_ok, masks)}
    log(f"dp: verify_batch_dp over {SHARDS} shards on cuda:0, {N_PROOFS} lanes with the "
        f"{n_bad} tamper classes in lanes 1-{n_bad}: bitmap and all {len(masks)} masks "
        f"equal to verify, {int(n_ok)} accepted; {dp_s:.3f} s with its ingestion "
        f"(unsharded verify with to_torch {ref_s:.3f} s); launches {counts['dp']} [{CARD}]")

    n_tp = 512
    sub = P.map_fields(lambda x: x[:n_tp], batch)
    tp_mesh = make_mesh(SHARDS, tp=4, devices=card)
    for name, fn in (("tp", verify_batch_tp), ("gspmd", verify_batch_gspmd)):
        (bitmap, n_ok, masks), secs, made = counted(
            "tp", lambda fn=fn: fn(sub, PRODUCTION, tp_mesh, with_masks=True))
        counts.setdefault("tp", made)
        check(torch.equal(bitmap, want[:n_tp]) and int(n_ok) == int(want[:n_tp].sum()),
              f"{name} at dp2 x tp4: bitmap or count != the unsharded verify")
        check(same_masks(masks, slice(0, n_tp)),
              f"{name} at dp2 x tp4: masks != the unsharded verify's")
        eager[name] = (bitmap, n_ok, masks)
        log(f"{name}: dp2 x tp4 on cuda:0, {n_tp} lanes: bitmap and all {len(masks)} masks "
            f"(each the AND of its 4 query shards') equal to verify, {int(n_ok)} accepted; "
            f"{secs:.3f} s with its ingestion; launches {made} [{CARD}]")

    # K3 at a TP shard's FRI walk: a dp shard's 256 proofs x (9 layers x 4
    # local queries), the depths of a layer repeated a query: period 36
    rng = np.random.default_rng(20261018)
    n_local = PRODUCTION.n_queries // tp_mesh.shape["tp"]
    depths = np.repeat([PRODUCTION.fri_layer_depth(l)
                        for l in range(1 + PRODUCTION.n_inner_layers)], n_local)
    bshape, top = (n_tp // tp_mesh.shape["dp"], depths.size), int(depths.max())
    leaf, sibs = _words(rng, *bshape, 8), _words(rng, *bshape, top, 8)
    idx = rng.integers(0, 1 << top, bshape, dtype=np.uint32)
    args = (from_numpy(leaf, "cuda"), from_numpy(idx, "cuda"), from_numpy(sibs, "cuda"))
    got = ck.merkle_compute_root(*args, depths)
    plain, k3_plain_ms = cuda_call(lambda: merkle.compute_root_plain(*args, depths))
    err = {} if err is None else err
    err["merkle_walk"] = max(err.get("merkle_walk", 0), int((got - plain).abs().max().item()))
    check(torch.equal(got, plain), "merkle_walk at a TP shard's FRI walk != plain")
    host, lanes = to_numpy(got).reshape(-1, 8), leaf.size // 8
    for lane in (0, 1, depths.size - 1, lanes // 2, lanes - 1):
        check(list(host[lane]) == _hashlib_root(leaf.reshape(-1, 8)[lane],
                                                int(idx.reshape(-1)[lane]),
                                                sibs.reshape(-1, top, 8)[lane],
                                                int(depths[lane % depths.size])),
              f"merkle_walk at a TP shard's FRI walk, lane {lane} != hashlib")
    k3_ms = cuda_ms(lambda: ck.merkle_compute_root(*args, depths), 20)
    k3_bound_ms, k3_by, _ = bound("merkle_walk", (*args, depths), [got])
    k3_dev_ms, = one_kernel_each([("merkle_walk", lambda: ck.merkle_compute_root(*args, depths))])
    log(f"K3 merkle_walk at a TP shard's FRI walk ({bshape[0]} proofs x {depths.size} paths, "
        f"depths {top}..{int(depths.min())}, period {depths.size}): bit-equal to plain and "
        f"hashlib; wrapper {k3_ms:.4f} ms (CUDA events, mean of 20), device {k3_dev_ms:.4f} ms "
        f"(torch.profiler, one call), plain {k3_plain_ms:.3f} ms, bound {k3_bound_ms:.6f} ms "
        f"({k3_by}) [{CARD}]")

    mixed, air_ids, routed_ok, _ = routed
    (bitmap, n_ok), secs, counts["routed_sharded"] = counted(
        "routed_sharded", lambda: verify_batch_routed_sharded(
            mixed, air_ids, PRODUCTION, make_mesh(SHARDS, devices=card)))
    check(torch.equal(bitmap, routed_ok) and int(n_ok) == int(routed_ok.sum()),
          "verify_batch_routed_sharded != verify_batch_routed")
    eager["routed_sharded"] = (bitmap, n_ok)
    log(f"routed_sharded: {N_PROOFS} routed lanes over {SHARDS} shards: bitmap equal to "
        f"verify_batch_routed, {int(n_ok)} accepted; {secs:.3f} s with its ingestion; "
        f"launches {counts['routed_sharded']} [{CARD}]")

    counts.update(phase_sp(rng, card))

    fixture = P.load_npz(str(fixture_path(PRODUCTION, 0)))
    seconds, record = [], []
    launch = kbuild.launch

    def recording(name, device, *args):
        record.append((name, launch_bound(name, args)))
        launch(name, device, *args)

    for i in range(2):
        kbuild.launch = recording if i == 0 else launch  # the first proof's launches
        try:
            (proof, info), secs, made = counted(
                "stwo_prover_sharded", lambda: E.prove_stwo_sharded(PRODUCTION, seed=0))
        finally:
            kbuild.launch = launch
        diff = first_difference(proof, fixture)
        check(diff is None, f"sharded stwo proof (PRODUCTION, s0): {diff and diff[0]} differs "
              f"from the fixture first at index {diff and diff[1]}")
        check(info == {"n_sharded_layers": 1 + PRODUCTION.n_inner_layers},
              f"sharded prover: {info}")
        seconds.append(secs)
    counts["stwo_prover_sharded"] = made
    eager["stwo_prover_sharded"] = proof
    log(f"stwo_prover_sharded: prove_stwo_sharded(PRODUCTION, s0) over {SHARDS} shards, "
        f"every FRI layer sharded, equal to its fixture in every field "
        f"{len(seconds)} times; "
        f"{seconds[0]:.4f} s first, median {statistics.median(seconds[1:]):.4f} s of the "
        f"next {len(seconds) - 1} ({min(seconds[1:]):.4f}-{max(seconds[1:]):.4f} s); "
        f"launches a proof {made}; their bound K1 "
        f"{sum(b for k, b in record if k == 'sha256_words'):.6f} ms, K2 "
        f"{sum(b for k, b in record if k == 'sha256_pair'):.6f} ms [{CARD}]")

    big = StwoConfig(**BIG)
    (proof, info), big_s = timed(lambda: E.prove_stwo_sharded(big))
    ok, masks = verifier.verify(P.to_torch(proof, "cuda"), big)
    check(bool(ok), f"lde-18 sharded proof rejected: {[k for k, v in masks.items() if not v]}")
    wits = tuple(w.copy() for w in proof.fri_witnesses)
    wits[6][1, 2] ^= 1
    ok_bad, _ = verifier.verify(P.to_torch(proof._replace(fri_witnesses=wits), "cuda"), big)
    check(not bool(ok_bad), "lde-18 sharded proof with a flipped FRI witness accepted")
    log(f"stwo_prover_sharded: the lde-18 BIG proof over {SHARDS} shards "
        f"({info['n_sharded_layers']} sharded layers) in {big_s:.3f} s, host tables "
        f"included; accepted by verify, rejected with fri_witnesses[6][1, 2] flipped [{CARD}]")

    runs, two_s = timed(lambda: multi_process_dp(N_PROOFS, 2, ["cuda:0"] * 4))
    for rank, (backend, local, total, _, _) in enumerate(runs):
        want_local = N_PROOFS // 2 - (n_bad if rank == 0 else 0)
        check(backend == "gloo" and local == want_local and total == N_PROOFS - n_bad,
              f"two-process dp, process {rank}: backend {backend}, {local} of its lanes and "
              f"{total} in all accepted, want gloo, {want_local}, {N_PROOFS - n_bad}")
    log(f"two processes: each verify_batch_dp over 4 shards of cuda:0 on its "
        f"{N_PROOFS // 2} lanes, gloo: both count {N_PROOFS - n_bad}; {two_s:.3f} s with "
        f"their start-up [{CARD}]")

    _, dry_s = timed(lambda: E.dryrun_multichip(4))
    log(f"dryrun_multichip(4) on cuda:0: dp and gspmd at dp2 x tp2, tp at dp1 x tp4, "
        f"accept every TESTING proof; {dry_s:.3f} s [{CARD}]")
    return counts, 1e3 * statistics.median(seconds[1:]), eager


def phase_sp(rng, card) -> dict:
    """(j): the SP blocks over a mesh of the devices `card`: the stwo
    fold and commit (every level) at lde 13 and 18 and the stark101 fold
    at 8,192 over 10 stages on inputs from `rng`, eager against their
    single-device oracles, then graphed (``graphed_sp``) against the eager
    calls.  Returns the lde-18 commit's launches in its graphs by path."""
    import numpy as np
    import torch

    from stark_symphony_tpu_torch.models.stwo.prover import _commit_leaves
    from stark_symphony_tpu_torch.ops import field101 as F101
    from stark_symphony_tpu_torch.ops.field import P as M31P
    from stark_symphony_tpu_torch.ops.u32 import from_numpy
    from stark_symphony_tpu_torch.parallel import fri_shard as FS
    from stark_symphony_tpu_torch.parallel.mesh import Mesh, unshard

    sp = Mesh(card, ("sp",))

    def commit_tree(vals, lde_log, graphed):
        root, levels = FS.stwo_commit_sharded(vals, sp, return_levels=True, graphed=graphed)
        return [root] + FS.natural_levels_to_tree(levels, lde_log)

    sp_cases = []  # (name, call(graphed), eager result, eager s) for graphed_sp
    for lde_log, stages in ((13, 9), (18, 14)):
        vals = from_numpy(rng.integers(0, M31P, (1 << lde_log, 4), dtype=np.uint32), "cuda")
        alphas = [from_numpy(rng.integers(0, M31P, 4, dtype=np.uint32), "cuda")
                  for _ in range(stages)]
        points = FS.stwo_domain_points(lde_log)
        folded, fold_s = timed(lambda: unshard(sp, FS.stwo_fold_sharded(
            vals, alphas, lde_log, sp, stages), "sp"))
        ref, ref_s = timed(lambda: FS.stwo_fold_reference(vals, points, alphas, stages))
        check(torch.equal(folded, ref), f"stwo_fold_sharded at lde {lde_log} != the reference")
        (root, levels), commit_s = timed(lambda: FS.stwo_commit_sharded(
            vals, sp, return_levels=True))
        tree = FS.natural_levels_to_tree(levels, lde_log)
        (ref_levels, ref_root), one_s = timed(lambda: _commit_leaves(vals, lde_log))
        check(torch.equal(root, ref_root) and len(tree) == len(ref_levels)
              and all(torch.equal(a, b) for a, b in zip(tree, ref_levels)),
              f"stwo_commit_sharded at lde {lde_log}: root or a level != _commit_leaves")
        log(f"sp: lde {lde_log}, {SHARDS} shards: stwo_fold_sharded ({stages} stages) equal "
            f"to the reference, {fold_s:.3f} s against {ref_s:.3f} s on one shard; "
            f"stwo_commit_sharded root and all {len(tree)} levels equal to _commit_leaves, "
            f"{commit_s:.3f} s against {one_s:.3f} s [{CARD}]")
        sp_cases += [
            (f"stwo fold at lde {lde_log}", lambda g, v=vals, a=alphas, n=lde_log, k=stages: [
                unshard(sp, FS.stwo_fold_sharded(v, a, n, sp, k, graphed=g), "sp")],
             [folded], fold_s),
            (f"stwo commit at lde {lde_log}", lambda g, v=vals, n=lde_log: commit_tree(v, n, g),
             [root] + tree, commit_s)]
    n101, stages101 = 8192, 10
    v101 = from_numpy(rng.integers(0, F101.Q, n101, dtype=np.uint64).astype(np.uint32), "cuda")
    x101 = from_numpy(rng.integers(1, F101.Q, n101, dtype=np.uint64).astype(np.uint32), "cuda")
    betas = [int(rng.integers(1, F101.Q)) for _ in range(stages101)]
    (v_sh, x_sh), s101 = timed(lambda: FS.stark101_fold_sharded(v101, x101, betas, sp, stages101))
    v_ref, x_ref = FS.stark101_fold_reference(v101, x101, betas, stages101)
    check(torch.equal(unshard(sp, v_sh, "sp"), v_ref) and torch.equal(unshard(sp, x_sh, "sp"), x_ref),
          "stark101_fold_sharded != the reference")
    log(f"sp: stark101_fold_sharded at {n101} over {stages101} stages and {SHARDS} shards "
        f"equal to the reference; {s101:.3f} s [{CARD}]")
    sp_cases.append((f"stark101 fold at {n101}", lambda g: [
        unshard(sp, t, "sp") for t in FS.stark101_fold_sharded(v101, x101, betas, sp, stages101,
                                                               graphed=g)],
        [v_ref, x_ref], s101))
    sp_graphed = graphed_sp(sp, sp_cases, f"over {SHARDS} shards of cuda:0")
    check_counts("sp_commit_graphed", sp_graphed["stwo commit at lde 18"])
    return {"sp_commit_graphed": sp_graphed["stwo commit at lde 18"]}


def graph_stats(graphs) -> str:
    """Capture, instantiate and pool of GraphedVerifiers, for a log line."""
    return ", ".join(f"capture {g.capture_s:.3f} s, instantiate {g.instantiate_s:.3f} s, "
                     f"pool {g.pool_bytes / 2**20:.1f} MiB" for g in graphs)


def graph_launches(graphs) -> dict:
    """The launches recorded in GraphedVerifiers, summed by kernel."""
    return {k: sum(g.launches[k] for g in graphs) for k in graphs[0].launches}


def pools_mib(pools) -> str:
    """The device memory held by the segments of these graph memory pools
    (the caching allocator's snapshot), in MiB, or "not measured" where
    the snapshot names no segment's pool."""
    import torch

    ids = {tuple(p) for p in pools if p is not None}
    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return "not measured"
    held = sum(seg["total_size"] for seg in segments if tuple(seg["segment_pool_id"]) in ids)
    return f"{held / 2**20:.1f} MiB"


def program_stats(graphs, pools) -> str:
    """Count, capture, instantiate and pools of many small graphs, for a
    log line: the pools' memory and the sum of each capture's peak; the
    graphs counted by their K1 and K2 launches."""
    import collections

    kinds = collections.Counter((g.launches["sha256_words"], g.launches["sha256_pair"])
                                for g in graphs)
    return (f"{len(graphs)} graphs (by their K1, K2 launches: "
            f"{ {k: n for k, n in sorted(kinds.items())} }), "
            f"capture {sum(g.capture_s for g in graphs):.3f} s, "
            f"instantiate {sum(g.instantiate_s for g in graphs):.3f} s, {len(set(pools))} "
            f"pools holding {pools_mib(pools)} (the captures' peaks summed "
            f"{sum(g.pool_bytes for g in graphs) / 2**20:.1f} MiB)")


def graphed_sp(mesh, cases, where: str) -> dict:
    """(j), (multi-GPU): each SP block of `cases`, (name, call(graphed) ->
    a list of tensors, the eager call's list, the eager call's seconds),
    with ``graphed=True`` on `mesh`, after a second eager call (timed,
    its host tables made): the first call captures one program and
    replays it, two more replay it (nothing captured again); each result
    equal to the eager one, tensor for tensor, so to the oracles the eager
    call was held to.  The replays launch no K1 or K2 through the
    wrappers: every launch lies in the graphs.  Logs the seconds of the
    first call and of the replays beside the eager call's, the program's
    graphs, capture, instantiate and pools, and its launches.  Returns
    each block's launches in its graphs."""
    import torch

    def same(got, want):
        return len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))

    out = {}
    for name, call, want, eager_s in cases:
        again, again_s = timed(lambda: call(False))  # the host tables made by the first
        check(same(again, want), f"{name} {where}: a second eager call != the first")
        before = mesh.graphs.captures
        reset_counts()
        got, first_s = timed(lambda: call(True))
        warm = launch_counts()
        program = list(mesh.graphs.entries.values())[-1]
        seconds = []
        for i in range(3):
            if i:
                reset_counts()
                got, secs = timed(lambda: call(True))
                seconds.append(secs)
            check(same(got, want), f"graphed {name} {where}, call {i + 1}: != the eager call")
        eager = launch_counts()
        check(mesh.graphs.captures == before + 1 and program.complete,
              f"graphed {name} {where}: {mesh.graphs.captures - before} captures")
        check(not any(eager.values()), f"graphed {name} {where}: a replay launched {eager} "
              "through the wrappers")
        out[name] = graph_launches(program.graphs)
        log(f"sp graphed {name} {where}: equal to the eager call 3 times; first call "
            f"{first_s:.3f} s (captures, one warm-up a step and device: launches {warm}), "
            f"replays {', '.join(f'{x:.4f}' for x in seconds)} s, eager {again_s:.4f} s "
            f"(its first call, with the host tables, {eager_s:.3f} s); "
            f"{len(program.steps)} steps, {program_stats(program.graphs, program.pools.values())}"
            f"; launches in the graphs {out[name]} [{CARD}]")
    return out


def per_shard_proofs(mesh, prove, eager_s: float, where: str) -> dict:
    """(l), (multi-GPU): the sharded prover's per-shard layout on `mesh`
    at PRODUCTION, prove(seed) -> (numpy proof, its GraphedProver): s0
    equal to its fixture at the call that captures and at 3 replays, then
    s1 through the same graphs equal to its fixture, one capture in all;
    the launches in A's program and in B together PATHS', none through the
    wrappers on the replays.  Logs the seconds beside `eager_s` (the
    eager sharded proof), the graphs' capture, instantiate and pools and,
    on one device, one replayed call split by its graph replays.  Returns
    the launches in the graphs."""
    import statistics

    from stark_symphony_tpu_torch.models.stwo import proof as P
    from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION
    from stark_symphony_tpu_torch.utils.proofcache import fixture_path

    want = {seed: P.load_npz(str(fixture_path(PRODUCTION, seed))) for seed in (0, 1)}

    def same(proof, seed, what):
        diff = first_difference(proof, want[seed])
        check(diff is None, f"per-shard sharded proof {where} (PRODUCTION, s{seed}), {what}: "
              f"{diff and diff[0]} differs from its fixture first at index {diff and diff[1]}")

    before = mesh.graphs.captures
    reset_counts()
    (proof, gp), first_s = timed(lambda: prove(0))
    warm = launch_counts()
    same(proof, 0, "the call that captures")
    reset_counts()
    seconds = []
    for i in range(3):
        (proof, _), secs = timed(lambda: prove(0))
        seconds.append(secs)
        same(proof, 0, f"replay {i + 1}")
    (proof, _), s1_s = timed(lambda: prove(1))
    eager = launch_counts()
    same(proof, 1, "through s0's graphs")
    program = gp.a.program
    inside = graph_launches(program.graphs + [gp.b])
    check_counts("stwo_prover_per_shard_graphed", inside)
    check(mesh.graphs.captures == before + 1 and gp.continued == 0 and not any(eager.values()),
          f"per-shard sharded prover {where}: {mesh.graphs.captures - before} captures, "
          f"{gp.continued} continued, {eager} launched through the wrappers on the replays")
    if len(set(mesh.devices)) == 1:
        split = replay_split(lambda: prove(0))
        split_text = (f"an unprofiled call {split['call_ms']:.3f} ms, its {split['replays']} graph "
                      f"replays held the host {split['host_ms']:.3f} ms and spanned "
                      f"{split['device_ms']:.3f} ms of the device (summed "
                      f"{split['device_sum_ms']:.3f} ms)")
    else:  # CUDA events of two devices give no elapsed time between them
        split_text = "its split by graph replays not measured (graphs on several devices)"
    log(f"stwo prover per-shard graphed {where}: PRODUCTION s0 equal to its fixture 4 times, "
        f"s1 through the same graphs equal to its fixture ({s1_s:.4f} s); first call "
        f"{first_s:.3f} s (A's {len(program.steps)} steps captured and replayed, then B: "
        f"launches {warm}); median {statistics.median(seconds):.4f} s of the next "
        f"{len(seconds)} ({min(seconds):.4f}-{max(seconds):.4f} s; host clock, synchronized), "
        f"eager {eager_s:.4f} s; A: {program_stats(program.graphs, program.pools.values())}; "
        f"B: {graph_stats([gp.b])}; launches in the graphs {inside}, through the wrappers on "
        f"the replays {eager}; {split_text} [{CARD}]")
    return inside


def compiled_sharded_prover(eager_s0, sharded_ms: float, eager20) -> dict:
    """(l): the sharded prover as JAX compiles it, ``prove_stwo_sharded(
    graphed=True)`` over 8 shards of cuda:0: graph A (the shard streams
    forked from and joined to its capture, so every shard's launches and
    exchanges lie inside it), one host read, graph B.  PRODUCTION s0 equal
    to its fixture and to `eager_s0` (phase (j)'s eager proof, which took
    `sharded_ms`) on the first call and five replays, s1 through the same
    graphs equal to its fixture; one capture; A's and B's launches
    together PATHS', the counts over the 7 proofs their warm-up's and
    capture's alone; a profiled graphed call.  TESTING at 20 PoW bits,
    continued, equal to the eager sharded proof and to `eager20`, the
    unsharded one.  Then the per-shard layout (``per_shard_proofs``) over
    8 shards of cuda:0, through ``prover_sharded.per_shard_prover``, its
    time beside graph A's.  Returns the launches in each layout's graphs
    by path."""
    import dataclasses
    import statistics

    from stark_symphony_tpu_torch import entry as E
    from stark_symphony_tpu_torch.models.stwo import proof as P
    from stark_symphony_tpu_torch.models.stwo import prover, prover_sharded
    from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION, TESTING
    from stark_symphony_tpu_torch.ops.u32 import from_numpy
    from stark_symphony_tpu_torch.parallel.mesh import Mesh
    from stark_symphony_tpu_torch.utils.proofcache import fixture_path

    mesh = E.sharded_prover_mesh("cuda", SHARDS)
    want = {seed: P.load_npz(str(fixture_path(PRODUCTION, seed))) for seed in (0, 1)}
    before = mesh.graphs.captures
    reset_counts()
    (proof, info), first_s = timed(
        lambda: E.prove_stwo_sharded(PRODUCTION, seed=0, graphed=True))
    captures = mesh.graphs.captures - before
    check(captures == 1 and info == {"n_sharded_layers": 1 + PRODUCTION.n_inner_layers},
          f"graphed sharded prover: {captures} captures, {info}")
    seconds = []
    for i in range(6):
        if i:
            (proof, _), secs = timed(
                lambda: E.prove_stwo_sharded(PRODUCTION, seed=0, graphed=True))
            seconds.append(secs)
        for what, ref in (("its fixture", want[0]),
                          ("phase (j)'s eager proof", eager_s0)):
            diff = first_difference(proof, ref)
            check(diff is None, f"graphed sharded proof (PRODUCTION, s0), call {i + 1}: "
                  f"{diff and diff[0]} differs from {what} first at index {diff and diff[1]}")
    (proof, _), s1_s = timed(lambda: E.prove_stwo_sharded(PRODUCTION, seed=1, graphed=True))
    diff = first_difference(proof, want[1])
    check(diff is None and mesh.graphs.captures - before == 1,
          f"graphed sharded proof (PRODUCTION, s1) through s0's graphs: {diff and diff[0]} "
          f"differs from its fixture first at index {diff and diff[1]}; "
          f"{mesh.graphs.captures - before} captures")
    made = launch_counts()
    gps = prover_sharded.graphed_prover(
        PRODUCTION, mesh, "sp", from_numpy(prover.seeded_trace(PRODUCTION, 0), "cuda"))
    graphed = graph_launches([gps.a, gps.b])
    check_counts("stwo_prover_sharded_graphed", graphed)
    check(made == {k: 2 * n for k, n in graphed.items()}
          and gps.continued == 0,
          f"graphed sharded prover: {made} launched over 7 proofs, want one warm-up and one "
          f"capture of A and B {graphed} and no eager launch; "
          f"{gps.continued} continued")
    log(f"stwo prover sharded graphed: prove_stwo_sharded(PRODUCTION, s0, graphed=True) over "
        f"{SHARDS} shards of cuda:0, equal to its fixture and to phase (j)'s eager proof in "
        f"every field 6 times, then s1 through the same graphs equal to its fixture "
        f"({s1_s:.4f} s); first call {first_s:.3f} s ({captures} capture: one warm-up, "
        f"capture of A, one replay, capture of B); median {statistics.median(seconds):.4f} s "
        f"of the next {len(seconds)} ({min(seconds):.4f}-{max(seconds):.4f} s; host clock, "
        f"synchronized), eager {sharded_ms / 1e3:.4f} s (phase j); A: {graph_stats([gps.a])}, "
        f"launches {gps.a.launches}; B: {graph_stats([gps.b])}, launches {gps.b.launches}; "
        f"launches over the 7 proofs {made} [{CARD}]")
    graph_profile("stwo_prover_sharded_graphed",
                  lambda _: E.prove_stwo_sharded(PRODUCTION, seed=0, graphed=True), None)

    cfg20 = dataclasses.replace(TESTING, pow_bits=20)
    eager20s, _ = E.prove_stwo_sharded(cfg20)
    graphed20s, _ = E.prove_stwo_sharded(cfg20, graphed=True)
    gps20 = prover_sharded.graphed_prover(
        cfg20, mesh, "sp", from_numpy(prover.seeded_trace(cfg20, None), "cuda"))
    check(first_difference(graphed20s, eager20s) is None
          and first_difference(graphed20s, eager20) is None and gps20.continued == 1,
          f"graphed sharded TESTING proof at 20 PoW bits: continued {gps20.continued}, first "
          f"difference from eager {first_difference(graphed20s, eager20s)}")
    log(f"stwo prover sharded graphed, TESTING at 20 PoW bits over {SHARDS} shards: graph A's "
        f"chunk missed, the eager grind carried on to nonce "
        f"{int(eager20.pow_nonce[0]) << 32 | int(eager20.pow_nonce[1])}; the proof equals the "
        "eager sharded and unsharded ones in every field")

    # the layout a mesh over several cards takes, here over 8 shards of
    # cuda:0 through prover_sharded.per_shard_prover, beside graph A's time
    card = Mesh(["cuda:0"] * SHARDS, ("sp",))

    def per_shard(seed):
        trace = from_numpy(prover.seeded_trace(PRODUCTION, seed), "cuda")
        gp = prover_sharded.per_shard_prover(PRODUCTION, card, "sp", trace)
        return prover._to_numpy_proof(gp(trace)), gp

    per_shard_counts = per_shard_proofs(
        card, per_shard, sharded_ms / 1e3,
        f"over {SHARDS} shards of cuda:0 (graph A, above: median "
        f"{statistics.median(seconds):.4f} s)")
    return {"stwo_prover_sharded_graphed": graphed,
            "stwo_prover_per_shard_graphed": per_shard_counts}


def phase_compiled(proofs, stwo_eager, prove_ms, routed, sharded, sharded_ms) -> dict:
    """(l): what the JAX package compiles as one program, captured as CUDA
    graphs and replayed, each result held to its eager run's.

    The stwo prover (``prove_stwo(graphed=True)``, graphs A and B around
    the PoW grind) at PRODUCTION, unseeded and seeds 0-3: each proof equal
    to its fixture and to phase (i)'s eager proof, word for word; A's and
    B's launches together equal PATHS, and the counts over the 5 proofs
    are the warm-up's and the capture's alone (a replay launches nothing
    through the wrappers); capture, instantiate and pool of A and B, the
    first call (with the capture) and the median of the 4 replays by the
    host clock, the device's busy share of one profiled graphed proof.
    The continuation: TESTING at 20 PoW bits, where the first chunk
    misses, equal to the eager proof.  The sharded prover
    (``prove_stwo_sharded(graphed=True)`` over 8 shards of cuda:0, every
    shard's launches and exchanges inside graph A): PRODUCTION s0 equal to
    its fixture and to phase (j)'s eager proof six times, then s1 through
    the same graphs equal to its fixture; one capture, A's and B's
    launches together PATHS' and the counts over the 7 proofs the warm-up's
    and the capture's alone; the first call and the median of 5 replays,
    capture, instantiate and pool of A and B, a profiled graphed call's
    busy share and its host launches outside the graphs; TESTING at 20
    PoW bits, continued, equal to eager.  stark101 (``prove_stark101(graphed=
    True)``): the golden proof and the eager one, its graph's launches
    equal to PATHS.  Routed verify captured (``tools/build.capture``):
    phase (i)'s bitmap and masks.  DP, TP, GSPMD and routed-sharded with
    ``graphed=True`` on 8 shards of cuda:0: phase (j)'s bitmaps, counts
    and masks; each shard's capture, the launches of the shard graphs
    against PATHS, the seconds of the first call (captures included) and
    of a second one (ingestion included, as (j) counts it), which captures
    nothing; a graphed DP call's graph replays, their host ms against their
    span on the device (``graph_split``).  `sharded_ms`: phase (j)'s eager
    sharded proof.  Returns each graphed path's launches."""
    import dataclasses
    import gc
    import statistics

    import numpy as np
    import torch

    from stark_symphony_tpu_torch import entry as E
    from stark_symphony_tpu_torch.models.stark101 import proof as P101
    from stark_symphony_tpu_torch.models.stark101 import prover as prover101
    from stark_symphony_tpu_torch.models.stwo import proof as P
    from stark_symphony_tpu_torch.models.stwo import prover
    from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION, TESTING
    from stark_symphony_tpu_torch.ops.u32 import from_numpy
    from stark_symphony_tpu_torch.parallel.batch import (
        make_mesh,
        verify_batch_dp,
        verify_batch_gspmd,
        verify_batch_tp,
    )
    from stark_symphony_tpu_torch.parallel.expert import (
        verify_batch_routed,
        verify_batch_routed_sharded,
    )
    from stark_symphony_tpu_torch.tools import build as TB
    from stark_symphony_tpu_torch.utils.proofcache import fixture_path

    counts = {}
    t_phase = time.perf_counter()

    # the stwo prover: graph A, one host read, graph B
    seconds = []
    reset_counts()
    for seed in PROVER_SEEDS:
        (proof, _), secs = timed(lambda: E.prove_stwo(PRODUCTION, seed, graphed=True))
        seconds.append(secs)
        for what, want in (("its fixture", P.load_npz(str(fixture_path(PRODUCTION, seed)))),
                           ("the eager proof", stwo_eager[seed])):
            diff = first_difference(proof, want)
            check(diff is None, f"graphed stwo proof (PRODUCTION, seed {seed}): "
                  f"{diff and diff[0]} differs from {what} first at index {diff and diff[1]}")
    made = launch_counts()
    gp = prover.graphed_prover(PRODUCTION, from_numpy(prover.seeded_trace(PRODUCTION, None),
                                                      "cuda"))
    graphs = [gp.a, gp.b]
    counts["stwo_prover_graphed"] = graph_launches(graphs)
    check_counts("stwo_prover_graphed", counts["stwo_prover_graphed"])
    check(made == {k: 2 * n for k, n in counts["stwo_prover_graphed"].items()}
          and gp.continued == 0,
          f"graphed stwo prover: {made} launched over {len(PROVER_SEEDS)} proofs, want one "
          f"warm-up and one "
          f"capture of A and B {counts['stwo_prover_graphed']}; {gp.continued} continued")
    steady = statistics.median(seconds[1:])
    log(f"stwo prover graphed: PRODUCTION unseeded and seeds 0-{len(PROVER_SEEDS) - 2}, each "
        f"equal to its fixture "
        f"and to the eager proof in every field; first call {seconds[0]:.3f} s (one warm-up, "
        f"capture of A, one replay, capture of B); median {steady:.4f} s of the next "
        f"{len(seconds) - 1} ({min(seconds[1:]):.4f}-{max(seconds[1:]):.4f} s; host clock, "
        f"synchronized), eager {prove_ms / 1e3:.4f} s (phase i); A: "
        f"{graph_stats([gp.a])}, launches {gp.a.launches}; B: {graph_stats([gp.b])}, "
        f"launches {gp.b.launches} [{CARD}]")
    graph_profile("stwo_prover_graphed", lambda _: E.prove_stwo(PRODUCTION, graphed=True), None)

    cfg20 = dataclasses.replace(TESTING, pow_bits=20)
    eager20, _ = E.prove_stwo(cfg20)
    graphed20, _ = E.prove_stwo(cfg20, graphed=True)
    gp20 = prover.graphed_prover(cfg20, from_numpy(prover.seeded_trace(cfg20, None), "cuda"))
    nonce = int(eager20.pow_nonce[0]) << 32 | int(eager20.pow_nonce[1])
    check(first_difference(graphed20, eager20) is None and gp20.continued == 1
          and nonce >= prover.n_candidates(cfg20),
          f"graphed TESTING proof at 20 PoW bits: nonce {nonce}, continued "
          f"{gp20.continued}, first difference {first_difference(graphed20, eager20)}")
    log(f"stwo prover graphed, TESTING at 20 PoW bits: graph A's chunk of "
        f"{prover.n_candidates(cfg20)} missed, the eager grind carried on to nonce {nonce}; the "
        "proof equals the eager one in every field")

    counts.update(compiled_sharded_prover(sharded["stwo_prover_sharded"], sharded_ms, eager20))

    golden = P101.load_json(str(E.STARK101_GOLDEN))
    (eager101, info_e), eager101_s = timed(E.prove_stark101)
    reset_counts()
    s101 = []
    for _ in range(6):
        (proof101, info), secs = timed(lambda: E.prove_stark101(graphed=True))
        s101.append(secs)
        for what, want in (("golden_proof.json", golden), ("the eager proof", eager101)):
            check(all(np.array_equal(a, b) for a, b in zip(TB.tree_leaves(tuple(proof101)),
                                                           TB.tree_leaves(tuple(want))))
                  and info == info_e, f"graphed stark101 proof != {what}")
    body = next(iter(prover101.GRAPHS.entries.values()))
    counts["stark101_prove_graphed"] = body.launches
    check_counts("stark101_prove_graphed", body.launches)
    check(launch_counts() == {k: 2 * n for k, n in body.launches.items()},
          f"graphed stark101 prover: {launch_counts()} launched over 6 proofs")
    log(f"stark101 prover graphed: equal to golden_proof.json and to the eager proof, query "
        f"index {info['idx']}; first call {s101[0]:.3f} s, median "
        f"{statistics.median(s101[1:]):.4f} s of the next {len(s101) - 1} (eager "
        f"{eager101_s:.4f} s); {graph_stats([body])}, launches {body.launches} [{CARD}]")

    mixed, air_ids, routed_ok, routed_masks = routed
    batch = P.to_torch(mixed, "cuda")
    ids = torch.as_tensor(air_ids, dtype=torch.int64, device="cuda")
    g = TB.capture(lambda b, i: verify_batch_routed(b, i, PRODUCTION, with_masks=True),
                   (batch, ids), warmup=1)
    ok, masks = g(batch, ids)
    check(torch.equal(ok, routed_ok) and list(masks) == list(routed_masks)
          and all(torch.equal(m, routed_masks[k]) for k, m in masks.items()),
          "graphed verify_batch_routed != phase (i)'s bitmap or masks")
    counts["routed_graphed"] = g.launches
    check_counts("routed_graphed", g.launches)
    routed_ms, runs = batch_ms(lambda b: g(b, ids), batch)
    log(f"routed graphed: {N_PROOFS} lanes, bitmap and all {len(masks)} masks equal to phase "
        f"(i)'s; {routed_ms:.3f} ms a batch (CUDA events, median of {len(runs)}); "
        f"{graph_stats([g])}, launches {g.launches} [{CARD}]")
    del g, batch, ok, masks
    gc.collect()
    torch.cuda.empty_cache()

    card = ["cuda:0"] * SHARDS
    host = tamper_lanes(E.production_batch(N_PROOFS, proofs), PROD_TAMPERS)
    sub = P.map_fields(lambda x: x[:512], host)
    tp_mesh = make_mesh(SHARDS, tp=4, devices=card)
    cases = [  # (path, its launches' PATHS row, mesh, call)
        ("dp", "dp_graphed", make_mesh(SHARDS, devices=card),
         lambda m: verify_batch_dp(host, PRODUCTION, m, with_masks=True, graphed=True)),
        ("tp", "tp_graphed", tp_mesh,
         lambda m: verify_batch_tp(sub, PRODUCTION, m, with_masks=True, graphed=True)),
        ("gspmd", None, tp_mesh,
         lambda m: verify_batch_gspmd(sub, PRODUCTION, m, with_masks=True, graphed=True)),
        ("routed_sharded", "routed_sharded_graphed", make_mesh(SHARDS, devices=card),
         lambda m: verify_batch_routed_sharded(mixed, air_ids, PRODUCTION, m, graphed=True)),
    ]
    for name, row, mesh, call in cases:
        before = mesh.graphs.captures
        first, first_s = timed(lambda: call(mesh))
        again, again_s = timed(lambda: call(mesh))
        check(mesh.graphs.captures == before + (row is not None),
              f"{name} graphed: {mesh.graphs.captures - before} captures, want "
              f"{int(row is not None)}")
        want = sharded[name]
        for got in (first, again):
            check(torch.equal(got[0], want[0]) and int(got[1]) == int(want[1]),
                  f"{name} graphed: bitmap or count != phase (j)'s")
            if len(want) > 2:
                check(list(got[2]) == list(want[2])
                      and all(torch.equal(m, want[2][k]) for k, m in got[2].items()),
                      f"{name} graphed: masks != phase (j)'s")
        shards = list(mesh.graphs.entries.values())[-1].graphs
        if row is not None:
            counts[row] = graph_launches(shards)
            check_counts(row, counts[row])
        log(f"{name} graphed on {SHARDS} shards of cuda:0: bitmap, count {int(first[1])}"
            f"{' and masks' if len(want) > 2 else ''} equal to phase (j)'s twice; first call "
            f"{first_s:.3f} s ({'the captures' if row else 'tp graphs replayed'}), second "
            f"{again_s:.3f} s with its ingestion; shards' capture + instantiate "
            f"{', '.join(f'{g.capture_s + g.instantiate_s:.3f}' for g in shards)} s, pools "
            f"{sum(g.pool_bytes for g in shards) / 2**20:.1f} MiB; launches in the shard "
            f"graphs {graph_launches(shards)} [{CARD}]")
        if name == "dp":
            # by CUDA events alone: under torch.profiler its 900,000 graph
            # nodes run five times slower and take minutes to parse
            graph_split("dp_graphed", lambda: call(mesh))
        if name != "tp":  # gspmd replays tp's graphs; free the others' pools
            mesh.graphs.entries.clear()
            gc.collect()
            torch.cuda.empty_cache()
    log(f"phase (l): {time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_multi_gpu(proofs, per_device: int = 1024):
    """(j) with two or more devices: DP weak scaling, `per_device` lanes
    on each device (SCALING_r05.json's measure: throughput on n devices
    over n times that on one, here t1 / tn).  In one process, one shard a
    device; then one process a device, each seeing every card and driving
    its share (``utils.distributed.device_share``: one card each, so the
    backend is nccl), each timing its second call.  Then, across the devices, TP
    at dp1 x tp4 (tp2 on fewer than 4 devices), the stwo fold and commit
    at lde 18 and the PRODUCTION sharded proof over 8 shards spread over
    them (``multi_gpu_sp``).  On one device, prints that none of it was
    measured."""
    import torch

    n_gpu = torch.cuda.device_count()
    if n_gpu < 2:
        log("dp scaling efficiency over devices: not measured (one device)")
        return
    from stark_symphony_tpu_torch import entry as E
    from stark_symphony_tpu_torch.models.stwo import proof as P
    from stark_symphony_tpu_torch.models.stwo import verifier
    from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION
    from stark_symphony_tpu_torch.parallel.batch import make_mesh, verify_batch_dp, verify_batch_tp

    n_bad = len(PROD_TAMPERS)
    total = n_gpu * per_device
    batch = tamper_lanes(E.production_batch(total, proofs), PROD_TAMPERS)
    want = verifier.verify_batch(P.to_torch(batch, "cuda:0"), PRODUCTION)
    one = P.map_fields(lambda x: x[:per_device], batch)
    times = {}
    for n in (1, n_gpu):
        sub = batch if n == n_gpu else one
        mesh = make_mesh(n)
        verify_batch_dp(sub, PRODUCTION, mesh)  # warm-up: each device's tables
        (bitmap, n_ok), times[n] = timed(lambda: verify_batch_dp(sub, PRODUCTION, mesh))
        check(torch.equal(bitmap, want[:n * per_device]), f"dp over {n} devices != verify")
    check(int(n_ok) == total - n_bad, f"dp over {n_gpu} devices: {int(n_ok)} accepted")
    log(f"dp scaling, one process: {per_device} lanes a device, {times[1]:.3f} s on one "
        f"device, {times[n_gpu]:.3f} s on {n_gpu}; efficiency {times[1] / times[n_gpu]:.3f} "
        f"[{CARD} x {n_gpu}]")
    graphed = {}
    for n in (1, n_gpu):
        sub = batch if n == n_gpu else one
        mesh = make_mesh(n)
        verify_batch_dp(sub, PRODUCTION, mesh, graphed=True)  # a graph a device
        (bitmap, n_ok), graphed[n] = timed(
            lambda: verify_batch_dp(sub, PRODUCTION, mesh, graphed=True))
        check(torch.equal(bitmap, want[:n * per_device]), f"graphed dp over {n} devices != verify")
        mesh.graphs.entries.clear()
    log(f"dp scaling graphed, one process: {per_device} lanes a device, a second call "
        f"{graphed[1]:.3f} s on one device, {graphed[n_gpu]:.3f} s on {n_gpu}; efficiency "
        f"{graphed[1] / graphed[n_gpu]:.3f} (eager {times[1] / times[n_gpu]:.3f}) "
        f"[{CARD} x {n_gpu}]")
    runs = multi_process_dp(total, n_gpu, runs=2)  # each process sees every card
    slowest = max(r[3] for r in runs)
    check(all(r[0] == "nccl" and r[2] == total - n_bad and r[4] == f"[{rank}]"
              for rank, r in enumerate(runs)), f"{n_gpu}-process dp: {runs}")
    log(f"dp scaling, one process a device (its share of the cards it sees, nccl): "
        f"{per_device} lanes each, second call "
        f"{', '.join(f'{r[3]:.3f}' for r in runs)} s; efficiency against one device "
        f"{times[1] / slowest:.3f} [{CARD} x {n_gpu}]")

    tp = 4 if n_gpu >= 4 else 2
    devs = [f"cuda:{i % n_gpu}" for i in range(tp)]
    (bitmap, _), tp_s = timed(lambda: verify_batch_tp(
        P.map_fields(lambda x: x[:512], batch), PRODUCTION, make_mesh(tp, tp=tp, devices=devs)))
    check(torch.equal(bitmap, want[:512]), f"tp over {devs} != verify")
    log(f"across {n_gpu} devices: tp over {tp} shards {tp_s:.3f} s, equal to verify "
        f"[{CARD} x {n_gpu}]")
    multi_gpu_sp(n_gpu)


def multi_gpu_sp(n_gpu: int) -> None:
    """(j) with two or more devices: over 8 shards spread over the
    `n_gpu` devices, the stwo fold and commit at lde 18 and the PRODUCTION
    sharded proof, eager, against their single-device oracles; then
    graphed, the fold and commit (``graphed_sp``: equal to the eager
    calls) and ``prove_sharded(graphed=True)``, which takes the per-shard
    layout there (``per_shard_proofs``: s0's and s1's fixtures through one
    capture, its time beside the eager proof's).  Logs ``nvidia-smi topo
    -m`` and ``nvlink --status`` and the devices' peer access: what joins
    the cards that the exchanges cross."""
    import numpy as np
    import torch

    from stark_symphony_tpu_torch.models.stwo import proof as P
    from stark_symphony_tpu_torch.models.stwo import prover_sharded
    from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION
    from stark_symphony_tpu_torch.models.stwo.prover import _commit_leaves, seeded_trace
    from stark_symphony_tpu_torch.ops.field import P as M31P
    from stark_symphony_tpu_torch.ops.u32 import from_numpy
    from stark_symphony_tpu_torch.parallel import fri_shard as FS
    from stark_symphony_tpu_torch.parallel.mesh import Mesh, unshard
    from stark_symphony_tpu_torch.utils.proofcache import fixture_path

    for query in (["topo", "-m"], ["nvlink", "--status"]):
        out = subprocess.run(["nvidia-smi", *query], capture_output=True, text=True, timeout=60)
        log(f"nvidia-smi {' '.join(query)} (exit {out.returncode}):\n"
            f"{(out.stdout + out.stderr).rstrip()}")
    peers = [torch.cuda.can_device_access_peer(i, j)
             for i in range(n_gpu) for j in range(n_gpu) if i != j]
    log(f"peer access: {sum(peers)} of the {len(peers)} ordered pairs of devices")
    spread = [f"cuda:{i % n_gpu}" for i in range(SHARDS)]
    sp = Mesh(spread, ("sp",))
    rng = np.random.default_rng(20261019)
    vals = from_numpy(rng.integers(0, M31P, (1 << 18, 4), dtype=np.uint32), "cuda:0")
    alphas = [from_numpy(rng.integers(0, M31P, 4, dtype=np.uint32), "cuda:0") for _ in range(14)]

    def fold(graphed):
        return [unshard(sp, FS.stwo_fold_sharded(vals, alphas, 18, sp, 14, graphed=graphed), "sp")]

    def commit(graphed):
        root, levels = FS.stwo_commit_sharded(vals, sp, return_levels=True, graphed=graphed)
        return [root] + FS.natural_levels_to_tree(levels, 18)

    folded, fold_s = timed(lambda: fold(False))
    check(torch.equal(folded[0], FS.stwo_fold_reference(vals, FS.stwo_domain_points(18), alphas,
                                                        14)), "stwo_fold_sharded across devices")
    tree, commit_s = timed(lambda: commit(False))
    ref_levels, ref_root = _commit_leaves(vals, 18)
    check(torch.equal(tree[0], ref_root) and all(torch.equal(a, b)
                                                 for a, b in zip(tree[1:], ref_levels)),
          "stwo_commit_sharded across devices: root or a level != _commit_leaves")
    prove_s = []
    for _ in range(2):  # the first call makes each device's host tables
        (proof, _), secs = timed(lambda: prover_sharded.prove_sharded(
            PRODUCTION, sp, trace=seeded_trace(PRODUCTION, 0)))
        prove_s.append(secs)
        check(first_difference(proof, P.load_npz(str(fixture_path(PRODUCTION, 0)))) is None,
              "the sharded proof across devices differs from its fixture")
    log(f"across {n_gpu} devices: lde-18 fold (14 stages) {fold_s:.3f} s and commit "
        f"{commit_s:.3f} s over {SHARDS} shards, equal to their oracles; PRODUCTION sharded "
        f"proof {prove_s[0]:.3f} s, then {prove_s[1]:.4f} s, equal to its fixture "
        f"[{CARD} x {n_gpu}]")
    where = f"over {SHARDS} shards on {n_gpu} devices"
    graphed_sp(sp, [("stwo fold at lde 18", fold, folded, fold_s),
                    ("stwo commit at lde 18", commit, tree, commit_s)], where)
    check(prover_sharded.per_shard_layout(sp), f"a mesh over {n_gpu} devices took graph A")

    def prove(seed):
        trace = seeded_trace(PRODUCTION, seed)
        proof, _ = prover_sharded.prove_sharded(PRODUCTION, sp, trace=trace, graphed=True)
        return proof, prover_sharded.graphed_prover(PRODUCTION, sp, "sp",
                                                    from_numpy(trace, sp.devices[0]))

    per_shard_proofs(sp, prove, prove_s[1], f"{where}, prove_sharded(graphed=True)")


def phase_tools(proofs) -> dict:
    """(k): the tools and utils layer on the card.

    debug (``tools/debug.main``) on ``proof_test.json``, ``proof.json`` and
    stark101's golden proof: each transcript, mask list and exit code
    equal to the CPU run's, text for text, and the launches of proof.json's
    verify under ``record_transcript`` equal to a plain verify's and to
    PATHS (61 / 9 / 2: recording adds none); ``--ops --ops-filter
    m31_mul,sha256_pair --limit 50`` equal to the CPU run's.  The linkage
    audit of proof.json: 16 queries, 20 columns, rank 11, augmented 12,
    inconsistent; of the own PRODUCTION proof: consistent.  The profiler
    (``tools/profile_verify``) over both paths at B = 4,096: every graphed
    stage equal to its eager run (it raises otherwise), ``full`` accepting
    every proof, each stage's K1-K6 launches as PROFILE_LAUNCHES, the
    run's total as its stages give it; the lines printed.  STPU_CHECK on:
    a TESTING verify accepts, ``m31_add`` on a lane holding P raises
    FloatingPointError, and a capture of the verify raises EagerOnlyError
    (the context still verifies after it).  BatchCheckpointer over 8
    graphed tiled batches (valid and tampered in turn), stopped after 4
    and resumed: 4 skipped, the accepted count and the journal those of
    the run never stopped.  Returns the launch counts by path."""
    import contextlib
    import io
    import tempfile

    import torch

    from stark_symphony_tpu_torch import entry as E
    from stark_symphony_tpu_torch.models.stwo import proof as P
    from stark_symphony_tpu_torch.models.stwo import tiled, verifier
    from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION, TESTING
    from stark_symphony_tpu_torch.ops import checks
    from stark_symphony_tpu_torch.ops import field as F
    from stark_symphony_tpu_torch.tools import build as TB
    from stark_symphony_tpu_torch.tools import debug
    from stark_symphony_tpu_torch.tools import linkage_audit as LA
    from stark_symphony_tpu_torch.tools import profile_verify as PV
    from stark_symphony_tpu_torch.utils.checkpoint import BatchCheckpointer
    from stark_symphony_tpu_torch.utils.proofcache import cached_stwo_proof

    t_start = time.perf_counter()
    fixtures = ROOT / "tests" / "fixtures"
    counts = {}

    def run_debug(*argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = debug.main(list(argv))
        return rc, out.getvalue()

    cases = [("stwo", "stwo/proof_test.json", 1, ()), ("stwo", "stwo/proof.json", 1, ()),
             ("stark101", "stark101/golden_proof.json", 0, ()),
             ("stwo", "stwo/proof_test.json", 1,
              ("--ops", "--ops-filter", "m31_mul,sha256_pair", "--limit", "50"))]
    for scheme, name, want_rc, extra in cases:
        argv = (scheme, str(fixtures / name), *extra)
        (rc_cpu, out_cpu), cpu_s = timed(lambda: run_debug(*argv, "--device", "cpu"))
        reset_counts()
        (rc, out), gpu_s = timed(lambda: run_debug(*argv, "--device", "cuda"))
        made = launch_counts()
        check(rc == rc_cpu == want_rc, f"debug {name} {extra}: exit {rc} on the card, "
              f"{rc_cpu} on the CPU, want {want_rc}")
        check(out == out_cpu, f"debug {name} {extra}: the card's output != the CPU run's")
        lines = out.splitlines()
        n_events = sum(1 for line in lines if line.startswith("["))
        log(f"debug {scheme} {name} {' '.join(extra)}: output equal to the CPU run's, text "
            f"for text ({n_events} events, {lines[-1]}, exit {rc}); {gpu_s:.3f} s on the card, "
            f"{cpu_s:.3f} s on the CPU; launches {made} [{CARD}]")
        if name == "stwo/proof.json":
            counts["debug"] = made
            check_counts("debug", made)
            proof, cfg = P.load_json(str(fixtures / name))
            reset_counts()
            verifier.verify(P.to_torch(proof, "cuda"), cfg)
            torch.cuda.synchronize()
            check(launch_counts() == made, f"debug: recording changed the launches: {made}, "
                  f"a plain verify {launch_counts()}")

    proof, cfg = P.load_json(str(fixtures / "stwo" / "proof.json"))
    reset_counts()
    res, audit_s = timed(lambda: LA.audit(proof, cfg, "cuda"))
    counts["linkage_audit"] = launch_counts()
    check_counts("linkage_audit", counts["linkage_audit"])
    check(res == {"n_queries": 16, "n_columns": 20, "rank": 11, "rank_augmented": 12,
                  "consistent": False}, f"linkage audit of proof.json: {res}")
    own, own_s = timed(lambda: LA.audit(cached_stwo_proof(PRODUCTION), PRODUCTION, "cuda"))
    check(own["consistent"] and own["rank"] == own["rank_augmented"],
          f"linkage audit of the own PRODUCTION proof: {own}")
    log(f"linkage audit: proof.json {res} in {audit_s:.3f} s; the own PRODUCTION proof "
        f"{own} in {own_s:.3f} s; launches {counts['linkage_audit']} [{CARD}]")

    valid = E.production_batch(N_PROOFS, proofs)
    for path, profile, names in (("profile_standard", PV.profile_standard, PV.STAGES),
                                 ("profile_tiled", PV.profile_tiled, PV.TILED_STAGES)):
        reset_counts()
        lines, secs = timed(lambda: profile(valid, PRODUCTION, PROFILE_ITERS, "cuda"))
        total = launch_counts()
        check([line["stage"] for line in lines] == list(names), f"{path}: stages {lines}")
        check(lines[-1]["accepted"] == N_PROOFS,
              f"{path}: full accepted {lines[-1]['accepted']} of {N_PROOFS}")
        per_path = {k: 0 for k in KERNELS}
        for line in lines:
            want = PROFILE_LAUNCHES[path][line["stage"]]
            check(line["launches"] == want, f"{path} {line['stage']}: launches "
                  f"{line['launches']}, want {want}")
            for k, n in line["launches"].items():
                per_path[k] += n
            log(f"{path}: {json.dumps(line)} [{CARD}]")
        check_counts(path, per_path)
        # each stage: a first eager call, PROFILE_ITERS timed ones, a warm-up
        # and the capture; the standard path's transcript once more for its
        # queries
        runs = PROFILE_ITERS + 3
        extra = PROFILE_LAUNCHES[path]["stages_i_iv"] if path == "profile_standard" else {}
        want_total = {k: runs * n + extra.get(k, 0) for k, n in per_path.items()}
        check(total == want_total, f"{path}: the run launched {total}, want {want_total}")
        counts[path] = per_path
        log(f"{path}: every graphed stage equal to its eager run; {secs:.3f} s in all; "
            f"the stages' launches {per_path}, the run's {total} [{CARD}]")
        torch.cuda.empty_cache()

    small = P.to_torch(P.replicate(cached_stwo_proof(TESTING), 64), "cuda")
    with checks.checking():
        (ok, _), check_s = timed(lambda: verifier.verify(small, TESTING))
        check(bool(ok.all()), "STPU_CHECK=1: the TESTING verify rejected valid proofs")
        lane = torch.tensor([1, 2, F.P, 3], dtype=torch.int64, device="cuda")
        raised = None
        try:
            F.m31_add(lane, lane)
        except FloatingPointError as e:
            raised = str(e)
        check(raised == "overflow check failed: m31_add lhs (bound 0x7fffffff)",
              f"STPU_CHECK=1: m31_add on a lane holding P raised {raised!r}")
        refused = None
        try:
            TB.capture(lambda b: verifier.verify_batch(b, TESTING), (small,))
        except checks.EagerOnlyError as e:
            refused = str(e)
        check(refused is not None and "STPU_CHECK=1 needs eager mode" in refused,
              f"STPU_CHECK=1: capture of a verify gave {refused!r}")
    check(bool(verifier.verify_batch(small, TESTING).all()),
          "after the refused capture the context no longer verifies")
    log(f"STPU_CHECK=1 on the card: a TESTING verify of 64 lanes accepts in {check_s:.3f} s; "
        f"m31_add on a lane holding P raises FloatingPointError ({raised}); "
        f"tools/build.capture of the verify raises EagerOnlyError ({refused}) [{CARD}]")

    fn, (tb,) = E.entry_tiled(N_PROOFS, "cuda", proofs, graphed=True)
    bad = tiled.tile_batch(tamper_lanes(valid, PROD_TAMPERS), PRODUCTION, "cuda")
    batches = [tb, bad] * 4
    with tempfile.TemporaryDirectory() as d:
        whole = BatchCheckpointer(f"{d}/whole.jsonl")
        for i, b in enumerate(batches):
            whole.record(i, fn(b))
        stopped = BatchCheckpointer(f"{d}/stopped.jsonl")
        for i, b in enumerate(batches[:4]):
            stopped.record(i, fn(b))
        resumed, skipped = BatchCheckpointer(f"{d}/stopped.jsonl"), 0
        for i, b in enumerate(batches):
            if resumed.done(i):
                skipped += 1
                continue
            resumed.record(i, fn(b))
        same = (pathlib.Path(d) / "whole.jsonl").read_bytes() == \
            (pathlib.Path(d) / "stopped.jsonl").read_bytes()
    want_ok = 4 * N_PROOFS + 4 * (N_PROOFS - len(PROD_TAMPERS))
    check(skipped == 4 and resumed.batches() == 8 and same
          and resumed.accepted() == whole.accepted() == want_ok,
          f"BatchCheckpointer: skipped {skipped}, accepted {resumed.accepted()} against "
          f"{whole.accepted()} (want {want_ok}), journals equal {same}")
    log(f"BatchCheckpointer: 8 graphed tiled batches of {N_PROOFS}, stopped after 4 and "
        f"resumed: 4 skipped, {resumed.accepted()} accepted as in the run never stopped, "
        f"journals byte-equal [{CARD}]")
    del fn, tb, bad, batches
    torch.cuda.empty_cache()
    log(f"phase (k): {time.perf_counter() - t_start:.1f} s")
    return counts


def main() -> int:
    t_start = time.perf_counter()

    def stamp(phases):
        log(f"elapsed after phase {phases}: {time.perf_counter() - t_start:.1f} s")

    phase_device()  # (a)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from stark_symphony_tpu_torch import entry as E

    phase_build()  # (b)
    rng = np.random.default_rng(20261016)
    errs = phase_kernels(rng)  # (c)
    phase_prover_kernels(np.random.default_rng(20261017), errs)
    stamp("(c)")

    t0 = time.perf_counter()
    proofs = E.production_proofs()
    log(f"fixtures: {len(proofs)} distinct PRODUCTION proofs loaded in "
        f"{time.perf_counter() - t0:.3f} s")
    counts = {}
    counts["standard"], std_ms, fn, batch, tamper_cpu = phase_slice(proofs)  # (d), (e)
    counts["tiled"], tiled_ms, fn_t, tb = phase_tiled(proofs, tamper_cpu)  # (d'), (e)
    rows = phase_timings(rng, errs)  # (f)
    rows.append(phase_deep(rng, proofs, errs))
    phase_profile("standard", fn, batch, std_ms)
    phase_profile("tiled", fn_t, tb, tiled_ms)
    stamp("(f)")
    s101_counts, s101_ms, fn_s, sb = phase_stark101()  # (g)
    counts.update(s101_counts)
    phase_stark101_timings(rng, errs)
    phase_profile("stark101", fn_s, sb, s101_ms)
    del fn, batch, fn_t, tb, fn_s, sb
    stamp("(g)")
    counts.update(phase_graphs(proofs))  # (h)
    stamp("(h)")
    prover_counts, prove_ms, routed, stwo_proofs = phase_stwo_prover(proofs)  # (i)
    counts.update(prover_counts)
    phase_prover_timings(rng, errs)
    phase_profile("stwo_prover", lambda _: E.prove_stwo(), None, prove_ms)
    stamp("(i)")
    sharded_counts, sharded_ms, sharded = phase_parallel(proofs, routed, errs)  # (j)
    counts.update(sharded_counts)
    phase_profile("stwo_prover_sharded", lambda _: E.prove_stwo_sharded(), None, sharded_ms)
    phase_multi_gpu(proofs)
    stamp("(j)")
    counts.update(phase_tools(proofs))  # (k)
    stamp("(k)")
    counts.update(phase_compiled(proofs, stwo_proofs, prove_ms, routed, sharded,  # (l)
                                 sharded_ms))
    stamp("(l)")

    largest = {}  # per kernel, its last timed shape: the path's largest call
    for name, *row in rows:
        largest[name] = row
    kernels = []
    for name, (_, source, replaces, _) in KERNELS.items():
        _, k_ms, p_ms, b_ms, b_by, _, _ = largest[name]
        path = next(p for p, want in PATHS.items() if want[name] != 0)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{PACKAGE}/{source}", "replaces": replaces,
            "launches": counts[path][name],
            "launches_per_path": {p: c[name] for p, c in counts.items() if c[name]},
            "max_abs_err": errs[name],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
