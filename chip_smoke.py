#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python chip_smoke.py

Drives the port's main path, the batched stwo verifier at the PRODUCTION
config, through both entry points of ``stark_symphony_tpu_torch.entry``:
``entry()`` (the standard path, kernels K1-K3) and ``entry_tiled()`` (the
tiled fast path, kernels K1, K4 and K5), in phases:

  (a) device: needs CUDA (exits non-zero without it) and prints the card's
      name and power limit as nvidia-smi reports them;
  (b) build: compiles the kernels K1-K5 from ``stark_symphony_tpu_torch/csrc``
      (one nvcc process per source, all at once) and prints ptxas's
      registers, shared memory and spills for each;
  (c) kernels: each kernel against its plain PyTorch version on the card, bit
      for bit, on seeded random words at ragged lane counts (words >= P and
      >= 2^31 included; K1-K3 at both of their block sizes, K2 with a
      broadcast and a misaligned operand, K3 with per-lane and per-query
      depths and a broadcast sibling path; about half the K4/K5 lanes carry
      valid paths), and a few lanes against hashlib;
  (d) standard path: 4,096 PRODUCTION proofs (the 256 committed fixtures, 16
      times each) must all be accepted; a 16-proof batch carrying the 15
      tamper classes in lanes 1-15 must reject exactly those lanes, with every
      mask equal to the port's own CPU run;
  (d') tiled path: the same 4,096 proofs through ``entry_tiled()`` must all be
      accepted, and the tamper batch, tiled on the card, must give every mask
      of the CPU run; the time of ``tile_batch`` (H2D and the on-device
      relayout) is printed;
  (e) launch counts, per path, each counted from 0 over one run: standard K1,
      K2, K3 > 0 and no K4/K5; tiled K1 > 0, K4 = 2, K5 = 1 and no K2/K3;
  (f) at the shapes each path gives each kernel: kernel and plain version
      compared bit for bit again (K4/K5 on inputs where both ok values
      occur, as in (c)), then timed with CUDA events, beside each
      path's proofs/s (median of 5 batches, each timed alone); for every
      kernel, torch.profiler over one wrapper call must show one device
      activity, the stpu:: kernel itself, and K3 is timed in blocks of 32
      and of 128 threads;
      torch.profiler over one batch of each path gives the device's busy
      share and each kernel's own device time, with the launches it saw
      beside those counted, and where it saw fewer, which ones it missed.

Any failure raises and exits non-zero.  The last line is the JSON object
``{"ok": true, "device": {...}}``; the line before it lists the kernels,
each with its time, its plain version's time and its bound: the larger of
the bytes its inputs and outputs move at the card's memory rate and the
integer ALU instructions its SHA-256 compressions need at the card's
issue rate for them (``bound()``).
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
PACKAGE = "stark_symphony_tpu_torch"
N_PROOFS = 4096
LANES = 4097  # not a multiple of any block size: the ragged edge runs
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


def tamper_batch(proof, n_layers: int):
    """A batch of 1 + 15 copies of a numpy proof: lane 0 clean, lane k
    tampered by the k-th class.  A tuple field's index is taken mod
    `n_layers`, the proof's FRI layer count (9 at PRODUCTION)."""
    from stark_symphony_tpu_torch.models.stwo import proof as P

    batch = P.replicate(proof, 1 + len(PROD_TAMPERS))
    fields = batch._asdict()
    for lane, (field, mutate, idx) in enumerate(PROD_TAMPERS, 1):
        arr = fields[field] if idx is None else fields[field][idx % n_layers]
        arr[lane] = mutate(arr[lane])
    return batch


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
}
# Each path's launch counts expected on one batch; a count of None means
# "more than 0".  Its profile must show the device function of every
# kernel it launches.
PATHS = {
    "standard": {"sha256_words": None, "sha256_pair": None, "merkle_walk": None,
                 "leafwalk": 0, "fri_all_layers": 0},
    "tiled": {"sha256_words": None, "sha256_pair": 0, "merkle_walk": 0,
              "leafwalk": 2, "fri_all_layers": 1},
}

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


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() over iters runs, by CUDA events, after
    one warm-up run."""
    import torch

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


def reset_counts() -> None:
    from stark_symphony_tpu_torch.ops.cuda import fri_kernel as fk
    from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck

    ck.reset_launches()
    fk.reset_launches()


def launch_counts() -> dict:
    from stark_symphony_tpu_torch.ops.cuda import fri_kernel as fk
    from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck

    return {**ck.launches, **fk.launches}


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

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script runs "
                         "the port on an NVIDIA GPU and has no CPU mode")
    if not (ROOT / PACKAGE / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke: {PACKAGE}/ not found beside this "
                         "script; run it from a checkout of the repository")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log(smi[0].strip())
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

    slice_ms, runs = batch_ms(fn, batch)  # the first run above was the warm-up
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
    """Lanes 1-15 rejected, lane 0 accepted, every mask of the card's run
    equal to the CPU run's, keys in the same order."""
    import numpy as np
    import torch

    bm = ok_g.cpu().numpy()
    check(bm[0] and not bm[1:].any(),
          f"{path} tamper matrix: accepted lanes {np.flatnonzero(bm).tolist()}, want [0]")
    check(list(masks_g) == list(masks_c), f"{path}: mask keys differ from the CPU run's")
    for k in masks_g:
        check(torch.equal(masks_g[k].cpu(), masks_c[k]), f"{path} mask {k}: GPU != CPU")
    check(torch.equal(ok_g.cpu(), ok_c), f"{path} accept bitmap: GPU != CPU")
    log(f"{path} tamper matrix: lanes 1-15 rejected, lane 0 accepted; all "
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

    slice_ms, runs = batch_ms(fn, tb)
    log(f"tiled slice: {slice_ms:.3f} ms per {N_PROOFS}-proof batch "
        f"({N_PROOFS / (slice_ms / 1e3):.1f} proofs/s; CUDA events, median of "
        f"{len(runs)} runs: {', '.join(f'{r:.1f}' for r in runs)} ms)")

    tamper = tiled.tile_batch(tamper_batch(proofs[0], 1 + PRODUCTION.n_inner_layers),
                              PRODUCTION, "cuda")
    ok_g, masks_g = verifier.verify_batch_tiled(tamper, PRODUCTION, with_masks=True)
    check_tamper("tiled", ok_g, masks_g, *tamper_cpu)
    return counts, slice_ms, fn, tb


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
    import torch

    from stark_symphony_tpu_torch.ops import fri, merkle, sha256
    from stark_symphony_tpu_torch.ops.cuda import fri_kernel as fk
    from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
    from stark_symphony_tpu_torch.ops.u32 import from_i32, from_numpy, to_i32

    bq = N_PROOFS * 16

    def words(*shape):
        return from_numpy(rng.integers(0, 1 << 32, shape, dtype=np.uint32), "cuda")

    def i32(args):
        return [to_i32(a).contiguous() if isinstance(a, torch.Tensor) else a
                for a in args]

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
        want = plain[name](*args)
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
        p_ms = cuda_ms(lambda: plain[name](*args), 2)
        calls.append((name, lambda f=kern[name], a=kargs: f(*a)))
        rows.append([name, what, k_ms, p_ms, b_ms, b_by, compr])
        log(f"time {name} [{what}]: bit-equal; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.3f} ms ({p_ms / k_ms:.1f}x); bound {b_ms:.4f} ms by {b_by}; "
            f"{compr} compressions, {compr / (k_ms / 1e3) / 1e9:.2f} G/s")
    for row, ms in zip(rows, one_kernel_each(calls)):
        row.append(ms)
        log(f"profile {row[0]} [{row[1]}]: one launch a call, {ms:.4f} ms on the device")
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


def _device_events(prof) -> list:
    """The device activities of a torch.profiler run, in start order."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sorted(dev, key=lambda e: e.time_range.start)


def _profiled(fn, complete):
    """torch.profiler over fn(), taken again, up to three times in all,
    while complete(profile) is false: on the card the profiler has been
    seen to miss a kernel now and then (PERF.md)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    computes them: what the profiler's trace shows of each launch."""
    if name == "sha256_words":
        _, _, n, lanes, threads = args
        return -(-lanes // threads), threads * max(n, 8) * 8 + 8
    if name == "sha256_pair":
        lanes, threads = args[3], args[4]
        return -(-lanes // threads), 512 + threads * 128 + 8
    if name == "merkle_walk":
        lanes, threads = args[7], args[8]
        return -(-lanes // threads), threads * 200 + 32
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
    dev = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    log(f"profile {path}: the trace's first device activities: "
        f"{[e['name'][:40] for e in dev[:3]]}")
    for name, fn_name in short:
        made = [shape for n, shape in record if n == name]
        seen = [(e["args"]["grid"][0], e["args"].get("shared memory"))
                for e in dev if f"stpu::{fn_name}(" in e["name"]]
        if seen and seen[0][1] is None:  # no shared memory in the trace
            made = [(blocks, None) for blocks, _ in made]
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
    # device-side rows only: an operator's row repeats its kernels' time
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile {path}: device busy {busy_ms:.1f} ms in "
        f"{sum(e.count for e in kernels)} launches, "
        f"{100 * busy_ms / slice_ms:.1f} % of the {slice_ms:.1f} ms batch")
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


def main() -> int:
    phase_device()  # (a)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from stark_symphony_tpu_torch import entry as E

    phase_build()  # (b)
    rng = np.random.default_rng(20261016)
    errs = phase_kernels(rng)  # (c)

    t0 = time.perf_counter()
    proofs = E.production_proofs()
    log(f"fixtures: {len(proofs)} distinct PRODUCTION proofs loaded in "
        f"{time.perf_counter() - t0:.3f} s")
    counts = {}
    counts["standard"], std_ms, fn, batch, tamper_cpu = phase_slice(proofs)  # (d), (e)
    counts["tiled"], tiled_ms, fn_t, tb = phase_tiled(proofs, tamper_cpu)  # (d'), (e)
    rows = phase_timings(rng, errs)  # (f)
    phase_profile("standard", fn, batch, std_ms)
    phase_profile("tiled", fn_t, tb, tiled_ms)

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
            "launches": counts[path][name], "max_abs_err": errs[name],
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
