#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python chip_smoke.py

Drives the port's main path, the batched stwo verifier at the PRODUCTION
config, through ``stark_symphony_tpu_torch.entry``, in phases:

  (a) device: needs CUDA (exits non-zero without it) and prints the card's
      name and power limit as nvidia-smi reports them;
  (b) build: compiles the kernels K1-K3 from ``stark_symphony_tpu_torch/csrc``;
  (c) kernels: each kernel against its plain PyTorch version on the card, bit
      for bit, on seeded random words at a ragged lane count, and a few lanes
      against hashlib;
  (d) slice: 4,096 PRODUCTION proofs (the 256 committed fixtures, 16 times
      each) must all be accepted; a 16-proof batch carrying the 15 tamper
      classes in lanes 1-15 must reject exactly those lanes, with every
      mask equal to the port's own CPU run;
  (e) every kernel's launch count in the main-path run is above zero;
  (f) at the shapes the slice gives each kernel: kernel and plain version
      compared bit for bit again, then timed with CUDA events, beside the
      slice's proofs/s; torch.profiler over one slice run gives the
      device's busy share and each kernel's own device time.

Any failure raises and exits non-zero.  The last line is the JSON object
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
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
LANES = 4097  # not a multiple of the 256-thread block: the ragged edge runs

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


KERNELS = {  # wrapper name -> (kernel, Pallas function it replaces)
    "sha256_words": ("K1", "stark_symphony_tpu/ops/pallas/sha256_kernel.py:221"),
    "sha256_pair": ("K2", "stark_symphony_tpu/ops/pallas/sha256_kernel.py:265"),
    "merkle_walk": ("K3", "stark_symphony_tpu/ops/pallas/sha256_kernel.py:312"),
}


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

    from stark_symphony_tpu_torch.ops import merkle, sha256
    from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
    from stark_symphony_tpu_torch.ops.u32 import from_numpy, to_numpy

    err = {name: 0 for name in KERNELS}

    def compare(name, got, want, what):
        diff = int((got - want).abs().max().item()) if got.numel() else 0
        err[name] = max(err[name], diff)
        check(torch.equal(got, want), f"{name} != plain ({what}), max |diff| {diff}")

    for n in (4, 9, 10, 12, 16, 88):
        msgs = rng.integers(0, 1 << 32, (LANES, n), dtype=np.uint32)
        t = from_numpy(msgs, "cuda")
        got = ck.sha256_words(t)
        compare("sha256_words", got, sha256.sha256_words_plain(t), f"n={n}")
        host = to_numpy(got)
        for lane in (0, 1, LANES // 2, LANES - 1):
            check(list(host[lane]) == _hashlib_words(msgs[lane]),
                  f"sha256_words n={n} lane {lane} != hashlib")
    log(f"K1 sha256_words: bit-equal to plain and hashlib, n in 4,9,10,12,16,88, {LANES} lanes")

    left = rng.integers(0, 1 << 32, (LANES, 8), dtype=np.uint32)
    right = rng.integers(0, 1 << 32, (LANES, 8), dtype=np.uint32)
    lt, rt = from_numpy(left, "cuda"), from_numpy(right, "cuda")
    got = ck.sha256_pair(lt, rt)
    compare("sha256_pair", got, sha256.sha256_pair_plain(lt, rt), "node")
    host = to_numpy(got)
    for lane in (0, 1, LANES // 2, LANES - 1):
        check(list(host[lane]) == _hashlib_words(np.concatenate([left[lane], right[lane]])),
              f"sha256_pair lane {lane} != hashlib")
    log(f"K2 sha256_pair: bit-equal to plain and hashlib, {LANES} lanes")

    for depth, ragged in ((13, False), (12, True)):
        leaf = rng.integers(0, 1 << 32, (LANES, 8), dtype=np.uint32)
        sibs = rng.integers(0, 1 << 32, (LANES, depth, 8), dtype=np.uint32)
        idx = rng.integers(0, 1 << depth, LANES, dtype=np.uint32)
        deps = (rng.integers(0, depth + 1, LANES) if ragged
                else np.full(LANES, depth))
        args = (from_numpy(leaf, "cuda"), from_numpy(idx, "cuda"),
                from_numpy(sibs, "cuda"))
        got = ck.merkle_compute_root(*args, deps if ragged else None)
        want = merkle.compute_root_plain(*args, deps if ragged else None)
        compare("merkle_walk", got, want, f"depth {depth} ragged={ragged}")
        host = to_numpy(got)
        for lane in (0, 1, LANES // 2, LANES - 1):
            check(list(host[lane]) == _hashlib_root(leaf[lane], int(idx[lane]),
                                                    sibs[lane], int(deps[lane])),
                  f"merkle_walk depth {depth} lane {lane} != hashlib")
    log(f"K3 merkle_walk: bit-equal to plain and hashlib, depth 13 and "
        f"per-lane depths 0..12, {LANES} lanes")
    return err


def phase_slice(proofs):
    """The main path at B = 4,096 through entry(); then the tamper matrix
    against the port's own CPU run.  Returns (launch counts, the median
    batch ms, the entry function and its batch)."""
    import numpy as np
    import torch

    from stark_symphony_tpu_torch import entry as E
    from stark_symphony_tpu_torch.models.stwo import proof as P
    from stark_symphony_tpu_torch.models.stwo import verifier
    from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION
    from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck

    t0 = time.perf_counter()
    fn, (batch,) = E.entry(N_PROOFS, "cuda", proofs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    nbytes = 4 * sum(t.numel() for f in batch
                     for t in (f if isinstance(f, tuple) else (f,)))
    log(f"batch: {N_PROOFS} proofs, {nbytes / 1e6:.1f} MB as uint32; entry() "
        f"set-up (stack, H2D, widen) {setup_s:.3f} s")

    ck.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bitmap = fn(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = dict(ck.launches)
    log(f"main path: verify_batch(B={N_PROOFS}) first run {first_s:.3f} s, "
        f"launches {counts}")
    check(tuple(bitmap.shape) == (N_PROOFS,), f"bitmap shape {tuple(bitmap.shape)}")
    n_ok = int(bitmap.sum().item())
    check(n_ok == N_PROOFS, f"{N_PROOFS - n_ok} of {N_PROOFS} valid proofs rejected")
    log(f"main path: all {N_PROOFS} proofs accepted")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    runs = []  # the first run above was the warm-up
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(batch)
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
    runs.sort()
    slice_ms = runs[len(runs) // 2]
    log(f"slice: {slice_ms:.3f} ms per {N_PROOFS}-proof batch "
        f"({N_PROOFS / (slice_ms / 1e3):.1f} proofs/s; CUDA events, median of "
        f"{len(runs)} runs: {', '.join(f'{r:.1f}' for r in runs)} ms)")

    # tamper matrix: lane 0 clean, lanes 1..15 one class each
    tb = tamper_batch(proofs[0], 1 + PRODUCTION.n_inner_layers)
    ok_g, masks_g = verifier.verify(P.to_torch(tb, "cuda"), PRODUCTION)
    ok_c, masks_c = verifier.verify(P.to_torch(tb, "cpu"), PRODUCTION)
    bm = ok_g.cpu().numpy()
    check(bm[0] and not bm[1:].any(),
          f"tamper matrix: accepted lanes {np.flatnonzero(bm).tolist()}, want [0]")
    check(list(masks_g) == list(masks_c), "mask keys differ between GPU and CPU")
    for k in masks_g:
        check(torch.equal(masks_g[k].cpu(), masks_c[k]), f"mask {k}: GPU != CPU")
    check(torch.equal(ok_g.cpu(), ok_c), "accept bitmap: GPU != CPU")
    log(f"tamper matrix: lanes 1-15 rejected, lane 0 accepted; all {len(masks_g)} "
        "masks equal to the CPU run")
    return counts, slice_ms, fn, batch


def phase_timings(rng, err):
    """Each kernel (wrapper, layout included) against its plain version at
    the shapes of the slice at B = 4,096 (Q = 16, 9 FRI layers): compared
    bit for bit (largest difference into `err`), then timed."""
    import numpy as np
    import torch

    from stark_symphony_tpu_torch.ops import merkle, sha256
    from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
    from stark_symphony_tpu_torch.ops.u32 import from_numpy

    bq = N_PROOFS * 16

    def words(*shape):
        return from_numpy(rng.integers(0, 1 << 32, shape, dtype=np.uint32), "cuda")

    # per-proof FRI layer depths 12..4, 16 queries each, as the slice pads them
    fri_depths = np.repeat(np.arange(12, 3, -1), 16)
    cases = [
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
    ]
    kern = {"sha256_words": ck.sha256_words, "sha256_pair": ck.sha256_pair,
            "merkle_walk": ck.merkle_compute_root}
    plain = {"sha256_words": sha256.sha256_words_plain,
             "sha256_pair": sha256.sha256_pair_plain,
             "merkle_walk": merkle.compute_root_plain}
    rows = []
    for name, what, args in cases:
        got, want = kern[name](*args), plain[name](*args)
        diff = int((got - want).abs().max().item())
        err[name] = max(err[name], diff)
        check(torch.equal(got, want), f"{name} != plain ({what}), max |diff| {diff}")
        k_ms = cuda_ms(lambda: kern[name](*args), 20)
        p_ms = cuda_ms(lambda: plain[name](*args), 2)
        rows.append((name, what, k_ms, p_ms))
        log(f"time {name} [{what}]: bit-equal; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.3f} ms ({p_ms / k_ms:.1f}x)")
    return rows


def phase_profile(fn, batch, slice_ms):
    """torch.profiler over one slice run at B = 4,096: the device-time table,
    the device's busy share of the unprofiled batch time, and the three
    kernels' own device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    log(events.table(sort_by="self_cuda_time_total", row_limit=15))
    # device-side rows only: an operator's row repeats its kernels' time
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile: device busy {busy_ms:.1f} ms in {sum(e.count for e in kernels)} "
        f"launches, {100 * busy_ms / slice_ms:.1f} % of the {slice_ms:.1f} ms batch")
    ours = [e for e in kernels if "stpu" in e.key]
    for e in ours:
        log(f"profile: {e.key}: {e.self_device_time_total / 1e3:.3f} ms device "
            f"in {e.count} launches")
    check(busy_ms > 0 and len(ours) == len(KERNELS),
          f"profile saw {len(ours)} of the {len(KERNELS)} kernels on the device")


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
    counts, slice_ms, fn, batch = phase_slice(proofs)  # (d), (e)
    rows = phase_timings(rng, errs)  # (f)
    phase_profile(fn, batch, slice_ms)

    largest = {}  # per kernel, its last timed shape: the slice's largest call
    for name, what, k_ms, p_ms in rows:
        largest[name] = (what, k_ms, p_ms)
    kernels = []
    for name, (_, replaces) in KERNELS.items():
        what, k_ms, p_ms = largest[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{PACKAGE}/csrc/sha256.cu", "replaces": replaces,
            "launches": counts[name], "max_abs_err": errs[name],
            "ms": k_ms, "plain_ms": p_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
