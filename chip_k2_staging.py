#!/usr/bin/env python3
"""K2's staging on one NVIDIA GPU: the port's swizzled tensor-map copies
against plain per-thread 16-byte loads from device memory.

    python chip_k2_staging.py

K2 (``sha256_pair_kernel`` in ``stark_symphony_tpu_torch/csrc/sha256.cu``)
stages each block's (lanes, 8) int64 left and right digests in shared
memory with one 2-D tensor-map copy each, 64-byte swizzle, and stores its
result with one tensor-map store.  The yardstick built here runs the same
``node_hash`` (``csrc/sha256.cuh``) on the same operands, but each thread
reads its own 64-byte rows with four ``ld.global.nc.v2.u64`` a row and
writes its result with four 16-byte stores.  The script builds both
(nvcc, ``sm_90a``), holds both bit for bit to the plain PyTorch version
at the main path's 65,536 lanes, and prints each one's device time a call
from torch.profiler over rounds of 50 launches in the order kernel,
yardstick, yardstick, kernel, with the card's name and power limit.  It
then prints the host's cost a call (host clock over HOST_CALLS calls at
HOST_LANES lanes, where the device keeps up) of K2's wrapper, of its
launcher alone (three tensor-map encodes and a launch), of K1's launcher
alone (no encode) and of ``torch.broadcast_shapes``, which the wrapper
calls only for operands of unequal shapes.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
LANES = 4096 * 16  # the FRI layer's node hash at B = 4,096, Q = 16
THREADS = 128      # K2's block at that lane count (lane_threads)
CALLS = 50
HOST_LANES = 4096  # a few µs on the device, so the host's cost shows
HOST_CALLS = 2000

YARDSTICK = r"""
#include <cstdint>
#include <cuda_runtime.h>
#include "sha256.cuh"

__device__ __forceinline__ ulonglong2 ld_nc(const uint64_t* p) {
  ulonglong2 v;
  asm volatile("ld.global.nc.v2.u64 {%0, %1}, [%2];\n"
               : "=l"(v.x), "=l"(v.y) : "l"(p));
  return v;
}

__global__ void __launch_bounds__(128)
k2_global_loads(const uint64_t* __restrict__ left, const uint64_t* __restrict__ right,
                uint64_t* __restrict__ out, int lanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  const uint64_t* lrow = left + static_cast<size_t>(i) * 8;
  const uint64_t* rrow = right + static_cast<size_t>(i) * 8;
  uint32_t l[8], r[8], h[8];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const ulonglong2 a = ld_nc(lrow + 2 * c), b = ld_nc(rrow + 2 * c);
    l[2 * c] = static_cast<uint32_t>(a.x);
    l[2 * c + 1] = static_cast<uint32_t>(a.y);
    r[2 * c] = static_cast<uint32_t>(b.x);
    r[2 * c + 1] = static_cast<uint32_t>(b.y);
  }
  stpu::node_hash(l, r, h);
  ulonglong2* orow = reinterpret_cast<ulonglong2*>(out + static_cast<size_t>(i) * 8);
#pragma unroll
  for (int c = 0; c < 4; ++c) orow[c] = make_ulonglong2(h[2 * c], h[2 * c + 1]);
}

extern "C" int k2_global_launch(const void* left, const void* right, void* out,
                                int lanes, int threads, void* stream) {
  k2_global_loads<<<(lanes + threads - 1) / threads, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(left), static_cast<const uint64_t*>(right),
      static_cast<uint64_t*>(out), lanes);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_yardstick(build) -> ctypes.CDLL:
    out_dir = build.BUILD_DIR / "k2_staging"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "k2_global_loads.cu", out_dir / "libk2_global_loads.so"
    src.write_text(YARDSTICK)
    res = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared",
                          "-I", str(build.CSRC), "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas (yardstick): {line.strip()}", flush=True)
    fn = ctypes.CDLL(str(lib)).k2_global_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def device_ms(launch, name: str) -> float:
    """Mean device ms of the `name` kernel over CALLS launches, from
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            launch()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and name in e.name]
    if not dev:
        raise RuntimeError(f"the profiler saw no {name} kernel")
    return sum(e.time_range.elapsed_us() for e in dev) / len(dev) / 1e3


def host_us(fn) -> float:
    """Host µs a call of fn() over HOST_CALLS calls, after a warm-up and
    with the device drained before and after."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / HOST_CALLS * 1e6


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_k2_staging: CUDA is not available")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from stark_symphony_tpu_torch.ops import sha256
    from stark_symphony_tpu_torch.ops.cuda import build
    from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
    from stark_symphony_tpu_torch.ops.u32 import from_numpy

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()
    print(smi[0].strip(), flush=True)
    build.load()
    yardstick = build_yardstick(build)
    check_threads = ck.lane_threads(LANES)
    if check_threads != THREADS:
        raise RuntimeError(f"K2's block at {LANES} lanes is {check_threads}, not {THREADS}")

    rng = np.random.default_rng(4)
    dev = torch.device("cuda", torch.cuda.current_device())
    left, right = (from_numpy(rng.integers(0, 1 << 32, (LANES, 8), dtype=np.uint32), dev)
                   for _ in range(2))
    want = sha256.sha256_pair_plain(left, right)
    outs = {"kernel": torch.empty_like(left), "yardstick": torch.empty_like(left)}
    stream = torch.cuda.current_stream().cuda_stream

    def kernel():
        build.launch("sha256_pair", dev, left, right, outs["kernel"], LANES, THREADS, 8, 8)

    def global_loads():
        err = yardstick(left.data_ptr(), right.data_ptr(), outs["yardstick"].data_ptr(),
                        LANES, THREADS, stream)
        if err:
            raise RuntimeError(f"yardstick launch failed: error {err}")

    kernel()
    global_loads()
    torch.cuda.synchronize()
    for what, out in outs.items():
        if not torch.equal(out, want):
            raise RuntimeError(f"{what} != plain at {LANES} lanes")
    print(f"both bit-equal to sha256_pair_plain at {LANES} lanes", flush=True)

    times = {"kernel": [], "yardstick": []}
    for what in ("kernel", "yardstick", "yardstick", "kernel"):
        if what == "kernel":
            times[what].append(device_ms(kernel, "sha256_pair_kernel"))
        else:
            times[what].append(device_ms(global_loads, "k2_global_loads"))
    for what, label in (("kernel", "swizzled tensor-map staging (K2)"),
                        ("yardstick", "per-thread ld.global.nc.v2.u64")):
        runs = ", ".join(f"{t:.4f}" for t in times[what])
        print(f"{label}: {sum(times[what]) / 2:.4f} ms a call on the device at "
              f"{LANES} lanes, blocks of {THREADS} (rounds of {CALLS}: {runs} ms)",
              flush=True)

    hl, hr = left[:HOST_LANES], right[:HOST_LANES]
    hout = torch.empty_like(hl)
    threads = ck.lane_threads(HOST_LANES)
    msg = left[:HOST_LANES, :1].contiguous()
    costs = {
        "K2 wrapper (ck.sha256_pair)": lambda: ck.sha256_pair(hl, hr),
        "K2 launcher alone (build.launch)": lambda: build.launch(
            "sha256_pair", dev, hl, hr, hout, HOST_LANES, threads, 8, 8),
        "K1 launcher alone, n = 1": lambda: build.launch(
            "sha256_words", dev, msg, hout, 1, HOST_LANES, threads),
        "torch.broadcast_shapes of two (4096, 8)": lambda: torch.broadcast_shapes(
            hl.shape, hr.shape),
    }
    for what, fn in costs.items():
        print(f"host {what}: {host_us(fn):.2f} us a call at {HOST_LANES} lanes "
              f"(mean of {HOST_CALLS})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
