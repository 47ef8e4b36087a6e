"""Build the package's CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a``, all at once in
parallel processes, and links them into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  The library
needs no link against libcuda: the one libcuda function it calls,
``cuTensorMapEncodeTiled`` (K2's and K3's tensor maps), it fetches at run
time through the CUDA runtime's entry-point query.  The library lands in
``build/stark_symphony_tpu_torch/`` at the repository root, named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is loaded as it is.

A missing ``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "stark_symphony_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of the extern "C" launchers in csrc/sha256.cu and
# csrc/fri.cu; the last two arguments of each are the device ordinal and the
# CUDA stream.
_SIGNATURES = {
    "stpu_sha256_words": (_P, _P, _I, _I, _I, _I, _P),
    "stpu_sha256_pair": (_P, _P, _P, _I, _I, _I, _P),
    "stpu_merkle_walk": (_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P),
    "stpu_leafwalk": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "stpu_fri_all_layers": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _P),
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME or /usr/local/cuda; raises if none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of stark_symphony_tpu_torch cannot be built"
    )


class Kernels:
    """The loaded library: its launchers, where it came from, and what
    building it cost (0 when an existing build was loaded)."""

    def __init__(self, lib: ctypes.CDLL, path: pathlib.Path,
                 build_seconds: float, log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


def _run_all(cmds) -> str:
    """Run the commands all at once; raise with the output of the first
    that fails.  Returns their output, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, text in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}")
    return "".join(outs)


def _compile(out: pathlib.Path) -> str:
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=str(out.parent)) as tmp:
        objs, cmds = [], []
        for cu in sorted(CSRC.glob("*.cu")):
            objs.append(str(pathlib.Path(tmp) / (cu.stem + ".o")))
            cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(cu)])
        log = _run_all(cmds)
        lib = str(pathlib.Path(tmp) / out.name)
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    return log


@functools.lru_cache(maxsize=None)
def load() -> Kernels:
    """Build (if needed) and load the kernel library, once per process."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libstpu_kernels_{source_hash()}.so"
    log_path = out.with_suffix(".log")
    t0 = time.perf_counter()
    if out.exists():
        seconds = 0.0
        log = log_path.read_text() if log_path.exists() else ""
    else:
        log = _compile(out)
        seconds = time.perf_counter() - t0
        log_path.write_text(log)
    return Kernels(ctypes.CDLL(str(out)), out, seconds, log)


def launch(name: str, device: torch.device, *args) -> None:
    """Call the launcher ``stpu_{name}`` for `device` on its current PyTorch
    stream; tensors in `args` are passed as their data pointers.  Raises if
    the launch was refused.  The stream is read as the raw handle PyTorch
    keeps for the device: what ``torch.cuda.current_stream(device)
    .cuda_stream`` gives, without building a Python Stream object on
    every launch."""
    fn = getattr(load(), f"stpu_{name}")
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = fn(*ptrs, device.index, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
