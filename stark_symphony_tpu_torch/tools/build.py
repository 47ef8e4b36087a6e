"""The compile step: each verifier captured once as a CUDA graph and replayed.

Counterpart of ``stark_symphony_tpu/tools/build.py``.  The JAX package
compiles every verifier it runs (``verify_jit``, ``make_chained``, AOT
``build``/``load``); here the verifier's shapes are static and nothing in it
branches in Python on tensor data, so one run of it can be recorded as a
CUDA graph (``torch.cuda.CUDAGraph``) and replayed: each replay launches the
same 20,000-110,000 kernels, K1-K5 among them, from one host call.

* ``capture(fn, args)``: the counterpart of ``jax.jit``.  It clones `args`
  into static inputs, warms `fn` up on a side stream (the kernel library,
  every lazily made device table and constant), captures one graph, and
  returns a ``GraphedVerifier``: each call checks the shapes, copies the
  batch into the static inputs, replays, and returns copies of the
  outputs (``replay`` returns the graph's own outputs, which the next
  replay overwrites).  A capture may name the stream it is captured on (a
  mesh shard's) and a memory pool shared with an earlier graph that
  always runs before it.  With CUDA tensors a failed capture or
  replay raises: there is no eager fallback.  With CPU tensors (a caller
  has to ask for them) the same copy-in, call and copy-out runs without a
  graph.  Its spans (``utils/trace.record_spans``): host spans
  ``graph.copy_in`` and ``graph.replay`` in ``replay``, ``graph.copy_out``
  in ``__call__``, and the device span ``dev.graph.replay`` around the
  replay itself; a graph captured under the recorder also replays the
  device spans its function met (the verifiers' stages), and waits for
  its last replay before the next.
* ``GraphCache``: graphs by key and input specs, so a second call with
  the same key and the same shapes replays without capturing again (the
  counterpart of jit's cache); it counts the captures it made.
* ``make_chained``: the chained-verification loop ``bench.py`` times,
  unrolled into one graph.
* ``build``/``load``: a CUDA graph cannot be written to disk, so the
  artifact is a manifest, framed as the JAX package frames its executables
  (magic, SHA-256, payload); the payload is JSON, never a pickle.  ``load``
  checks the frame, builds the kernel library if it is missing, and
  captures again.
* ``static_cost``: SHA-256 compressions per proof, per stage, as in the JAX
  package.

Usage (on a machine with an NVIDIA GPU):
    python -m stark_symphony_tpu_torch.tools.build [--config production|testing]
        [--batch 2048] [--path standard|tiled] [--out build] [--chain N]
    python -m stark_symphony_tpu_torch.tools.build --load <manifest> [--check]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import sys
import time

import torch

from ..models.stwo import proof as P
from ..models.stwo import tiled, verifier
from ..models.stwo.config import PRODUCTION, TESTING
from ..ops.cuda import build as kbuild
from ..ops.cuda import deep_kernel as dk
from ..ops.cuda import fri_kernel as fk
from ..ops.cuda import sha256_kernel as ck
from ..ops.u32 import WORD
from ..utils import trace

_MAGIC = b"STPUGRF1"
_PKG = pathlib.Path(__file__).resolve().parents[1]
# the sources a captured stwo verifier runs: their hash marks a stale manifest
_HASHED = (("ops", "*.py"), ("ops/cuda", "*.py"), ("models/stwo", "*.py"),
           ("csrc", "*"))
CONFIGS = {"production": PRODUCTION, "testing": TESTING}


def static_cost(cfg) -> dict:
    """SHA-256 compressions per proof, per stage (the node.bounds()
    analogue; message framing per ops/sha256._padding_words)."""
    q = cfg.n_queries
    d = cfg.lde_log_size
    n_layers = 1 + cfg.n_inner_layers
    # transcript: ~3 root mixes + 12 qm31 draws (2 attempts) + oods mix
    # (88 words -> 6 blocks) + last mix + pow + 2 query draws
    transcript = 3 + 2 * (3 + n_layers) + 6 + 1 + 1 + (q + 7) // 8
    # stage V: leaf hash (trace: C words -> 1 block; cp: 16+pad -> 2) +
    # walk (2 compr per level)
    stage_v = q * (1 + 2 * d) + q * (2 + 2 * d)
    # stage VII per layer: 2 leaf hashes + node pair (2) + walk depth_l
    stage_vii = sum(
        q * (2 + 2 + 2 * cfg.fri_layer_depth(l)) for l in range(n_layers)
    )
    total = transcript + stage_v + stage_vii
    return {
        "transcript_compr": transcript,
        "stage_v_compr": stage_v,
        "stage_vii_compr": stage_vii,
        "total_compr_per_proof": total,
    }


def verifier_source_hash() -> str:
    """Hash of every source a captured stwo verifier runs (the port's
    ``ops/``, ``ops/cuda/``, ``models/stwo/`` and ``csrc/``): a mismatch
    means a manifest is stale and must be rebuilt."""
    h = hashlib.sha256()
    for sub, pattern in _HASHED:
        for p in sorted((_PKG / sub).glob(pattern)):
            if p.is_file():
                h.update(f"{sub}/{p.name}".encode())
                h.update(p.read_bytes())
    return h.hexdigest()[:16]


def require_device(device: str) -> str:
    """`device`, or a RuntimeError where it names CUDA and there is none:
    a tool never falls back to the CPU by itself."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: CUDA is not available; pass --device cpu "
                           "to run on the CPU")
    return device


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`; a
    leaf is anything but a tuple (NamedTuples kept as their type), list or
    dict.  Raises ValueError where the structures differ."""
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or r.keys() != tree.keys() for r in rest):
            raise ValueError("tree_map: dicts with different keys")
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        if any(not isinstance(r, (tuple, list)) or len(r) != len(tree) for r in rest):
            raise ValueError("tree_map: sequences of different lengths")
        items = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def _spec(x):
    """What a call must match of a leaf: a tensor's shape, dtype and
    device; any other leaf itself."""
    return (tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor) else x


def launch_counts() -> dict:
    """The kernel wrappers' launch counts (``ops/cuda/{sha256,fri,deep}_kernel``)."""
    return {**ck.launches, **fk.launches, **dk.launches}


def specs(tree):
    """``_spec`` of every leaf of `tree`."""
    return tree_map(_spec, tree)


class GraphedVerifier:
    """`fn` captured once on static copies of `args` and replayed.

    `stream`: the stream to warm up and capture on (by default a side
    stream; a replay runs on the caller's current stream, which
    ``Mesh.run`` sets to the shard's own); `pool`: the memory pool of an
    earlier graph to share, which must always replay before this one
    (``pool``).

    Attributes: ``out``, the outputs of the last call (a graph's own
    output tensors, which every replay overwrites); ``launches``, each
    kernel's launches recorded in the graph (the wrappers count while the
    graph is captured, never on a replay); ``capture_s`` (recording the
    launches) and ``instantiate_s`` (ending the capture, which
    instantiates the graph); ``pool_bytes``, the device memory the capture
    took (``max_memory_allocated`` around it); ``pool``, the graph's
    memory pool; ``spans``, the device spans met in the capture
    (``trace.GraphSpans``: none unless a span recorder was on).  On the
    CPU there is no graph, the counts are 0, the times 0.0, the pool and
    ``spans`` None."""

    def __init__(self, fn, args: tuple, warmup: int = 2, stream=None, pool=None):
        self.fn = fn
        self.static = tree_map(_clone, tuple(args))
        tensors = [x for x in tree_leaves(self.static) if isinstance(x, torch.Tensor)]
        if not tensors:
            raise ValueError("capture: the arguments hold no tensor")
        self.device = tensors[0].device
        self._spec = specs(self.static)
        self.graph = self.pool = self.out = self.spans = None
        self.launches = {name: 0 for name in launch_counts()}
        self.capture_s = self.instantiate_s = 0.0
        self.pool_bytes = 0
        if self.device.type == "cuda":
            self._capture(warmup, stream, pool)

    def _capture(self, warmup: int, stream, pool) -> None:
        dev = self.device
        side = stream or torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                self.fn(*self.static)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        before = launch_counts()
        mem0 = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=stream), \
                trace.capture_spans() as spans:
            t0 = time.perf_counter()
            out = self.fn(*self.static)
            t1 = time.perf_counter()
        self.instantiate_s = time.perf_counter() - t1
        self.capture_s = t1 - t0
        self.pool_bytes = torch.cuda.max_memory_allocated(dev) - mem0
        self.launches = {k: n - before[k] for k, n in launch_counts().items()}
        self.out = out
        self.pool = graph.pool()
        self.graph = graph
        self.spans = spans

    def replay(self, *args):
        """Copy `args` into the static inputs and replay (on the CPU: call
        `fn` on them); returns ``out``, which the next call overwrites."""
        spec = specs(tuple(args))
        if spec != self._spec:
            raise ValueError(f"graphed verifier captured for {self._spec}, called with {spec}")
        if self.spans is not None:
            self.spans.settle()
        with trace.span("graph.copy_in"):
            tree_map(lambda s, a: s.copy_(a) if isinstance(s, torch.Tensor) else None,
                     self.static, tuple(args))
        with trace.span("graph.replay"), trace.device_span("dev.graph.replay", self.device):
            if self.graph is None:
                self.out = self.fn(*self.static)
            else:
                self.graph.replay()
                self.spans.replayed(torch.cuda.current_stream(self.device))
        return self.out

    def __call__(self, *args):
        out = self.replay(*args)
        with trace.span("graph.copy_out"):
            return tree_map(_clone, out)


def capture(fn, args: tuple, warmup: int = 2, stream=None, pool=None) -> GraphedVerifier:
    """`fn(*args)` as a graphed verifier (see GraphedVerifier); `warmup`
    eager runs on a side stream (or `stream`) come first."""
    return GraphedVerifier(fn, args, warmup, stream, pool)


def _frozen(tree):
    """`tree` with every list and dict made a tuple, so it can key a dict."""
    if isinstance(tree, dict):
        return tuple((k, _frozen(v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return tuple(_frozen(x) for x in tree)
    return tree


class GraphCache:
    """Graphed functions by (key, input specs): ``get`` makes an entry
    once (``make()``, which captures) and returns it on every later call
    with the same key and the same shapes, dtypes and devices.
    ``captures`` counts the entries made."""

    def __init__(self):
        self.entries = {}
        self.captures = 0

    def get(self, key, args, make):
        k = (key, _frozen(specs(args)))
        if k not in self.entries:
            self.entries[k] = make()
            self.captures += 1
        return self.entries[k]


def make_chained(cfg, chain: int, tiled_path: bool):
    """The chained-verification loop bench.py times: `chain` verifications,
    each data-dependent on the previous bitmap through a runtime zero
    (commitments ^ (carry[0] ^ 1)), seeded with ones.  Captured, the loop
    is unrolled into one graph.  Returns fn(batch, seed_bits) -> the last
    bitmap as int64 words 0/1."""

    def chained(b, seed_bits):
        carry = seed_bits
        for _ in range(chain):
            zero = carry[0] ^ 1
            b2 = b._replace(commitments=b.commitments ^ zero)
            if tiled_path:
                bm = verifier.verify_batch_tiled(b2, cfg, linkage="reference")
            else:
                bm = verifier.verify_batch(b2, cfg, linkage="reference")
            carry = bm.to(WORD)
        return carry

    return chained


def artifact_name(cfg_name: str, path: str, batch: int, backend: str,
                  chain: int = 0) -> str:
    part = f"_c{chain}" if chain else ""
    return f"verify_{cfg_name}_{path}_b{batch}{part}_{backend}.manifest"


def inputs(cfg_name: str, batch: int, path: str, chain: int, device):
    """(fn, args) of a manifest: the committed proof of the config in every
    lane, on `device`, through the standard or tiled verifier (chained when
    `chain`)."""
    # imported here: the proof cache imports the prover, which captures
    # through this module
    from ..utils.proofcache import cached_stwo_proof

    cfg = CONFIGS[cfg_name]
    b = P.replicate(cached_stwo_proof(cfg), batch)
    arg = tiled.tile_batch(b, cfg, device) if path == "tiled" else P.to_torch(b, device)
    if chain:
        ones = torch.ones(batch, dtype=WORD, device=device)
        return make_chained(cfg, chain, path == "tiled"), (arg, ones)
    if path == "tiled":
        return (lambda x: verifier.verify_batch_tiled(x, cfg, linkage="reference")), (arg,)
    return (lambda x: verifier.verify_batch(x, cfg, linkage="reference")), (arg,)


def _frame(payload: bytes) -> bytes:
    return _MAGIC + hashlib.sha256(payload).digest() + payload


def build(cfg_name: str, batch: int, path: str, out_dir: str, chain: int = 0,
          device: str = "cuda") -> str:
    """Capture the verifier for (config, batch, path, chain) on `device` and
    write its manifest into `out_dir`; returns the manifest's path."""
    fn, args = inputs(cfg_name, batch, path, chain, device)
    t0 = time.perf_counter()
    graphed = capture(fn, args)
    capture_s = time.perf_counter() - t0
    dev = graphed.device
    backend = dev.type
    library = str(kbuild.load().path) if backend == "cuda" else None
    meta = {
        "config": cfg_name, "batch": batch, "path": path, "chain": chain,
        "backend": backend,
        "device_name": torch.cuda.get_device_name(dev) if backend == "cuda" else "cpu",
        "kernel_library": library,
        "kernel_source_hash": kbuild.source_hash(),
        "source_hash": verifier_source_hash(),
        "capture_s": capture_s,
        "graph_capture_s": graphed.capture_s,
        "instantiate_s": graphed.instantiate_s,
        "pool_bytes": graphed.pool_bytes,
        "launches": graphed.launches,
        "static_cost": static_cost(CONFIGS[cfg_name]),
    }
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, artifact_name(cfg_name, path, batch, backend, chain))
    with open(out_path, "wb") as f:
        f.write(_frame(json.dumps(meta, sort_keys=True).encode()))
    print(json.dumps({"artifact": out_path, "bytes": os.path.getsize(out_path),
                      "capture_s": round(capture_s, 3), "backend": backend,
                      "batch": batch, **meta["static_cost"]}))
    return out_path


def load(artifact: str):
    """Read a manifest and capture its verifier again; returns (fn, meta)
    with meta["load_s"] and meta["stale"] (the verifier's or the kernels'
    sources changed since the manifest was written).  Raises ValueError on
    a manifest that is not one, is truncated or was altered."""
    raw = pathlib.Path(artifact).read_bytes()
    if not raw.startswith(_MAGIC):
        raise ValueError(f"{artifact}: not a stark-symphony graph manifest (bad "
                         "magic); rebuild with tools.build")
    digest, payload = raw[len(_MAGIC):len(_MAGIC) + 32], raw[len(_MAGIC) + 32:]
    if hashlib.sha256(payload).digest() != digest:
        raise ValueError(f"{artifact}: integrity check failed (corrupted or "
                         "altered manifest); rebuild with tools.build")
    meta = json.loads(payload)
    t0 = time.perf_counter()
    if meta["backend"] == "cuda":
        kbuild.load()  # builds the library where it is missing
    fn, args = inputs(meta["config"], meta["batch"], meta["path"], meta["chain"],
                      meta["backend"])
    graphed = capture(fn, args)
    meta["load_s"] = round(time.perf_counter() - t0, 3)
    meta["stale"] = (meta["source_hash"] != verifier_source_hash()
                     or meta["kernel_source_hash"] != kbuild.source_hash())
    return graphed, meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="production", choices=sorted(CONFIGS))
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--path", default="tiled", choices=["tiled", "standard"])
    ap.add_argument("--out", default="build")
    ap.add_argument("--chain", type=int, default=0,
                    help="also chain `chain` verifications in one graph "
                         "(the loop bench.py times)")
    ap.add_argument("--load", default=None,
                    help="load a manifest (and capture again) instead of building")
    ap.add_argument("--check", action="store_true",
                    help="after load, run one batch and require every proof accepted")
    args = ap.parse_args(argv)

    if args.load:
        fn, meta = load(args.load)
        print(json.dumps({"loaded": args.load, "load_s": meta["load_s"],
                          "backend": meta["backend"], "stale": meta["stale"]}))
        if args.check:
            t0 = time.perf_counter()
            bitmap = fn(*fn.static).cpu()
            dt = time.perf_counter() - t0
            if not bool((bitmap != 0).all()):
                raise SystemExit("the loaded verifier rejected valid proofs")
            print(json.dumps({"check": "ok", "batch": meta["batch"],
                              "first_run_s": round(dt, 3)}))
        return 0

    build(args.config, args.batch, args.path, args.out, args.chain)
    return 0


if __name__ == "__main__":
    sys.exit(main())
