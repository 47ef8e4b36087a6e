"""Transcript and op tracing (the execution-tracker analogue).

Port of ``stark_symphony_tpu/utils/trace.py``.  ``record_transcript``
records every Fiat-Shamir channel operation (mix/draw) with its value
while a verifier runs, for bit-exactness triage against the native oracle
(``native/symphony verify-stwo -v`` prints the same digests);
``record_ops`` records every field, hash, Merkle and circle primitive call
with decoded arguments and result.

The port runs eagerly, so values are concrete as they are recorded (the
JAX package turns jit off for the same end).  Recording copies each value
to the host, one device-to-host synchronisation an event on the card.
Neither recorder may be entered while a CUDA graph is being captured, and
a value met during a capture is not recorded: both raise
``EagerOnlyError``.  A replay of a captured graph (``tools/build``'s
``GraphedVerifier``) runs no Python, so it records nothing.

Usage:
    with record_transcript() as events:
        verifier.verify(proof, cfg)
    print(format_transcript(events))
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Any, List, Tuple

import numpy as np
import torch

from ..ops.checks import EagerOnlyError, capturing
from ..ops.u32 import WORD

_TRACE: List[Tuple[str, Any]] | None = None


def _refuse_capture(what: str) -> None:
    if capturing():
        raise EagerOnlyError(f"{what} reads values on the host and cannot run inside a "
                             "CUDA graph capture; trace an eager call")


def _host(x) -> np.ndarray:
    """A tensor's values on the host; int64 word tensors as np.uint32, the
    JAX package's dtype for them."""
    _refuse_capture("tracing")
    a = x.detach().cpu().numpy()
    return a.astype(np.uint32) if x.dtype == WORD else a


def emit(op: str, value) -> None:
    """Record one channel event if a transcript is being recorded: a test
    of one global when none is (no copy, no launch, no sync)."""
    if _TRACE is not None:
        _TRACE.append((op, _host(value)))


@contextlib.contextmanager
def record_transcript():
    """Context manager: collects the (op, value) channel events of the
    eager calls inside it."""
    global _TRACE
    _refuse_capture("record_transcript")
    prev = _TRACE
    _TRACE = []
    try:
        yield _TRACE
    finally:
        _TRACE = prev


def _hex_words(words: np.ndarray) -> str:
    flat = np.atleast_1d(words).reshape(-1)
    return "".join(f"{int(w):08x}" for w in flat)


def format_transcript(events) -> str:
    lines = []
    for i, (op, value) in enumerate(events):
        lines.append(f"[{i:3d}] {op:<14s} {_hex_words(value)}")
    return "\n".join(lines)


# (module, attributes) wrapped by record_ops: the port's primitives, and
# every module that imports a hash op by name (``from ...ops.sha256 import
# sha256_words``): rebinding only ops.sha256's global would miss their
# call sites.
_OP_SITES = [
    ("stark_symphony_tpu_torch.ops.field",
     ("m31_add", "m31_sub", "m31_mul", "m31_neg", "m31_inv",
      "cm31_mul", "cm31_inv",
      "qm31_mul", "qm31_inv", "qm31_mul_m31", "qm31_mul_cm31")),
    ("stark_symphony_tpu_torch.ops.sha256", ("sha256_words", "sha256_pair")),
    ("stark_symphony_tpu_torch.ops.merkle", ("compute_root", "sha256_pair")),
    ("stark_symphony_tpu_torch.ops.circle", ("point_add", "point_from_index")),
    ("stark_symphony_tpu_torch.ops.field101",
     ("f_add", "f_sub", "f_mul", "f_inv", "f_pow", "mod_u64")),
    # direct-import call sites of the hash ops
    ("stark_symphony_tpu_torch.models.stwo.channel", ("sha256_words",)),
    ("stark_symphony_tpu_torch.models.stwo.verifier", ("sha256_words", "sha256_pair")),
    ("stark_symphony_tpu_torch.models.stwo.prover", ("sha256_words",)),
    ("stark_symphony_tpu_torch.models.stark101.channel", ("sha256_words",)),
    ("stark_symphony_tpu_torch.models.stark101.verifier", ("sha256_words",)),
    ("stark_symphony_tpu_torch.models.stark101.prover", ("sha256_words",)),
    ("stark_symphony_tpu_torch.parallel.fri_shard", ("sha256_words", "sha256_pair")),
]


def _summarize(x):
    """Decode one argument/result into a compact printable form, as the
    JAX package prints it."""
    if isinstance(x, torch.Tensor):
        a = _host(x)
    else:
        try:
            a = np.asarray(x)
        except (TypeError, ValueError):
            return repr(x)
    if a.ndim == 0:
        return f"{int(a):#x}" if np.issubdtype(a.dtype, np.integer) else str(a)
    flat = a.reshape(-1)
    if flat.size <= 8 and np.issubdtype(a.dtype, np.integer):
        return "[" + " ".join(f"{int(v):08x}" for v in flat) + "]"
    return f"<{a.dtype}{list(a.shape)}>"


@contextlib.contextmanager
def record_ops(ops=None):
    """Record every primitive-op call with decoded args and results.

    Usage:
        with record_ops() as events:
            verifier.verify(proof, cfg)
        print(format_ops(events))

    `ops`: optional iterable of op names to restrict to (e.g. {"m31_mul"}).
    Events are (name, [decoded args], decoded result) tuples.  The
    primitives are wrapped inside the block and the originals restored on
    leaving it, so the hot path carries no hook outside it.
    """
    _refuse_capture("record_ops")
    events: List[tuple] = []
    saved = []
    only = set(ops) if ops is not None else None

    def _wrap(name, fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            if only is None or name in only:
                events.append((name, [_summarize(a) for a in args], _summarize(out)))
            return out

        wrapper.__name__ = f"traced_{name}"
        wrapper.__wrapped__ = fn
        return wrapper

    # every module imported before any is patched: a module first imported
    # inside the patch would bind a wrapper by name and keep it
    mods = [(importlib.import_module(name), attrs) for name, attrs in _OP_SITES]
    try:
        for mod, attrs in mods:
            for attr in attrs:
                orig = getattr(mod, attr)
                saved.append((mod, attr, orig))
                setattr(mod, attr, _wrap(attr, orig))
        yield events
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def format_ops(events, limit: int | None = None) -> str:
    lines = []
    for i, (name, args, out) in enumerate(events):
        if limit is not None and i >= limit:
            lines.append(f"... ({len(events) - limit} more)")
            break
        lines.append(f"[{i:5d}] {name:<16s} ({', '.join(args)}) -> {out}")
    return "\n".join(lines)
