"""Overflow-safety checks of the field primitives (``STPU_CHECK=1``).

Port of ``stark_symphony_tpu/ops/checks.py``.  The field kernels assume
canonical inputs (M31 in [0, p), F_q in [0, q)); a violated precondition
silently wraps.  With the checks on, ``m31_add`` and ``m31_mul``
(``ops/field.py``) and ``f_add`` (``ops/field101.py``) test their operands
first and raise ``FloatingPointError`` with the JAX package's message.

The flag is read from ``STPU_CHECK`` once, when this module is imported,
into ``ON``; ``checking()`` sets it for a block.  The hooks test that one
module attribute, so with the checks off they read no environment, launch
nothing and synchronise nothing: an eager batch, which calls these
primitives tens of thousands of times and is bound by host dispatch,
keeps its time and its launches.

With the checks on, each test is ``bool((x < bound).all())``: a
device-to-host read, so on the card a synchronisation.  A CUDA graph
capture cannot hold one, so a check met during a capture raises
``EagerOnlyError``: ``STPU_CHECK=1`` needs eager mode.  (A device assert,
``torch._assert_async``, would kill the CUDA context instead.)
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from .u32 import WORD

ON = os.environ.get("STPU_CHECK", "0") == "1"


class EagerOnlyError(RuntimeError):
    """A host read (an ``STPU_CHECK`` test, a transcript or op trace) was
    reached inside a CUDA graph capture, which cannot hold one."""


def capturing() -> bool:
    """True while the current CUDA stream is capturing a graph (never on a
    build of PyTorch without CUDA)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def checking(on: bool = True):
    """Turn the checks on (or off) inside the block."""
    global ON
    prev, ON = ON, on
    try:
        yield
    finally:
        ON = prev


def check_lt(x, bound: int, what: str) -> None:
    """Raise FloatingPointError unless every lane of `x` < bound (when the
    checks are on).  A bound the words cannot reach passes untested: an
    int64 word tensor holds u32 words (``ops/u32.py``), so its width is 32
    bits, as the JAX package's uint32 arrays are."""
    if not ON:
        return
    msg = f"overflow check failed: {what} (bound {bound:#x})"
    if isinstance(x, torch.Tensor):
        nbits = 32 if x.dtype == WORD else x.element_size() * 8
        if int(bound) >= (1 << nbits):
            return
        if capturing():
            raise EagerOnlyError(f"STPU_CHECK=1 needs eager mode: {what} was checked "
                                 "inside a CUDA graph capture")
        ok = bool((x < bound).all())
    else:
        a = np.asarray(x)
        if int(bound) >= (1 << (a.dtype.itemsize * 8)):
            return
        ok = bool((a < bound).all())
    if not ok:
        raise FloatingPointError(msg)
