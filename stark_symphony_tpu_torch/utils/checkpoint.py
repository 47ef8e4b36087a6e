"""Checkpoint / resume.

Port of ``stark_symphony_tpu/utils/checkpoint.py``; the dict and the
journal are the JAX package's, byte for byte, so what one package writes
the other reads:

* channel-cursor (de)serialization: ``channel_state_to_dict`` /
  ``channel_state_from_dict`` snapshot the Fiat-Shamir transcript position
  of a staged verification;
* ``BatchCheckpointer``: durable accept-bitmap progress for long proof
  streams.  Each verified batch's bitmap appends one JSON line to a
  journal, and a restarted run skips the batches it finds there.
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import torch

from ..models.stwo.channel import ChannelState
from ..ops.u32 import from_numpy, to_numpy


def channel_state_to_dict(state: ChannelState) -> dict:
    digest = to_numpy(state.digest)
    return {
        "digest": [int(w) for w in digest.reshape(-1)],
        "counter": int(to_numpy(state.counter).reshape(())),
        "shape": list(digest.shape[:-1]),
    }


def channel_state_from_dict(d: dict, device) -> ChannelState:
    """The ChannelState of `d`, as the port's int64 word tensors on
    `device`."""
    shape = tuple(d.get("shape", ()))
    digest = np.asarray(d["digest"], np.uint32).reshape(shape + (8,))
    counter = np.full(shape, d["counter"], np.uint32)
    # from_numpy gives a 0-d array back 1-d: the counter takes its shape again
    return ChannelState(from_numpy(digest, device), from_numpy(counter, device).reshape(shape))


class BatchCheckpointer:
    """Append-only verification journal with resume.

    Usage:
        ckpt = BatchCheckpointer(path)
        for i, batch in enumerate(stream):
            if ckpt.done(i):
                continue
            bitmap = verify_batch(batch)
            ckpt.record(i, bitmap)
        total_ok = ckpt.accepted()

    A bitmap may be a CUDA or CPU tensor (bool, or words 0/1) or an array;
    recording one reads it on the host."""

    def __init__(self, path: str | os.PathLike):
        self._path = pathlib.Path(path)
        self._done: dict[int, int] = {}
        if self._path.exists():
            with open(self._path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    rec = json.loads(line)
                    self._done[rec["batch"]] = rec["n_ok"]

    def done(self, batch_index: int) -> bool:
        return batch_index in self._done

    def record(self, batch_index: int, bitmap) -> None:
        if isinstance(bitmap, torch.Tensor):
            bitmap = bitmap.detach().cpu().numpy()
        bits = np.asarray(bitmap).astype(bool)
        rec = {
            "batch": batch_index,
            "n_ok": int(bits.sum()),
            "n": int(bits.size),
            "bitmap_hex": np.packbits(bits).tobytes().hex(),
        }
        with open(self._path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        self._done[batch_index] = rec["n_ok"]

    def accepted(self) -> int:
        return sum(self._done.values())

    def batches(self) -> int:
        return len(self._done)
