"""The SHA-256 work a proof system needs, counted from its configuration,
and the least time an H100 takes for it.

Each hash of an n-word message is counted at its compressions' integer
instructions (a compression over data 1,024, one over a block of padding
alone 640: Sigma0 and Sigma1 three shifts and a LOP3 each, ch and maj a
LOP3 each, a schedule word 8; the additions are left out, since the
compiler may issue them on the FMA pipe) and at its bytes, the message
read once and the digest written once.  The least time is the larger of
the instructions over the H100 SXM's integer rate (132 SMs x 64 lanes x
1.98 GHz) and the bytes over 3.35 TB/s.  These constants and the
instruction count are copied from ``chip_smoke.py`` (``bound``).

Only the hashes the protocol needs are counted: one attempt a draw where
the program unrolls two, and no hash whose digest nothing reads.  So a share of this least time above
100 % is a fault of the count.
"""

from __future__ import annotations

import json
import pathlib

MEM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9
OPS_DATA_COMPRESS = 1024
OPS_CONST_COMPRESS = 640
NODE = 16  # words of a Merkle node's message: two digests


def kernel_names() -> list:
    """The kernels whose device time the rooflines divide by."""
    return json.loads((pathlib.Path(__file__).with_name("kernels.json")).read_text())["kernels"]


def hash_ops(n: int) -> int:
    """Integer instructions of SHA-256 over an n-word message."""
    blocks = (n + 3 + 15) // 16
    const = 1 if n % 16 == 0 else 0  # a last block of padding alone
    return (blocks - const) * OPS_DATA_COMPRESS + const * OPS_CONST_COMPRESS


class Work:
    """Hashes tallied as (instructions, bytes)."""

    def __init__(self):
        self.ops = 0
        self.bytes = 0

    def hash(self, n_words: int, count: int = 1) -> "Work":
        self.ops += count * hash_ops(n_words)
        self.bytes += count * (4 * n_words + 32)
        return self

    def least_s(self, times: float = 1.0) -> float:
        return times * max(self.ops / INT_OPS_PER_S, self.bytes / MEM_BYTES_PER_S)


def _stwo_transcript(w: Work, p: dict) -> None:
    """Stages I-IV and the query draw: mixes of (digest || payload), draws
    of (digest || counter)."""
    n_inner = p["n_inner_layers"]
    w.hash(16, 3).hash(9, 1)  # three roots mixed, the composition coefficient drawn
    w.hash(9).hash(8 + 4 * p["n_columns"] + 4 * p["n_cp_partitions"]).hash(9)  # OODS
    w.hash(16, 1 + n_inner).hash(9, 1 + n_inner).hash(8 + 4)  # FRI roots, alphas, last layer
    w.hash(8 + 2)  # the nonce
    w.hash(9, (p["n_queries"] + 7) // 8)


def stwo_verify(config: dict) -> Work:
    """One stwo proof's verification."""
    p = config["params"]
    q, lde, n_inner = p["n_queries"], p["lde_log_size"], p["n_inner_layers"]
    w = Work()
    _stwo_transcript(w, p)
    w.hash(p["n_columns"], q).hash(p["n_cp_partitions"], q).hash(NODE, 2 * q * lde)  # stage V
    for layer in range(1 + n_inner):  # stage VII: two leaves, their node, the walk
        w.hash(4, 2 * q).hash(NODE, q * (1 + lde - 1 - layer))
    return w


def stark101_verify(config: dict) -> Work:
    """One stark101 proof's verification."""
    p = config["params"]
    n_ex = p["domain_size"] * p["blowup"]
    log_ex = n_ex.bit_length() - 1
    layers = (p["domain_size"] - 1).bit_length()
    w = Work()
    w.hash(8)  # the channel's genesis
    w.hash(8, 3 + layers + 1).hash(16, layers).hash(9)  # draws, roots and the last value mixed
    w.hash(1, 3).hash(NODE, 3 * log_ex)  # the trace reads
    for i in range(layers):
        w.hash(1, 2).hash(NODE, 2 * (log_ex - i))
    return w


VERIFY = {"stwo": stwo_verify, "stark101": stark101_verify}
