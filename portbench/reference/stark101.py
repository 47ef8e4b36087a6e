"""Plain reference verifier of one stark101 (FibonacciSq) proof: Python
integers and hashlib.

It follows StarkWare's STARK 101 verifier as the stark-symphony stark101
verifier runs it: mix the trace root, draw three composition coefficients,
replay the FRI commitments (each beta drawn and checked), draw one query
index, check the three trace reads against the trace root, evaluate the
composition polynomial at x = g * h^idx, and walk the FRI layers with
their Merkle reads.  It imports nothing of the program under test.  A
proof is a mapping of field name to numpy uint32 array:

  p_mt_root (8,), evals (3,), eval_sibs (3, 13, 8), fri_roots (L, 8),
  fri_betas (L,), cpa_evals (L,), cpa_sibs L arrays (13 - i, 8),
  cpb_evals (L,), cpb_sibs L arrays (13 - i, 8), last ().

``verify(proof, cfg)`` returns (accepted, masks) under the upstream
verifier's check names.  ``parse_json`` reads the reference prover's
``proof.json`` schema into that mapping.
"""

from __future__ import annotations

import numpy as np

from .stwo import be, merkle_ok, sha

Q = 3 * (1 << 30) + 1
GEN = 5


def _u256(value: int) -> np.ndarray:
    return np.array([(value >> (32 * (7 - i))) & 0xFFFFFFFF for i in range(8)], np.uint32)


def parse_json(res: dict) -> dict:
    """The proof.json schema of the reference prover -> field arrays."""
    layers = res["fri_layers"]
    return {
        "p_mt_root": _u256(int(res["p_mt_root"])),
        "evals": np.array([int(e[0]) for e in res["evals"]], np.uint32),
        "eval_sibs": np.stack([np.stack([_u256(int(s)) for s in e[1]]) for e in res["evals"]]),
        "fri_roots": np.stack([_u256(int(l[0])) for l in layers]),
        "fri_betas": np.array([int(l[1]) for l in layers], np.uint32),
        "cpa_evals": np.array([int(l[2]) for l in layers], np.uint32),
        "cpa_sibs": tuple(np.stack([_u256(int(s)) for s in l[3]]) for l in layers),
        "cpb_evals": np.array([int(l[4]) for l in layers], np.uint32),
        "cpb_sibs": tuple(np.stack([_u256(int(s)) for s in l[5]]) for l in layers),
        "last": np.uint32(int(res["fri_last_layer"])),
    }


def _inv(a: int) -> int:
    return pow(a % Q, Q - 2, Q)  # inv(0) = 0


class Channel:
    """state = H(root); mix: state = H(state || payload); draw: the state
    read as a big-endian integer mod the bound, then state = H(state)."""

    def __init__(self, root: bytes):
        self.state = sha(root)

    def mix(self, payload: bytes) -> None:
        self.state = sha(self.state + payload)

    def draw(self, bound: int) -> int:
        value = int.from_bytes(self.state, "big") % bound
        self.state = sha(self.state)
        return value


def verify(proof, cfg: dict):
    """(accepted, masks) of one proof under `cfg` (domain_size, blowup,
    idx_offset, boundary1)."""
    n = cfg["domain_size"]
    n_ex = n * cfg["blowup"]
    log_ex = n_ex.bit_length() - 1
    n_layers = (n - 1).bit_length()
    g = pow(GEN, (3 << 30) // n, Q)
    h = pow(GEN, (3 << 30) // n_ex, Q)
    masks = {}

    ch = Channel(be(proof["p_mt_root"]))
    a0, a1, a2 = ch.draw(Q), ch.draw(Q), ch.draw(Q)
    for i in range(n_layers):
        ch.mix(be(proof["fri_roots"][i]))
        masks[f"fri_beta_{i}"] = ch.draw(Q) == int(proof["fri_betas"][i])
    ch.mix(be([proof["last"]]))
    idx = ch.draw(n_ex)

    evals = [int(v) for v in proof["evals"]]
    root = be(proof["p_mt_root"])
    masks["trace_merkle"] = all(
        merkle_ok(sha(be([evals[k]])), idx + k * cfg["idx_offset"], proof["eval_sibs"][k], root,
                  log_ex)
        for k in range(3))

    x = GEN * pow(h, idx, Q) % Q
    f_x, f_gx, f_ggx = (v % Q for v in evals)
    p0 = (f_x - 1) * _inv(x - 1)
    p1 = (f_x - cfg["boundary1"]) * _inv(x - pow(g, 1022, Q))
    num = (f_ggx - f_x * f_x - f_gx * f_gx) * (x - pow(g, 1021, Q)) * (x - pow(g, 1022, Q)) \
        * (x - pow(g, 1023, Q))
    p2 = num * _inv(pow(x, n, Q) - 1)
    cp = (p0 * a0 + p1 * a1 + p2 * a2) % Q

    inv2 = _inv(2)
    x_inv = _inv(x)
    paths_ok = True
    for i in range(n_layers):
        ds = n_ex >> i
        cpa, cpb = int(proof["cpa_evals"][i]), int(proof["cpb_evals"][i])
        masks[f"fri_carry_{i}"] = cp == cpa
        fri_root = be(proof["fri_roots"][i])
        paths_ok &= merkle_ok(sha(be([cpa])), idx & (ds - 1), proof["cpa_sibs"][i], fri_root,
                              log_ex - i)
        paths_ok &= merkle_ok(sha(be([cpb])), (idx + ds // 2) & (ds - 1), proof["cpb_sibs"][i],
                              fri_root, log_ex - i)
        beta = int(proof["fri_betas"][i])
        cp = ((cpa + cpb) * inv2 + (cpa - cpb) * inv2 % Q * x_inv % Q * beta) % Q
        x_inv = x_inv * x_inv % Q
    masks["fri_merkle"] = paths_ok
    masks["fri_last"] = cp == int(proof["last"])
    return all(masks.values()), masks
