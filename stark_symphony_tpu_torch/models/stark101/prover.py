"""stark101 (FibonacciSq) prover over int64 word tensors.

Port of ``stark_symphony_tpu/models/stark101/prover.py``.  It replays the
reference prover's Fiat-Shamir transcript exactly, so on the default trace
it emits the reference's proof word for word
(``tests/fixtures/stark101/golden_proof.json``):

  mix(trace root) -> draw a0, a1, a2 -> [draw beta_i; fold; mix root_{i+1}]*
  -> mix(last free term) -> draw the query index -> decommitments.

* Interpolation over the 1023-point subset of the 1024 subgroup takes two
  INTTs (the value at g^1023 is chosen so that coefficient 1023 vanishes).
* Constraints and the composition are evaluated pointwise on the 8192
  coset; the quotients divide exactly, so value-space division gives the
  same polynomial.  The coset points and the constraint denominators'
  inverses are protocol constants, computed on the host.
* FRI folds in value space: u_i = (v_i + v_{i+n/2})/2 + beta (v_i -
  v_{i+n/2}) / (2 x_i).
* Merkle trees are built level by level (``merkle.build_tree``).
* With ``graphed=True`` the whole body (``_prove_body``) is one CUDA
  graph, as the JAX package compiles ``_prove_jit``: its host tables go
  to each device once (``_device_tables``), and the query index is read
  after the replay.

On a CUDA device every SHA-256 call runs in kernel K1 (37 launches: 11
leaf batches and the single-lane transcript) and every tree level in K2
(98 launches over 11 trees).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...ops import field101 as F
from ...ops import merkle
from ...ops.ntt import eval_on_coset, ntt
from ...ops.sha256 import sha256_words
from ...ops.u32 import to_numpy
from ...tools import build as TB
from . import channel as ch
from .config import Stark101Config
from .proof import Stark101Proof


def generate_trace(cfg: Stark101Config) -> np.ndarray:
    t = [1, cfg.x1]
    while len(t) < cfg.trace_len:
        t.append((t[-2] * t[-2] + t[-1] * t[-1]) % F.Q)
    return np.array(t, dtype=np.uint32)


def interpolate_trace(cfg: Stark101Config, trace):
    """Coefficients (..., 1024) of the unique polynomial of degree <= 1022
    with p(g^i) = trace[i] for i < 1023 (trace: (..., 1023) words).

    The INTT with the value at g^1023 set to 0 gives coefficient c_1023 =
    a; the true value u there must satisfy a + u g^(-1023 * 1023) / n = 0."""
    n = cfg.domain_size
    g = cfg.subgroup_gen
    vals = torch.cat([trace, trace.new_zeros(trace.shape[:-1] + (1,))], dim=-1)
    a = ntt(vals, g, inverse=True)[..., -1]
    # contribution factor of v_{n-1} to c_{n-1}: g^{-(n-1)^2} / n
    factor = (pow(pow(g, (n - 1) * (n - 1), F.Q), F.Q - 2, F.Q)
              * pow(n, F.Q - 2, F.Q)) % F.Q
    vals = vals.clone()
    vals[..., -1] = F.f_mul(F.f_neg(a), pow(factor, F.Q - 2, F.Q))
    return ntt(vals, g, inverse=True)  # coefficient 1023 is zero


def _tree(values):
    """Merkle tree over word leaf values: (levels, root words)."""
    levels = merkle.build_tree(sha256_words(values[..., None]))
    return levels, levels[-1][..., 0, :]


@functools.lru_cache(maxsize=None)
def _host_tables(cfg: Stark101Config):
    """The coset points' constants, computed on the host with Python ints:
    the coset points x_i = GEN h^i, the inverses of the three constraint
    denominators at them, and each FRI layer's 1/x over its half domain."""
    n_ex = cfg.domain_ex_size
    h = cfg.coset_gen
    xs = []
    cur = F.GEN % F.Q
    for _ in range(n_ex):
        xs.append(cur)
        cur = (cur * h) % F.Q
    g1022 = cfg.g_pow(1022)
    inv0 = np.array([pow((x - 1) % F.Q, F.Q - 2, F.Q) for x in xs], np.uint32)
    inv1 = np.array([pow((x - g1022) % F.Q, F.Q - 2, F.Q) for x in xs], np.uint32)
    inv2 = np.array([pow((pow(x, cfg.domain_size, F.Q) - 1) % F.Q, F.Q - 2, F.Q)
                     for x in xs], np.uint32)
    xinv_layers = []
    cur_inv = [pow(x, F.Q - 2, F.Q) for x in xs]
    for _ in range(cfg.n_fri_layers):
        cur_inv = cur_inv[: len(cur_inv) // 2]
        xinv_layers.append(np.array(cur_inv, np.uint32))
        cur_inv = [(v * v) % F.Q for v in cur_inv]
    return np.array(xs, np.uint32), inv0, inv1, inv2, xinv_layers


@functools.lru_cache(maxsize=None)
def _device_tables(cfg: Stark101Config, device: torch.device):
    """``_host_tables(cfg)`` as int64 tensors on `device`, sent there once
    per (cfg, device), so a proof's body copies nothing from the host (a
    CUDA graph may not capture a host-to-device copy)."""
    xs, inv0, inv1, inv2, xinv = _host_tables(cfg)

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    return dev(xs), dev(inv0), dev(inv1), dev(inv2), tuple(dev(x) for x in xinv)


def _take(values, pos):
    """values[..., pos] for a word-tensor position (...)."""
    return torch.take_along_dim(values, pos[..., None], dim=-1)[..., 0]


def _prove_body(cfg: Stark101Config, trace):
    """The proof of `trace` (1023,) words on its device: (Stark101Proof of
    word tensors, the query index as a 0-d word tensor).  It reads
    nothing to the host and makes no tensor from host data once the
    device tables are warm (``_device_tables``, ``ntt._device_tables``)."""
    n_ex = cfg.domain_ex_size
    h = cfg.coset_gen
    xs, inv0, inv1, inv2, xinv = _device_tables(cfg, trace.device)

    coeffs = interpolate_trace(cfg, trace)
    p_ev = eval_on_coset(coeffs, F.GEN, h, n_out=n_ex)  # values on GEN * <h>
    p_levels, p_root = _tree(p_ev)

    # Channel genesis: state = H(root)
    state = sha256_words(p_root)
    state, a0 = ch.draw(state, F.Q)
    state, a1 = ch.draw(state, F.Q)
    state, a2 = ch.draw(state, F.Q)

    # Composition polynomial values on the coset (pointwise quotients)
    f_x = p_ev
    f_gx = torch.roll(p_ev, -cfg.idx_offset, dims=-1)
    f_ggx = torch.roll(p_ev, -2 * cfg.idx_offset, dims=-1)
    p0 = F.f_mul(F.f_sub(f_x, 1), inv0)
    p1 = F.f_mul(F.f_sub(f_x, cfg.boundary1), inv1)
    num0 = F.f_sub(f_ggx, F.f_add(F.f_mul(f_x, f_x), F.f_mul(f_gx, f_gx)))
    num1 = F.f_mul(
        F.f_mul(F.f_sub(xs, cfg.g_pow(1021)), F.f_sub(xs, cfg.g_pow(1022))),
        F.f_sub(xs, cfg.g_pow(1023)),
    )
    p2 = F.f_mul(F.f_mul(num0, num1), inv2)
    cp_ev = F.f_add(F.f_add(F.f_mul(p0, a0), F.f_mul(p1, a1)), F.f_mul(p2, a2))

    # FRI: fold down to a constant, committing each layer but the last
    fri_values = [cp_ev]
    lv, root = _tree(cp_ev)
    fri_levels, fri_roots, fri_betas = [lv], [root], []
    state = ch.mix_words(state, root)
    inv2 = pow(2, F.Q - 2, F.Q)
    cur_vals = cp_ev
    for layer in range(cfg.n_fri_layers):
        state, beta = ch.draw(state, F.Q)
        fri_betas.append(beta)
        half = cur_vals.shape[-1] // 2
        va, vb = cur_vals[..., :half], cur_vals[..., half:]
        even = F.f_mul(F.f_add(va, vb), inv2)
        odd = F.f_mul(F.f_mul(F.f_sub(va, vb), inv2), xinv[layer])
        cur_vals = F.f_add(even, F.f_mul(odd, beta))
        fri_values.append(cur_vals)
        if layer < cfg.n_fri_layers - 1:
            lv, root = _tree(cur_vals)
            fri_levels.append(lv)
            fri_roots.append(root)
            state = ch.mix_words(state, root)

    last = cur_vals[..., 0]
    state = ch.mix_u32(state, last)

    # Query and decommitments
    state, idx = ch.draw(state, n_ex)
    evals, eval_sibs = [], []
    for k in range(3):
        pos = (idx + k * cfg.idx_offset) & (n_ex - 1)
        evals.append(_take(p_ev, pos))
        eval_sibs.append(merkle.gather_path(p_levels, pos))
    cpa_evals, cpa_sibs, cpb_evals, cpb_sibs = [], [], [], []
    for i in range(cfg.n_fri_layers):
        length = n_ex >> i
        fri_idx = idx & (length - 1)
        sib_idx = (idx + length // 2) & (length - 1)
        cpa_evals.append(_take(fri_values[i], fri_idx))
        cpb_evals.append(_take(fri_values[i], sib_idx))
        cpa_sibs.append(merkle.gather_path(fri_levels[i], fri_idx))
        cpb_sibs.append(merkle.gather_path(fri_levels[i], sib_idx))

    proof = Stark101Proof(
        p_mt_root=p_root,
        evals=torch.stack(evals, dim=-1),
        eval_sibs=torch.stack(eval_sibs, dim=-3),
        fri_roots=torch.stack(fri_roots, dim=-2),
        fri_betas=torch.stack(fri_betas, dim=-1),
        cpa_evals=torch.stack(cpa_evals, dim=-1),
        cpa_sibs=tuple(cpa_sibs),
        cpb_evals=torch.stack(cpb_evals, dim=-1),
        cpb_sibs=tuple(cpb_sibs),
        last=last,
    )
    return proof, idx


GRAPHS = TB.GraphCache()  # the graphed body by cfg and the trace's spec


def prove(cfg: Stark101Config = Stark101Config(), trace=None, device="cuda",
          graphed: bool = False):
    """Make a proof on `device`.  Returns (Stark101Proof of numpy uint32
    words, {"idx": the query index}), as the JAX package's prove does.
    `graphed`: replay the body as one CUDA graph (``tools/build.capture``),
    captured once per (cfg, device); the proof is the same."""
    if trace is None:
        trace = generate_trace(cfg)
    t = torch.from_numpy(np.asarray(trace, np.int64)).to(device)
    if graphed:
        body = GRAPHS.get(cfg, (t,), lambda: TB.capture(lambda x: _prove_body(cfg, x), (t,),
                                                         warmup=1))
        proof, idx = body.replay(t)
    else:
        proof, idx = _prove_body(cfg, t)
    words = Stark101Proof(*(tuple(to_numpy(s) for s in x) if isinstance(x, tuple)
                            else to_numpy(x) for x in proof))
    return words, {"idx": int(idx)}
