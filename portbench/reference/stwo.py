"""Plain reference verifier of one stwo circle-STARK proof: Python integers
and hashlib, one proof at a time.

It follows the stwo verifier of starkware-bitcoin/stark-symphony
(commit -> OODS -> FRI commit -> PoW -> decommit -> DEEP quotients -> FRI)
as the benchmark's configuration files state it, and imports nothing of
the program under test.  A proof is a mapping of field name to numpy
uint32 array, with the layout of the committed ``.npz`` fixtures:

  commitments (3, 8), trace_evals (Q, C), trace_sibs (Q, D, 8),
  cp_evals (Q, 16), cp_sibs (Q, D, 8), oods_trace (C, 4), oods_cp (16, 4),
  fri_first_commit (8,), fri_inner_commits (L, 8), fri_last (4,),
  fri_witnesses L+1 arrays (Q, 4), fri_sibs L+1 arrays (Q, D_l, 8),
  pow_nonce (2,) = (hi, lo).

``verify(proof, cfg)`` returns (accepted, masks): one boolean per check,
under the names and in the order of the upstream verifier's stages.
"""

from __future__ import annotations

import functools
import hashlib
import struct

P = (1 << 31) - 1
CIRCLE_GEN = (2, 1268011823)  # generator of the circle group over M31, order 2^31
DBL_P = (1 << 32) - 2  # M31 draws accept words below 2p


# --- hashing -------------------------------------------------------------

def be(words) -> bytes:
    """u32 words as big-endian bytes."""
    words = [int(w) for w in words]
    return struct.pack(f">{len(words)}I", *words)


def sha(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def words_of(digest: bytes) -> list:
    return list(struct.unpack(f">{len(digest) // 4}I", digest))


def merkle_ok(leaf: bytes, index: int, sibs, root: bytes, depth: int) -> bool:
    """Walk `depth` levels from `leaf` (sibling on the left where the low
    index bit is set) and compare with `root`."""
    cur = leaf
    for d in range(depth):
        sib = be(sibs[d])
        cur = sha(sib + cur) if index & 1 else sha(cur + sib)
        index >>= 1
    return cur == root


# --- fields: M31, CM31 = M31[i]/(i^2 + 1), QM31 = CM31[j]/(j^2 - 2 - i) --

def inv(a: int) -> int:
    return pow(a % P, P - 2, P)  # inv(0) = 0


def cmul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def cadd(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def csub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def cinv(a):
    n = inv(a[0] * a[0] + a[1] * a[1])
    return (a[0] * n % P, -a[1] * n % P)


def q(v) -> tuple:
    return tuple(int(x) % P for x in v)


def qadd(a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def qsub(a, b):
    return tuple((x - y) % P for x, y in zip(a, b))


def qmul(a, b):
    ar, ai, br, bi = a[:2], a[2:], b[:2], b[2:]
    re = cadd(cmul(ar, br), cmul(cmul(ai, bi), (2, 1)))
    im = cadd(cmul(ar, bi), cmul(ai, br))
    return re + im


def qscale(a, s: int):
    return tuple(x * s % P for x in a)


def qinv(a):
    ar, ai = a[:2], a[2:]
    den = csub(cmul(ar, ar), cmul(cmul(ai, ai), (2, 1)))
    d = cinv(den)
    return cmul(ar, d) + cmul(((-ai[0]) % P, (-ai[1]) % P), d)


ONE = (1, 0, 0, 0)
ZERO = (0, 0, 0, 0)


# --- the circle ------------------------------------------------------------

def padd(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def gen_pow(index: int):
    """CIRCLE_GEN * index (the group written additively)."""
    res, cur = (1, 0), CIRCLE_GEN
    while index:
        if index & 1:
            res = padd(res, cur)
        cur = padd(cur, cur)
        index >>= 1
    return res


@functools.lru_cache(maxsize=None)
def domain_points(log_size: int) -> tuple:
    """The canonic coset of size 2^log_size in natural order: the first
    half G^(offset + step * i), the second half their conjugates."""
    half = 1 << (log_size - 1)
    offset = 1 << (31 - (log_size + 1))
    step = gen_pow(1 << (31 - (log_size - 1)))
    pt = gen_pow(offset)
    first = []
    for _ in range(half):
        first.append(pt)
        pt = padd(pt, step)
    return tuple(first) + tuple((x, (-y) % P) for x, y in first)


def bit_reverse(x: int, log_size: int) -> int:
    return int(format(x, f"0{log_size}b")[::-1], 2)


# --- the channel -------------------------------------------------------------

class Channel:
    """SHA-256 over (digest || counter) for draws, (digest || payload) for
    mixes; a mix resets the counter."""

    def __init__(self):
        self.digest = bytes(32)
        self.counter = 0

    def mix(self, payload: bytes) -> None:
        self.digest = sha(self.digest + payload)
        self.counter = 0

    def draw_words(self) -> list:
        out = words_of(sha(self.digest + struct.pack(">I", self.counter)))
        self.counter = (self.counter + 1) & 0xFFFFFFFF
        return out

    def draw_qm31(self):
        """Four M31 values by rejection, at most two attempts; (value, ok)."""
        for _ in range(2):
            w = self.draw_words()[:4]
            if all(x < DBL_P for x in w):
                return tuple(x % P for x in w), True
        return tuple(x % P for x in w), False

    def draw_point(self):
        t, ok = self.draw_qm31()
        t2 = qmul(t, t)
        d = qinv(qadd(ONE, t2))
        return (qmul(qsub(ONE, t2), d), qmul(qadd(t, t), d)), ok


# --- the verifier ---------------------------------------------------------------

def composition_at_oods(cfg: dict, oods_point, oods_trace, coeff):
    """The wide-Fibonacci AIR (c_k = c_{k-1}^2 + c_{k-2}^2) folded by
    `coeff` and divided by the trace domain's vanishing polynomial."""
    acc = ZERO
    a, b = oods_trace[0], oods_trace[1]
    for c in oods_trace[2:]:
        acc = qadd(qmul(acc, coeff), qsub(c, qadd(qmul(b, b), qmul(a, a))))
        a, b = b, c
    x = oods_point[0]
    for _ in range(cfg["trace_log_size"] - 1):
        x2 = qmul(x, x)
        x = qsub(qadd(x2, x2), ONE)
    return qmul(acc, qinv(x))


def composition_from_parts(oods_cp, oods_point):
    """F = F_a + y F_b + x F_c + x y F_d, each from four partitions
    p0 + p1 i + p2 j + p3 ij."""
    units = [ONE, (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1)]

    def part(k):
        acc = ZERO
        for u in range(4):
            acc = qadd(acc, qmul(oods_cp[4 * u + k], units[u]))
        return acc

    x, y = oods_point
    res = qadd(part(0), qmul(part(1), y))
    res = qadd(res, qmul(part(2), x))
    return qadd(res, qmul(part(3), qmul(x, y)))


def deep_quotient(cfg, qpt, trace_row, cp_row, alpha, oods_point, oods_trace, oods_cp):
    """The DEEP quotients of one query, aggregated by powers of alpha."""
    px, py = oods_point
    x, y = qpt
    dx = ((px[0] - x) % P, px[1])
    dy = ((py[0] - y) % P, py[1])
    d = csub(cmul(dx, py[2:]), cmul(dy, px[2:]))
    den_inv = cinv(d)
    acc = ZERO
    alpha_i = alpha
    im_py2 = ((-2 * py[2]) % P, (-2 * py[3]) % P)
    for sample, value in list(zip(oods_trace, trace_row)) + list(zip(oods_cp, cp_row)):
        a = (0, 0, (-2 * sample[2]) % P, (-2 * sample[3]) % P)
        b = (0, 0) + im_py2
        c = qsub(qmul(b, sample), qmul(a, py))
        num = qsub(qscale(qmul(alpha_i, b), value),
                   qadd(qscale(qmul(alpha_i, a), y), qmul(alpha_i, c)))
        acc = qadd(acc, num)
        alpha_i = qmul(alpha_i, alpha)
    acc = cmul(acc[:2], den_inv) + cmul(acc[2:], den_inv)
    return qmul(acc, alpha_i)


def verify(proof, cfg: dict):
    """(accepted, masks) of one proof under `cfg` (trace_log_size,
    lde_log_size, n_queries, n_inner_layers, pow_bits)."""
    n_q = cfg["n_queries"]
    lde = cfg["lde_log_size"]
    n_inner = cfg["n_inner_layers"]
    com = proof["commitments"]
    masks = {}
    ch = Channel()

    # I: commitments
    ch.mix(be(com[0]))
    ch.mix(be(com[1]))
    cp_alpha, masks["draw_cp_alpha"] = ch.draw_qm31()
    ch.mix(be(com[2]))

    # II: OODS
    oods_point, masks["draw_oods_point"] = ch.draw_point()
    ch.mix(be(list(proof["oods_trace"].reshape(-1)) + list(proof["oods_cp"].reshape(-1))))
    oods_trace = [q(v) for v in proof["oods_trace"]]
    oods_cp = [q(v) for v in proof["oods_cp"]]
    masks["oods_cp_match"] = (composition_at_oods(cfg, oods_point, oods_trace, cp_alpha)
                              == composition_from_parts(oods_cp, oods_point))
    deep_alpha, masks["draw_deep_alpha"] = ch.draw_qm31()

    # III: FRI commitments
    ch.mix(be(proof["fri_first_commit"]))
    alpha, masks["draw_fri_alpha_first"] = ch.draw_qm31()
    alphas = [alpha]
    for i in range(n_inner):
        ch.mix(be(proof["fri_inner_commits"][i]))
        alpha, masks[f"draw_fri_alpha_{i}"] = ch.draw_qm31()
        alphas.append(alpha)
    ch.mix(be(proof["fri_last"]))

    # IV: proof of work, the digest's last 8 bytes read little-endian
    ch.mix(be(proof["pow_nonce"]))
    work = int.from_bytes(ch.digest[24:32], "little")
    masks["pow"] = work < (1 << (64 - cfg["pow_bits"])) - 1

    # V: queries and the trace and composition decommitments
    queries = []
    for _ in range((n_q + 7) // 8):
        queries += [w & ((1 << lde) - 1) for w in ch.draw_words()]
    queries = queries[:n_q]
    for name, evals, sibs, root in (("trace_merkle", "trace_evals", "trace_sibs", com[1]),
                                    ("cp_merkle", "cp_evals", "cp_sibs", com[2])):
        ev, sb = proof[evals], proof[sibs]
        masks[name] = all(merkle_ok(sha(be(ev[k])), queries[k], sb[k], be(root), sb.shape[1])
                          for k in range(n_q))

    # VI: DEEP quotients; VII: FRI folds and their decommitments
    points = domain_points(lde)
    roots = [proof["fri_first_commit"]] + [proof["fri_inner_commits"][i] for i in range(n_inner)]
    layer_ok = [True] * (1 + n_inner)
    last_ok = True
    last = q(proof["fri_last"])
    for k in range(n_q):
        qk = queries[k]
        pt = points[bit_reverse(qk, lde)]
        value = deep_quotient(cfg, pt, [int(v) for v in proof["trace_evals"][k]],
                              [int(v) for v in proof["cp_evals"][k]], deep_alpha, oods_point,
                              oods_trace, oods_cp)
        x, y = pt
        coords = [(-y) % P if qk & 1 else y]
        u = x
        for l in range(1, 1 + n_inner):
            coords.append((-u) % P if (qk >> l) & 1 else u)
            u = (2 * u * u - 1) % P
        cur = qk
        for l in range(1 + n_inner):
            wit = q(proof["fri_witnesses"][l][k])
            e0, e1 = (value, wit) if cur & 1 == 0 else (wit, value)
            node = sha(sha(be(e0)) + sha(be(e1)))
            sibs = proof["fri_sibs"][l][k]
            if not merkle_ok(node, cur >> 1, sibs, be(roots[l]), lde - 1 - l):
                layer_ok[l] = False
            value = qadd(qadd(e0, e1), qmul(alphas[l], qscale(qsub(e0, e1), inv(coords[l]))))
            cur >>= 1
        last_ok &= value == last
    for l in range(1 + n_inner):
        masks[f"fri_merkle_{l}"] = layer_ok[l]
    masks["fri_last_eval"] = last_ok
    if lde - 1 - n_inner == 0:
        masks["fri_last_query"] = all((qk >> (1 + n_inner)) == 0 for qk in queries)
    return all(masks.values()), masks
