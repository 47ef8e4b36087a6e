"""The port's SHA-256 and Merkle walks against the JAX package and hashlib.

On CPU tensors the port runs the plain versions of kernels K1-K3; these
tests hold them bit-equal to the JAX lax path, to the Pallas kernels' tile
math (``pk._sha_words_tiles``, ``pk._node_tiles``, ``pk._walk_tiles``)
and to hashlib.  The CUDA kernels themselves are compared with the plain
versions on the card by ``chip_smoke.py``.
"""

import hashlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_symphony_tpu.ops import merkle as JM
from stark_symphony_tpu.ops import sha256 as JS
from stark_symphony_tpu.ops.pallas import sha256_kernel as pk
from stark_symphony_tpu_torch.ops import merkle as TM
from stark_symphony_tpu_torch.ops import sha256 as TS
from stark_symphony_tpu_torch.ops.cuda import build
from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
from stark_symphony_tpu_torch.ops.u32 import from_numpy, to_numpy


@pytest.fixture(scope="module", autouse=True)
def jit_jax_compress():
    """Run the JAX reference's compressions jitted, compiled once per shape:
    called eagerly, each of its fori_loops compiles anew on every call.
    The values are the same; only the CPU time of the suite changes."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "compress", jax.jit(JS.compress))
        mp.setattr(JS, "compress_const_schedule", jax.jit(JS.compress_const_schedule))
        yield


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=shape,
                                                dtype=np.uint32)


def _hashlib_words(row) -> np.ndarray:
    raw = np.asarray(row, dtype=">u4").tobytes()
    return np.frombuffer(hashlib.sha256(raw).digest(), dtype=">u4").astype(np.uint32)


@pytest.mark.parametrize("n_words", [4, 9, 16, 24, 88])
def test_sha256_words(n_words):
    msgs = _rand((2, 9, n_words), seed=n_words)  # two batch axes
    got = to_numpy(TS.sha256_words(from_numpy(msgs)))
    assert got.shape == (2, 9, 8)
    np.testing.assert_array_equal(got, np.asarray(JS.sha256_words(jnp.asarray(msgs))))
    flat = msgs.reshape(-1, n_words)
    tiles = np.stack([np.asarray(t) for t in pk._sha_words_tiles(
        [flat[:, i] for i in range(n_words)])], axis=1)
    np.testing.assert_array_equal(got.reshape(-1, 8), tiles)
    for i in (0, 7, 17):
        np.testing.assert_array_equal(got.reshape(-1, 8)[i], _hashlib_words(flat[i]))


def test_sha256_pair():
    left, right = _rand((3, 11, 8), seed=1), _rand((3, 11, 8), seed=2)
    got = to_numpy(TS.sha256_pair(from_numpy(left), from_numpy(right)))
    np.testing.assert_array_equal(
        got, np.asarray(JS.sha256_pair(jnp.asarray(left), jnp.asarray(right))))
    l2, r2 = left.reshape(-1, 8), right.reshape(-1, 8)
    tiles = np.stack([np.asarray(t) for t in pk._node_tiles(
        tuple(l2[:, i] for i in range(8)), tuple(r2[:, i] for i in range(8)))], axis=1)
    np.testing.assert_array_equal(got.reshape(-1, 8), tiles)
    for i in (0, 32):
        np.testing.assert_array_equal(
            got.reshape(-1, 8)[i], _hashlib_words(np.concatenate([l2[i], r2[i]])))
    # a broadcast operand hashes like its expanded form
    got_b = to_numpy(TS.sha256_pair(from_numpy(left), from_numpy(right[0, 0])))
    np.testing.assert_array_equal(got_b, to_numpy(TS.sha256_pair(
        from_numpy(left), from_numpy(np.broadcast_to(right[0, 0], left.shape)))))


def test_compress_and_schedules():
    state, block = _rand((6, 8), seed=3), _rand((6, 16), seed=4)
    np.testing.assert_array_equal(
        to_numpy(TS.compress(from_numpy(state), from_numpy(block))),
        np.asarray(JS.compress(jnp.asarray(state), jnp.asarray(block))))
    sched = JS.schedule_host(block[0])
    np.testing.assert_array_equal(TS.schedule_host(block[0]), sched)
    np.testing.assert_array_equal(
        to_numpy(TS.compress_const_schedule(from_numpy(state), sched)),
        np.asarray(JS.compress_const_schedule(jnp.asarray(state), sched)))
    for n in range(1, 90):
        pad, blocks = TS._padding_words(n)
        jpad, jblocks = JS._padding_words(n)
        np.testing.assert_array_equal(pad, jpad)
        assert blocks == jblocks == -(-(n + 3) // 16)


def test_device_header_constants_match_reference():
    """The constant tables in csrc/sha256.cuh are the JAX package's K, IV
    and Merkle-node padding schedule (_PAD64_SCHED)."""
    text = (build.CSRC / "sha256.cuh").read_text()

    def table(name):
        body = re.search(name + r"\[\d+\] = \{([^}]*)\}", text).group(1)
        return np.array([int(x, 16) for x in re.findall(r"0x([0-9A-F]+)u", body)],
                        dtype=np.uint32)

    np.testing.assert_array_equal(table("kK"), JS.K)
    np.testing.assert_array_equal(table("kIV"), JS.IV)
    np.testing.assert_array_equal(table("kPad64Sched"), pk._PAD64_SCHED)


def test_merkle_full_depth():
    depth, n = 7, 40
    leaves = _rand((n, 8), seed=5)
    sibs = _rand((n, depth, 8), seed=6)
    idx = _rand((n,), seed=7) % (1 << depth)
    got = to_numpy(TM.compute_root(from_numpy(leaves), from_numpy(idx), from_numpy(sibs)))
    want = np.asarray(JM.compute_root(jnp.asarray(leaves), jnp.asarray(idx),
                                      jnp.asarray(sibs)))
    np.testing.assert_array_equal(got, want)
    roots = want.copy()
    roots[::3, 0] ^= 1
    ok = TM.verify_path(from_numpy(leaves), from_numpy(idx), from_numpy(sibs),
                        from_numpy(roots)).numpy()
    np.testing.assert_array_equal(ok, np.asarray(JM.verify_path(
        jnp.asarray(leaves), jnp.asarray(idx), jnp.asarray(sibs), jnp.asarray(roots))))
    assert ok.any() and not ok.all()


def test_merkle_padded_per_lane_depths():
    """Random per-path depths, as test_kernel_math_walk_matches_scan: equal
    to the JAX padded walk and to the kernel's tile math, with a leading
    batch axis over which the depths broadcast (lanes (B, L*Q))."""
    max_depth, b, n = 6, 3, 16
    rng = np.random.default_rng(8)
    depths = rng.integers(0, max_depth + 1, size=n)
    leaves = _rand((b, n, 8), seed=9)
    sibs = _rand((b, n, max_depth, 8), seed=10)
    idx = _rand((b, n), seed=11) % (1 << max_depth)
    got = to_numpy(TM.compute_root(from_numpy(leaves), from_numpy(idx),
                                   from_numpy(sibs), depths))
    walk = np.stack([np.asarray(t) for t in pk._walk_tiles(
        tuple(leaves.reshape(-1, 8)[:, i] for i in range(8)),
        idx.reshape(-1),
        np.tile(depths, b).astype(np.uint32),
        [tuple(sibs.reshape(-1, max_depth, 8)[:, lvl, i] for i in range(8))
         for lvl in range(max_depth)],
    )], axis=1)
    np.testing.assert_array_equal(got.reshape(-1, 8), walk)
    roots = got.copy()
    roots[1, ::4, 2] ^= 1
    ok = TM.verify_path_padded(from_numpy(leaves), from_numpy(idx), from_numpy(sibs),
                               from_numpy(roots), depths).numpy()
    want = np.asarray(JM.verify_path_padded(
        jnp.asarray(leaves), jnp.asarray(idx), jnp.asarray(sibs),
        jnp.asarray(roots), depths))
    np.testing.assert_array_equal(ok, want)
    assert ok.any() and not ok.all()


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """The device alone picks the path: a CPU tensor never builds or loads
    the CUDA library, and a kernel wrapper refuses a CPU tensor."""
    def no_build():
        raise AssertionError("CUDA build reached from a CPU tensor")

    monkeypatch.setattr(build, "load", no_build)
    before = dict(ck.launches)
    msgs = from_numpy(_rand((5, 9), seed=12))
    TS.sha256_words(msgs)
    TS.sha256_pair(msgs[:, :8], msgs[:, 1:])
    TM.compute_root(msgs[:, :8], msgs[:, 0] & 3, msgs[:, None, :8].expand(5, 2, 8))
    assert ck.launches == before
    with pytest.raises(ValueError):
        ck.sha256_words(msgs)
    with pytest.raises(ValueError):
        ck.sha256_pair(msgs[:, :8], msgs[:, 1:])
    with pytest.raises(ValueError):
        ck.merkle_compute_root(msgs[:, :8], msgs[:, 0], msgs[:, None, :8])
    with pytest.raises(ValueError):
        TS.sha256_words(msgs.to("meta"))


def _emulated_launch(name, device, *args):
    """What each CUDA kernel computes, lane by lane, on its word-major
    (W, lanes) int32 buffers, written with the plain versions; it lets the
    wrappers' layout code (relayout, broadcasting, per-lane depths) run on
    the CPU."""
    from stark_symphony_tpu_torch.ops.u32 import from_i32, to_i32

    if name == "sha256_words":
        msg, out, n, lanes = args
        assert msg.shape == (n, lanes) and msg.is_contiguous()
        res = TS.sha256_words_plain(from_i32(msg).t())
    elif name == "sha256_pair":
        left, right, out, lanes = args
        assert left.shape == right.shape == (8, lanes)
        res = TS.sha256_pair_plain(from_i32(left).t(), from_i32(right).t())
    else:
        leaf, idx, dep, sibs, out, depth, lanes = args
        assert sibs.shape == (depth * 8, lanes) and dep.shape == idx.shape == (lanes,)
        res = TM.compute_root_plain(
            from_i32(leaf).t(), from_i32(idx),
            from_i32(sibs).reshape(depth, 8, lanes).permute(2, 0, 1),
            dep.to(torch.int64))
    assert out.shape == (8, lanes) and out.dtype == torch.int32
    out.copy_(to_i32(res.t()))
    ck.launches[name] += 1


def test_kernel_wrappers_layout(monkeypatch):
    """The wrappers' word-major relayout around a lane-wise kernel gives
    the plain results, for batch shapes, broadcast operands and per-lane
    depths broadcast over the batch axis (the padded FRI walk's lanes)."""
    monkeypatch.setattr(ck, "_check", lambda *a: None)
    monkeypatch.setattr(ck, "_launch", _emulated_launch)
    msgs = from_numpy(_rand((2, 3, 9), seed=13))
    np.testing.assert_array_equal(to_numpy(ck.sha256_words(msgs)),
                                  to_numpy(TS.sha256_words_plain(msgs)))
    assert tuple(ck.sha256_words(msgs[:0]).shape) == (0, 3, 8)
    left, right = from_numpy(_rand((4, 5, 8), seed=14)), from_numpy(_rand((8,), seed=15))
    np.testing.assert_array_equal(to_numpy(ck.sha256_pair(left, right)),
                                  to_numpy(TS.sha256_pair_plain(left, right)))
    b, n, d = 3, 10, 5
    leaf = from_numpy(_rand((b, n, 8), seed=16))
    idx = from_numpy(_rand((b, n), seed=17) % (1 << d))
    sibs = from_numpy(_rand((b, n, d, 8), seed=18))
    depths = np.random.default_rng(19).integers(0, d + 1, n)
    for deps in (None, depths):
        np.testing.assert_array_equal(
            to_numpy(ck.merkle_compute_root(leaf, idx, sibs, deps)),
            to_numpy(TM.compute_root_plain(leaf, idx, sibs, deps)))
    # one sibling path shared by every lane
    np.testing.assert_array_equal(
        to_numpy(ck.merkle_compute_root(leaf, idx, sibs[0, 0])),
        to_numpy(TM.compute_root_plain(leaf, idx, sibs[0, 0])))
