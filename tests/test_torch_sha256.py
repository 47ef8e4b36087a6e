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
    """What each CUDA kernel computes, lane by lane, written with the plain
    versions, on the buffers its launcher takes: K1-K3 read lane-major
    int64 words in place and write (lanes, 8) int64 words.  It lets the
    wrappers' layout code (broadcasting, copies, per-lane depths) run on
    the CPU.  The last launch's arguments are kept in
    `_emulated_launch.seen`."""
    from stark_symphony_tpu_torch.ops.u32 import WORD

    _emulated_launch.seen = args
    if name == "sha256_words":
        msg, out, n, lanes, threads = args
        ins = [(msg, lanes * n)]
        assert threads == ck.lane_threads(lanes, n)
        res = TS.sha256_words_plain(msg.reshape(lanes, n))
    elif name == "sha256_pair":
        left, right, out, lanes, threads = args
        ins = [(left, lanes * 8), (right, lanes * 8)]
        assert threads == ck.lane_threads(lanes)
        res = TS.sha256_pair_plain(left.reshape(lanes, 8), right.reshape(lanes, 8))
    else:
        leaf, idx, dep, period, sibs, out, depth, lanes, threads = args
        ins = [(leaf, lanes * 8), (idx, lanes), (sibs, lanes * depth * 8)]
        assert threads == (32 if dep is not None else ck.lane_threads(lanes))
        lane_dep = None
        if dep is not None:
            assert dep.dtype == torch.int32 and dep.numel() == period >= 1
            lane_dep = dep[torch.arange(lanes) % period].to(WORD)
        res = TM.compute_root_plain(leaf.reshape(lanes, 8), idx.reshape(lanes),
                                    sibs.reshape(lanes, depth, 8), lane_dep)
    for x, numel in ins:
        assert x.dtype == WORD and x.is_contiguous() and x.numel() == numel
        assert x.data_ptr() % 16 == 0
    assert out.dtype == WORD and out.is_contiguous() and out.numel() == lanes * 8
    out.view(lanes, 8).copy_(res)
    ck.launches[name] += 1


def test_lane_block_sizes():
    """K1/K3 blocks: 32 threads at the transcript's 4,096 lanes (128
    blocks), 128 at the leaves' 65,536; fewer where a K1 block's messages
    would not fit in shared memory, and an error where none would; 32 for
    K3 where paths have depths of their own."""
    assert ck.lane_threads(4096, 9) == ck.lane_threads(4096, 88) == 32
    assert ck.lane_threads(4096) == ck.lane_threads(ck.SMALL_LANES - 1) == 32
    assert ck.lane_threads(ck.SMALL_LANES) == ck.lane_threads(589_824) == 128
    assert ck.lane_threads(65_536, 16) == ck.lane_threads(65_536, 88) == 128
    assert ck.lane_threads(65_536, 300) == 64
    assert ck.lane_threads(65_536, 600) == 32
    with pytest.raises(ValueError):
        ck.lane_threads(4096, 1000)
    assert ck.walk_threads(589_824, None) == 128
    assert ck.walk_threads(589_824, np.arange(144)) == 32


@pytest.fixture()
def emulated(monkeypatch):
    monkeypatch.setattr(ck, "_check", lambda *a, **k: None)
    monkeypatch.setattr(ck, "_launch", _emulated_launch)


def test_kernel_wrappers_layout(emulated):
    """Around an emulated launch, each wrapper gives the plain results for
    batch shapes, the empty batch, broadcast operands and per-lane depths
    (periodic over the batch, as the padded FRI walk gives them, or not);
    K1-K3 hand the kernel the caller's own storage when it is already
    lane-major, as the verifier's operands are, and copy it otherwise."""
    msgs = from_numpy(_rand((2, 3, 9), seed=13))
    got = ck.sha256_words(msgs)
    assert _emulated_launch.seen[0].data_ptr() == msgs.data_ptr()
    np.testing.assert_array_equal(to_numpy(got), to_numpy(TS.sha256_words_plain(msgs)))
    assert tuple(ck.sha256_words(msgs[:0]).shape) == (0, 3, 8)
    strided = msgs[..., ::2]
    np.testing.assert_array_equal(to_numpy(ck.sha256_words(strided)),
                                  to_numpy(TS.sha256_words_plain(strided)))
    assert _emulated_launch.seen[0].data_ptr() != strided.data_ptr()
    # K2: the caller's own storage when both operands are lane-major, else
    # a copy of the one that is broadcast, strided or misaligned
    left, right = from_numpy(_rand((4, 5, 8), seed=14)), from_numpy(_rand((4, 5, 8), seed=15))
    wide = from_numpy(_rand((4, 5, 16), seed=20))
    flat = from_numpy(_rand((4 * 5 * 8 + 1,), seed=21))
    misaligned = flat[1:].view(4, 5, 8)
    assert misaligned.data_ptr() % 16 == 8
    for other, in_place in ((right, True), (right[0, 0], False), (wide[..., ::2], False),
                            (misaligned, False)):
        got = ck.sha256_pair(left, other)
        seen = _emulated_launch.seen
        assert seen[0].data_ptr() == left.data_ptr()
        assert (seen[1].data_ptr() == other.data_ptr()) == in_place
        np.testing.assert_array_equal(to_numpy(got),
                                      to_numpy(TS.sha256_pair_plain(left, other)))
    assert tuple(ck.sha256_pair(left[:0], right[:0]).shape) == (0, 5, 8)
    assert tuple(ck.sha256_pair(left[:, :0], right[0, 0]).shape) == (4, 0, 8)
    b, n, d = 3, 10, 5
    leaf = from_numpy(_rand((b, n, 8), seed=16))
    idx = from_numpy(_rand((b, n), seed=17) % (1 << d))
    sibs = from_numpy(_rand((b, n, d, 8), seed=18))
    rng = np.random.default_rng(19)
    per_query = rng.integers(0, d + 1, n)  # period n, as the FRI walk's
    for deps in (None, per_query, per_query[None], rng.integers(0, d + 1, (b, 1)),
                 rng.integers(0, d + 1, (b, n)), 2, torch.from_numpy(per_query)):
        got = ck.merkle_compute_root(leaf, idx, sibs, deps)
        seen = _emulated_launch.seen
        assert [seen[i].data_ptr() for i in (0, 1, 4)] == [
            leaf.data_ptr(), idx.data_ptr(), sibs.data_ptr()]
        np.testing.assert_array_equal(
            to_numpy(got), to_numpy(TM.compute_root_plain(leaf, idx, sibs, deps)))
    assert _emulated_launch.seen[3] == n  # per_query: one period of n lanes
    assert tuple(ck.merkle_compute_root(leaf[:0], idx[:0], sibs[:0], per_query).shape) \
        == (0, n, 8)
    # one sibling path shared by every lane; one leaf shared by the batch
    np.testing.assert_array_equal(
        to_numpy(ck.merkle_compute_root(leaf, idx, sibs[0, 0])),
        to_numpy(TM.compute_root_plain(leaf, idx, sibs[0, 0])))
    np.testing.assert_array_equal(
        to_numpy(ck.merkle_compute_root(leaf[0], idx, sibs, per_query)),
        to_numpy(TM.compute_root_plain(leaf[0], idx, sibs, per_query)))


@pytest.mark.parametrize("lshape, rshape", [
    ((1, 8), (1, 8)), ((33, 8), (33, 8)), ((3, 11, 8), (3, 11, 8)),
    ((2, 3, 5, 8), (5, 8)), ((8,), (6, 8)),
])
def test_sha256_pair_wrapper_matches_jax(emulated, lshape, rshape):
    """K2's wrapper around an emulated launch, at batch shapes and
    broadcasts, equals the JAX package's sha256_pair (on the operands
    broadcast) and hashlib."""
    left, right = _rand(lshape, seed=len(lshape)), _rand(rshape, seed=40 + len(rshape))
    got = to_numpy(ck.sha256_pair(from_numpy(left), from_numpy(right)))
    l2, r2 = np.broadcast_arrays(left, right)  # JAX's lax path does not broadcast
    want = np.asarray(JS.sha256_pair(jnp.asarray(l2), jnp.asarray(r2)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got.reshape(-1, 8)[-1],
        _hashlib_words(np.concatenate([l2.reshape(-1, 8)[-1], r2.reshape(-1, 8)[-1]])))
