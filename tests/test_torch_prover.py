"""The port's stwo prover (``models/stwo/prover.py``) against the JAX
package: its traces and LDE rules, its proofs against the committed
fixtures of the JAX prover (word for word, every field), ``pow_grind``
against a hashlib search, ``save_npz`` against the JAX package's, and the
writing half of the proof cache.  Proofs are made on the CPU at TESTING
size; no JAX prover runs."""

import dataclasses
import hashlib
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_symphony_tpu.models.stwo import constraints as JCON
from stark_symphony_tpu.models.stwo import proof as JP
from stark_symphony_tpu.models.stwo import prover as JPROVER
from stark_symphony_tpu.models.stwo.config import TESTING as J_TESTING
from stark_symphony_tpu_torch.models.stwo import constraints as TCON
from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.models.stwo import prover as TPROVER
from stark_symphony_tpu_torch.models.stwo import verifier as TV
from stark_symphony_tpu_torch.models.stwo.config import TESTING, TESTING_Q4
from stark_symphony_tpu_torch.ops import merkle as TM
from stark_symphony_tpu_torch.ops import sha256 as TS
from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
from stark_symphony_tpu_torch.ops.u32 import from_numpy, to_numpy
from stark_symphony_tpu_torch.utils import proofcache as PC
from test_torch_sha256 import _emulated_launch

AIRS = ["wide_fibonacci", "wide_product"]


def assert_proofs_equal(got, want):
    """Every field equal, word for word, with the same shapes and dtype."""
    for name in TP.StwoProof._fields:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, tuple):
            assert isinstance(g, tuple) and len(g) == len(w), name
        pairs = zip(g, w) if isinstance(w, tuple) else [(g, w)]
        for i, (a, b) in enumerate(pairs):
            assert a.dtype == np.uint32 and a.shape == b.shape, (name, i, a.dtype, a.shape)
            np.testing.assert_array_equal(a, b, err_msg=f"{name}[{i}]")


@pytest.mark.parametrize("seed", [None, 5])
@pytest.mark.parametrize("air", AIRS)
def test_generate_trace_equals_jax(air, seed):
    cfg = dataclasses.replace(TESTING, n_columns=6)
    seeds = None if seed is None else np.random.default_rng(seed).integers(
        0, 1 << 32, 1 << cfg.trace_log_size, dtype=np.uint64)
    got = TPROVER.generate_trace(cfg, seeds, air)
    want = JPROVER.generate_trace(dataclasses.replace(J_TESTING, n_columns=6), seeds, air)
    assert got.dtype == np.uint32 and got.shape == (6, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("air", AIRS)
def test_lde_rule_equals_jax(air):
    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, 1 << 32, 256, dtype=np.uint32) for _ in range(2))
    got = to_numpy(TCON.lde_rule(air)(from_numpy(a), from_numpy(b)))
    want = np.asarray(JCON.lde_rule(air)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    assert TCON.AIR_IDS == JCON.AIR_IDS
    assert TCON.TRACE_RULES[air](3, 5) == JCON.TRACE_RULES[air](3, 5)
    with pytest.raises(KeyError):
        TCON.lde_rule("no_such_air")


@pytest.mark.parametrize("cfg,seed", [
    (TESTING, None), (TESTING, 0), (TESTING, 1), (TESTING, 2), (TESTING, 3),
    (TESTING_Q4, None),
], ids=["testing", "testing-s0", "testing-s1", "testing-s2", "testing-s3", "testing_q4"])
def test_prove_equals_fixture(cfg, seed):
    """The port's proof on the CPU equals the JAX prover's committed one."""
    proof, info = TPROVER.prove(cfg, TPROVER.seeded_trace(cfg, seed), device="cpu")
    assert info == {}
    assert_proofs_equal(proof, TP.load_npz(str(PC.fixture_path(cfg, seed))))


def test_prove_through_the_kernel_wrappers(monkeypatch):
    """Every SHA-256 and tree level of a TESTING proof dispatched as on the
    card, to the K1/K2 wrappers around an emulated launch (the layouts the
    kernels get: strided tree levels, the PoW candidates): the proof equals
    the fixture, with one K1 launch a hash call and one K2 launch a level."""
    monkeypatch.setattr(TS, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(TM, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(ck, "_check", lambda *a, **k: None)
    monkeypatch.setattr(ck, "_launch", _emulated_launch)
    ck.reset_launches()
    proof, _ = TPROVER.prove(TESTING, device="cpu")
    assert_proofs_equal(proof, TP.load_npz(str(PC.fixture_path(TESTING))))
    # K1: trace and CP leaves; 2 root mixes, the cp_alpha draw (2), the CP
    # root, the OODS point (2), its mix, deep_alpha (2); per FRI layer its
    # leaves, root mix and alpha draw (2); fri_last; one PoW chunk; the
    # nonce; one query draw.  K2: one launch a level of each tree.
    n_layers = 1 + TESTING.n_inner_layers
    lde = TESTING.lde_log_size
    assert ck.launches["sha256_words"] == 2 + 2 + 2 + 1 + 2 + 1 + 2 + 4 * n_layers + 1 + 1 + 1 + 1
    assert ck.launches["sha256_pair"] == 2 * lde + sum(lde - l for l in range(n_layers))
    assert ck.launches["merkle_walk"] == 0


def _transcript_state(cfg):
    """The channel state the TESTING prover grinds on."""
    seen = []
    grind = TPROVER.pow_grind

    def spy(cfg_, state):
        seen.append(state)
        return grind(cfg_, state)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TPROVER, "pow_grind", spy)
        TPROVER.prove(cfg, device="cpu")
    return to_numpy(seen[0].digest)


def _hashlib_nonce(digest, target) -> int:
    """The smallest nonce whose mix sha256(digest || hi || lo) reads below
    the target: words 7 and 6 of the digest, each byte-swapped, as hi, lo."""
    prefix = np.asarray(digest, dtype=">u4").tobytes()
    for nonce in itertools.count():
        d = hashlib.sha256(prefix + nonce.to_bytes(8, "big")).digest()
        if (int.from_bytes(d[28:32], "little") << 32 | int.from_bytes(d[24:28], "little")) < target:
            return nonce


@pytest.fixture(scope="module")
def testing_state():
    return _transcript_state(TESTING)


@pytest.mark.parametrize("pow_bits", [5, 8, 10])
@pytest.mark.parametrize("source", ["testing", "random1", "random2"])
def test_pow_grind_finds_the_smallest_nonce(testing_state, source, pow_bits):
    if source == "testing":
        digest = testing_state
    else:
        digest = np.random.default_rng(int(source[-1])).integers(0, 1 << 32, 8, dtype=np.uint32)
    cfg = dataclasses.replace(TESTING, pow_bits=pow_bits)
    state = TPROVER.ch.ChannelState(from_numpy(digest), torch.tensor(3))
    got = to_numpy(TPROVER.pow_grind(cfg, state))
    want = _hashlib_nonce(digest, cfg.pow_target)
    assert got.shape == (2,) and (int(got[0]) << 32 | int(got[1])) == want
    if source == "testing" and pow_bits == TESTING.pow_bits:
        fixture = TP.load_npz(str(PC.fixture_path(TESTING)))
        np.testing.assert_array_equal(got, fixture.pow_nonce)


def test_save_npz_equals_jax(tmp_path):
    """The port's save_npz writes JAX's keys and dtypes, and JAX's load_npz
    reads the proof back equal."""
    proof = TP.load_npz(str(PC.fixture_path(TESTING)))
    TP.save_npz(str(tmp_path / "port.npz"), proof)
    JP.save_npz(str(tmp_path / "jax.npz"), JP.StwoProof(*proof))
    with np.load(tmp_path / "port.npz") as got, np.load(tmp_path / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
            np.testing.assert_array_equal(got[key], want[key])
    assert_proofs_equal(TP.StwoProof(*JP.load_npz(str(tmp_path / "port.npz"))), proof)


def test_cached_proof_is_made_written_and_served(tmp_path, monkeypatch):
    """A (cfg, seed) with no fixture (TESTING s4) is proved by the port,
    written under the cache directory, and served from disk next time; the
    proof verifies, and a committed fixture is still served as it is."""
    monkeypatch.setattr(PC, "CACHE", tmp_path)
    with pytest.raises(FileNotFoundError):
        PC.fixture_path(TESTING, seed=4)
    made = PC.cached_stwo_proof(TESTING, seed=4, device="cpu")
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == [f"stwo_wide_fibonacci_{PC._cfg_hash(TESTING)}_s4_"
                                       f"{PC.source_hash()}.npz"]
    assert TV.verify_batch(TP.to_torch(made), TESTING).item()
    s3 = TP.load_npz(str(PC.fixture_path(TESTING, seed=3)))
    assert not np.array_equal(made.commitments, s3.commitments)

    def no_prover(*args, **kwargs):
        raise AssertionError("the cached proof should have been served")

    monkeypatch.setattr(TPROVER, "prove", no_prover)
    assert_proofs_equal(PC.cached_stwo_proof(TESTING, seed=4, device="cpu"), made)
    assert_proofs_equal(PC.cached_stwo_proof(TESTING, seed=3), s3)
    assert list(tmp_path.iterdir()) == files
