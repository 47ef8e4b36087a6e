"""The port's domain-sharded FRI (``parallel/fri_shard.py``) and sharded
stwo prover (``models/stwo/prover_sharded.py``) against the JAX package.

Each JAX sharded function runs once, jitted on the 8-device CPU mesh that
``tests/conftest.py`` provides: the stark101 fold at n = 256 over 3
stages, the stwo fold at lde 8 over 3 stages, and the stwo commit with its
levels at lde 7.  The port's counterparts run over 2, 4 and 8 CPU shards
and must equal them word for word, as must the port's single-device
oracles.  ``prove_sharded`` over 2 and 4 shards must give the committed
fixtures of the JAX prover word for word; no JAX prover runs here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stark_symphony_tpu.ops import field101 as JF101
from stark_symphony_tpu.parallel import fri_shard as JFS
from stark_symphony_tpu_torch import entry as E
from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.models.stwo import prover as TPROVER
from stark_symphony_tpu_torch.models.stwo import prover_sharded
from stark_symphony_tpu_torch.models.stwo import verifier as TV
from stark_symphony_tpu_torch.models.stwo.config import TESTING, TESTING_Q4, StwoConfig
from stark_symphony_tpu_torch.ops import field101 as F101
from stark_symphony_tpu_torch.ops import merkle as TM
from stark_symphony_tpu_torch.ops import sha256 as TS
from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
from stark_symphony_tpu_torch.ops.field import P as M31P
from stark_symphony_tpu_torch.ops.u32 import from_numpy, to_numpy
from stark_symphony_tpu_torch.parallel import fri_shard as FS
from stark_symphony_tpu_torch.parallel.mesh import Mesh, unshard
from stark_symphony_tpu_torch.utils.proofcache import fixture_path
from test_torch_prover import assert_proofs_equal
from test_torch_sha256 import _emulated_launch

SHARDS = [2, 4, 8]

# lde 2^18, blowup 2^4 like PRODUCTION (the JAX suite's BIG)
BIG = StwoConfig(trace_log_size=14, lde_log_size=18, n_queries=4, n_inner_layers=13,
                 pow_bits=5)


def _sp(n):
    return Mesh(["cpu"] * n, ("sp",))


def _jax_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:8]), ("sp",))


def _qm31(shape, seed):
    return np.random.default_rng(seed).integers(0, M31P, size=shape + (4,), dtype=np.uint32)


def _words(t):
    return to_numpy(t)


@pytest.fixture(scope="module")
def stark101_case():
    """The JAX suite's inputs (n = 256 over a coset, 3 betas) and JAX's
    sharded fold of them on 8 devices."""
    rng = np.random.default_rng(7)
    n, stages = 256, 3
    values = rng.integers(0, JF101.Q, n, dtype=np.uint64).astype(np.uint32)
    x0 = pow(JF101.GEN, 3, JF101.Q)
    xs = [pow(x0, i, JF101.Q) for i in range(n)]
    x_invs = np.array([pow(int(v), JF101.Q - 2, JF101.Q) for v in xs], np.uint32)
    betas = [int(rng.integers(1, JF101.Q)) for _ in range(stages)]
    jv, jx = JFS.stark101_fold_sharded(jnp.asarray(values), jnp.asarray(x_invs),
                                       [jnp.uint32(b) for b in betas], _jax_mesh(), stages)
    return values, x_invs, betas, stages, np.asarray(jv), np.asarray(jx)


@pytest.fixture(scope="module")
def stwo_fold_case():
    lde_log, stages = 8, 3
    values = _qm31((1 << lde_log,), 3)
    alphas = [_qm31((), 10 + s) for s in range(stages)]
    got = JFS.stwo_fold_sharded(jnp.asarray(values), [jnp.asarray(a) for a in alphas],
                                lde_log, _jax_mesh(), stages)
    return values, alphas, lde_log, stages, np.asarray(got)


@pytest.fixture(scope="module")
def stwo_commit_case():
    lde_log = 7
    values = _qm31((1 << lde_log,), 4)
    root, levels = JFS.stwo_commit_sharded(jnp.asarray(values), _jax_mesh(), return_levels=True)
    tree = [np.asarray(level) for level in JFS.natural_levels_to_tree(levels, lde_log)]
    return values, lde_log, np.asarray(root), tree


def test_stark101_fold_reference_equals_jax(stark101_case):
    values, x_invs, betas, stages, jv, jx = stark101_case
    v, x = FS.stark101_fold_reference(from_numpy(values), from_numpy(x_invs), betas, stages)
    np.testing.assert_array_equal(_words(v), jv)
    np.testing.assert_array_equal(_words(x), jx)
    assert FS._INV2 == JFS._INV2 and F101.Q == JF101.Q


@pytest.mark.parametrize("n_shards", SHARDS)
def test_stark101_fold_sharded_equals_jax(stark101_case, n_shards):
    values, x_invs, betas, stages, jv, jx = stark101_case
    mesh = _sp(n_shards)
    v, x = FS.stark101_fold_sharded(from_numpy(values), from_numpy(x_invs), betas, mesh, stages)
    assert len(v) == n_shards and all(t.shape == (256 // 8 // n_shards,) for t in v)
    np.testing.assert_array_equal(_words(unshard(mesh, v, "sp")), jv)
    np.testing.assert_array_equal(_words(unshard(mesh, x, "sp")), jx)


def test_stwo_fold_reference_equals_jax(stwo_fold_case):
    values, alphas, lde_log, stages, want = stwo_fold_case
    got = FS.stwo_fold_reference(from_numpy(values), FS.stwo_domain_points(lde_log),
                                 [from_numpy(a) for a in alphas], stages)
    np.testing.assert_array_equal(_words(got), want)
    np.testing.assert_array_equal(FS.stwo_domain_points(lde_log),
                                  np.asarray(JFS.stwo_domain_points(lde_log)))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_stwo_fold_sharded_equals_jax(stwo_fold_case, n_shards):
    values, alphas, lde_log, stages, want = stwo_fold_case
    mesh = _sp(n_shards)
    got = FS.stwo_fold_sharded(from_numpy(values), [from_numpy(a) for a in alphas], lde_log,
                               mesh, stages)
    np.testing.assert_array_equal(_words(unshard(mesh, got, "sp")), want)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_stwo_commit_sharded_equals_jax(stwo_commit_case, n_shards):
    """The root and every level, in tree order, equal JAX's sharded commit
    and the single-device tree (``prover._commit_leaves``)."""
    values, lde_log, want_root, want_tree = stwo_commit_case
    mesh = _sp(n_shards)
    root, levels = FS.stwo_commit_sharded(from_numpy(values), mesh, return_levels=True)
    np.testing.assert_array_equal(_words(root), want_root)
    assert _words(FS.stwo_commit_sharded(from_numpy(values), mesh)).tolist() == want_root.tolist()
    tree = FS.natural_levels_to_tree(levels, lde_log)
    single, single_root = TPROVER._commit_leaves(from_numpy(values), lde_log)
    assert len(tree) == len(want_tree) == len(single) == lde_log + 1
    for got, want, one in zip(tree, want_tree, single):
        np.testing.assert_array_equal(_words(got), want)
        np.testing.assert_array_equal(_words(one), want)
    np.testing.assert_array_equal(_words(single_root), want_root)


@pytest.mark.parametrize("cfg,n_shards,n_layers", [
    (TESTING, 2, 3), (TESTING, 4, 2), (TESTING_Q4, 2, 3),
], ids=["testing-2", "testing-4", "testing_q4-2"])
def test_prove_sharded_equals_fixture(cfg, n_shards, n_layers):
    """The sharded prover's proof equals the JAX prover's committed one;
    over 4 shards the last layer (4 values) is too small to shard and
    commits and folds on the first device."""
    proof, info = prover_sharded.prove_sharded(cfg, _sp(n_shards))
    assert info == {"n_sharded_layers": n_layers}
    assert_proofs_equal(proof, TP.load_npz(str(fixture_path(cfg))))


def test_prove_sharded_through_the_kernel_wrappers(monkeypatch):
    """Over 4 shards with every SHA-256 and tree level dispatched as on the
    card, to the K1/K2 wrappers around an emulated launch: the fixture,
    with one K1 launch a shard for a sharded layer's leaves and, on a layer
    of log n over D shards, n - log2 D levels of D/2 K2 launches and
    log2 D top levels of one (the single-device prover's counts where a
    layer is not sharded; test_torch_prover holds those)."""
    monkeypatch.setattr(TS, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(TM, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(ck, "_check", lambda *a, **k: None)
    monkeypatch.setattr(ck, "_launch", _emulated_launch)
    ck.reset_launches()
    proof, info = prover_sharded.prove_sharded(TESTING, _sp(4))
    assert_proofs_equal(proof, TP.load_npz(str(fixture_path(TESTING))))
    # layers of log 4 and 3 sharded (16 and 8 values over 4 shards), log 2 not
    single_k1 = 2 + 2 + 2 + 1 + 2 + 1 + 2 + 4 * 3 + 1 + 1 + 1 + 1
    assert info == {"n_sharded_layers": 2}
    assert ck.launches["sha256_words"] == single_k1 + 2 * (4 - 1)
    assert ck.launches["sha256_pair"] == 2 * 4 + (2 * (4 - 2) + 2) + (2 * (3 - 2) + 2) + 2
    assert ck.launches["merkle_walk"] == 0


def test_prove_stwo_sharded_entry():
    proof, info = E.prove_stwo_sharded(TESTING, seed=1, n_shards=2, device="cpu")
    assert info == {"n_sharded_layers": 3}
    assert_proofs_equal(proof, TP.load_npz(str(fixture_path(TESTING, 1))))


@pytest.mark.slow
def test_sharded_prove_verifies_at_lde_18():
    """JAX's big-domain case on the port: proved over 8 CPU shards,
    accepted by the standard verifier; a flipped FRI witness word is
    rejected."""
    proof, info = prover_sharded.prove_sharded(BIG, _sp(8))
    assert info["n_sharded_layers"] >= 10
    ok, masks = TV.verify(TP.to_torch(proof), BIG)
    assert bool(ok), [k for k, v in masks.items() if not bool(v)]
    bad_wits = tuple(w.copy() for w in proof.fri_witnesses)
    bad_wits[6][1, 2] ^= 1
    ok2, _ = TV.verify(TP.to_torch(proof._replace(fri_witnesses=bad_wits)), BIG)
    assert not bool(ok2)
