"""The stark101 prover's polynomial and tree ops against the JAX package:
``ops/ntt.py`` (NTT, INTT, coset evaluation) and ``merkle.build_tree`` /
``merkle.gather_path``, on seeded words, exactly.  ``build_tree`` also runs
through kernel K2's wrapper around an emulated launch, so the strided
operands it hands the kernel (a level's even and odd rows) are checked
here too.  The JAX reference's NTTs run jitted: eagerly, each of its
stages compiles every operator anew for its own shapes (12 s at n = 1,024
against 1 s).  The values are the same."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stark_symphony_tpu.ops import field101 as JF
from stark_symphony_tpu.ops import merkle as JM
from stark_symphony_tpu.ops import ntt as JN
from stark_symphony_tpu_torch.ops import merkle as TM
from stark_symphony_tpu_torch.ops import ntt as TN
from stark_symphony_tpu_torch.ops import sha256 as TS
from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
from stark_symphony_tpu_torch.ops.u32 import from_numpy, to_numpy
from test_torch_sha256 import _emulated_launch
from test_torch_sha256 import jit_jax_compress  # noqa: F401 (autouse)

Q = JF.Q


def _root(n: int) -> int:
    """A root of unity of order n (n a power of two dividing 2^30)."""
    return pow(JF.GEN, (Q - 1) // n, Q)


def _jax_ntt(x, root, inverse=False):
    return np.asarray(jax.jit(lambda v: JN.ntt(v, root, inverse))(jnp.asarray(x)))


def _jax_eval_on_coset(coeffs, offset, root, n_out):
    return np.asarray(jax.jit(lambda c: JN.eval_on_coset(c, offset, root, n_out))(
        jnp.asarray(coeffs)))


def _vals(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, Q, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n", [16, 1024])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_equals_jax(n, inverse):
    x = _vals((2, n), seed=n)
    got = to_numpy(TN.ntt(from_numpy(x), _root(n), inverse))
    np.testing.assert_array_equal(got, _jax_ntt(x, _root(n), inverse))
    if n == 16 and not inverse:  # the definition, X_k = sum_i x_i w^(ik)
        w = _root(n)
        want = [[sum(int(row[i]) * pow(w, i * k, Q) for i in range(n)) % Q
                 for k in range(n)] for row in x]
        np.testing.assert_array_equal(got, np.array(want, np.uint32))


@pytest.mark.parametrize("n", [16, 1024])
def test_intt_of_ntt_is_identity(n):
    x = _vals((3, n), seed=n + 1)
    y = TN.ntt(TN.ntt(from_numpy(x), _root(n)), _root(n), inverse=True)
    np.testing.assert_array_equal(to_numpy(y), x)


@pytest.mark.parametrize("n, n_out", [(16, 16), (16, 64), (1024, 1024)])
def test_eval_on_coset_equals_jax(n, n_out):
    coeffs = _vals((n,), seed=3 * n + n_out)
    got = to_numpy(TN.eval_on_coset(from_numpy(coeffs), JF.GEN, _root(n_out), n_out))
    want = _jax_eval_on_coset(coeffs, JF.GEN, _root(n_out), n_out)
    np.testing.assert_array_equal(got, want)
    # p(GEN * w^i) by Horner at two points
    w = _root(n_out)
    for i in (0, n_out - 1):
        pt, acc = JF.GEN * pow(w, i, Q) % Q, 0
        for c in coeffs[::-1]:
            acc = (acc * pt + int(c)) % Q
        assert int(got[i]) == acc


def test_ntt_rejects_a_wrong_root():
    with pytest.raises(ValueError):
        TN.ntt(from_numpy(_vals((16,), seed=1)), _root(32))


def _tree_case():
    rng = np.random.default_rng(16)
    leaves = rng.integers(0, 1 << 32, (16, 8), dtype=np.uint64).astype(np.uint32)
    index = rng.integers(0, 16, (5,), dtype=np.uint64).astype(np.uint32)
    return leaves, index


def test_build_tree_and_gather_path_equal_jax():
    """16 leaves: every level, and the paths of five leaves (an unbatched
    tree, as the prover's; the port's gather_path takes the five indices
    as one batch)."""
    leaves, index = _tree_case()
    got = TM.build_tree(from_numpy(leaves))
    want = JM.build_tree(jnp.asarray(leaves))
    assert [tuple(g.shape) for g in got] == [(16 >> k, 8) for k in range(5)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    paths = to_numpy(TM.gather_path(got, from_numpy(index)))
    assert paths.shape == (5, 4, 8)
    for i, path in zip(index, paths):  # JAX's takes one index on an unbatched tree
        np.testing.assert_array_equal(path, np.asarray(JM.gather_path(want, jnp.uint32(i))))
    # each path walks back to the root
    ok = TM.verify_path(got[0][from_numpy(index).long()], from_numpy(index),
                        from_numpy(paths), got[-1][0])
    assert ok.all()


def test_build_tree_through_the_kernel_wrapper(monkeypatch):
    """On the card each level is one K2 launch on the level's even and odd
    rows, read in place: around an emulated launch the wrapper gets the
    rows 16 words apart and the tree equals JAX's."""
    monkeypatch.setattr(TS, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(ck, "_check", lambda *a, **k: None)
    strides = []

    def launch(name, device, *args):
        strides.append((name, args[3], args[5:7]))
        _emulated_launch(name, device, *args)

    monkeypatch.setattr(ck, "_launch", launch)
    leaves, _ = _tree_case()
    got = TM.build_tree(from_numpy(leaves))
    # (kernel, lanes, row strides): 8 lanes, 4, 2, then 1 (a single row)
    assert strides == [("sha256_pair", 8, (16, 16)), ("sha256_pair", 4, (16, 16)),
                       ("sha256_pair", 2, (16, 16)), ("sha256_pair", 1, (8, 8))]
    for g, w in zip(got, JM.build_tree(jnp.asarray(leaves))):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
