"""The port's fused stages (``ops/fri.py``) against the JAX package's.

``leafwalk_plain`` (K4's plain version) and ``fri_all_layers_plain`` (K5's)
against ``fri_kernel.leafwalk_tiled`` and ``fri_kernel.fri_all_layers_tiled``,
which off the TPU run their own oracles (``_leafwalk_jnp``, ``_fri_jnp``),
as ``tests/test_tiled.py`` runs them.  Inputs come from a seed at M = 8
(1,024 lanes = 64 proofs x 16 queries; ``chip_smoke.leafwalk_case`` and
``fri_case``, the makers of the card's own checks): words >= P and >= 2^31
in every operand, and even proofs carry valid paths, so both ok values
occur.  The port takes per-proof roots and alphas; the JAX functions take
them broadcast to every lane.  Tolerance 0: the results are words.

The CUDA wrappers (``ops/cuda/fri_kernel.py``) are run here around an
emulated launch, so their argument checks and layout reach the CPU; the
kernels themselves are held to the plain versions on the card by
``chip_smoke.py``.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import fri_case, leafwalk_case
from stark_symphony_tpu.ops.pallas import fri_kernel as FK
from stark_symphony_tpu_torch.ops import fri
from stark_symphony_tpu_torch.ops.cuda import build
from stark_symphony_tpu_torch.ops.cuda import fri_kernel as fk
from stark_symphony_tpu_torch.ops.u32 import from_i32, to_i32, to_numpy

M, N_PROOFS, N_Q = 8, 64, 16  # 1,024 lanes


def _tiles(x):
    """(..., lanes) int64 words -> JAX (..., M, 128) uint32."""
    a = to_numpy(x)
    return jnp.asarray(a.reshape(a.shape[:-1] + (M, 128)))


def _lanes(x, n: int):
    """Per-proof (B, ...) -> (..., lanes): the JAX functions' broadcast."""
    a = np.repeat(to_numpy(x), n, axis=0)
    return np.moveaxis(a, 0, -1)


@pytest.mark.parametrize("n_words", [4, 16])
def test_leafwalk_equals_jax(n_words):
    depth = 4
    evals, idx, sibs, roots = leafwalk_case(np.random.default_rng(n_words),
                                            N_PROOFS, N_Q, n_words, depth)
    got = to_numpy(fri.leafwalk_plain(evals, idx, sibs, roots))
    want = np.asarray(FK.leafwalk_tiled(
        _tiles(evals), _tiles(idx[None]), _tiles(sibs),
        jnp.asarray(_lanes(roots, N_Q).reshape(8, M, 128)), n_words, depth))
    np.testing.assert_array_equal(got, want.reshape(-1))
    assert 0 < got.sum() < got.size
    assert to_numpy(evals).max() >= 1 << 31


def test_fri_all_layers_equals_jax():
    depths = (3, 2, 1)
    args = fri_case(np.random.default_rng(7), N_PROOFS, N_Q, depths)
    queries, evals, wits, cinvs, alphas, sibs, roots = args
    ok, folded, q_out = (to_numpy(r) for r in fri.fri_all_layers_plain(*args, depths))
    j_ok, j_folded, j_q = FK.fri_all_layers_tiled(
        _tiles(queries[None]), _tiles(evals), _tiles(wits), _tiles(cinvs),
        jnp.asarray(_lanes(alphas, N_Q).reshape(3, 4, M, 128)), _tiles(sibs),
        jnp.asarray(_lanes(roots, N_Q).reshape(3, 8, M, 128)), depths)
    np.testing.assert_array_equal(ok, np.asarray(j_ok).reshape(3, -1))
    np.testing.assert_array_equal(folded, np.asarray(j_folded).reshape(4, -1))
    np.testing.assert_array_equal(q_out, np.asarray(j_q).reshape(-1))
    assert ok.any() and not ok.all()
    for x in (evals, wits, cinvs, alphas):
        assert to_numpy(x).max() >= 1 << 31
        assert (to_numpy(x) >= 0x7FFFFFFF).mean() > 0.4


def test_dispatch_on_cpu_takes_the_plain_version(monkeypatch):
    """int32 arrays in, int32 out, through the plain versions; a CPU tensor
    never builds or loads the CUDA library, and a kernel wrapper refuses it."""
    def no_build():
        raise AssertionError("CUDA build reached from a CPU tensor")

    monkeypatch.setattr(build, "load", no_build)
    before = dict(fk.launches)
    lw = leafwalk_case(np.random.default_rng(1), 4, 4, 4, 3)
    got = fri.leafwalk(*[to_i32(a) for a in lw])
    assert got.dtype == torch.int32
    assert torch.equal(from_i32(got), fri.leafwalk_plain(*lw))
    depths = (2, 1)
    fa = fri_case(np.random.default_rng(2), 4, 4, depths)
    got = fri.fri_all_layers(*[to_i32(a) for a in fa], depths)
    for g, w in zip(got, fri.fri_all_layers_plain(*fa, depths)):
        assert g.dtype == torch.int32 and torch.equal(from_i32(g), w)
    assert fk.launches == before
    with pytest.raises(ValueError):
        fk.leafwalk(*[to_i32(a) for a in lw])
    with pytest.raises(ValueError):
        fk.fri_all_layers(*[to_i32(a) for a in fa], depths)
    with pytest.raises(ValueError):
        fri.leafwalk(*[to_i32(a).to("meta") for a in lw])


def _emulated_launch(name, device, *args):
    """What each CUDA kernel computes, lane by lane, on its int32 buffers,
    written with the plain versions; the layer depths are read back from
    the host array the wrapper passes by address."""
    if name == "leafwalk":
        evals, index, sibs, roots, ok, n_words, depth, n_q, lanes = args
        assert evals.shape == (n_words, lanes) and sibs.shape == (depth, 8, lanes)
        assert roots.shape[0] * n_q == lanes
        ok.copy_(to_i32(fri.leafwalk_plain(*map(from_i32, (evals, index, sibs, roots)))))
    else:
        *ins, ok, folded, q_out, depths_addr, n_layers, n_q, lanes = args
        depths = tuple((ctypes.c_int * n_layers).from_address(depths_addr))
        assert ins[4].shape == (lanes // n_q, n_layers, 4)
        res = fri.fri_all_layers_plain(*map(from_i32, ins), depths)
        for out, r in zip((ok, folded, q_out), res):
            out.copy_(to_i32(r))
    fk.launches[name] += 1


def test_kernel_wrappers_emulated(monkeypatch):
    """The wrappers' checks, outputs and per-proof operands around a
    lane-wise kernel give the plain results; a malformed operand raises."""
    def cpu_check(x, what, shape=None, device=None):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
            raise TypeError(what)
        if shape is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(what)
        if not x.is_contiguous():
            raise ValueError(what)

    monkeypatch.setattr(fk, "_check", cpu_check)
    monkeypatch.setattr(fk, "_launch", _emulated_launch)
    before = dict(fk.launches)
    lw = leafwalk_case(np.random.default_rng(3), 6, 5, 16, 4)
    got = fk.leafwalk(*[to_i32(a) for a in lw])
    assert torch.equal(from_i32(got), fri.leafwalk_plain(*lw))
    depths = (4, 3, 2, 1)
    fa = fri_case(np.random.default_rng(4), 6, 5, depths)
    got = fk.fri_all_layers(*[to_i32(a) for a in fa], depths)
    for g, w in zip(got, fri.fri_all_layers_plain(*fa, depths)):
        assert torch.equal(from_i32(g), w)
    assert fk.launches["leafwalk"] == before["leafwalk"] + 1
    assert fk.launches["fri_all_layers"] == before["fri_all_layers"] + 1
    bad = [to_i32(a) for a in fa]
    with pytest.raises(ValueError):  # sibs of the wrong total depth
        fk.fri_all_layers(*bad, (4, 3, 2, 2))
    with pytest.raises(ValueError):  # 30 lanes are not 7 proofs
        fk.leafwalk(*[to_i32(a) for a in lw[:3]], to_i32(lw[3][:1]).repeat(7, 1))
    with pytest.raises(ValueError):  # a transposed (non-contiguous) operand
        fk.leafwalk(to_i32(lw[0]).t().contiguous().t(), *[to_i32(a) for a in lw[1:]])
