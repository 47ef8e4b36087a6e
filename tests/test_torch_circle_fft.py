"""The port's circle FFT (``ops/circle_fft.py``) and the circle functions
the prover adds to ``ops/circle.py``, against the JAX package's, bit for
bit, on the same seeded words.  The JAX FFTs are jitted, once per (log
size, field) for all four: eagerly, each of their operations compiles
anew for every shape, seconds of CPU a case.  ``eval_at_point`` and
``line_position_to_x`` run eagerly, largest size first, so that the
shapes of the smaller sizes are compiled already."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_symphony_tpu.ops import circle as JC
from stark_symphony_tpu.ops import circle_fft as JF
from stark_symphony_tpu_torch.ops import circle as TC
from stark_symphony_tpu_torch.ops import circle_fft as TF
from stark_symphony_tpu_torch.ops.u32 import from_numpy, to_numpy

P = (1 << 31) - 1
LOGS = [6, 5, 4, 3, 2]  # largest first (see above)
FIELDS = ["m31", "qm31"]


def _words(seed, shape, canonical=False):
    """Seeded words: field elements, or any 32-bit words (P and above too)."""
    high = P if canonical else 1 << 32
    return np.random.default_rng(seed).integers(0, high, shape, dtype=np.uint32)


def _values(log, field, seed, canonical=False):
    """A batch of 3 vectors of 2^log M31 values, or QM31 values (..., 4)."""
    shape = (3, 1 << log) + ((4,) if field == "qm31" else ())
    return _words(seed, shape, canonical)


def _both(jfn, tfn, *args, jit=True):
    """(JAX result, port result) as numpy uint32, on the same numpy args."""
    want = np.asarray((jax.jit(jfn) if jit else jfn)(*[jnp.asarray(a) for a in args]))
    got = to_numpy(tfn(*[from_numpy(a) for a in args]))
    return want, got


@pytest.mark.parametrize("log", LOGS)
def test_twiddles_equal_jax(log):
    jl, jinv = JF.twiddles(log)
    tl, tinv = TF.twiddles(log)
    assert len(tl) == len(jl) == log
    for a, b in zip(tl + tinv, jl + jinv):
        assert a.dtype == np.uint32
        np.testing.assert_array_equal(a, b)
    for a, t in zip(tl + tinv, sum(TF.device_twiddles(log, torch.device("cpu")), ())):
        np.testing.assert_array_equal(to_numpy(t), a)


FFT_FUNCTIONS = ["cfft_eval", "cfft_interpolate", "embed_coeffs", "extend"]


def _jax_fft(log, field):
    """(input, {name: JAX result}) for the FFT functions at (log, field),
    all four in one jitted call (embed_coeffs and extend into log + 2)."""
    q = field == "qm31"
    x = _values(log, field, log)

    def all_four(v):
        return (JF.cfft_eval(v, log, q), JF.cfft_interpolate(v, log, q),
                JF.embed_coeffs(v, log, log + 2, q), JF.extend(v, log, log + 2, q))

    return x, dict(zip(FFT_FUNCTIONS, map(np.asarray, jax.jit(all_four)(jnp.asarray(x)))))


@pytest.fixture(scope="module")
def jax_fft():
    return functools.lru_cache(maxsize=None)(_jax_fft)


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("log", LOGS)
@pytest.mark.parametrize("name", FFT_FUNCTIONS)
def test_fft_equals_jax(jax_fft, name, log, field):
    x, want = jax_fft(log, field)
    q = field == "qm31"
    fn = getattr(TF, name)
    got = to_numpy(fn(from_numpy(x), log, q) if name.startswith("cfft")
                   else fn(from_numpy(x), log, log + 2, q))
    grow = 1 if name.startswith("cfft") else 4
    assert got.shape == x.shape[:1] + (grow << log,) + x.shape[2:]
    np.testing.assert_array_equal(got, want[name])


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("log", LOGS)
def test_eval_at_point_equals_jax(log, field):
    q = field == "qm31"
    coeffs = _values(log, field, 20 + log)
    point = _words(30 + log, (2, 4))
    want, got = _both(lambda c, p: JF.eval_at_point(c, log, p, q),
                      lambda c, p: TF.eval_at_point(c, log, p, q), coeffs, point,
                      jit=False)
    assert got.shape == (3, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("log", LOGS)
def test_interpolate_inverts_eval(log, field):
    """On field elements, interpolation undoes evaluation and the
    extension agrees with the small domain's evaluation at the embedded
    positions' polynomial: evaluating the embedded coefficients on the
    large domain and interpolating back gives them again."""
    q = field == "qm31"
    coeffs = from_numpy(_values(log, field, 40 + log, canonical=True))
    assert torch.equal(TF.cfft_interpolate(TF.cfft_eval(coeffs, log, q), log, q), coeffs)
    big = TF.embed_coeffs(coeffs, log, log + 1, q)
    assert torch.equal(TF.cfft_interpolate(TF.extend(TF.cfft_eval(coeffs, log, q), log,
                                                     log + 1, q), log + 1, q), big)


def test_eval_at_point_agrees_with_cfft_eval():
    """At a domain point (embedded into QM31), the one-point evaluation
    equals the FFT's value at that position."""
    log = 5
    coeffs = from_numpy(_values(log, "m31", 50, canonical=True))
    evals = TF.cfft_eval(coeffs, log)
    for pos in (0, 7, 16, 31):
        x, y = TF._host_point_at(int(TC.circle_position_to_index(TC.CircleDomain(log),
                                                                 torch.tensor(pos))))
        point = torch.tensor([[x, 0, 0, 0], [y, 0, 0, 0]])
        got = TF.eval_at_point(coeffs, log, point)
        assert got[:, 1:].eq(0).all() and torch.equal(got[:, 0], evals[:, pos])


@pytest.mark.parametrize("name", ["point_neg", "point_dbl"])
def test_point_ops_equal_jax(name):
    pts = _words(60, (64, 2))
    want, got = _both(getattr(JC, name), getattr(TC, name), pts)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("log", LOGS)
def test_line_and_bit_reverse_positions_equal_jax(log):
    pos = np.arange(16, dtype=np.uint32) % (1 << (log - 1))  # one shape for every log
    dom = (JC.LineDomain(log), TC.LineDomain(log))
    assert (dom[0].offset, dom[0].step) == (dom[1].offset, dom[1].step)
    want, got = _both(lambda p: JC.line_position_to_x(dom[0], p),
                      lambda p: TC.line_position_to_x(dom[1], p), pos, jit=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, TF.twiddles(log + 1)[0][1][pos])  # the line level's x
    all_pos = np.arange(1 << log, dtype=np.uint32)
    want, got = _both(lambda p: JC.bit_reverse_position(p, log),
                      lambda p: TC.bit_reverse_position(p, log), all_pos)
    np.testing.assert_array_equal(got, want)


def test_qm31_points_equal_jax():
    x, y = _words(70, (8, 4)), _words(71, (8, 4))
    want, got = _both(JC.qm31_point, TC.qm31_point, x, y)
    assert got.shape == (8, 2, 4)
    np.testing.assert_array_equal(got, want)
    p, q = _words(72, (8, 2, 4)), _words(73, (8, 2, 4))
    want, got = _both(JC.qm31_point_add, TC.qm31_point_add, p, q)
    np.testing.assert_array_equal(got, want)
