"""The port's Fiat-Shamir channel and circle helpers against the JAX package.

Transcript draws and mixes on a seeded batch of channel states, the query
point table, both branches of ``query_points``, the FRI fold coordinates
with their batch inversion, and the vanishing polynomial.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_symphony_tpu.models.stwo import channel as JC
from stark_symphony_tpu.models.stwo import verifier as JV
from stark_symphony_tpu.models.stwo.config import TESTING
from stark_symphony_tpu.ops import circle as JCi
from stark_symphony_tpu_torch.models.stwo import channel as TC
from stark_symphony_tpu_torch.models.stwo import verifier as TV
from stark_symphony_tpu_torch.ops import circle as TCi
from stark_symphony_tpu_torch.ops.u32 import from_numpy, to_numpy
from test_torch_sha256 import jit_jax_compress  # noqa: F401 (autouse)

B = 5


@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(31)
    digest = rng.integers(0, 1 << 32, (B, 8), dtype=np.uint32)
    counter = rng.integers(0, 4, B, dtype=np.uint32)
    payload = rng.integers(0, 1 << 32, (B, 80), dtype=np.uint32)
    return (JC.ChannelState(jnp.asarray(digest), jnp.asarray(counter)),
            TC.ChannelState(from_numpy(digest), from_numpy(counter)),
            payload)


def _eq(t, j):
    got = t.numpy() if t.dtype == torch.bool else to_numpy(t)
    np.testing.assert_array_equal(got, np.asarray(j))


def _eq_state(ts, js):
    _eq(ts.digest, js.digest)
    _eq(ts.counter, js.counter)


def test_draw_and_mix(states):
    js, ts, payload = states
    js2, jw = JC.draw_words(js)
    ts2, tw = TC.draw_words(ts)
    _eq(tw, jw)
    _eq_state(ts2, js2)
    for n in (8, 80):  # mix_root and the OODS payload
        _eq_state(TC.mix_words(ts, from_numpy(payload[:, :n])),
                  JC.mix_words(js, jnp.asarray(payload[:, :n])))
    _eq_state(TC.mix_u64(ts, from_numpy(payload[:, 0]), from_numpy(payload[:, 1])),
              JC.mix_u64(js, jnp.asarray(payload[:, 0]), jnp.asarray(payload[:, 1])))


@pytest.mark.parametrize("n", [4, 8])
def test_draw_m31(states, n):
    js, ts, _ = states
    jst, jv, jok = JC.draw_m31(js, n)
    tst, tv, tok = TC.draw_m31(ts, n)
    _eq(tv, jv)
    _eq(tok, jok)
    _eq_state(tst, jst)


def test_draw_qm31_point_and_queries(states):
    js, ts, _ = states
    jst, jp, jok = JC.draw_qm31_point(js)
    tst, tp, tok = TC.draw_qm31_point(ts)
    assert tuple(tp.shape) == (B, 2, 4)
    _eq(tp, jp)
    _eq(tok, jok)
    _eq_state(tst, jst)
    for nq, log in ((1, 4), (20, 20)):
        jst, jq = JC.draw_queries(js, nq, log)
        tst, tq = TC.draw_queries(ts, nq, log)
        _eq(tq, jq)
        _eq_state(tst, jst)


@pytest.mark.parametrize("log_size", [4, 13])
def test_query_point_table(log_size):
    np.testing.assert_array_equal(TCi.query_point_table(log_size),
                                  JCi.query_point_table(log_size))


@pytest.mark.parametrize("lde_log", [4, 13])
def test_query_points_both_branches(lde_log, monkeypatch):
    cfg = dataclasses.replace(TESTING, lde_log_size=lde_log)
    rng = np.random.default_rng(11)
    q = np.concatenate([rng.integers(0, 1 << lde_log, 60).astype(np.uint32),
                        np.array([0, 1, (1 << lde_log) - 1], np.uint32)])
    want = np.asarray(JV.query_points(cfg, jnp.asarray(q)))
    via_table = to_numpy(TV.query_points(cfg, from_numpy(q)))
    np.testing.assert_array_equal(via_table, want)
    monkeypatch.setattr(TV, "_POINT_TABLE_MAX_LOG", lde_log - 1)
    via_scalar = to_numpy(TV.query_points(cfg, from_numpy(q)))
    np.testing.assert_array_equal(via_scalar, want)


@pytest.mark.parametrize("lde_log,n_inner", [(4, 2), (13, 8)])
def test_fri_fold_coords_and_batch_inv(lde_log, n_inner):
    cfg = dataclasses.replace(TESTING, lde_log_size=lde_log, n_inner_layers=n_inner)
    rng = np.random.default_rng(7)
    q = rng.integers(0, 1 << lde_log, size=(3, 33)).astype(np.uint32)
    jpts = JV.query_points(cfg, jnp.asarray(q))
    jc = JV.fri_fold_coords(cfg, jnp.asarray(q), jpts)
    tpts = TV.query_points(cfg, from_numpy(q))
    tc = TV.fri_fold_coords(cfg, from_numpy(q), tpts)
    assert len(tc) == len(jc) == 1 + n_inner
    for t, j in zip(tc, jc):
        _eq(t, j)
    # zeros keep inv(0) = 0 inside the Montgomery batch
    jc[1] = jc[1].at[0, :5].set(0)
    tc[1][0, :5] = 0
    for t, j in zip(TV.batch_inv_m31(tc), JV.batch_inv_m31(jc)):
        _eq(t, j)


def test_vanishing_poly_eval():
    rng = np.random.default_rng(5)
    pts = rng.integers(0, 1 << 32, (7, 2, 4), dtype=np.uint32)
    for log in (3, 9):
        _eq(TCi.vanishing_poly_eval(log, from_numpy(pts)),
            JCi.vanishing_poly_eval(log, jnp.asarray(pts)))
