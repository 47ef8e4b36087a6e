"""The port's stark101 family against the JAX package and the golden proof.

* The slice as a whole: one batch of lane 0 clean and the
  ``chip_smoke.STARK101_TAMPERS`` classes in lanes 1-10 (the batch the
  card's smoke run rejects) goes once through JAX's ``verify``, eagerly,
  with its compressions jitted (``jit_jax_compress``), and once through
  the port's ``verify`` on the CPU: ``ok`` and all 23 masks equal, in the
  same key order.  The same batch also goes through the port's verifier
  with every SHA-256 and Merkle call sent to the K1/K3 wrappers around an
  emulated launch.
* The prover: the port's ``prove`` on the CPU must give
  ``tests/fixtures/stark101/golden_proof.json`` word for word (the JAX
  prover, tested in test_stark101.py, gives the same proof), its JSON
  export the fixture's JSON, and its proof must verify.
* The pieces: the channel, the configuration's derived constants,
  ``load_json`` and ``to_torch`` against the JAX package's.

Integer arithmetic: every comparison is exact.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_symphony_tpu.models.stark101 import channel as JC
from stark_symphony_tpu.models.stark101 import proof as JP
from stark_symphony_tpu.models.stark101 import verifier as JV
from stark_symphony_tpu.models.stark101.config import Stark101Config as JConfig
from stark_symphony_tpu_torch import entry as E
from stark_symphony_tpu_torch.models.stark101 import channel as TC
from stark_symphony_tpu_torch.models.stark101 import proof as TP
from stark_symphony_tpu_torch.models.stark101 import prover as TPR
from stark_symphony_tpu_torch.models.stark101 import verifier as TV
from stark_symphony_tpu_torch.models.stark101.config import Stark101Config
from stark_symphony_tpu_torch.ops import merkle as TM
from stark_symphony_tpu_torch.ops import sha256 as TS
from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
from stark_symphony_tpu_torch.ops.u32 import from_numpy, to_numpy
from stark_symphony_tpu_torch.parallel.pipeline import StreamVerifier
from chip_smoke import STARK101_TAMPERS, stark101_tamper_batch
import test_stark101
from test_torch_sha256 import _emulated_launch
from test_torch_sha256 import jit_jax_compress  # noqa: F401 (autouse)

CFG = Stark101Config()
N_LAYERS = CFG.n_fri_layers
MASK_KEYS = ([f"fri_beta_{i}" for i in range(N_LAYERS)] + ["trace_merkle"]
             + [f"fri_carry_{i}" for i in range(N_LAYERS)] + ["fri_merkle", "fri_last"])


def _fields_equal(got, want):
    for name in TP.Stark101Proof._fields:
        g, w = getattr(got, name), getattr(want, name)
        pairs = list(zip(g, w)) if isinstance(w, tuple) else [(g, w)]
        if isinstance(w, tuple):
            assert isinstance(g, tuple) and len(g) == len(w), name
        for a, b in pairs:
            a = to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
            assert a.dtype == np.uint32 and a.shape == np.shape(b), name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def golden(fixtures_dir):
    return TP.load_json(str(fixtures_dir / "stark101" / "golden_proof.json"))


@pytest.fixture(scope="module")
def results(golden):
    """The tamper batch through JAX's verify (once, eagerly) and the
    port's, on the CPU."""
    batch = stark101_tamper_batch(golden)
    jok, jmasks = JV.verify(JP.Stark101Proof(*batch), JConfig())
    tok, tmasks = TV.verify(TP.to_torch(batch), CFG)
    return {
        "jax": (np.asarray(jok), {k: np.asarray(v) for k, v in jmasks.items()}),
        "port": (tok.numpy(), {k: v.numpy() for k, v in tmasks.items()}),
    }


@pytest.fixture(scope="module")
def proved():
    return TPR.prove(CFG, device="cpu")


def test_mask_keys_in_jax_order(results):
    assert list(results["jax"][1]) == MASK_KEYS
    assert list(results["port"][1]) == MASK_KEYS


@pytest.mark.parametrize("key", MASK_KEYS)
def test_mask_equals_jax(results, key):
    got, want = results["port"][1][key], results["jax"][1][key]
    assert got.dtype == np.bool_ and got.shape == (1 + len(STARK101_TAMPERS),)
    np.testing.assert_array_equal(got, want)


def test_accept_bitmap(results):
    got, want = results["port"][0], results["jax"][0]
    np.testing.assert_array_equal(got, want)
    assert got[0] and not got[1:].any()


def test_verify_through_the_kernel_wrappers(golden, results, monkeypatch):
    """The verifier with every SHA-256 and Merkle call dispatched as on the
    card, to the K1 and K3 wrappers around an emulated launch: 1-word
    messages at 3 and 20 lanes a proof, depths 13..4 with period 20.  31 K1
    and 2 K3 launches, and every mask equal to JAX's."""
    monkeypatch.setattr(TS, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(TM, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(ck, "_check", lambda *a, **k: None)
    seen = []

    def launch(name, device, *args):
        seen.append((name, args))
        _emulated_launch(name, device, *args)

    monkeypatch.setattr(ck, "_launch", launch)
    ok, masks = TV.verify(TP.to_torch(stark101_tamper_batch(golden)), CFG)
    names = [n for n, _ in seen]
    assert names.count("sha256_words") == 31 and names.count("merkle_walk") == 2
    assert len(names) == 33
    lanes = 1 + len(STARK101_TAMPERS)
    k1_ones = [a[3] for n, a in seen if n == "sha256_words" and a[2] == 1]
    assert k1_ones == [3 * lanes, 20 * lanes]
    walks = [a for n, a in seen if n == "merkle_walk"]
    assert walks[0][2] is None and walks[0][6:8] == (13, 3 * lanes)
    assert walks[1][3] == 20 and walks[1][6:8] == (13, 20 * lanes)
    assert walks[1][2].tolist() == np.repeat(np.arange(13, 3, -1), 2).tolist()
    jok, jmasks = results["jax"]
    assert list(masks) == list(jmasks)
    for k in jmasks:
        np.testing.assert_array_equal(masks[k].numpy(), jmasks[k], err_msg=k)
    np.testing.assert_array_equal(ok.numpy(), jok)


def test_tamper_classes_include_the_jax_suite(golden):
    """STARK101_TAMPERS holds test_stark101.py's five classes first, each on
    the same field with the same result on a sample array, then one class
    for each other field; the batch tampers lane k alone by class k."""
    mark = next(m for m in test_stark101.test_tampered_rejected.pytestmark
                if m.name == "parametrize")
    jax_list = mark.args[1]
    assert [f for f, _ in jax_list] == [f for f, _, _ in STARK101_TAMPERS[:5]]
    sample = np.array([0, 1, 7, TV.F.Q - 1, 0xFFFFFFFE], dtype=np.uint32)
    for (_, jmut), (_, mut, idx) in zip(jax_list, STARK101_TAMPERS):
        assert idx is None
        np.testing.assert_array_equal(mut(sample.copy()).astype(np.uint32), jmut(sample.copy()))
    assert ({f for f, _, _ in STARK101_TAMPERS} == set(TP.Stark101Proof._fields))
    batch = stark101_tamper_batch(golden)
    for lane, (field, _, idx) in enumerate(STARK101_TAMPERS, 1):
        arr = getattr(batch, field) if idx is None else getattr(batch, field)[idx]
        clean = getattr(golden, field) if idx is None else getattr(golden, field)[idx]
        changed = [k for k in range(len(arr)) if not np.array_equal(arr[k], clean)]
        assert changed == [lane], field


def test_prover_reproduces_the_golden_proof(golden, proved):
    proof, info = proved
    _fields_equal(proof, golden)
    assert info == {"idx": 6160}


def test_prover_json_equals_the_fixture(fixtures_dir, proved):
    with open(fixtures_dir / "stark101" / "golden_proof.json") as f:
        assert TP.to_json_dict(proved[0]) == json.load(f)


def test_prove_then_verify(proved):
    ok, masks = TV.verify(TP.to_torch(proved[0]), CFG)
    assert ok.shape == () and bool(ok), [k for k, v in masks.items() if not bool(v)]


def test_stream_equals_jax(golden, results):
    """The numpy tamper batch through the port's stream: JAX's bitmap."""
    stream = StreamVerifier(TV.verify_batch, device="cpu")
    stream.feed(stark101_tamper_batch(golden))
    (got,) = stream.finish()
    np.testing.assert_array_equal(got.numpy(), results["jax"][0])


def test_entry_stark101_on_cpu():
    fn, (batch,) = E.entry_stark101(n_proofs=8, device="cpu")
    assert tuple(batch.eval_sibs.shape) == (8, 3, 13, 8)
    assert [tuple(s.shape) for s in batch.cpa_sibs] == [(8, 13 - i, 8) for i in range(10)]
    bitmap = fn(batch)
    assert bitmap.dtype == torch.bool and bitmap.tolist() == [True] * 8


def test_channel_equals_jax():
    """draw (mod q and mod 8192), mix_words and mix_u32 on seeded states,
    with a batch axis."""
    rng = np.random.default_rng(101)
    state = rng.integers(0, 1 << 32, (6, 8), dtype=np.uint64).astype(np.uint32)
    root = rng.integers(0, 1 << 32, (6, 8), dtype=np.uint64).astype(np.uint32)
    value = rng.integers(0, 1 << 32, (6,), dtype=np.uint64).astype(np.uint32)
    ts, js = from_numpy(state), jnp.asarray(state)
    for m in (TV.F.Q, CFG.domain_ex_size):
        (tn, tv), (jn, jv) = TC.draw(ts, m), JC.draw(js, m)
        np.testing.assert_array_equal(to_numpy(tn), np.asarray(jn))
        np.testing.assert_array_equal(to_numpy(tv), np.asarray(jv))
    np.testing.assert_array_equal(to_numpy(TC.mix_words(ts, from_numpy(root))),
                                  np.asarray(JC.mix_words(js, jnp.asarray(root))))
    np.testing.assert_array_equal(to_numpy(TC.mix_u32(ts, from_numpy(value))),
                                  np.asarray(JC.mix_u32(js, jnp.asarray(value))))


def test_config_equals_jax():
    """The derived constants of test_stark101.py::test_derived_constants,
    and every property equal to the JAX package's."""
    assert CFG.coset_gen == 1734477367
    assert CFG.g_pow(1022) == 2450347685
    assert CFG.g_pow(1021) == 2342081930
    assert CFG.g_pow(1023) == 532203874
    j = JConfig()
    assert CFG.__dict__ == j.__dict__
    for name in ("domain_ex_size", "log_domain_ex", "n_fri_layers", "subgroup_gen",
                 "coset_gen"):
        assert getattr(CFG, name) == getattr(j, name), name


def test_load_json_equals_jax(fixtures_dir, golden):
    jproof = JP.load_json(str(fixtures_dir / "stark101" / "golden_proof.json"))
    _fields_equal(golden, jproof)
    assert [s.shape for s in golden.cpb_sibs] == [(13 - i, 8) for i in range(10)]


def test_to_torch_of_the_jax_proof(fixtures_dir):
    """The JAX package's proof, one and replicated, carried to int64 word
    tensors: same words, tuple fields kept, a 0-d last kept 0-d."""
    jproof = JP.load_json(str(fixtures_dir / "stark101" / "golden_proof.json"))
    one = TP.to_torch(jproof)
    assert isinstance(one, TP.Stark101Proof) and one.last.shape == ()
    assert all(t.dtype == torch.int64 for t in one.cpa_sibs)
    _fields_equal(one, jproof)
    batch = TP.to_torch(JP.replicate(jproof, 3))
    _fields_equal(batch, TP.replicate(jproof, 3))
    _fields_equal(TP.stack([jproof, jproof, jproof]), TP.replicate(jproof, 3))
    assert int(one.p_mt_root.max()) >= 1 << 31
