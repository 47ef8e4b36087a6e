"""The port's stwo verifier against the JAX package, mask for mask.

Two 16-proof batches at TESTING size, each with lane 0 clean and the 15
tamper classes in lanes 1-15 (``chip_smoke.tamper_batch``, the same batch
the card's smoke run rejects; a test holds its list to the JAX suite's
``test_pow_production.PROD_TAMPERS``):

* an own-prover TESTING proof under ``linkage="reference"``;
* the external fixture ``tests/fixtures/stwo/proof_test.json`` under
  ``linkage="unfold"``.

TESTING proofs have 3 FRI layers, so the classes that tamper layer 4 and 5
(of PRODUCTION's 9) tamper layer 4 % 3 = 1 and 5 % 3 = 2.  Each batch runs
once per package per module (JAX eagerly: the jitted verifier costs
minutes to compile on CPU), and every mask of the port must equal JAX's,
bit for bit, in the same key order.
"""

import numpy as np
import pytest
import torch

from stark_symphony_tpu.models.stwo import proof as JP
from stark_symphony_tpu.models.stwo import verifier as JV
from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.models.stwo import verifier as TV
from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION, TESTING
from stark_symphony_tpu_torch.utils.proofcache import cached_stwo_proof
from chip_smoke import PROD_TAMPERS, tamper_batch
import test_pow_production
from test_torch_sha256 import jit_jax_compress  # noqa: F401 (autouse)

MASK_KEYS = (
    ["draw_cp_alpha", "draw_oods_point", "oods_cp_match", "draw_deep_alpha",
     "draw_fri_alpha_first", "draw_fri_alpha_0", "draw_fri_alpha_1", "pow",
     "trace_merkle", "cp_merkle", "fri_merkle_0", "fri_merkle_1",
     "fri_merkle_2", "fri_last_eval"]
)
CASES = ["own_reference", "fixture_unfold"]


def _run_both(proof, cfg, linkage):
    batch = tamper_batch(proof, 1 + cfg.n_inner_layers)
    jok, jmasks = JV.verify(JP.StwoProof(*batch), cfg, linkage=linkage)
    tok, tmasks = TV.verify(TP.to_torch(batch), cfg, linkage=linkage)
    return {
        "jax": (np.asarray(jok), {k: np.asarray(v) for k, v in jmasks.items()}),
        "port": (tok.numpy(), {k: v.numpy() for k, v in tmasks.items()}),
    }


@pytest.fixture(scope="module")
def results(fixtures_dir):
    ext, ext_cfg = TP.load_json(str(fixtures_dir / "stwo" / "proof_test.json"))
    assert ext_cfg == TESTING
    return {
        "own_reference": _run_both(cached_stwo_proof(TESTING), TESTING, "reference"),
        "fixture_unfold": _run_both(ext, TESTING, "unfold"),
    }


@pytest.mark.parametrize("case", CASES)
def test_mask_keys_in_order(results, case):
    assert list(results[case]["jax"][1]) == MASK_KEYS
    assert list(results[case]["port"][1]) == MASK_KEYS


@pytest.mark.parametrize("key", MASK_KEYS)
@pytest.mark.parametrize("case", CASES)
def test_mask_equals_jax(results, case, key):
    got = results[case]["port"][1][key]
    want = results[case]["jax"][1][key]
    assert got.dtype == np.bool_ and got.shape == (1 + len(PROD_TAMPERS),)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_accept_bitmap(results, case):
    got, want = results[case]["port"][0], results[case]["jax"][0]
    np.testing.assert_array_equal(got, want)
    assert got[0], "the clean lane must be accepted"
    # at TESTING size a nonce change can land on a valid transcript (one
    # query mod 16, 5 PoW bits); every other class must be rejected
    nonce_lane = 1 + [t[0] for t in PROD_TAMPERS].index("pow_nonce")
    others = np.delete(got[1:], nonce_lane - 1)
    assert not others.any()


def test_tamper_classes_match_the_jax_suite():
    """chip_smoke's tamper list makes the batch that the JAX suite's
    PROD_TAMPERS makes, class for class, on a PRODUCTION proof."""
    proof = cached_stwo_proof(PRODUCTION, seed=0)
    jax_list = test_pow_production.PROD_TAMPERS
    assert [(f, i) for f, _, i in PROD_TAMPERS] == [(f, i) for f, _, i in jax_list]
    want = TP.replicate(proof, 1 + len(jax_list))
    for lane, (field, mutate, idx) in enumerate(jax_list, 1):
        arr = getattr(want, field) if idx is None else getattr(want, field)[idx]
        arr[lane] = mutate(arr[lane])
    got = tamper_batch(proof, 1 + PRODUCTION.n_inner_layers)
    for name, g, w in zip(TP.StwoProof._fields, got, want):
        for ga, wa in zip(g if isinstance(g, tuple) else (g,),
                          w if isinstance(w, tuple) else (w,)):
            assert ga.dtype == wa.dtype, name
            np.testing.assert_array_equal(ga, wa, err_msg=name)


def test_verify_batch_is_verify_ok():
    proof = cached_stwo_proof(TESTING)
    batch = TP.to_torch(tamper_batch(proof, 3))
    ok, _ = TV.verify(batch, TESTING)
    assert torch.equal(TV.verify_batch(batch, TESTING), ok)
    with pytest.raises(ValueError):
        TV.verify(batch, TESTING, linkage="none")


def test_production_fixture_accepted_on_cpu():
    """Port only: the PRODUCTION fixture s0 verifies under full linkage."""
    ok, masks = TV.verify(TP.to_torch(cached_stwo_proof(PRODUCTION, seed=0)),
                          PRODUCTION)
    assert bool(ok), [k for k, v in masks.items() if not bool(v)]
    assert "fri_merkle_8" in masks and len(masks) == 26


@pytest.mark.slow
def test_production_tamper_matrix_equals_jax():
    """The 15 classes at PRODUCTION size: every mask equal to JAX's."""
    res = _run_both(cached_stwo_proof(PRODUCTION, seed=0), PRODUCTION, "reference")
    jok, jmasks = res["jax"]
    tok, tmasks = res["port"]
    assert list(tmasks) == list(jmasks)
    for k in jmasks:
        np.testing.assert_array_equal(tmasks[k], jmasks[k], err_msg=k)
    np.testing.assert_array_equal(tok, jok)
    assert tok[0] and not tok[1:].any()
