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
from stark_symphony_tpu_torch.ops import merkle as TM
from stark_symphony_tpu_torch.ops import sha256 as TS
from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
from stark_symphony_tpu_torch.parallel.batch import make_mesh, verify_batch_dp
from stark_symphony_tpu_torch.parallel.pipeline import StreamVerifier, scan_microbatches
from stark_symphony_tpu_torch.tools import build as TB
from stark_symphony_tpu_torch.utils.proofcache import cached_stwo_proof
from chip_smoke import PROD_TAMPERS, tamper_batch
import test_pow_production
from test_torch_sha256 import _emulated_launch
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


def test_verify_through_the_kernel_wrappers(results, monkeypatch):
    """The standard verify with every SHA-256 and Merkle call dispatched as
    on the card, to the K1-K3 wrappers around an emulated launch (the
    layouts and block sizes the kernels get): on the own TESTING tamper
    batch every mask and the accept bitmap equal JAX's."""
    monkeypatch.setattr(TS, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(TM, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(ck, "_check", lambda *a, **k: None)
    monkeypatch.setattr(ck, "_launch", _emulated_launch)
    before = dict(ck.launches)
    batch = tamper_batch(cached_stwo_proof(TESTING), 1 + TESTING.n_inner_layers)
    ok, masks = TV.verify(TP.to_torch(batch), TESTING)
    assert all(ck.launches[k] > before[k] for k in before), ck.launches
    jok, jmasks = results["own_reference"]["jax"]
    assert list(masks) == list(jmasks)
    for k in jmasks:
        np.testing.assert_array_equal(masks[k].numpy(), jmasks[k], err_msg=k)
    np.testing.assert_array_equal(ok.numpy(), jok)


def test_scan_microbatches_equals_jax(results):
    """The own TESTING tamper batch in two micro-batches of 8 lanes, one
    graphed verifier (on the CPU: its copy-in, call and copy-out) for both:
    JAX's accept bitmap."""
    batch = tamper_batch(cached_stwo_proof(TESTING), 1 + TESTING.n_inner_layers)
    got = scan_microbatches(lambda b: TV.verify_batch(b, TESTING), TP.to_torch(batch), 8)
    np.testing.assert_array_equal(got.numpy(), results["own_reference"]["jax"][0])


def test_make_chained_equals_jax(results):
    """Two chained verifications of the own TESTING tamper batch (standard
    path), seeded with ones, through the graphed object (on the CPU: its
    copy-in, call and copy-out): lane 0 is accepted, so the runtime zero
    leaves the commitments as they are, and the last bitmap is JAX's."""
    batch = TP.to_torch(tamper_batch(cached_stwo_proof(TESTING), 1 + TESTING.n_inner_layers))
    ones = torch.ones(16, dtype=torch.int64)
    chained = TB.make_chained(TESTING, 2, tiled_path=False)
    got = TB.capture(chained, (batch, ones))(batch, ones)
    want = results["own_reference"]["jax"][0]
    assert got.dtype == torch.int64 and want[0] and not want.all()
    np.testing.assert_array_equal((got == 1).numpy(), want)


def test_stream_equals_jax(results):
    """The own TESTING tamper batch (numpy words) and its lanes reversed,
    two host batches in flight through the port's stream: JAX's bitmaps,
    in the order fed."""
    batch = tamper_batch(cached_stwo_proof(TESTING), 1 + TESTING.n_inner_layers)
    stream = StreamVerifier(lambda b: TV.verify_batch(b, TESTING), depth=2, device="cpu")
    stream.feed(batch)
    stream.feed(TP.map_fields(lambda x: x[::-1].copy(), batch))
    got = stream.finish()
    want = results["own_reference"]["jax"][0]
    assert len(got) == 2 and stream.finish() == []
    np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(got[1].numpy(), want[::-1])


def test_verify_batch_dp_equals_jax(results):
    """DP over 4 CPU shards of 4 lanes each (``parallel.batch``): the own
    TESTING tamper batch's bitmap is JAX's, gathered in lane order on the
    mesh's first device, and the count is its sum."""
    batch = tamper_batch(cached_stwo_proof(TESTING), 1 + TESTING.n_inner_layers)
    bitmap, n_ok = verify_batch_dp(batch, TESTING, make_mesh(4, devices=["cpu"] * 4))
    want = results["own_reference"]["jax"][0]
    assert bitmap.dtype == torch.bool and bitmap.device.type == "cpu"
    np.testing.assert_array_equal(bitmap.numpy(), want)
    assert n_ok.dtype == torch.int64 and n_ok.dim() == 0
    assert int(n_ok) == int(want.sum()) == 2


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
