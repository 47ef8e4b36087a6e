"""The port's tiled fast path against the JAX package's.

* ``tiled.tile_batch`` equals the JAX package's word for word on the real
  lanes (JAX pads the lane axis to whole 1,024-lane tiles; the port does
  not pad).
* ``verify_batch_tiled(with_masks=True)`` on the 16-proof tamper batch at
  TESTING size (an own-prover proof, lane 0 clean, the 15 tamper classes in
  lanes 1-15; ``chip_smoke.tamper_batch``) equals JAX's
  ``verify_batch_tiled`` mask for mask, in key order, and equals the port's
  standard ``verify``.  Each package runs it once per module (JAX's tiled
  verify takes some 10 s on the CPU).
* PRODUCTION proofs s0 and s1 are accepted through ``entry_tiled``.
* The same batch through the CUDA wrappers of ``ops/cuda/fri_kernel.py``
  around an emulated launch gives the plain route's masks.
"""

import functools

import numpy as np
import pytest
import torch

from chip_smoke import tamper_batch
from stark_symphony_tpu.models.stwo import proof as JP
from stark_symphony_tpu.models.stwo import tiled as JT
from stark_symphony_tpu.models.stwo import verifier as JV
from stark_symphony_tpu_torch import entry as E
from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.models.stwo import tiled as TT
from stark_symphony_tpu_torch.models.stwo import verifier as TV
from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION, TESTING
from stark_symphony_tpu_torch.ops import fri
from stark_symphony_tpu_torch.ops.cuda import fri_kernel as fk
from stark_symphony_tpu_torch.parallel.pipeline import StreamVerifier
from stark_symphony_tpu_torch.utils.proofcache import cached_stwo_proof
from test_torch_fri import _emulated_launch
from test_torch_verifier import MASK_KEYS

PER_QUERY = ("trace_evals_t", "cp_evals_t", "trace_sibs_t", "cp_sibs_t",
             "fri_wits_t", "fri_sibs_t")


@pytest.mark.parametrize("cfg,n_proofs", [(TESTING, 6), (TESTING, 5), (PRODUCTION, 2)])
def test_tile_batch_equals_jax(cfg, n_proofs):
    seeds = [None] if cfg is TESTING else list(range(n_proofs))
    proofs = [cached_stwo_proof(cfg, s) for s in seeds]
    batch = TP.stack([proofs[i % len(proofs)] for i in range(n_proofs)])
    batch.trace_evals[-1, 0, 0] ^= 0x80000001  # a word >= 2^31 in a real lane
    want = JT.tile_batch(JP.StwoProof(*batch), cfg)
    got = TT.tile_batch(batch, cfg, "cpu")
    assert list(got._fields) == list(want._fields)
    lanes = n_proofs * cfg.n_queries
    for name in got._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        if name in PER_QUERY:
            assert g.dtype == torch.int32 and g.is_contiguous(), name
            assert tuple(g.shape) == w.shape[:-2] + (lanes,), name
            g = g.numpy().view(np.uint32)
            w = w.reshape(w.shape[:-2] + (-1,))[..., :lanes]
        else:
            assert g.dtype == torch.int64, name
            g = g.numpy().astype(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def tamper_results():
    batch = tamper_batch(cached_stwo_proof(TESTING), 1 + TESTING.n_inner_layers)
    jok, jmasks = JV.verify_batch_tiled(JT.tile_batch(JP.StwoProof(*batch), TESTING),
                                        TESTING, with_masks=True)
    tb = TT.tile_batch(batch, TESTING, "cpu")
    tok, tmasks = TV.verify_batch_tiled(tb, TESTING, with_masks=True)
    sok, smasks = TV.verify(TP.to_torch(batch), TESTING)
    as_np = lambda ok, masks: (np.asarray(ok), {k: np.asarray(v) for k, v in masks.items()})  # noqa: E731
    return {"jax": as_np(jok, jmasks), "port": as_np(tok, tmasks),
            "standard": as_np(sok, smasks), "batch": tb}


def test_tiled_mask_keys_in_order(tamper_results):
    for who in ("jax", "port", "standard"):
        assert list(tamper_results[who][1]) == MASK_KEYS, who


@pytest.mark.parametrize("key", MASK_KEYS)
@pytest.mark.parametrize("against", ["jax", "standard"])
def test_tiled_mask_equals(tamper_results, against, key):
    got = tamper_results["port"][1][key]
    assert got.dtype == np.bool_ and got.shape == (16,)
    np.testing.assert_array_equal(got, tamper_results[against][1][key])


def test_tiled_accept_bitmap(tamper_results):
    got = tamper_results["port"][0]
    np.testing.assert_array_equal(got, tamper_results["jax"][0])
    np.testing.assert_array_equal(got, tamper_results["standard"][0])
    assert got[0] and not got[1:].all()


def test_tiled_through_emulated_kernels(tamper_results, monkeypatch):
    """The CUDA route of verify_batch_tiled (wrappers, per-proof roots and
    alphas, the depths array) around an emulated launch, on the CPU."""
    monkeypatch.setattr(fri, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(fk, "_check", lambda *a, **k: None)
    monkeypatch.setattr(fk, "_launch", _emulated_launch)
    fk.reset_launches()
    ok, masks = TV.verify_batch_tiled(tamper_results["batch"], TESTING, with_masks=True)
    assert fk.launches == {"leafwalk": 2, "fri_all_layers": 1}
    np.testing.assert_array_equal(ok.numpy(), tamper_results["port"][0])
    for k, v in masks.items():
        np.testing.assert_array_equal(v.numpy(), tamper_results["port"][1][k], err_msg=k)


def test_stream_tiled_equals_jax(tamper_results):
    """The numpy tamper batch through the port's stream, laid out by
    ``tiled.relayout`` as ``tile_batch`` lays it out: JAX's bitmap."""
    batch = tamper_batch(cached_stwo_proof(TESTING), 1 + TESTING.n_inner_layers)
    stream = StreamVerifier(lambda b: TV.verify_batch_tiled(b, TESTING), device="cpu",
                            layout=functools.partial(TT.relayout, cfg=TESTING))
    stream.feed(batch)
    (got,) = stream.finish()
    np.testing.assert_array_equal(got.numpy(), tamper_results["jax"][0])


def test_entry_tiled_on_cpu():
    """PRODUCTION fixtures s0 and s1 through the tiled entry point."""
    fn, (tb,) = E.entry_tiled(n_proofs=2, device="cpu")
    assert tuple(tb.trace_evals_t.shape) == (4, 32)
    assert tuple(tb.fri_sibs_t.shape) == (72, 8, 32)
    bitmap = fn(tb)
    assert bitmap.dtype == torch.bool and bitmap.tolist() == [True, True]


def test_tiled_linkage_must_be_reference(tamper_results):
    with pytest.raises(ValueError):
        TV.verify_batch_tiled(tamper_results["batch"], TESTING, linkage="unfold")


@pytest.mark.slow
def test_production_tamper_matrix_tiled_equals_jax():
    """The 15 classes at PRODUCTION size through both packages' tiled paths."""
    batch = tamper_batch(cached_stwo_proof(PRODUCTION, seed=0),
                         1 + PRODUCTION.n_inner_layers)
    jok, jmasks = JV.verify_batch_tiled(JT.tile_batch(JP.StwoProof(*batch), PRODUCTION),
                                        PRODUCTION, with_masks=True)
    tok, tmasks = TV.verify_batch_tiled(TT.tile_batch(batch, PRODUCTION, "cpu"),
                                        PRODUCTION, with_masks=True)
    assert list(tmasks) == list(jmasks)
    for k in jmasks:
        np.testing.assert_array_equal(tmasks[k].numpy(), np.asarray(jmasks[k]), err_msg=k)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok[0] and not tok[1:].any()
