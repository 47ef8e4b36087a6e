"""The ``wide_product`` AIR and routed verification on the port.

The port makes the TESTING ``wide_product`` proof on the CPU (no
committed fixture holds one); its verifier accepts it under its own AIR
and rejects it under the other, with masks equal to the JAX package's
eager ``verify`` on a 2-lane batch (the proof, and the proof with one
tampered OODS value).  ``parallel.expert.verify_batch_routed`` then
routes a mixed batch of it and the committed ``wide_fibonacci`` TESTING
proof, each lane to its own AIR, lane for lane as the single-AIR
verifier does."""

import numpy as np
import pytest
import torch

from stark_symphony_tpu.models.stwo import proof as JP
from stark_symphony_tpu.models.stwo import verifier as JV
from stark_symphony_tpu.models.stwo.config import TESTING as J_TESTING
from stark_symphony_tpu_torch import entry as E
from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.models.stwo import verifier as TV
from stark_symphony_tpu_torch.models.stwo.config import TESTING
from stark_symphony_tpu_torch.models.stwo.constraints import AIR_IDS
from stark_symphony_tpu_torch.parallel.expert import verify_batch_routed
from stark_symphony_tpu_torch.utils.proofcache import cached_stwo_proof
from test_torch_sha256 import jit_jax_compress  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def product():
    proof, _ = E.prove_stwo(TESTING, air="wide_product", device="cpu")
    return proof


@pytest.fixture(scope="module")
def fib():
    return cached_stwo_proof(TESTING)


@pytest.fixture(scope="module")
def product_pair(product):
    """The proof and a copy with one OODS trace word flipped, as numpy."""
    batch = TP.replicate(product, 2)
    batch.oods_trace[1, 2, 0] ^= 1
    return batch


@pytest.fixture(scope="module")
def product_masks(product_pair):
    """(port, JAX) (bitmap, masks) of the 2-lane batch under wide_product."""
    tok, tmasks = TV.verify(TP.to_torch(product_pair), TESTING, "wide_product")
    jok, jmasks = JV.verify(JP.StwoProof(*product_pair), J_TESTING, "wide_product")
    return ((tok.numpy(), {k: v.numpy() for k, v in tmasks.items()}),
            (np.asarray(jok), {k: np.asarray(v) for k, v in jmasks.items()}))


def test_product_proof_accepted_under_its_air(product):
    ok, masks = TV.verify(TP.to_torch(product), TESTING, "wide_product")
    assert ok.item() and all(m.item() for m in masks.values())


def test_product_proof_rejected_under_the_other_air(product):
    ok, masks = TV.verify(TP.to_torch(product), TESTING, "wide_fibonacci")
    assert not ok.item() and not masks["oods_cp_match"].item()
    assert all(m.item() for k, m in masks.items() if k != "oods_cp_match")


def test_product_masks_equal_jax(product_masks):
    (tok, tmasks), (jok, jmasks) = product_masks
    np.testing.assert_array_equal(tok, jok)
    assert tok.tolist() == [True, False]
    assert list(tmasks) == list(jmasks)
    for k in jmasks:
        np.testing.assert_array_equal(tmasks[k], jmasks[k], err_msg=k)
    assert not tmasks["oods_cp_match"][1]


IDS = {"routed": [0, 1, 1, 0], "swapped": [1, 0, 0, 1], "edges": [0, -1, 2, 1]}


@pytest.fixture(scope="module")
def mixed(fib, product):
    """The batch [fib, product, product, fib]; its masks under each single
    AIR; and verify_batch_routed's (bitmap, masks) under each id list of
    IDS (the edges given as a tensor, the others as numpy)."""
    batch = TP.to_torch(TP.stack([fib, product, product, fib]))
    single = {air: TV.verify(batch, TESTING, air)[1] for air in AIR_IDS}
    routed = {name: verify_batch_routed(batch, torch.tensor(ids) if name == "edges"
                                        else np.array(ids), TESTING, with_masks=True)
              for name, ids in IDS.items()}
    return batch, single, routed


@pytest.mark.parametrize("name", ["routed", "swapped"])
def test_routed_batch(mixed, name):
    """Every lane accepted under its own AIR; every lane rejected with the
    ids swapped, by the composition check alone."""
    _, _, routed = mixed
    ok, masks = routed[name]
    want = [name == "routed"] * 4
    assert ok.dtype == torch.bool and ok.tolist() == want
    assert masks["oods_cp_match"].tolist() == want
    assert all(m.all() for k, m in masks.items() if k != "oods_cp_match")


@pytest.mark.parametrize("name", list(IDS))
def test_routed_masks_equal_single_air_verify(mixed, name):
    """Each lane's masks equal those of the single-AIR verify of the batch
    under AIR_IDS[id], in the same key order; a negative id counts from
    the end, and an id out of range fails the composition check alone (as
    JAX's ``take`` fills it)."""
    _, single, routed = mixed
    ids = IDS[name]
    ok, masks = routed[name]
    for lane, air_id in enumerate(ids):
        if air_id >= len(AIR_IDS):
            assert [k for k, m in masks.items() if not m[lane]] == ["oods_cp_match"]
            continue
        want = single[AIR_IDS[air_id]]
        assert list(masks) == list(want)
        for k in want:
            assert masks[k][lane] == want[k][lane], (k, lane)
    assert ok.tolist() == [all(m[lane] for m in masks.values()) for lane in range(4)]


def test_routed_needs_air_ids(mixed):
    with pytest.raises(ValueError):
        TV.verify(mixed[0], TESTING, AIR_IDS)
