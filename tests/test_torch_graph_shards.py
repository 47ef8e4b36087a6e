"""The sharded verifiers as the JAX package compiles them: one CUDA graph a
shard (``parallel/mesh.Mesh.capture``), cached on the mesh, on CPU meshes
of 8 shards, where a capture runs each shard's verify without a graph.

DP, TP, GSPMD and routed-sharded with ``graphed=True`` give the eager
bitmaps, counts and masks (the unsharded ``verify`` and
``verify_batch_routed`` of the same lanes, which the eager sharded paths
equal and which ``tests/test_torch_parallel.py`` and
``tests/test_torch_routed.py`` hold to JAX); a second call captures nothing
new, GSPMD replays TP's graphs where its query slices are TP's, a batch of
another shape gets an entry of its own, and a shard called with other
specs than its capture's raises.  TESTING sizes; each shard's verify costs
about a second and a half of CPU, so the calls are few.
"""

import numpy as np
import pytest
import torch

from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.models.stwo import verifier as TV
from stark_symphony_tpu_torch.models.stwo.config import TESTING, TESTING_Q4
from stark_symphony_tpu_torch.parallel.batch import (
    make_mesh,
    shard_batch,
    verify_batch_dp,
    verify_batch_gspmd,
    verify_batch_tp,
)
from stark_symphony_tpu_torch.parallel.expert import (
    verify_batch_routed,
    verify_batch_routed_sharded,
)
from stark_symphony_tpu_torch.utils.proofcache import cached_stwo_proof

CPU8 = ["cpu"] * 8


def _assert_equal(got, want):
    """A sharded path's (bitmap, n_ok[, masks]) equal to the eager
    unsharded (bitmap, masks), mask for mask where it returned them."""
    ok, want_masks = want
    assert torch.equal(got[0], ok)
    assert got[1].dim() == 0 and int(got[1]) == int(ok.sum())
    if len(got) > 2:
        assert list(got[2]) == list(want_masks)
        for key, mask in got[2].items():
            assert torch.equal(mask, want_masks[key]), key


@pytest.fixture(scope="module")
def dp_batch():
    """8 TESTING proofs with lane 3's fri_last tampered (numpy), and the
    eager verify's (bitmap, masks) of them."""
    batch = TP.replicate(cached_stwo_proof(TESTING), 8)
    batch.fri_last[3, 0] ^= 1
    return batch, TV.verify(TP.to_torch(batch), TESTING)


@pytest.fixture(scope="module")
def dp_graphed(dp_batch):
    """A CPU mesh of 8 shards and its first graphed DP call's result."""
    mesh = make_mesh(8, devices=CPU8)
    return mesh, verify_batch_dp(dp_batch[0], TESTING, mesh, with_masks=True, graphed=True)


def test_dp_graphed_equals_eager(dp_batch, dp_graphed):
    batch, want = dp_batch
    mesh, first = dp_graphed
    _assert_equal(first, want)
    assert not bool(first[0][3]) and int(first[1]) == 7
    assert mesh.graphs.captures == 1
    again = verify_batch_dp(batch, TESTING, mesh, with_masks=True, graphed=True)
    _assert_equal(again, want)
    assert mesh.graphs.captures == 1  # the second call replays


def test_dp_graphed_other_shape_and_specs(dp_batch, dp_graphed):
    """A batch of twice the lanes gets its own entry; the first entry's
    shard graphs refuse its shards."""
    batch, (ok, _) = dp_batch
    mesh, _ = dp_graphed
    captures = mesh.graphs.captures
    twice = TP.map_fields(lambda x: np.concatenate([x, x]), batch)
    bitmap, n_ok = verify_batch_dp(twice, TESTING, mesh, graphed=True)
    assert torch.equal(bitmap, torch.cat([ok, ok])) and int(n_ok) == 2 * int(ok.sum())
    assert mesh.graphs.captures == captures + 1 and len(mesh.graphs.entries) == 2
    first = next(iter(mesh.graphs.entries.values()))
    with pytest.raises(ValueError):
        first.run(shard_batch(twice, mesh))


def test_tp_and_gspmd_graphed_equal_eager():
    """TP at dp2 x tp4 on the TESTING_Q4 batch of test_torch_parallel.py
    (lane 1's query 3 tampered, held by the last query shard); GSPMD's
    slices are TP's there, so it replays TP's graphs."""
    batch = TP.replicate(cached_stwo_proof(TESTING_Q4), 4)
    batch.trace_evals[1, 3, 0] ^= 1
    want = TV.verify(TP.to_torch(batch), TESTING_Q4)
    mesh = make_mesh(8, tp=4, devices=CPU8)
    tp = verify_batch_tp(batch, TESTING_Q4, mesh, with_masks=True, graphed=True)
    _assert_equal(tp, want)
    assert tp[0].tolist() == [True, False, True, True] and mesh.graphs.captures == 1
    gspmd = verify_batch_gspmd(batch, TESTING_Q4, mesh, with_masks=True, graphed=True)
    _assert_equal(gspmd, want)
    assert mesh.graphs.captures == 1


def test_routed_sharded_graphed_equals_routed():
    """8 lanes alternating the TESTING fixture (air_id 0) and the TESTING
    wide_product proof (air_id 1), lane 2's ids swapped: the routed
    verify's bitmap, lane 2 alone rejected."""
    fib = cached_stwo_proof(TESTING)
    product = cached_stwo_proof(TESTING, air="wide_product", device="cpu")
    batch = TP.stack([fib, product] * 4)
    ids = np.arange(8) % 2
    ids[2] = 1
    want = verify_batch_routed(TP.to_torch(batch), ids, TESTING)
    assert want.tolist() == [True, True, False, True, True, True, True, True]
    mesh = make_mesh(8, devices=CPU8)
    bitmap, n_ok = verify_batch_routed_sharded(batch, ids, TESTING, mesh, graphed=True)
    assert torch.equal(bitmap, want) and int(n_ok) == 7
    assert mesh.graphs.captures == 1
