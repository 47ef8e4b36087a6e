"""The port's mesh and its sharded verifiers (``parallel/mesh.py``,
``parallel/batch.py``) on CPU shards, against the JAX package.

TP splits each proof's queries over the ``tp`` axis; on the TESTING_Q4
batch of the JAX suite's ``test_tp_tamper_localizes`` (lane 1's query 3
tampered, handled by the last query shard) its bitmap, count and every
stage's mask must equal JAX's ``verify`` of the batch, over dp2 x tp2 and
dp1 x tp4, and so must the GSPMD counterpart's (over dp1 x tp2), also
where the query axis does not divide TESTING's one query.  JAX verifies
each batch once, eagerly (no jit or shard_map: compiling the verifier
costs minutes on the CPU).  Each shard's verify costs about a second of
CPU, so the cases are few.
"""

import numpy as np
import pytest
import torch

from stark_symphony_tpu.models.stwo import proof as JP
from stark_symphony_tpu.models.stwo import verifier as JV
from stark_symphony_tpu_torch import entry as E
from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.models.stwo.config import TESTING, TESTING_Q4
from stark_symphony_tpu_torch.ops import merkle as TM
from stark_symphony_tpu_torch.ops import sha256 as TS
from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
from stark_symphony_tpu_torch.parallel import fri_shard
from stark_symphony_tpu_torch.parallel.batch import (
    make_mesh,
    shard_batch,
    verify_batch_gspmd,
    verify_batch_tp,
)
from stark_symphony_tpu_torch.parallel.mesh import Mesh, all_gather, ppermute, psum, unshard
from stark_symphony_tpu_torch.utils.proofcache import cached_stwo_proof
from test_torch_sha256 import _emulated_launch
from test_torch_sha256 import jit_jax_compress  # noqa: F401 (autouse)


def _cpu(n):
    return ["cpu"] * n


def _jax_verify(batch, cfg):
    """JAX's eager verify of a numpy batch: (bitmap, masks) as numpy."""
    ok, masks = JV.verify(JP.StwoProof(*batch), cfg, linkage="reference")
    return np.asarray(ok), {k: np.asarray(v) for k, v in masks.items()}


def _assert_equals_jax(got, jax_result):
    """A sharded verifier's (bitmap, n_ok, masks) equal to JAX's bitmap,
    its sum and every mask, key for key."""
    bitmap, n_ok, masks = got
    want, want_masks = jax_result
    assert bitmap.dtype == torch.bool
    np.testing.assert_array_equal(bitmap.numpy(), want)
    assert n_ok.dtype == torch.int64 and n_ok.dim() == 0 and int(n_ok) == int(want.sum())
    assert list(masks) == list(want_masks)
    for key, mask in masks.items():
        np.testing.assert_array_equal(mask.numpy(), want_masks[key], err_msg=key)


@pytest.fixture(scope="module")
def q4_bad():
    """4 TESTING_Q4 proofs, lane 1's query 3 tampered (numpy), and JAX's
    (bitmap, masks) of them."""
    batch = TP.replicate(cached_stwo_proof(TESTING_Q4), 4)
    batch.trace_evals[1, 3, 0] ^= 1
    return batch, _jax_verify(batch, TESTING_Q4)


@pytest.fixture(scope="module")
def tp_results(q4_bad):
    batch, _ = q4_bad
    return {(dp, tp): verify_batch_tp(batch, TESTING_Q4,
                                      make_mesh(dp * tp, tp=tp, devices=_cpu(dp * tp)),
                                      with_masks=True)
            for dp, tp in [(2, 2), (1, 4)]}


def test_make_mesh_shapes_and_devices():
    mesh = make_mesh(8, tp=4, devices=_cpu(8))
    assert mesh.axis_names == ("dp", "tp") and mesh.shape == {"dp": 2, "tp": 4}
    assert mesh.size == 8 and all(d == torch.device("cpu") for d in mesh.devices)
    assert mesh.coords(6) == {"dp": 1, "tp": 2}
    assert mesh.axis_index("tp") == [0, 1, 2, 3] * 2
    assert mesh.groups("tp") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh.groups("dp") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert make_mesh(4, devices=_cpu(8)).shape == {"dp": 4, "tp": 1}
    with pytest.raises(ValueError):
        make_mesh(6, tp=4, devices=_cpu(8))
    with pytest.raises(ValueError):
        make_mesh(16, devices=_cpu(8))


def test_make_mesh_needs_cuda_or_devices(monkeypatch):
    """No CUDA device and no devices=: make_mesh raises, and so do the
    entry points that default to CUDA; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(8, tp=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.dryrun_multichip(8)


def test_shard_batch_slices_and_replicates():
    """Contiguous slices of the leading axis over dp, the same slice on
    every tp shard, as int64 words on each shard's device."""
    proof = cached_stwo_proof(TESTING)
    batch = TP.stack([proof] * 4)
    batch.pow_nonce[:, 1] = np.arange(4)  # tell the lanes apart
    mesh = make_mesh(4, tp=2, devices=_cpu(4))
    shards = shard_batch(batch, mesh)
    assert len(shards) == 4
    for i, shard in enumerate(shards):
        dp = mesh.coords(i)["dp"]
        assert shard.pow_nonce.dtype == torch.int64 and shard.pow_nonce.device.type == "cpu"
        assert shard.pow_nonce[:, 1].tolist() == [2 * dp, 2 * dp + 1]
        assert len(shard.fri_sibs) == len(proof.fri_sibs)
        np.testing.assert_array_equal(shard.fri_sibs[1].numpy(),
                                      batch.fri_sibs[1][2 * dp:2 * dp + 2])
    with pytest.raises(ValueError):
        shard_batch(TP.stack([proof] * 3), mesh)


@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 4)])
def test_tp_equals_verify_and_localizes_the_tamper(q4_bad, tp_results, dp, tp):
    """TP's bitmap, count and masks are JAX's verify's: lane 1 alone
    rejected (trace_merkle among its failed stages), 3 accepted."""
    _, jax_result = q4_bad
    assert jax_result[0].tolist() == [True, False, True, True]
    assert not jax_result[1]["trace_merkle"][1]
    _assert_equals_jax(tp_results[(dp, tp)], jax_result)


def test_gspmd_equals_tp(q4_bad, tp_results):
    batch, jax_result = q4_bad
    got = verify_batch_gspmd(batch, TESTING_Q4, make_mesh(2, tp=2, devices=_cpu(2)),
                             with_masks=True)
    _assert_equals_jax(got, jax_result)
    want, want_n, _ = tp_results[(2, 2)]
    assert torch.equal(got[0], want) and int(got[1]) == int(want_n)


@pytest.fixture(scope="module")
def testing_bad():
    """4 TESTING proofs, lane 1's last FRI value tampered (numpy), and
    JAX's (bitmap, masks) of them (4 lanes, as q4_bad's: JAX compiles its
    transcript hashes for one batch size)."""
    batch = TP.replicate(cached_stwo_proof(TESTING), 4)
    batch.fri_last[1, 0] ^= 1
    return batch, _jax_verify(batch, TESTING)


def test_gspmd_uneven_queries(testing_bad):
    """TESTING's one query over tp = 2 (which XLA splits unevenly): every
    query shard verifies it, and the bitmap, count and masks are JAX's
    verify's; TP refuses the split."""
    batch, jax_result = testing_bad
    assert jax_result[0].tolist() == [True, False, True, True]
    got = verify_batch_gspmd(batch, TESTING, make_mesh(2, tp=2, devices=_cpu(2)),
                             with_masks=True)
    _assert_equals_jax(got, jax_result)
    with pytest.raises(ValueError, match="not divisible"):
        verify_batch_tp(batch, TESTING, make_mesh(2, tp=2, devices=_cpu(2)))


def test_tp_through_the_kernel_wrappers(q4_bad, monkeypatch):
    """TP over dp1 x tp2 with every SHA-256 and Merkle call dispatched as on
    the card, to the K1-K3 wrappers around an emulated launch: the bitmap
    is JAX's verify's, and the FRI walk's per-path depths repeat with the
    shard's query count (3 layers x 2 queries), not the config's."""
    monkeypatch.setattr(TS, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(TM, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(ck, "_check", lambda *a, **k: None)
    monkeypatch.setattr(ck, "_launch", _emulated_launch)
    periods = []
    launch = _emulated_launch

    def spy(name, device, *args):
        if name == "merkle_walk" and args[2] is not None:
            periods.append(args[3])
        launch(name, device, *args)

    monkeypatch.setattr(ck, "_launch", spy)
    batch, (want, _) = q4_bad
    bitmap, n_ok = verify_batch_tp(batch, TESTING_Q4, make_mesh(2, tp=2, devices=_cpu(2)))
    np.testing.assert_array_equal(bitmap.numpy(), want)
    assert int(n_ok) == 3
    assert periods == [3 * 2, 3 * 2]


def test_refusals():
    """Q % tp, an odd SP axis and a layer of fewer than 2 leaves a shard
    are refused, as the JAX package asserts them."""
    batch = TP.replicate(cached_stwo_proof(TESTING_Q4), 8)
    with pytest.raises(ValueError, match="not divisible"):
        verify_batch_tp(batch, TESTING_Q4, make_mesh(8, tp=8, devices=_cpu(8)))
    values = torch.arange(48, dtype=torch.int64).reshape(12, 4)
    with pytest.raises(ValueError, match="even"):
        fri_shard.sharded_fold(values, values, [1], Mesh(_cpu(3), ("sp",)),
                               fold_fn=lambda a, b, x, beta: a, coord_step=lambda x: x,
                               n_stages=1)
    with pytest.raises(ValueError, match="2\\*\\*2"):
        fri_shard.sharded_fold(values[:8], values[:8], [1, 1], Mesh(_cpu(4), ("sp",)),
                               fold_fn=lambda a, b, x, beta: a, coord_step=lambda x: x,
                               n_stages=2)
    with pytest.raises(ValueError, match="at least 2 leaves"):
        fri_shard.stwo_commit_sharded(values[:8], Mesh(_cpu(8), ("sp",)))


def test_collectives_never_alias():
    """ppermute, psum and all_gather give new tensors on each shard, never
    an input itself, with JAX's values; a shard that ppermute sends nothing
    gets None."""
    mesh = Mesh(_cpu(4), ("sp",))
    shards = [torch.full((2, 3), i, dtype=torch.int64) for i in range(4)]
    moved = ppermute(mesh, shards, "sp", [((d + 2) % 4, d) for d in range(4)])
    ptrs = {s.data_ptr() for s in shards}
    for d, t in enumerate(moved):
        assert t.data_ptr() not in ptrs and torch.equal(t, shards[(d + 2) % 4])
    moved[0].fill_(-1)
    assert shards[2].eq(2).all()
    half = ppermute(mesh, shards, "sp", [(0, 1)])
    assert half[0] is None and half[2] is None and torch.equal(half[1], shards[0])
    total = psum(mesh, shards, "sp")
    assert all(t.data_ptr() not in ptrs and t.eq(6).all() for t in total)
    whole = all_gather(mesh, shards, "sp")
    assert all(torch.equal(w, torch.cat(shards)) for w in whole)
    assert whole[0].data_ptr() not in ptrs
    assert torch.equal(unshard(mesh, shards, "sp"), torch.cat(shards))
    grid = Mesh([_cpu(2), _cpu(2)], ("dp", "tp"))
    sums = psum(grid, [torch.tensor(v) for v in (1, 2, 3, 4)], "dp")
    assert [int(t) for t in sums] == [4, 6, 4, 6]

