"""The port's per-stage profiler (``tools/profile_verify.py``) on the CPU,
where its stages run eagerly and are timed by the host clock.

The stage bodies are held to the verifier they mirror: on a TESTING batch
with one tampered lane, the standard path's stage V, on the queries its
transcript stage draws, gives the verifier's trace and CP Merkle masks;
the tiled path's stage VI, on the unlaned eval columns, equals the
standard path's on the same queries.
Each stage line carries the JAX package's keys.
"""

import pytest
import torch

from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.models.stwo import tiled as TT
from stark_symphony_tpu_torch.models.stwo import verifier as TV
from stark_symphony_tpu_torch.models.stwo.config import TESTING
from stark_symphony_tpu_torch.tools import profile_verify as PV
from stark_symphony_tpu_torch.utils.proofcache import cached_stwo_proof

JAX_KEYS = {"stage", "ms_per_batch", "batch", "proofs_per_sec", "compile_s"}


@pytest.fixture(scope="module")
def batch():
    b = TP.replicate(cached_stwo_proof(TESTING), 2)
    b.trace_sibs[1, 0, 2, 5] ^= 1
    return b


def test_standard_stages_mirror_verify(batch):
    proof = TP.to_torch(batch)
    ok, masks = TV.verify(proof, TESTING)
    assert ok.tolist() == [True, False] and masks["trace_merkle"].tolist() == [True, False]
    calls = PV.standard_calls(proof, TESTING)
    assert [name for name, _, _ in calls] == list(PV.STAGES)
    # each stage once but full, which is verify_batch itself
    out = {name: fn(*args) for name, fn, args in calls if name != "full"}
    queries = calls[1][2][1]
    assert torch.equal(out["stages_i_iv"][1], queries)
    q = TESTING.n_queries
    assert torch.equal(out["stage_v"][..., :q].all(dim=-1), masks["trace_merkle"])
    assert torch.equal(out["stage_v"][..., q:].all(dim=-1), masks["cp_merkle"])
    assert tuple(out["stage_vi"].shape) == (2, q, 4)
    assert torch.equal(out["stage_vi_points_only"], TV.query_points(TESTING, queries))
    ok_paths, folded = out["stage_vii"]
    assert tuple(ok_paths.shape) == (2, (1 + TESTING.n_inner_layers) * q)
    assert tuple(folded.shape) == (2, q, 4)

    line = PV.time_stage("stage_vi_points_only", calls[3][1], calls[3][2], 1, 2)
    assert JAX_KEYS | {"eager_ms_per_batch", "launches"} == set(line)
    assert line["ms_per_batch"] is None and line["compile_s"] is None  # no graph on the CPU
    assert line["eager_ms_per_batch"] > 0 and line["launches"] == {} and line["batch"] == 2


def test_tiled_stage_vi_equals_standard(batch):
    tb = TT.tile_batch(batch, TESTING, "cpu")
    calls = {name: (fn, args) for name, fn, args in PV.tiled_calls(tb, TESTING)}
    assert list(calls) == list(PV.TILED_STAGES)
    fn, (queries,) = calls["stage_vi"]
    std = dict((n, (f, a)) for n, f, a in PV.standard_calls(TP.to_torch(batch), TESTING))
    std_vi, (proof, _) = std["stage_vi"]
    assert torch.equal(fn(queries), std_vi(proof, queries))
    lanes = 2 * TESTING.n_queries
    for name in ("stage_v_trace", "stage_v_cp"):
        f, args = calls[name]
        assert tuple(f(*args).shape) == (lanes,)
    f, args = calls["fri_fused"]
    ok_l, folded, q_out = f(*args)
    assert tuple(ok_l.shape) == (1 + TESTING.n_inner_layers, lanes)
    assert tuple(folded.shape) == (4, lanes) and tuple(q_out.shape) == (lanes,)


def test_needs_a_gpu_unless_asked_for_the_cpu():
    assert PV.card("cpu") == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PV.main(["--tiled", "2", "1"])
