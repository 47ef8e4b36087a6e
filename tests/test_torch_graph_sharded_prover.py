"""The sharded stwo prover as the JAX package compiles it
(``models/stwo/prover_sharded.py`` ``prove_sharded(graphed=True)``) on CPU
shards, where a capture runs the same segments without a graph.

* Graphed equals eager equals the committed fixture of the JAX prover, word
  for word, over 2 and 4 shards, through ``prove_sharded`` and through
  ``entry.prove_stwo_sharded``; another seed's trace through the cached
  graphs gives its own fixture and captures nothing new.
* The grind's continuation: with graph A's PoW chunk made to miss, the
  graphed proof equals the eager one under the same miss.
* Segments A and B make no tensor from host data and read nothing to the
  host on their second call: the CPU stand-in for "a CUDA graph can
  capture them".
* The per-shard layout, which a mesh over several devices takes
  (``per_shard_prover``: graph A's work as one graphed sharded call, a
  graph on the first device for ``_pre_fri``, each transcript step and
  the small layers with the first PoW chunk, a graph a shard for every
  leaf hash, level and fold; graph B on the first device), built here on
  CPU meshes of 2, 4 and 8 shards: the fixture word for word, then
  another seed's through the same graphs, nothing captured again; its
  second call makes no tensor from host data and reads nothing to the
  host; through the kernel wrappers it launches what the eager prover
  does; a mesh over two devices selects it before anything runs.

TESTING sizes; no JAX prover runs (the fixtures are its output).
"""

import pytest
import torch

from stark_symphony_tpu_torch import entry as E
from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.models.stwo import prover as TPROVER
from stark_symphony_tpu_torch.models.stwo import prover_sharded as PS
from stark_symphony_tpu_torch.models.stwo.config import TESTING, TESTING_Q4
from stark_symphony_tpu_torch.ops import merkle as TM
from stark_symphony_tpu_torch.ops import sha256 as TS
from stark_symphony_tpu_torch.ops.cuda import sha256_kernel as ck
from stark_symphony_tpu_torch.ops.u32 import from_numpy, to_numpy
from stark_symphony_tpu_torch.parallel.mesh import Mesh
from stark_symphony_tpu_torch.tools import build as TB
from stark_symphony_tpu_torch.tools.build import tree_leaves
from stark_symphony_tpu_torch.utils.proofcache import fixture_path
from test_torch_build import _host_copies
from test_torch_fri_shard import _sp
from test_torch_graph_prover import _host_reads, _ScalarReads
from test_torch_prover import assert_proofs_equal
from test_torch_sha256 import _emulated_launch


def _fixture(cfg, seed=None):
    return TP.load_npz(str(fixture_path(cfg, seed)))


@pytest.mark.parametrize("cfg,n_shards,seed,n_layers", [
    (TESTING, 2, None, 3), (TESTING, 4, None, 2), (TESTING, 2, 1, 3), (TESTING_Q4, 2, None, 3),
], ids=["testing-2", "testing-4", "testing-s1-2", "testing_q4-2"])
def test_graphed_equals_eager_and_fixture(cfg, n_shards, seed, n_layers):
    trace = TPROVER.seeded_trace(cfg, seed)
    want = _fixture(cfg, seed)
    mesh = _sp(n_shards)
    graphed, info = PS.prove_sharded(cfg, mesh, trace=trace, graphed=True)
    eager, info_eager = PS.prove_sharded(cfg, mesh, trace=trace)
    assert info == info_eager == {"n_sharded_layers": n_layers}
    assert_proofs_equal(graphed, want)
    assert_proofs_equal(eager, graphed)
    gp = PS.graphed_prover(cfg, mesh, "sp", from_numpy(trace))
    assert gp.b is not None and gp.continued == 0 and mesh.graphs.captures == 1
    via_entry, info_entry = E.prove_stwo_sharded(cfg, seed, n_shards, device="cpu",
                                                 graphed=True)
    assert info_entry == info
    assert_proofs_equal(via_entry, want)
    assert E.sharded_prover_mesh("cpu", n_shards).graphs.captures >= 1


def test_second_seed_through_the_same_graphs():
    """s0 captures, s2 replays: s2's fixture, no new capture."""
    mesh = _sp(2)
    for seed in (0, 2):
        proof, _ = PS.prove_sharded(TESTING, mesh, trace=TPROVER.seeded_trace(TESTING, seed),
                                    graphed=True)
        assert_proofs_equal(proof, _fixture(TESTING, seed))
        assert mesh.graphs.captures == 1


def test_continuation_when_the_first_chunk_misses(monkeypatch):
    """Graph A's chunk (start 0) made to report no hit: the graphed prover
    carries on eagerly from n_cand (continued == 1) and its proof equals
    the eager prover's under the same miss, whose grind also passes chunk
    0 by; the nonce found is n_cand or more."""
    real = TPROVER._grind_chunk

    def missing_first(cfg, state, start):
        word = real(cfg, state, start)
        return torch.cat([torch.zeros_like(word[:1]), word[1:]]) if start == 0 else word

    monkeypatch.setattr(TPROVER, "_grind_chunk", missing_first)
    monkeypatch.setattr(PS, "_grind_chunk", missing_first)
    mesh = _sp(4)
    trace = TPROVER.seeded_trace(TESTING, None)
    eager, _ = PS.prove_sharded(TESTING, mesh, trace=trace)
    graphed, _ = PS.prove_sharded(TESTING, mesh, trace=trace, graphed=True)
    assert_proofs_equal(graphed, eager)
    assert PS.graphed_prover(TESTING, mesh, "sp", from_numpy(trace)).continued == 1
    hi, lo = (int(w) for w in graphed.pow_nonce)
    assert (hi << 32 | lo) >= TPROVER.n_candidates(TESTING)


def test_graphed_through_the_kernel_wrappers(monkeypatch):
    """Over 4 shards with every SHA-256 and tree level dispatched as on the
    card, to the K1/K2 wrappers around an emulated launch: the graphed
    prover launches what the eager one does
    (``test_torch_fri_shard.test_prove_sharded_through_the_kernel_wrappers``
    counts those) and gives the fixture."""
    monkeypatch.setattr(TS, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(TM, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(ck, "_check", lambda *a, **k: None)
    monkeypatch.setattr(ck, "_launch", _emulated_launch)
    counts = []
    for graphed in (False, True):
        ck.reset_launches()
        proof, _ = PS.prove_sharded(TESTING, _sp(4), graphed=graphed)
        assert_proofs_equal(proof, _fixture(TESTING))
        counts.append(dict(ck.launches))
    assert counts[0] == counts[1] and counts[1]["sha256_pair"] > 0


@pytest.fixture(scope="module")
def segment_a_4():
    """Segment A of the TESTING proof over 4 shards (layers of 16 and 8
    values sharded, the last of 4 on the first device) and its nonce."""
    mesh = _sp(4)
    trace = from_numpy(TPROVER.generate_trace(TESTING))
    a = PS._segment_a(TESTING, mesh, "sp", trace, "wide_fibonacci")
    return mesh, trace, a, a.grind[1:].clone()


@pytest.mark.parametrize("segment", ["a", "b"])
def test_segment_makes_no_host_tensor_or_read(segment, segment_a_4, monkeypatch):
    """Each segment's second call makes no tensor from host data and reads
    nothing to the host, sharded layers, exchanges and the first device's
    small layer included."""
    mesh, trace, a, nonce = segment_a_4
    if segment == "a":
        run = lambda: PS._segment_a(TESTING, mesh, "sp", trace, "wide_fibonacci")  # noqa: E731
    else:
        run = lambda: PS._segment_b(TESTING, 4, a, nonce)  # noqa: E731
    first = run()
    copies, reads = _host_copies(monkeypatch), _host_reads(monkeypatch)
    with _ScalarReads() as scalar:
        out = run()
    assert copies == [] and reads == [] and scalar.reads == []
    monkeypatch.undo()
    for x, y in zip(tree_leaves(tuple(first)), tree_leaves(tuple(out)), strict=True):
        assert (to_numpy(x) == to_numpy(y)).all()


def test_mesh_over_two_devices_selects_the_per_shard_layout(monkeypatch):
    """A mesh over two devices takes the per-shard layout, decided from
    its devices before anything runs (nothing can run on ``meta``); a mesh
    of one device takes graph A."""
    built = []
    monkeypatch.setattr(PS, "per_shard_prover", lambda *args: built.append(args) or "per-shard")
    two, one = Mesh(["cpu", "meta"], ("sp",)), _sp(2)
    assert PS.per_shard_layout(two) and not PS.per_shard_layout(one)
    trace = from_numpy(TPROVER.generate_trace(TESTING))
    assert PS.graphed_prover(TESTING, two, "sp", trace) == "per-shard"
    assert built == [(TESTING, two, "sp", trace, "wide_fibonacci")] and two.graphs.captures == 0


@pytest.mark.parametrize("n_shards,n_layers", [(2, 3), (4, 2), (8, 1)])
def test_per_shard_layout_equals_fixture(n_shards, n_layers):
    """The per-shard layout over 2, 4 and 8 shards: s0's fixture at the
    call that captures and s2's through the same graphs; the one entry it
    adds to ``mesh.graphs`` holds graph A as a program whose steps are the
    first device's pieces, every sharded layer's leaf hash, levels, top
    levels and fold, and each transcript step."""
    mesh = _sp(n_shards)
    for seed in (0, 2):
        trace = from_numpy(TPROVER.seeded_trace(TESTING, seed))
        proof = TPROVER._to_numpy_proof(PS.per_shard_prover(TESTING, mesh, "sp", trace)(trace))
        assert_proofs_equal(proof, _fixture(TESTING, seed))
        assert mesh.graphs.captures == 1
    gp = PS.per_shard_prover(TESTING, mesh, "sp", trace)
    assert gp.b is not None and gp.continued == 0 and gp.a.program.complete
    # _pre_fri, then a layer's leaves, log2(n / D) levels, top levels, its
    # transcript step and fold, then the small layers' graph
    n_dist = [TESTING.lde_log_size - l - (n_shards.bit_length() - 1) for l in range(n_layers)]
    assert len(gp.a.program.steps) == 1 + sum(4 + k for k in n_dist) + 1


def test_per_shard_layout_makes_no_host_tensor_or_read(monkeypatch):
    """Graph A of the per-shard layout over 4 shards, at its second call
    (every shard body and first-device piece replayed, the exchanges and
    the copy into B's inputs between them), makes no tensor from host data
    and reads nothing to the host; B's second call neither."""
    mesh = _sp(4)
    trace = from_numpy(TPROVER.generate_trace(TESTING))
    gp = PS.per_shard_prover(TESTING, mesh, "sp", trace)
    gp(trace)
    nonce = gp.a.out.grind[1:].clone()
    copies, reads = _host_copies(monkeypatch), _host_reads(monkeypatch)
    with _ScalarReads() as scalar:
        a = gp.a.replay(trace)
        proof = gp.b.replay(nonce)
    assert copies == [] and reads == [] and scalar.reads == []
    monkeypatch.undo()
    assert_proofs_equal(TPROVER._to_numpy_proof(proof), _fixture(TESTING))
    assert a is gp.a.out


def test_per_shard_layout_through_the_kernel_wrappers(monkeypatch):
    """Over 4 shards with every SHA-256 and tree level dispatched as on the
    card, to the K1/K2 wrappers around an emulated launch: the per-shard
    layout launches what the eager prover does, at the call that captures
    and at the one that replays, and gives the fixture."""
    monkeypatch.setattr(TS, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(TM, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(ck, "_check", lambda *a, **k: None)
    monkeypatch.setattr(ck, "_launch", _emulated_launch)
    mesh = _sp(4)
    trace = from_numpy(TPROVER.generate_trace(TESTING))
    counts = []
    for run in (lambda: PS.prove_sharded(TESTING, mesh)[0],
                lambda: TPROVER._to_numpy_proof(PS.per_shard_prover(TESTING, mesh, "sp",
                                                                     trace)(trace)),
                lambda: TPROVER._to_numpy_proof(PS.per_shard_prover(TESTING, mesh, "sp",
                                                                     trace)(trace))):
        ck.reset_launches()
        assert_proofs_equal(run(), _fixture(TESTING))
        counts.append(dict(ck.launches))
    assert counts[0] == counts[1] == counts[2] and counts[0]["sha256_pair"] > 0
    assert TB.launch_counts()["merkle_walk"] == 0
