"""The provers as the JAX package compiles them (``models/stwo/prover.py``
``GraphedProver``, ``models/stark101/prover.py`` ``prove(graphed=True)``) on
the CPU, where a capture runs the same segments without a graph.

* The graphed stwo prover (graph A, one read of 3 words, graph B) gives
  the committed fixtures of the JAX prover word for word, and the eager
  prove's words; a second proof of the same config captures nothing new.
* The graphed stark101 prover gives ``golden_proof.json``.
* The grind's continuation, started after the first chunk as the graphed
  prover starts it where that chunk missed, finds the smallest nonce from
  n_cand on that a hashlib search finds.
* Segments A and B and the stark101 body make no tensor from host data and
  read nothing to the host on their second call: the CPU stand-in for
  "a CUDA graph can capture them".

TESTING sizes; no JAX prover runs (the fixtures are its output).
"""

import dataclasses
import hashlib
import itertools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from stark_symphony_tpu_torch import entry as E
from stark_symphony_tpu_torch.models.stark101 import proof as P101
from stark_symphony_tpu_torch.models.stark101 import prover as TPROVER101
from stark_symphony_tpu_torch.models.stark101.config import Stark101Config
from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.models.stwo import prover as TPROVER
from stark_symphony_tpu_torch.models.stwo.config import TESTING, TESTING_Q4
from stark_symphony_tpu_torch.ops.u32 import from_numpy, to_numpy
from stark_symphony_tpu_torch.tools.build import tree_leaves
from stark_symphony_tpu_torch.utils import proofcache as PC
from test_torch_build import _host_copies
from test_torch_prover import assert_proofs_equal


@pytest.mark.parametrize("cfg,seed", [(TESTING, None), (TESTING, 0), (TESTING_Q4, None)],
                         ids=["testing", "testing-s0", "testing_q4"])
def test_graphed_prove_equals_fixture_and_eager(cfg, seed):
    trace = TPROVER.seeded_trace(cfg, seed)
    graphed, info = TPROVER.prove(cfg, trace, device="cpu", graphed=True)
    assert info == {}
    assert_proofs_equal(graphed, TP.load_npz(str(PC.fixture_path(cfg, seed))))
    assert_proofs_equal(graphed, TPROVER.prove(cfg, trace, device="cpu")[0])
    gp = TPROVER.graphed_prover(cfg, from_numpy(trace))
    assert gp.b is not None and gp.continued == 0
    captures = TPROVER.GRAPHS.captures
    again, _ = E.prove_stwo(cfg, seed, device="cpu", graphed=True)
    assert_proofs_equal(again, graphed)
    assert TPROVER.GRAPHS.captures == captures  # the config's entry served it


def test_graphed_stark101_equals_golden():
    want = tree_leaves(tuple(P101.load_json(str(E.STARK101_GOLDEN))))
    infos = []
    for _ in range(2):  # the capture, then a replay of the same entry
        proof, info = E.prove_stark101("cpu", graphed=True)
        infos.append(info)
        got = tree_leaves(tuple(proof))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.uint32
            np.testing.assert_array_equal(g, w)
    assert infos[0] == infos[1] and 0 <= infos[0]["idx"] < Stark101Config().domain_ex_size
    assert TPROVER101.GRAPHS.captures == 1


def _hashlib_nonce_from(digest, target, start: int) -> int:
    """The smallest nonce from `start` on whose mix sha256(digest || hi ||
    lo) reads below the target (words 7 and 6, byte-swapped, as hi, lo)."""
    prefix = np.asarray(digest, dtype=">u4").tobytes()
    for nonce in itertools.count(start):
        d = hashlib.sha256(prefix + nonce.to_bytes(8, "big")).digest()
        if (int.from_bytes(d[28:32], "little") << 32 | int.from_bytes(d[24:28], "little")) < target:
            return nonce


@pytest.mark.parametrize("pow_bits", [5, 8])
def test_continuation_grind_equals_hashlib(pow_bits):
    """pow_grind from chunk 2 on, as the graphed prover carries on where
    graph A's chunk missed: the smallest nonce >= n_cand."""
    cfg = dataclasses.replace(TESTING, pow_bits=pow_bits)
    digest = np.random.default_rng(pow_bits).integers(0, 1 << 32, 8, dtype=np.uint32)
    state = TPROVER.ch.ChannelState(from_numpy(digest), torch.tensor(0))
    n_cand = TPROVER.n_candidates(cfg)
    got = to_numpy(TPROVER.pow_grind(cfg, state, start=n_cand))
    want = _hashlib_nonce_from(digest, cfg.pow_target, n_cand)
    assert got.shape == (2,) and (int(got[0]) << 32 | int(got[1])) == want >= n_cand


def _host_reads(monkeypatch) -> list:
    """Patch the Python ways of reading a tensor to the host; returns the
    list of calls they see."""
    calls = []
    for name in ("item", "tolist", "numpy", "cpu", "__int__", "__bool__", "__float__",
                 "__index__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *args, _name=name, _orig=orig, **kwargs):
            calls.append(_name)
            return _orig(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return calls


class _ScalarReads(TorchDispatchMode):
    """Records aten's ``_local_scalar_dense``, the read of a value to the
    host behind ``item()``, ``int()``, ``bool()`` and indexing by a 0-d
    tensor (the last reaches no Python method)."""

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("segment", ["stwo_a", "stwo_b", "stark101"])
def test_segment_makes_no_host_tensor_or_read(segment, monkeypatch):
    """Each graphed segment's second call makes no tensor from host data and
    reads nothing to the host."""
    if segment == "stark101":
        cfg = Stark101Config()
        trace = torch.from_numpy(TPROVER101.generate_trace(cfg).astype(np.int64))
        run = lambda: TPROVER101._prove_body(cfg, trace)  # noqa: E731
    else:
        trace = from_numpy(TPROVER.generate_trace(TESTING))
        a = TPROVER._segment_a(TESTING, trace, "wide_fibonacci")
        nonce = a.grind[1:].clone()
        if segment == "stwo_a":
            run = lambda: TPROVER._segment_a(TESTING, trace, "wide_fibonacci")  # noqa: E731
        else:
            run = lambda: TPROVER._segment_b(TESTING, a, nonce)  # noqa: E731
    run()
    copies, reads = _host_copies(monkeypatch), _host_reads(monkeypatch)
    with _ScalarReads() as scalar:
        out = run()
    assert copies == [] and reads == [] and scalar.reads == []
    assert tree_leaves(tuple(out))
    x = torch.arange(3)
    with _ScalarReads() as scalar:  # the patches themselves count
        x[torch.tensor(1)]
    assert copies == ["tensor"] and reads == [] and len(scalar.reads) == 1
    x[0].item()
    assert reads == ["item"]
