"""The plain reference: it accepts the committed proofs, rejects every
tamper class, agrees with the port stage by stage, and imports nothing of
the port."""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from portbench import inputs
from portbench.reference import stark101 as ref101
from portbench.reference import stwo as ref_stwo
from portbench.tampers import PROD_TAMPERS, STARK101_TAMPERS

ROOT = pathlib.Path(__file__).resolve().parents[2]
STWO = json.loads((ROOT / "portbench/configs/stwo_production.json").read_text())
S101 = json.loads((ROOT / "portbench/configs/stark101.json").read_text())


@pytest.fixture(scope="module")
def stwo_proofs():
    return inputs.distinct_proofs(ROOT, STWO)


def _tampered(proofs, tampers, system):
    """Lane 0 clean, lane k tampered by class k - 1, all of proof 0."""
    stacked = inputs.stack(proofs[:1])
    batch = inputs.Batch(stacked, np.zeros(1 + len(tampers), int),
                         {k + 1: k for k in range(len(tampers))}, system)
    return batch


def test_reference_accepts_committed_stwo_proofs(stwo_proofs):
    assert len(stwo_proofs) == 256
    for proof in stwo_proofs[::17]:
        ok, masks = ref_stwo.verify(proof, STWO["params"])
        assert ok, [k for k, v in masks.items() if not v]


def test_reference_accepts_the_golden_stark101_proof():
    (proof,) = inputs.distinct_proofs(ROOT, S101)
    ok, masks = ref101.verify(proof, S101["params"])
    assert ok, [k for k, v in masks.items() if not v]


@pytest.mark.parametrize("system", ["stwo", "stark101"])
def test_reference_rejects_every_tamper_class_as_the_port_does(system, stwo_proofs):
    import torch  # noqa: F401  (the port's verifiers, on the CPU)

    if system == "stwo":
        from stark_symphony_tpu_torch.models.stwo import proof as P
        from stark_symphony_tpu_torch.models.stwo import verifier as V
        from stark_symphony_tpu_torch.models.stwo.config import StwoConfig

        batch = _tampered(stwo_proofs, PROD_TAMPERS, system)
        cfg, ref = STWO["params"], ref_stwo.verify
        ok, masks = V.verify(P.to_torch(P.StwoProof(**batch.fields), "cpu"), StwoConfig(**cfg))
    else:
        from stark_symphony_tpu_torch.models.stark101 import proof as P
        from stark_symphony_tpu_torch.models.stark101 import verifier as V
        from stark_symphony_tpu_torch.models.stark101.config import Stark101Config

        batch = _tampered(inputs.distinct_proofs(ROOT, S101), STARK101_TAMPERS, system)
        cfg, ref = S101["params"], ref101.verify
        ok, masks = V.verify(P.to_torch(P.Stark101Proof(**batch.fields), "cpu"),
                             Stark101Config(**cfg))
    for lane in range(batch.lanes):
        want_ok, want = ref(batch.lane(lane), cfg)
        assert want_ok == (lane == 0)
        assert list(want) == list(masks)
        assert want == {k: bool(m[lane]) for k, m in masks.items()}, lane
        assert want_ok == bool(ok[lane])


def test_tamper_lane_mutates_one_lane_only(stwo_proofs):
    stacked = inputs.stack(stwo_proofs[:1])
    batch = inputs.Batch(stacked, np.zeros(3, int), {1: 9}, "stwo")  # fri_witnesses layer 0
    assert np.array_equal(batch.fields["fri_witnesses"][0][0], batch.fields["fri_witnesses"][0][2])
    assert not np.array_equal(batch.fields["fri_witnesses"][0][0],
                              batch.fields["fri_witnesses"][0][1])
    assert np.array_equal(stacked["fri_witnesses"][0][0], batch.fields["fri_witnesses"][0][0])


def test_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "portbench/reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0].startswith("stark_symphony") for n in names), path
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.stwo, "
            "portbench.reference.stark101; print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    loaded = set(eval(out.stdout))
    assert not loaded & {"stark_symphony_tpu_torch", "stark_symphony_tpu", "jax", "torch"}
