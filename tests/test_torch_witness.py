"""The port's witness export (``tools/witness.py``) and packing helpers
(``utils/packing.py``) against the JAX package's and the committed
``.wit.json`` fixtures, byte for byte.

Host-only: numpy in, text out, in both packages.
"""

import json

import numpy as np
import pytest

from stark_symphony_tpu.models.stwo import proof as JP
from stark_symphony_tpu.tools import witness as JW
from stark_symphony_tpu.utils import packing as JPk
from stark_symphony_tpu_torch.models.stark101 import proof as TP101
from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.models.stwo.config import TESTING
from stark_symphony_tpu_torch.tools import witness as TW
from stark_symphony_tpu_torch.utils import packing as TPk
from stark_symphony_tpu_torch.utils.proofcache import cached_stwo_proof

PROOFS = [("stwo", "stwo/proof_test"), ("stwo", "stwo/proof"),
          ("stark101", "stark101/golden_proof")]


@pytest.mark.parametrize("scheme,name", PROOFS, ids=[n for _, n in PROOFS])
def test_wit_and_simf_equal_fixture_and_jax(fixtures_dir, capsys, scheme, name):
    data = json.load(open(fixtures_dir / f"{name}.json"))
    golden = json.load(open(fixtures_dir / f"{name}.wit.json"))
    wit, simf = (TW.stwo_wit, TW.stwo_simf) if scheme == "stwo" else \
        (TW.stark101_wit, TW.stark101_simf)
    jwit, jsimf = (JW.stwo_wit, JW.stwo_simf) if scheme == "stwo" else \
        (JW.stark101_wit, JW.stark101_simf)
    assert wit(data) == golden
    assert json.dumps(wit(data), indent=4) == json.dumps(jwit(data), indent=4)
    assert simf(data) == jsimf(data)
    # the CLIs print the same bytes
    for fmt in ("wit", "simf"):
        argv = [scheme, str(fixtures_dir / f"{name}.json"), "--format", fmt]
        assert TW.main(argv) == 0
        port_out = capsys.readouterr().out
        assert JW.main(argv) == 0
        assert port_out == capsys.readouterr().out


@pytest.mark.parametrize("source", ["proof_test", "own_testing"])
def test_stwo_proof_json_round_trip(fixtures_dir, source):
    """parse(export(p)) is p, and the export equals JAX's export."""
    if source == "own_testing":
        proof, cfg = cached_stwo_proof(TESTING), TESTING
    else:
        proof, cfg = TP.load_json(str(fixtures_dir / "stwo" / f"{source}.json"))
    exported = TW.stwo_proof_json(proof, cfg)
    jproof, jcfg = JP.parse(exported)
    assert exported == JW.stwo_proof_json(jproof, jcfg)
    back, back_cfg = TP.parse(exported)
    assert back_cfg == cfg
    for name in TP.StwoProof._fields:
        a, b = getattr(back, name), getattr(proof, name)
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            np.testing.assert_array_equal(x, y)
    assert TW.stwo_wit(exported) == JW.stwo_wit(exported)


def test_stark101_export_feeds_the_wit(fixtures_dir):
    data = json.load(open(fixtures_dir / "stark101" / "golden_proof.json"))
    proof = TP101.load_json(str(fixtures_dir / "stark101" / "golden_proof.json"))
    assert TW.stark101_wit(TP101.to_json_dict(proof)) == TW.stark101_wit(data)


def test_packing_helpers_equal_jax():
    rng = np.random.default_rng(5)
    for _ in range(4):
        raw = rng.bytes(32)
        words = TPk.bytes32_to_words(raw)
        np.testing.assert_array_equal(words, JPk.bytes32_to_words(raw))
        assert words.dtype == np.uint32
        assert TPk.words_to_bytes32(words) == raw == JPk.words_to_bytes32(words)
        h = "0x" + raw.hex()
        np.testing.assert_array_equal(TPk.hex_to_words(h), JPk.hex_to_words(h))
        np.testing.assert_array_equal(TPk.hex_to_words(h[2:]), words)
        v = int(rng.integers(0, 1 << 63)) * 2 + 1
        np.testing.assert_array_equal(TPk.u64_to_words(v), JPk.u64_to_words(v))
    with pytest.raises(ValueError):
        TPk.bytes32_to_words(b"\0" * 31)
