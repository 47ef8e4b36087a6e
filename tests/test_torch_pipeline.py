"""The port's pipeline (``stark_symphony_tpu_torch/parallel/pipeline.py``)
on the CPU: ``scan_microbatches`` refuses a batch it cannot split, and
``StreamVerifier`` a depth below 1.  What they compute is held to JAX's
bitmaps beside the module fixtures that already hold them:
``scan_microbatches`` and the standard stream in ``test_torch_verifier.py``,
the tiled stream in ``test_torch_tiled.py``, the stark101 stream in
``test_torch_stark101.py``.
"""

import pytest

from chip_smoke import tamper_batch
from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.models.stwo import verifier as TV
from stark_symphony_tpu_torch.models.stwo.config import TESTING
from stark_symphony_tpu_torch.parallel import pipeline as PL
from stark_symphony_tpu_torch.utils.proofcache import cached_stwo_proof


def verify_testing(b):
    return TV.verify_batch(b, TESTING)


@pytest.fixture(scope="module")
def stwo4():
    """Lanes 0-3 of the TESTING tamper batch as numpy words."""
    batch = tamper_batch(cached_stwo_proof(TESTING), 1 + TESTING.n_inner_layers)
    return TP.map_fields(lambda x: x[:4].copy(), batch)


def test_scan_microbatches_rejects_bad_splits(stwo4):
    tensors = TP.to_torch(stwo4)
    with pytest.raises(ValueError):
        PL.scan_microbatches(verify_testing, tensors, 3)
    ragged = tensors._replace(pow_nonce=tensors.pow_nonce[:2])
    with pytest.raises(ValueError):
        PL.scan_microbatches(verify_testing, ragged, 2)


def test_stream_rejects_bad_depth():
    with pytest.raises(ValueError):
        PL.StreamVerifier(verify_testing, depth=0, device="cpu")
