"""The port's checkpoint / resume (``utils/checkpoint.py``) against the JAX
package's ``utils/checkpoint.py``.

The channel cursor's dict equals JAX's for the same transcript and
restores a state that continues it identically; the batch journal is
byte-identical to the one JAX writes for the same bitmaps, and a journal
either package writes resumes in the other.
"""

import numpy as np
import torch

from stark_symphony_tpu.models.stwo import channel as JC
from stark_symphony_tpu.utils import checkpoint as JK
from stark_symphony_tpu_torch.models.stwo import channel as TC
from stark_symphony_tpu_torch.ops.u32 import from_numpy, to_numpy
from stark_symphony_tpu_torch.utils import checkpoint as TK

ROOT8 = np.arange(8, dtype=np.uint32) * 0x9E3779B9
BITMAPS = [np.array([1, 1, 0, 1, 1, 1, 1, 1, 0], bool), np.ones(9, bool),
           np.zeros(9, bool), np.array([0, 1] * 4 + [1], bool)]


def test_channel_cursor_equals_jax_and_resumes():
    jstate = JC.draw_words(JC.mix_root(JC.init(), ROOT8))[0]
    tstate = TC.draw_words(TC.mix_root(TC.init(), from_numpy(ROOT8)))[0]
    d = TK.channel_state_to_dict(tstate)
    assert d == JK.channel_state_to_dict(jstate)
    restored = TK.channel_state_from_dict(JK.channel_state_to_dict(jstate), "cpu")
    assert restored.digest.dtype == torch.int64 and restored.digest.device.type == "cpu"
    assert torch.equal(restored.digest, tstate.digest)
    assert torch.equal(restored.counter, tstate.counter)
    _, w1 = TC.draw_words(tstate)
    _, w2 = TC.draw_words(restored)
    assert torch.equal(w1, w2)
    np.testing.assert_array_equal(to_numpy(w2), np.asarray(JC.draw_words(jstate)[1]))


def test_journal_byte_identical_and_cross_resumes(tmp_path):
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    jax_ckpt, port_ckpt = JK.BatchCheckpointer(jpath), TK.BatchCheckpointer(tpath)
    for i, bits in enumerate(BITMAPS):
        jax_ckpt.record(i, bits)
        # the port's bitmaps as a verifier gives them: bool, or words 0/1
        port_ckpt.record(i, torch.from_numpy(bits) if i % 2 else from_numpy(bits))
    assert tpath.read_bytes() == jpath.read_bytes()

    # a run stopped after two batches by one package resumes in the other
    for writer, reader in ((JK, TK), (TK, JK)):
        path = tmp_path / f"{writer.__name__}.jsonl"
        first = writer.BatchCheckpointer(path)
        for i in range(2):
            first.record(i, BITMAPS[i])
        resumed = reader.BatchCheckpointer(path)
        assert [resumed.done(i) for i in range(4)] == [True, True, False, False]
        for i in range(2, 4):
            resumed.record(i, BITMAPS[i])
        assert resumed.accepted() == sum(int(b.sum()) for b in BITMAPS)
        assert resumed.batches() == 4
        assert path.read_bytes() == jpath.read_bytes()
