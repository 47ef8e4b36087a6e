"""The port's transcript and op tracing (``utils/trace.py``) and the emit
hooks of its channels, against the JAX package's ``utils/trace.py``.

A few channel ops of each proof system and a few field ops, recorded in
both packages, give the same events and the same text; every site of
``_OP_SITES`` is wrapped inside ``record_ops`` and restored after it; the
recorders and ``emit`` refuse a CUDA graph capture by name; with no
recording, ``emit`` touches nothing.
"""

import importlib

import numpy as np
import pytest
import torch

from stark_symphony_tpu.models.stark101 import channel as J101
from stark_symphony_tpu.models.stwo import channel as JC
from stark_symphony_tpu.ops import field as JF
from stark_symphony_tpu.utils import trace as JT
from stark_symphony_tpu_torch.models.stark101 import channel as T101
from stark_symphony_tpu_torch.models.stwo import channel as TC
from stark_symphony_tpu_torch.ops import field as TF
from stark_symphony_tpu_torch.ops.checks import EagerOnlyError
from stark_symphony_tpu_torch.utils import trace as TT

ROOT8 = np.arange(8, dtype=np.uint32) * 0x1F2E3D4C


def from_numpy(a):
    """np.uint32 words (0-d included) -> the port's int64 word tensor."""
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def _stwo_ops(ch, conv):
    state = ch.mix_root(ch.init(), conv(ROOT8))
    return ch.draw_words(state)


def _stark101_ops(ch, conv):
    state = ch.mix_u32(conv(ROOT8), conv(np.uint32(12345)))
    return ch.draw(state, 3221225473)


@pytest.mark.parametrize("ops,jch,tch", [(_stwo_ops, JC, TC), (_stark101_ops, J101, T101)],
                         ids=["stwo", "stark101"])
def test_transcript_equals_jax(ops, jch, tch):
    with JT.record_transcript() as jev:
        ops(jch, np.asarray)
    with TT.record_transcript() as tev:
        ops(tch, from_numpy)
    assert [op for op, _ in tev] == [op for op, _ in jev]
    for (_, t), (_, j) in zip(tev, jev):
        assert t.dtype == np.uint32
        np.testing.assert_array_equal(t, np.asarray(j))
    assert TT.format_transcript(tev) == JT.format_transcript(jev)
    n = len(tev)
    ops(tch, from_numpy)  # nothing recorded outside the context
    assert len(tev) == n


def _field_ops(f, conv):
    f.m31_mul(conv(np.uint32(3)), conv(np.uint32(5)))
    f.m31_sub(conv(np.array([1, 2], np.uint32)), conv(np.array([5, 1], np.uint32)))
    f.qm31_mul(conv(np.array([1, 2, 3, 4], np.uint32)), conv(np.array([5, 6, 7, 8], np.uint32)))
    f.m31_inv(conv(np.arange(16, dtype=np.uint32)))


def test_ops_equal_jax():
    with JT.record_ops() as jev:
        _field_ops(JF, np.asarray)
        JC.mix_root(JC.init(), ROOT8)
    with TT.record_ops() as tev:
        _field_ops(TF, from_numpy)
        TC.mix_root(TC.init(), from_numpy(ROOT8))
    assert tev == jev
    assert TT.format_ops(tev, limit=3) == JT.format_ops(jev, limit=3)
    assert "more)" in TT.format_ops(tev, limit=3)
    only = {"m31_mul", "sha256_words"}
    with TT.record_ops(only) as filtered:
        _field_ops(TF, from_numpy)
        TC.mix_root(TC.init(), from_numpy(ROOT8))
    assert filtered == [e for e in jev if e[0] in only]


def test_every_site_wrapped_and_restored():
    sites = [(importlib.import_module(m), attrs) for m, attrs in TT._OP_SITES]
    with TT.record_ops():
        for mod, attrs in sites:
            for attr in attrs:
                assert getattr(mod, attr).__name__ == f"traced_{attr}", (mod.__name__, attr)
    for mod, attrs in sites:
        for attr in attrs:
            assert getattr(mod, attr).__name__ == attr, (mod.__name__, attr)


def test_emit_outside_recording_touches_nothing():
    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"emit read .{name}")

    TT.emit("mix", Untouchable())


def test_recorders_refuse_a_capture(monkeypatch):
    monkeypatch.setattr(TT, "capturing", lambda: True)
    for recorder in (TT.record_transcript, TT.record_ops):
        with pytest.raises(EagerOnlyError, match="CUDA graph capture"):
            with recorder():
                pass
    monkeypatch.setattr(TT, "capturing", lambda: False)
    with TT.record_transcript():
        monkeypatch.setattr(TT, "capturing", lambda: True)
        with pytest.raises(EagerOnlyError):
            TT.emit("mix", torch.zeros(8, dtype=torch.int64))
