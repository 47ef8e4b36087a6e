"""The port's compile step (``stark_symphony_tpu_torch/tools/build.py``) on
the CPU, where a graphed verifier runs its copy-in, call and copy-out
without a graph.

* ``static_cost`` equals the JAX package's on PRODUCTION and TESTING.
* A manifest round-trips; a corrupted, truncated or foreign one raises
  ValueError; an edited source makes it stale.
* The graphed object gives each batch its own result, checks shapes, and
  never overwrites a result it returned.
* A second call of each verifier (stwo ``verify``, ``verify_batch_tiled``,
  stark101 ``verify``) makes no tensor from host data: nothing for a CUDA
  graph to refuse.

``make_chained`` is held to JAX's bitmap beside the module fixture of
``test_torch_verifier.py``.  TESTING sizes, a few lanes: each verifier call
costs about a second of CPU.
"""

import shutil

import pytest
import torch

from chip_smoke import tamper_batch
from stark_symphony_tpu.tools import build as JB
from stark_symphony_tpu_torch import entry as E
from stark_symphony_tpu_torch.models.stark101 import verifier as V101
from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.models.stwo import tiled as TT
from stark_symphony_tpu_torch.models.stwo import verifier as TV
from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION, TESTING
from stark_symphony_tpu_torch.tools import build as TB
from stark_symphony_tpu_torch.utils.proofcache import cached_stwo_proof


@pytest.mark.parametrize("cfg", [PRODUCTION, TESTING], ids=["production", "testing"])
def test_static_cost_equals_jax(cfg):
    got = TB.static_cost(cfg)
    assert got == JB.static_cost(cfg)
    assert got["total_compr_per_proof"] == (3797 if cfg is PRODUCTION else 67)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return TB.build("testing", 2, "tiled", str(tmp_path_factory.mktemp("graphs")),
                    device="cpu")


def test_manifest_round_trip(manifest):
    fn, meta = TB.load(manifest)
    assert (meta["config"], meta["batch"], meta["path"], meta["chain"],
            meta["backend"]) == ("testing", 2, "tiled", 0, "cpu")
    assert meta["stale"] is False and meta["static_cost"] == TB.static_cost(TESTING)
    assert isinstance(fn, TB.GraphedVerifier) and fn.graph is None


@pytest.mark.parametrize("damage", ["payload", "digest", "truncated", "magic", "empty"])
def test_damaged_manifest_raises(manifest, tmp_path, damage):
    raw = bytearray(open(manifest, "rb").read())
    if damage == "payload":
        raw[-5] ^= 1
    elif damage == "digest":
        raw[len(TB._MAGIC)] ^= 1
    elif damage == "truncated":
        raw = raw[:len(raw) // 2]
    elif damage == "magic":
        raw[0] ^= 1
    else:
        raw = bytearray()
    path = tmp_path / "damaged.manifest"
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        TB.load(str(path))


def test_edited_source_makes_manifest_stale(manifest, tmp_path, monkeypatch):
    pkg = tmp_path / "pkg"
    for sub, _ in TB._HASHED:
        shutil.copytree(TB._PKG / sub, pkg / sub, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(TB, "_PKG", pkg)
    assert TB.load(manifest)[1]["stale"] is False
    edited = pkg / "ops" / "field.py"
    edited.write_text(edited.read_text() + "\n# edited\n")
    assert TB.load(manifest)[1]["stale"] is True


@pytest.fixture(scope="module")
def tamper16():
    """The TESTING tamper batch (lane 0 clean, the 15 classes in lanes
    1-15) as the port's tensors."""
    return TP.to_torch(tamper_batch(cached_stwo_proof(TESTING), 1 + TESTING.n_inner_layers))


def test_graphed_object_on_cpu(tamper16):
    """Each call copies its batch into the static inputs and returns copies
    of its own outputs: an output that is a static input itself, returned
    earlier, is not overwritten by a later call; a batch of other shapes
    raises."""
    tensors = tamper16
    a = TP.map_fields(lambda x: x[:2].clone(), tensors)
    b = TP.map_fields(lambda x: x[2:4].clone(), tensors)
    fn = TB.capture(lambda p: {"commitments": p.commitments, "nonce": p.pow_nonce + 1}, (a,))
    assert fn.launches == {name: 0 for name in TB.launch_counts()}
    first = fn(a)
    second = fn(b)
    assert torch.equal(first["commitments"], tensors.commitments[:2])
    assert torch.equal(first["nonce"], tensors.pow_nonce[:2] + 1)
    assert torch.equal(second["commitments"], tensors.commitments[2:4])
    assert torch.equal(second["nonce"], tensors.pow_nonce[2:4] + 1)
    assert torch.equal(a.commitments, tensors.commitments[:2])  # inputs untouched
    with pytest.raises(ValueError):
        fn(TP.map_fields(lambda x: x[:3], tensors))
    with pytest.raises(ValueError):
        fn(a._replace(commitments=a.commitments.to(torch.int32)))


def _host_copies(monkeypatch):
    """Patch the three ways of making a tensor from host data; returns the
    list of calls they see (torch.as_tensor on a tensor is not one)."""
    calls = []
    for name in ("tensor", "as_tensor", "from_numpy"):
        orig = getattr(torch, name)

        def counted(*args, _name=name, _orig=orig, **kwargs):
            if not (_name == "as_tensor" and isinstance(args[0], torch.Tensor)):
                calls.append(_name)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(torch, name, counted)
    return calls


@pytest.mark.parametrize("which", ["stwo_verify", "stwo_tiled", "stark101_verify"])
def test_second_call_makes_no_host_tensor(which, request, monkeypatch):
    """With each verifier's first call made, its second call makes no
    tensor from host data."""
    if which == "stwo_verify":
        batch = TP.map_fields(lambda x: x[:2], request.getfixturevalue("tamper16"))
        run = lambda: TV.verify(batch, TESTING)  # noqa: E731
        run()
    elif which == "stwo_tiled":
        batch = TT.tile_batch(TP.replicate(cached_stwo_proof(TESTING), 2), TESTING, "cpu")
        run = lambda: TV.verify_batch_tiled(batch, TESTING)  # noqa: E731
        run()
    else:
        _, (batch,) = E.entry_stark101(2, "cpu")
        run = lambda: V101.verify(batch)  # noqa: E731
        run()
    calls = _host_copies(monkeypatch)
    ok = run()
    assert calls == []
    ok = ok[0] if isinstance(ok, tuple) else ok
    assert bool(ok[0]) and tuple(ok.shape) == (batch[0].shape[0],)
    torch.tensor([1])  # the patch itself counts
    assert calls == ["tensor"]
