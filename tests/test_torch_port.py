"""Package-level checks of the PyTorch port: no JAX inside it, its proof
ingestion and fixtures, its entry point, and chip_smoke.py's refusal to run
without a GPU."""

import ast
import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from stark_symphony_tpu.models.stwo import proof as JP
from stark_symphony_tpu_torch import entry as E
from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.models.stwo.config import PRODUCTION, TESTING, TESTING_Q4
from stark_symphony_tpu_torch.utils import proofcache as PC
from stark_symphony_tpu_torch.utils import trace as TT

ROOT = pathlib.Path(__file__).resolve().parents[1]
OK_LINE_START = '{"ok": true'


def _run(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import stark_symphony_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 15, mods\n"
        "assert {'stark_symphony_tpu_torch.tools.build',"
        " 'stark_symphony_tpu_torch.parallel.pipeline',"
        " 'stark_symphony_tpu_torch.ops.circle_fft',"
        " 'stark_symphony_tpu_torch.models.stwo.prover',"
        " 'stark_symphony_tpu_torch.parallel.expert',"
        " 'stark_symphony_tpu_torch.parallel.mesh',"
        " 'stark_symphony_tpu_torch.parallel.batch',"
        " 'stark_symphony_tpu_torch.parallel.fri_shard',"
        " 'stark_symphony_tpu_torch.models.stwo.prover_sharded',"
        " 'stark_symphony_tpu_torch.utils.distributed',"
        " 'stark_symphony_tpu_torch.ops.checks',"
        " 'stark_symphony_tpu_torch.utils.trace',"
        " 'stark_symphony_tpu_torch.utils.checkpoint',"
        " 'stark_symphony_tpu_torch.tools.witness',"
        " 'stark_symphony_tpu_torch.tools.debug',"
        " 'stark_symphony_tpu_torch.tools.linkage_audit',"
        " 'stark_symphony_tpu_torch.tools.profile_verify'} <= set(mods), mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('stark_symphony_tpu.') or m == 'stark_symphony_tpu')\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    res = _run(["-c", code], cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def _hash_imports(path: pathlib.Path) -> set:
    """Names of sha256_words / sha256_pair a module imports by name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and (node.module or "").endswith("sha256"):
            names |= {a.name for a in node.names} & {"sha256_words", "sha256_pair"}
    return names


def test_op_sites_cover_every_hash_import():
    """Each entry of utils/trace._OP_SITES resolves to a port module and
    its functions, and every port module that imports a hash op by name is
    listed with that op (a missed site would be a silent hole in
    tools/debug --ops)."""
    listed = {m: set(attrs) for m, attrs in TT._OP_SITES}
    for m, attrs in listed.items():
        assert m.startswith("stark_symphony_tpu_torch.")
        mod = importlib.import_module(m)
        assert all(callable(getattr(mod, a)) for a in attrs), m
    pkg = ROOT / "stark_symphony_tpu_torch"
    for path in sorted(pkg.rglob("*.py")):
        names = _hash_imports(path)
        if not names:
            continue
        rel = path.relative_to(ROOT).with_suffix("")
        mod = ".".join(rel.parts)
        assert names <= listed.get(mod, set()), (mod, names)


def test_chip_smoke_refuses_without_gpu():
    res = _run(["chip_smoke.py"], cwd=ROOT)
    assert res.returncode != 0
    lines = res.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith(OK_LINE_START)
    assert "CUDA is not available" in res.stderr


def test_parse_matches_jax(fixtures_dir):
    path = str(fixtures_dir / "stwo" / "proof_test.json")
    tproof, tcfg = TP.load_json(path)
    jproof, jcfg = JP.load_json(path)
    assert tcfg == TESTING and jcfg.__dict__ == tcfg.__dict__
    for name in TP.StwoProof._fields:
        t, j = getattr(tproof, name), getattr(jproof, name)
        if isinstance(j, tuple):
            assert len(t) == len(j)
            for a, b in zip(t, j):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(t, j)


def test_to_torch_carries_the_words():
    """A JAX-package proof of numpy words becomes the port's proof of int64
    tensors with the same values (words >= 2^31 included)."""
    jproof = JP.replicate(PC.cached_stwo_proof(TESTING), 2)
    tproof = TP.to_torch(jproof)
    assert isinstance(tproof, TP.StwoProof)
    for name in TP.StwoProof._fields:
        t, j = getattr(tproof, name), getattr(jproof, name)
        pairs = zip(t, j) if isinstance(j, tuple) else [(t, j)]
        for a, b in pairs:
            assert a.dtype == torch.int64 and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy().astype(np.uint32), b)
    assert int(tproof.commitments.max()) >= 1 << 31
    # stack and replicate agree with the JAX package's
    one = PC.cached_stwo_proof(TESTING)
    for t, j in zip(TP.stack([one, one]), JP.stack([one, one])):
        for a, b in (zip(t, j) if isinstance(j, tuple) else [(t, j)]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cfg,seed,digest", [
    (PRODUCTION, 0, "63d8168812aa"),
    (PRODUCTION, 255, "63d8168812aa"),
    (TESTING, None, "cb3ec0679d24"),
    (TESTING, 3, "cb3ec0679d24"),
    (TESTING_Q4, None, "5549caf83dce"),
])
def test_proofcache_fixtures(cfg, seed, digest):
    assert PC._cfg_hash(cfg) == digest
    path = PC.fixture_path(cfg, seed)
    assert path.name.startswith(f"stwo_wide_fibonacci_{digest}_")
    assert (seed is None) == ("_s" not in path.name[len("stwo_wide_fibonacci_"):])
    proof = PC.cached_stwo_proof(cfg, seed)
    assert proof.trace_evals.shape == (cfg.n_queries, cfg.n_columns)


def test_proofcache_missing_raises():
    with pytest.raises(FileNotFoundError):
        PC.fixture_path(PRODUCTION, seed=256)


def test_entry_on_cpu():
    """The entry point over PRODUCTION fixtures s0 and s1, on the CPU."""
    fn, (batch,) = E.entry(n_proofs=2, device="cpu")
    assert tuple(batch.trace_evals.shape) == (2, 16, 4)
    assert not torch.equal(batch.commitments[0], batch.commitments[1])
    bitmap = fn(batch)
    assert bitmap.dtype == torch.bool and bitmap.tolist() == [True, True]
    # lanes past the distinct proofs cycle through them
    two = E.production_proofs(2)
    cycled = E.production_batch(3, two)
    np.testing.assert_array_equal(cycled.commitments[2], two[0].commitments)
