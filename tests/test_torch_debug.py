"""The port's debug CLI (``tools/debug.py``) on the CPU, against cheap
oracles, and in full against the JAX package's ``tools/debug.py`` (slow).

* The stwo transcript replays with hashlib from the proof's own fields
  (each mix is H(digest || payload), each draw H(digest || counter)), and
  the stage digests of ``native/symphony verify-stwo -v`` appear among its
  mixes in order; the external fixtures print JAX's verdict under the
  default linkage: REJECT, with the FRI Merkle and last-eval masks failing
  (they verify only under ``unfold``), exit code 1.
* The stark101 transcript replays with hashlib, its beta draws are the
  proof's betas, and the golden proof is accepted.
* ``--ops --ops-filter sha256_pair --limit 2`` prints only that op, each
  result the hashlib node of its printed arguments.
* Without ``--device cpu`` on a machine with no GPU, the CLI raises.
"""

import hashlib
import pathlib
import re
import subprocess

import numpy as np
import pytest

from stark_symphony_tpu_torch.models.stark101 import proof as TP101
from stark_symphony_tpu_torch.models.stwo import proof as TP
from stark_symphony_tpu_torch.tools import debug

ROOT = pathlib.Path(__file__).resolve().parents[1]
NATIVE = ROOT / "native" / "symphony"
P = 0x7FFFFFFF
Q = 3221225473


def _run(capsys, *argv):
    rc = debug.main([*argv, "--device", "cpu"])
    return rc, capsys.readouterr().out


def _h(words) -> list:
    raw = np.asarray([int(w) for w in words], dtype=">u4").tobytes()
    return [int(w) for w in np.frombuffer(hashlib.sha256(raw).digest(), dtype=">u4")]


def _events(out: str) -> list:
    """(op, words) of each transcript line."""
    events = []
    for line in out.splitlines():
        m = re.match(r"\[\s*\d+\] (\w+)\s+([0-9a-f]+)$", line)
        if m:
            hx = m.group(2)
            events.append((m.group(1), [int(hx[i:i + 8], 16) for i in range(0, len(hx), 8)]))
    return events


def _masks(out: str) -> dict:
    return {line[5:]: line[:4] == "ok  " for line in out.splitlines()
            if line[:5] in ("ok   ", "FAIL ")}


def test_stwo_transcript_replays(fixtures_dir, capsys):
    path = fixtures_dir / "stwo" / "proof_test.json"
    rc, out = _run(capsys, "stwo", str(path))
    events = _events(out)
    assert len(events) == 22

    proof, cfg = TP.load_json(str(path))
    payloads = [proof.commitments[0], proof.commitments[1], proof.commitments[2],
                np.concatenate([proof.oods_trace.reshape(-1), proof.oods_cp.reshape(-1)]),
                proof.fri_first_commit, *proof.fri_inner_commits, proof.fri_last,
                proof.pow_nonce]
    digest, counter, mixes = [0] * 8, 0, []
    for op, value in events:
        if op == "mix":
            digest, counter = _h(digest + list(payloads[len(mixes)])), 0
            mixes.append(digest)
            assert value == digest
        else:
            assert op == "draw" and value == _h(digest + [counter])
            counter += 1
    assert len(mixes) == len(payloads)

    native = subprocess.run([str(NATIVE), "verify-stwo", str(path), "-v"],
                            capture_output=True, text=True, timeout=60).stdout
    stages = re.findall(r"\[(I|II|III|IV):[\w-]+\] digest=([0-9a-f]{64})", native)
    assert [s for s, _ in stages] == ["I", "II", "III", "IV"]
    hexes = ["".join(f"{w:08x}" for w in m) for m in mixes]
    at = [hexes.index(d) for _, d in stages]
    assert at == sorted(at)

    masks = _masks(out)
    n_layers = 1 + cfg.n_inner_layers
    failing = [f"fri_merkle_{l}" for l in range(n_layers)] + ["fri_last_eval"]
    assert [k for k, ok in masks.items() if not ok] == failing
    assert out.rstrip().endswith("result: REJECT") and rc == 1


def test_stark101_transcript_replays(fixtures_dir, capsys):
    path = fixtures_dir / "stark101" / "golden_proof.json"
    rc, out = _run(capsys, "stark101", str(path))
    assert rc == 0 and out.rstrip().endswith("result: ACCEPT")
    assert all(_masks(out).values())
    proof = TP101.load_json(str(path))
    n_layers = proof.fri_roots.shape[0]
    mixes = [[int(w) for w in r] for r in proof.fri_roots] + [[int(proof.last)]] + \
        [[int(e)] for e in proof.evals]
    state, draws, n_mix = _h(proof.p_mt_root), [], 0
    for op, value in _events(out):
        if op == "draw":
            # the query index is the draw after the last FRI mix, mod the LDE size
            modulus = 8192 if n_mix == n_layers + 1 else Q
            want = int("".join(f"{w:08x}" for w in state), 16) % modulus
            assert value == [want]
            draws.append(want)
            state = _h(state)
        else:
            state = _h(state + mixes[n_mix])
            n_mix += 1
            assert value == state
    assert n_mix == len(mixes)
    assert draws[3:3 + n_layers] == [int(b) for b in proof.fri_betas]


def test_ops_filtered_and_decoded(fixtures_dir, capsys):
    """The node hashes of stage VII's 3 layers, the first 2 printed, each
    the hashlib node of its printed children; every other op filtered out."""
    path = fixtures_dir / "stwo" / "proof_test.json"
    rc, out = _run(capsys, "stwo", str(path), "--ops", "--ops-filter", "sha256_pair",
                   "--limit", "2")
    assert rc == 1
    lines = out.splitlines()
    pairs = [re.match(r"\[\s*(\d+)\] sha256_pair\s+\(\[([0-9a-f ]+)\], \[([0-9a-f ]+)\]\) "
                      r"-> \[([0-9a-f ]+)\]$", line) for line in lines[:2]]
    assert all(pairs) and [int(m.group(1)) for m in pairs] == [0, 1]
    assert lines[2:4] == ["... (1 more)", "--- masks ---"]
    for m in pairs:
        words = [int(w, 16) for w in (m.group(2) + " " + m.group(3)).split()]
        assert [int(w, 16) for w in m.group(4).split()] == _h(words)


def test_needs_a_gpu_unless_asked_for_the_cpu(fixtures_dir):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        debug.main(["stwo", str(fixtures_dir / "stwo" / "proof_test.json")])


@pytest.mark.slow
@pytest.mark.parametrize("scheme,name", [("stwo", "stwo/proof_test"),
                                         ("stark101", "stark101/golden_proof")])
def test_output_equals_jax(fixtures_dir, capsys, scheme, name):
    from stark_symphony_tpu.tools import debug as jdebug

    path = str(fixtures_dir / f"{name}.json")
    rc, out = _run(capsys, scheme, path)
    assert jdebug.main([scheme, path]) == rc
    assert capsys.readouterr().out == out
