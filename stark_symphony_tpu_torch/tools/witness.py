"""Proof ingestion/export tools: proof.json <-> witness files.

Port of ``stark_symphony_tpu/tools/witness.py``, host-only (numpy), over
the port's ``models/stwo/proof.py`` and ``models/stark101/proof.py``; its
output is byte-equal to the JAX package's.  The reference ships generator
scripts per verifier that map prover proof JSON onto SimplicityHL witness
files (``.wit``) or inline proof literals (``.simf``); this module offers
the same interop surface in both directions:

* export a proof produced by the port's provers into the reference's
  proof.json schema (``stwo_proof_json``; stark101's is
  ``models/stark101/proof.to_json_dict``), so the reference tooling can
  consume proofs made here;
* render the ``.wit`` witness map / inline ``.simf`` literal for either
  verifier from a proof.json dict.

CLI:  python -m stark_symphony_tpu_torch.tools.witness {stwo|stark101} proof.json
          [--format wit|simf]
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

import numpy as np

# --------------------------------------------------------------------- #
# shared value formatting                                               #
# --------------------------------------------------------------------- #


def _u256_hex(words8) -> str:
    """8 big-endian u32 words -> 0x-prefixed 64-nibble literal."""
    v = 0
    for w in np.asarray(words8, dtype=np.uint64):
        v = (v << 32) | int(w)
    return "0x" + format(v, "064x")


def _qm31_str(q4) -> str:
    a, b, c, d = (int(x) for x in np.asarray(q4))
    return f"(({a}, {b}), ({c}, {d}))"


def _hash_list(words_2d) -> str:
    return "list![" + ", ".join(_u256_hex(h) for h in words_2d) + "]"


# --------------------------------------------------------------------- #
# stwo: StwoProof -> proof.json schema                                  #
# --------------------------------------------------------------------- #


def _words_to_bytes_list(words8) -> List[int]:
    out: List[int] = []
    for w in np.asarray(words8, dtype=np.uint64):
        w = int(w)
        out += [(w >> 24) & 0xFF, (w >> 16) & 0xFF, (w >> 8) & 0xFF, w & 0xFF]
    return out


def _qm31_json(q4) -> list:
    a, b, c, d = (int(x) for x in np.asarray(q4))
    return [[a, b], [c, d]]


def stwo_proof_json(proof, cfg) -> Dict[str, Any]:
    """Export a StwoProof (models/stwo/proof.py) into the stwo prover's
    proof.json schema: the inverse of models/stwo/proof.parse, so
    parse(stwo_proof_json(p, cfg)) round-trips bit-exactly and the
    reference witness generator accepts the file."""
    q = cfg.n_queries

    def concat_hashes(sibs):  # (Q, D, 8) -> flat list of 32-byte lists
        arr = np.asarray(sibs)
        return [
            _words_to_bytes_list(arr[i, d])
            for i in range(arr.shape[0])
            for d in range(arr.shape[1])
        ]

    fri_layers = []
    n_layers = 1 + cfg.n_inner_layers
    for l in range(n_layers):
        fri_layers.append(
            {
                "commitment": _words_to_bytes_list(
                    proof.fri_first_commit
                    if l == 0
                    else proof.fri_inner_commits[l - 1]
                ),
                "fri_witness": [
                    [_qm31_json(proof.fri_witnesses[l][i])] for i in range(q)
                ],
                "decommitment": {
                    "hash_witness": concat_hashes(proof.fri_sibs[l]),
                    "column_witness": [],
                },
            }
        )

    nonce = (int(proof.pow_nonce[0]) << 32) | int(proof.pow_nonce[1])
    return {
        "config": {
            "pow_bits": cfg.pow_bits,
            "fri_config": {
                "log_blowup_factor": cfg.lde_log_size - cfg.trace_log_size,
                "log_last_layer_degree_bound": 0,
                "n_queries": q,
            },
        },
        "commitments": [
            _words_to_bytes_list(proof.commitments[k]) for k in range(3)
        ],
        "sampled_values": [
            [],
            [[_qm31_json(proof.oods_trace[c])] for c in range(cfg.n_columns)],
            [[_qm31_json(proof.oods_cp[k])] for k in range(cfg.n_cp_partitions)],
        ],
        "decommitments": [
            {"hash_witness": [], "column_witness": []},
            {
                "hash_witness": concat_hashes(proof.trace_sibs),
                "column_witness": [],
            },
            {
                "hash_witness": concat_hashes(proof.cp_sibs),
                "column_witness": [],
            },
        ],
        "queried_values": [
            [],
            [int(v) for v in np.asarray(proof.trace_evals).reshape(-1)],
            [int(v) for v in np.asarray(proof.cp_evals).reshape(-1)],
        ],
        "proof_of_work": nonce,
        "fri_proof": {
            "first_layer": fri_layers[0],
            "inner_layers": fri_layers[1:],
            "last_layer_poly": {
                "coeffs": [[_qm31_json(proof.fri_last)]],
                "log_size": 0,
            },
        },
    }


# --------------------------------------------------------------------- #
# stwo: proof.json -> .wit / .simf                                      #
# --------------------------------------------------------------------- #


def stwo_wit(data: Dict[str, Any]) -> Dict[str, Dict[str, str]]:
    """stwo proof.json -> SimplicityHL `.wit` witness map, matching the
    output of the reference generator, keyed by the six witness names of
    the stwo verifier's main.simf."""
    from ..models.stwo import proof as P

    proof, cfg = P.parse(data)
    q = cfg.n_queries
    n_layers = cfg.n_inner_layers

    commitments = "(" + ", ".join(
        _u256_hex(proof.commitments[k]) for k in range(3)
    ) + ")"

    trace_oods = "[" + ", ".join(
        "[" + _qm31_str(proof.oods_trace[c]) + "]" for c in range(cfg.n_columns)
    ) + "]"
    cp_oods = "[" + ", ".join(
        _qm31_str(proof.oods_cp[k]) for k in range(cfg.n_cp_partitions)
    ) + "]"

    decommit_items = []
    for i in range(q):
        tvals = "[" + ", ".join(
            f"[{int(v)}]" for v in proof.trace_evals[i]
        ) + "]"
        cvals = "[" + ", ".join(str(int(v)) for v in proof.cp_evals[i]) + "]"
        decommit_items.append(
            f"(({tvals}, {_hash_list(proof.trace_sibs[i])}), "
            f"({cvals}, {_hash_list(proof.cp_sibs[i])}))"
        )

    def layer_decommitment(l: int) -> str:
        items = [
            f"({_qm31_str(proof.fri_witnesses[l][i])}, "
            f"{_hash_list(proof.fri_sibs[l][i])})"
            for i in range(q)
        ]
        return "[" + ", ".join(items) + "]"

    fri_commitments = (
        f"({_u256_hex(proof.fri_first_commit)}, "
        + "["
        + ", ".join(_u256_hex(proof.fri_inner_commits[i]) for i in range(n_layers))
        + f"], {_qm31_str(proof.fri_last)})"
    )
    fri_decommitments = (
        f"({layer_decommitment(0)}, "
        + "["
        + ", ".join(layer_decommitment(1 + i) for i in range(n_layers))
        + "])"
    )

    m31, proof32 = "u32", "List<u256, 32>"
    qm31 = f"(({m31}, {m31}), ({m31}, {m31}))"
    trace_m31 = f"[[{m31}; 1]; {cfg.n_columns}]"
    cp_m31 = f"[{m31}; {cfg.n_cp_partitions}]"
    trace_q = f"[[{qm31}; 1]; {cfg.n_columns}]"
    cp_q = f"[{qm31}; {cfg.n_cp_partitions}]"
    layer_dec_t = f"[({qm31}, {proof32}); {q}]"

    nonce = (int(proof.pow_nonce[0]) << 32) | int(proof.pow_nonce[1])
    return {
        "COMMITMENTS": {"value": commitments, "type": "(u256, u256, u256)"},
        "DECOMMITMENTS": {
            "value": "[" + ", ".join(decommit_items) + "]",
            "type": f"[(({trace_m31}, {proof32}), ({cp_m31}, {proof32})); {q}]",
        },
        "OODS_EVALS": {
            "value": f"({trace_oods}, {cp_oods})",
            "type": f"({trace_q}, {cp_q})",
        },
        "FRI_COMMITMENTS": {
            "value": fri_commitments,
            "type": f"(u256, [u256; {n_layers}], {qm31})",
        },
        "FRI_DECOMMITMENTS": {
            "value": fri_decommitments,
            "type": f"({layer_dec_t}, [{layer_dec_t}; {n_layers}])",
        },
        "POW_NONCE": {"value": str(nonce), "type": "u64"},
    }


def stwo_simf(data: Dict[str, Any]) -> str:
    """stwo proof.json -> inline `let proof: Proof = ...;` literal."""
    w = stwo_wit(data)
    return (
        "let proof: Proof = ("
        + ", ".join(
            w[k]["value"]
            for k in (
                "COMMITMENTS",
                "OODS_EVALS",
                "FRI_COMMITMENTS",
                "POW_NONCE",
                "DECOMMITMENTS",
                "FRI_DECOMMITMENTS",
            )
        )
        + ");"
    )


# --------------------------------------------------------------------- #
# stark101: proof.json -> .wit / .simf                                  #
# --------------------------------------------------------------------- #


def stark101_wit(proof_json: Dict[str, Any]) -> Dict[str, Dict[str, str]]:
    """stark101 proof.json -> `.wit` map with the four witness names of
    the stark101 verifier's main.simf."""
    evals = ", ".join(
        f"({int(v)}, list![" + ", ".join(str(int(s)) for s in sibs) + "])"
        for v, sibs in proof_json["evals"]
    )
    layers = ", ".join(
        "(("
        + f"{int(l[0])}, {int(l[1])}, {int(l[2])}, "
        + "list![" + ", ".join(str(int(x)) for x in l[3]) + "], "
        + f"{int(l[4])}, "
        + "list![" + ", ".join(str(int(x)) for x in l[5]) + "]"
        + "))"
        for l in proof_json["fri_layers"]
    )
    eval_t = "(u32, List<u256, 32>)"
    return {
        "P_MT_ROOT": {"value": str(proof_json["p_mt_root"]), "type": "u256"},
        "P_EVALS": {
            "value": f"({evals})",
            "type": f"({eval_t}, {eval_t}, {eval_t})",
        },
        "FRI_LAYERS": {
            "value": f"list![{layers}]",
            "type": "List<((u256, u32, u32, List<u256, 32>, u32, List<u256, 32>), 32)",
        },
        "FRI_LAST_LAYER": {
            "value": str(proof_json["fri_last_layer"]),
            "type": "u32",
        },
    }


def stark101_simf(proof_json: Dict[str, Any]) -> str:
    """stark101 proof.json -> inline FibSquareProof literal."""
    def fmt_evals(entry):
        v, sibs = entry
        inner = ", ".join(str(int(s)) for s in sibs)
        return f"({int(v)}, list![{inner}])"

    def fmt_layer(l):
        a = ", ".join(str(int(x)) for x in l[3])
        b = ", ".join(str(int(x)) for x in l[5])
        return (
            f"({int(l[0])}, {int(l[1])}, {int(l[2])}, "
            f"list![{a}], {int(l[4])}, list![{b}])"
        )

    evals = ", ".join(fmt_evals(e) for e in proof_json["evals"])
    layers = ", ".join(fmt_layer(l) for l in proof_json["fri_layers"])
    return (
        "let proof: FibSquareProof = ("
        f"{proof_json['p_mt_root']}, ({evals}), "
        f"list![{layers}], {proof_json['fri_last_layer']});"
    )


# --------------------------------------------------------------------- #
# CLI                                                                   #
# --------------------------------------------------------------------- #


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="proof.json -> .wit / .simf"
    )
    ap.add_argument("scheme", choices=["stwo", "stark101"])
    ap.add_argument("proof_json")
    ap.add_argument("--format", choices=["wit", "simf"], default="wit")
    args = ap.parse_args(argv)

    with open(args.proof_json) as f:
        data = json.load(f)

    if args.scheme == "stwo":
        out = stwo_wit(data) if args.format == "wit" else stwo_simf(data)
    else:
        out = (
            stark101_wit(data) if args.format == "wit" else stark101_simf(data)
        )
    print(json.dumps(out, indent=4) if isinstance(out, dict) else out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
