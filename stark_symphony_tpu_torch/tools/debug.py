"""symphony debug: the transcript dumper CLI (the ``simfony debug`` analogue).

Port of ``stark_symphony_tpu/tools/debug.py``.  Runs a verifier eagerly on
one proof with channel tracing on and prints every Fiat-Shamir mix/draw
with its value, then the per-stage validity masks and the verdict; exit
code 0 on ACCEPT, 1 on REJECT.  ``--ops`` decodes every primitive call
instead.  Cross-check oracle: ``native/symphony verify-stwo <proof.json>
-v`` prints the same stage digests.

The verifier runs on the card (``--device cuda``, the default: K1-K3 do
its hashing) unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it raises.

Usage:
    python -m stark_symphony_tpu_torch.tools.debug stwo <proof.json>
    python -m stark_symphony_tpu_torch.tools.debug stark101 <proof.json> --device cpu
"""

from __future__ import annotations

import argparse
import sys

from ..utils.trace import format_ops, format_transcript, record_ops, record_transcript
from .build import require_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="symphony-debug")
    ap.add_argument("scheme", choices=["stwo", "stark101"])
    ap.add_argument("proof_json")
    ap.add_argument(
        "--ops", action="store_true",
        help="decode EVERY primitive op call (field/hash/Merkle/circle) "
        "with typed args and results; default traces channel mix/draw "
        "events only",
    )
    ap.add_argument(
        "--ops-filter", default=None,
        help="comma-separated op names to restrict --ops to (e.g. "
        "'m31_mul,sha256_pair')",
    )
    ap.add_argument("--limit", type=int, default=None, help="print at most N op events")
    ap.add_argument("--device", default="cuda", help="torch device to verify on (default cuda)")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    only = set(args.ops_filter.split(",")) if args.ops_filter else None
    recorder = record_ops(only) if args.ops else record_transcript()

    if args.scheme == "stwo":
        from ..models.stwo import proof as P
        from ..models.stwo import verifier

        proof, cfg = P.load_json(args.proof_json)
        proof = P.to_torch(proof, device)
    else:
        from ..models.stark101 import proof as P
        from ..models.stark101 import verifier
        from ..models.stark101.config import Stark101Config

        proof = P.to_torch(P.load_json(args.proof_json), device)
        cfg = Stark101Config()
    with recorder as events:
        ok, masks = verifier.verify(proof, cfg)

    if args.ops:
        print(format_ops(events, limit=args.limit))
    else:
        print(format_transcript(events))
    print("--- masks ---")
    for name, m in masks.items():
        print(f"{'ok  ' if bool(m.all()) else 'FAIL'} {name}")
    accepted = bool(ok.all())
    print(f"result: {'ACCEPT' if accepted else 'REJECT'}")
    return 0 if accepted else 1


if __name__ == "__main__":
    sys.exit(main())
