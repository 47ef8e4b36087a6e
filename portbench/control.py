"""The control of each cell's check, and the faults it must catch.

    python3 portbench/control.py --workload <name> --seeds <n,n,...> --seconds <s>

runs the cell as ``run.py`` does, once a seed, with the driver's control in
the program's place: the verifier with one guarantee the configuration
states dropped (the FRI layers' Merkle checks).  Every run has to come out
not correct.  The
benchmark's own runs never run it; ``tests/test_portbench_correct.py``
holds it at small sizes on the CPU, and on the card at the cell's size.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run

    rc = 0
    for seed in args.seeds.split(","):
        rc |= run.main(["--workload", args.workload, "--seed", seed, "--seconds",
                        str(args.seconds), "--trace", "0"], control=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
