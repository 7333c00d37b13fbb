"""A run of one cell on the CPU, at a tiny size, with the program's
plain versions of its kernels: the tests' way to drive the harness
without a card.

    python3 portbench/rehearse.py <workload> [--fault answer|half] [--trace 1] [--seconds 2]

It sets the program's shard width (2^16 columns) before the program is
imported, runs ``run.main`` over 8 shards and, last on standard error,
prints ``modules {...}``: the top-level names of every module loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ["PILOSA_TPU_SHARD_WIDTH_EXP"] = "16"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402

SHARDS = 8


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("workload")
    ap.add_argument("--fault", choices=("answer", "half"))
    ap.add_argument("--trace", default="0")
    ap.add_argument("--seconds", default="2")
    ap.add_argument("--seed", default="3000000011")
    args = ap.parse_args()
    rehearsal = {"shards": SHARDS, "width_exp": 16}
    if args.fault:
        rehearsal["fault"] = args.fault
    rc = run.main(["--workload", args.workload, "--seed", args.seed, "--seconds", args.seconds,
                   "--trace", args.trace], rehearsal=rehearsal)
    print("modules " + json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})), file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
