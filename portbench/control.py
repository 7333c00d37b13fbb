"""The control of the comparison that decides ``correct``: the reference
put in the program's place, with its per-block counts and sums added
in float32 instead of the exact integers the configurations state.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 [--seconds 10]

For each seed it makes the cell's data at the cell's own size and the
traffic of a run of ``--seconds``, takes as many answers as a run
compares (``check_max``, the kept positions of each client in turn)
and counts those where the control's answer differs from the exact
reference's: the comparison's ``wrong``, which has to come out above
its limit (0). One JSON line per seed; the program is not run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from portbench.data import Dataset  # noqa: E402
from portbench.reference import Reference  # noqa: E402
from portbench.run import Bench  # noqa: E402
from portbench.traffic import Mix, read_spec  # noqa: E402


def picks(plan: dict, check_max: int) -> list:
    """[(client, position)]: each client's kept positions in turn, the
    first ones of each, as many as a run compares."""
    out, i = [], 0
    while len(out) < check_max and any(i < len(k) for k in plan["keep"]):
        out += [(c, k[i]) for c, k in enumerate(plan["keep"]) if i < len(k)]
        i += 1
    return out[:check_max]


def control(workload: str, seed: int, seconds: float, check_max: "int | None" = None) -> dict:
    bench = Bench()
    cell = bench.cell(workload)
    spec = read_spec(bench.traffic_path(cell["traffic"]))
    data = Dataset(bench.config(cell["config"]), seed, only=spec["fields"])
    mix = Mix(spec, data.fields)
    plan = mix.plan(seed, seconds)
    exact, low = Reference(data), Reference(data, acc=np.float32)
    t0 = time.perf_counter()
    chosen = picks(plan, check_max or mix.check_max)
    wrong = sum(exact.answer(plan["queries"][c][p]) != low.answer(plan["queries"][c][p]) for c, p in chosen)
    return {"workload": workload, "seed": seed, "checked": len(chosen), "wrong": int(wrong),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    seconds = args.seconds or Bench().spec["run_seconds"]
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed, seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
