"""The readings that a cell's limits are set from: the program's numbers and
the control's, on the same calls, seed by seed, at the cell's own size.

    python -m benchmark.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Each seed runs the cell's driver for a short window in this process and
judges the kept calls twice: the program's outputs, and the control's (the
reference computed in the next precision down, TF32, put in the program's
place). Prints one JSON line a seed, ``{"seed", "program", "control"}``,
and a last line with the largest program reading and the smallest control
reading of each number. The benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import common


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import importlib

    import torch

    if not torch.cuda.is_available():
        common.log("no CUDA card")
        return 2
    rows = []
    for seed in args.seeds:
        entry, wl = common.load_cell(args.workload)
        driver = importlib.import_module(f"benchmark.drivers.{wl['driver']}")
        ctx = common.Context(cell=args.workload, workload=wl, seed=seed, seconds=args.seconds,
                             trace=False, started=time.time(), control=True,
                             chips=entry["chips"])
        res = driver.run(ctx)
        row = {"seed": seed, "correct": res.correct, "attempted": res.attempted,
               "program": {k: c["value"] for k, c in res.checks.items()},
               "control": res.layer["control"]}
        for extra in ("worst", "faults"):
            if extra in res.layer:
                row[extra] = res.layer[extra]
        rows.append(row)
        print(json.dumps(row), flush=True)
    keys = rows[0]["program"]
    print(json.dumps({"program_max": {k: max(r["program"][k] for r in rows) for k in keys},
                      "control_min": {k: min(r["control"].get(k, float("inf")) for r in rows)
                                      for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
