"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``BENCHMARK.json`` and in
``workloads/<cell>.json`` (its configuration, driver, check and limits),
the traffic mix in ``traffic/<mix>.json``, the configuration in
``configs/<name>.json``, the driver in
``drivers/<driver>.py`` (``run(ctx) -> common.Result``), and each per-layer
metric in ``metrics/<metric>.py`` (``read(layer) -> float | None``), read
in the cells its ``workloads`` list names.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error. The run exits non-zero, with no result,
without enough CUDA cards, or if JAX or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import re
import sys
from typing import Dict, List

from . import common


def end_to_end_of(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def load_metric(name: str):
    path = common.HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer(bench: dict, cell: str, layer: dict) -> Dict[str, dict]:
    out = {}
    for m in bench["per_layer"]:
        if cell in m["workloads"]:
            value = load_metric(m["name"]).read(layer)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(bench: dict, cell: str, res: common.Result, traced: bool) -> dict:
    if traced:
        metrics = per_layer(bench, cell, res.layer)
    else:
        metrics = {m["name"]: {"value": res.metrics[m["name"]], "unit": m["unit"]}
                   for m in end_to_end_of(bench, cell)}
    line = {"correct": res.correct, "attempted": res.attempted, "failed": res.failed,
            "metrics": metrics, "device": res.device}
    if traced and res.breakdown is not None:
        line["breakdown"] = res.breakdown
    line["checks"] = res.checks
    return line


def main(argv=None) -> int:
    started = common.process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = common.read_json(common.ROOT / "BENCHMARK.json")
    if args.workload not in {w["name"] for w in bench["workloads"]}:
        common.log(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    entry, workload = common.load_cell(args.workload)
    chips = entry["chips"]

    # one process a card with few threads: host thread pools that spin
    # beside the program's own host work widen the spread of its timings
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        common.log(f"the cell needs {chips} CUDA card(s); "
                   f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 2
    # every build and kernel cache at a fixed place inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(common.CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(common.CACHE_DIR / "triton")
    driver = importlib.import_module(f"benchmark.drivers.{workload['driver']}")
    ctx = common.Context(cell=args.workload, workload=workload, seed=args.seed,
                         seconds=args.seconds, trace=bool(args.trace), started=started,
                         chips=chips)
    res = driver.run(ctx)

    bad = common.forbidden_modules()
    if bad:
        common.log(f"JAX or the JAX package is loaded: {', '.join(bad)}")
        return 3
    line = result_line(bench, args.workload, res, bool(args.trace))
    for name, c in res.checks.items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"[check] correct {res.correct}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
