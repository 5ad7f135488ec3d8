"""What every driver shares: the run's context, the clock of the process,
rate and percentile arithmetic, the card's description, the look for JAX,
and loading a configuration by name."""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# build caches and traces: fixed directories inside the checkout
CACHE_DIR = HERE / "_cache"
OUT_DIR = HERE / "_out"
FORBIDDEN = ("jax", "jaxlib", "flax", "gst_tacotron_tpu")


def log(*a) -> None:
    print("[bench]", *a, file=sys.stderr, flush=True)


def quiet_gc() -> None:
    """Collect once and move every object alive now out of the collector's
    sight, so that the window's collections walk only what the window
    allocates."""
    gc.collect()
    gc.freeze()


def process_start() -> float:
    """The wall-clock time (``time.time``) at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules(modules: Sequence[str] = ()) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    names = modules or list(sys.modules)
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def p90(values: Sequence[float]) -> float:
    """The 90th percentile, linear between the order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), 90))


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def flatten(d: Dict, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def load_cell(cell: str) -> Dict[str, Any]:
    """(the cell's entry in ``BENCHMARK.json``, its workload file with its
    traffic mix under ``traffic``)."""
    bench = read_json(ROOT / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[cell]
    workload = read_json(HERE / "workloads" / f"{cell}.json")
    workload["traffic"] = read_json(HERE / "traffic" / f"{entry['traffic']}.json")
    return entry, workload


def load_config(name: str):
    """(the program's Config, the file's dict) of ``configs/<name>.json``:
    the preset with every value the file's ``config`` states applied over
    it, so what runs is what the file holds."""
    from gst_tacotron_tpu_torch.config import apply_overrides, get_preset, to_dict

    spec = read_json(HERE / "configs" / f"{name}.json")
    cfg = apply_overrides(get_preset(spec["preset"]), flatten(spec["config"]))
    spec["config"] = to_dict(cfg)
    return cfg, spec


@dataclasses.dataclass
class Context:
    """One run of one cell."""
    cell: str
    workload: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    started: float
    device: str = "cuda"
    # the cards the cell asks for in BENCHMARK.json: one rank a card
    chips: int = 1
    # also judge the control on the kept calls (``benchmark/control.py``)
    control: bool = False

    @property
    def out_path(self) -> Path:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        return OUT_DIR / f"{self.cell}.trace.json"


@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, float]
    device: Dict[str, Any]
    checks: Dict[str, Dict[str, float]]
    layer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    breakdown: Optional[Dict[str, Any]] = None
