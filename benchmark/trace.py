"""Device traces: capture with torch.profiler, reduce to what the per-layer
readers need.

``capture`` profiles a run of calls (CPU and CUDA activity), writes the
Chrome trace to a fixed path inside the checkout and returns the host
window. ``summarize`` reads the trace's device events (kernels, memcpys,
memsets) of one card: the union of their intervals (busy seconds; an
event that overlaps another counts once), device seconds by class (each
port kernel by its launcher, memcpys by direction, NCCL, the rest as
library work), the top operations by device time and the longest idle
gaps named by the host operation that ran across them.

``check_complete`` is the guard against a profile that lost events (one
once lost a whole WaveRNN sampler launch): device time has to be there, and
each port launcher the program counted in the profiled calls has to show
at least as many kernels of its own in the trace.
"""

from __future__ import annotations

import bisect
import json
import re
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# the port's kernels by launcher (``csrc/<launcher>.cu``), by the names of
# their __global__ functions (a template's demangled name starts "void ")
PORT_KERNELS = (
    ("decode_scan", re.compile(r"^(?:void )?decode_(phase|scores|attend|prep|prep_weights)\b")),
    ("gru_scan", re.compile(r"^(?:void )?gru_(input_gemm|recur_kernel|stream_kernel)\b")),
    ("refenc_stack", re.compile(r"^(?:void )?refenc_(layer|bf16)_kernel\b")),
    ("stft", re.compile(r"^(?:void )?stft_(wav|bf16_wgmma)_kernel\b")),
    ("stft_frames", re.compile(r"^(?:void )?stft_frames_kernel\b")),
    ("wavernn_sample", re.compile(r"^(?:void )?wavernn_sample_kernel\b")),
)
# the program's launch counters that each class answers to
COUNTERS = {"decode_scan": ("decode_scan",), "gru_scan": ("gru_scan",),
            "refenc_stack": ("refenc_stack",), "stft": ("stft_features", "stft_fused"),
            "stft_frames": ("stft_frames",), "wavernn_sample": ("wavernn_sample",)}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


def classify(name: str, cat: str) -> str:
    if cat == "gpu_memcpy" or name.startswith("Memcpy"):
        for d in ("DtoH", "HtoD", "DtoD"):
            if d in name:
                return f"memcpy_{d}"
        return "memcpy"
    if cat == "gpu_memset" or name.startswith("Memset"):
        return "memset"
    if "nccl" in name.lower():
        return "nccl"
    for cls, pat in PORT_KERNELS:
        if pat.match(name):
            return cls
    return "library"


def capture(fn: Callable[[], None], calls: int, path: str) -> float:
    """Profile ``calls`` calls of ``fn`` (each ending with its results on
    the host); write the Chrome trace to ``path``; return the host seconds
    from the first call's start to the last call's end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    return window


def profile(fn: Callable[[], None], calls: int, path: str,
            reset: Callable[[], None] = lambda: None,
            counted: Callable[[], Dict[str, int]] = dict) -> Dict:
    """``capture`` and ``summarize`` ``calls`` calls of ``fn``; a profile that
    fails ``check_complete`` (``counted()``: the program's launch counters
    after ``reset()``) is taken once more, and a second raises."""
    for attempt in range(2):
        reset()
        window = capture(fn, calls, path)
        summary = summarize(load(path), window)
        problem = check_complete(summary, counted())
        if problem is None:
            return summary
        print(f"[bench] profile {attempt + 1}: {problem}", file=sys.stderr, flush=True)
    raise RuntimeError(f"the profile lost events twice: {problem}")


def load(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _device_of(ev: dict) -> Optional[int]:
    args = ev.get("args") or {}
    for key in ("device", "Device"):
        if key in args:
            return int(args[key])
    pid = ev.get("pid")
    return int(pid) if isinstance(pid, int) else None


def merged(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def summarize(events: Sequence[dict], window_s: float, device: int = 0,
              top: int = 10) -> Dict:
    """The device side of a trace (times in the trace are microseconds)."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and _device_of(e) == device]
    by_class: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    spans = []
    for e in dev:
        dur = float(e.get("dur", 0.0))
        cls = classify(e["name"], e["cat"])
        by_class[cls] += dur * 1e-6
        by_name[e["name"]] += dur * 1e-6
        counts[cls] += 1
        spans.append((float(e["ts"]), float(e["ts"]) + dur))
    busy = merged(spans)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                  for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS)
    starts = [h[0] for h in host]
    gap_by_host: Dict[str, float] = defaultdict(float)
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        gap_by_host[_host_at(host, starts, (s + e) / 2)] += (e - s) * 1e-6
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": window_s,
        "kernels": sum(n for c, n in counts.items() if not c.startswith("mem")),
        "class_s": dict(by_class),
        "class_n": dict(counts),
        "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda r: -r[1])[:top],
        "idle_gaps": sorted(([n, s] for n, s in gap_by_host.items()),
                            key=lambda r: -r[1])[:top],
    }


def _host_at(host: Sequence[Tuple[float, float, str]], starts: Sequence[float],
             t: float, look: int = 256) -> str:
    """The innermost host operation running at ``t`` (µs): of the ``look``
    latest to start before it, the latest that is still running; ``python``
    where none is."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - look), -1):
        if host[j][1] >= t:
            return host[j][2][:80]
    return "python"


def check_complete(summary: Dict, launches: Dict[str, int]) -> Optional[str]:
    """None where the profile holds what the program launched, else why not.
    ``launches`` is the growth of the program's launch counters over the
    profiled calls."""
    if summary["busy_s"] <= 0.0:
        return "no device time in the profile"
    for cls, counters in COUNTERS.items():
        want = sum(launches.get(c, 0) for c in counters)
        got = summary["class_n"].get(cls, 0)
        if got < want:
            return f"{cls}: {got} kernels in the trace, {want} launches counted"
    return None
