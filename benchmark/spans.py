"""The program's own spans in a device trace: what the host was doing while
the card waited, and what each stage launched.

The port marks its stages with ``utils/profiling.py::span``: ``gst.*``
``user_annotation`` events in the same Chrome trace as the card's activity,
on the profiler's clock. ``summarize`` takes those of the thread that
opened the top-level spans (the one whose top-level spans last longest),
nests them, and gives for each span name:

- ``count``, ``wall_s`` and ``self_s`` (the wall time less that of its
  child ``gst.*`` spans);
- ``idle_s``: seconds in which the card ran no kernel, memcpy or memset
  (``trace.summarize``'s idle) while the span was the innermost open one,
  found by a sweep over the span stack; ``idle_in_s`` the same while it was
  open at any depth;
- ``device_s`` and ``launches``: the kernels, memcpys and memsets whose
  launching ``cuda_runtime`` or ``cuda_driver`` event (matched by
  ``args.correlation``) ran on that thread inside the span, at any depth.

Idle is taken over the window from the first top-level span's start to the
last one's end; ``unspanned_idle_s`` is the idle under no ``gst.*`` span.
A trace without such spans (a program that marks none) gives None.

The readers under ``metrics/`` take a driver's ``layer``. ``of_run`` and
``counters_of_run`` give them the spans and the program's counters of a
traced run: the layer's own ``spans`` and ``counters`` where a driver puts
them there; else, once the driver has profiled (``layer["trace"]``), the
summary of the trace it wrote last under ``common.OUT_DIR`` in this process,
read once, and the program's counters over the whole process with the
number of its calls (``calls``). A program without spans or counters gives
None.
"""

from __future__ import annotations

import bisect
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from . import common, trace

PREFIX = "gst."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _spans(events: Sequence[dict]) -> List[dict]:
    """The ``gst.*`` spans of the thread whose top-level spans last longest."""
    by_tid: Dict = defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and str(e.get("name", "")).startswith(PREFIX)):
            by_tid[e.get("tid")].append(e)
    if not by_tid:
        return []

    def top_level_us(evs):
        total, end = 0.0, float("-inf")
        for e in sorted(evs, key=lambda e: float(e["ts"])):
            if float(e["ts"]) >= end:
                end = float(e["ts"]) + float(e.get("dur", 0.0))
                total += float(e.get("dur", 0.0))
        return total

    return max(by_tid.values(), key=top_level_us)


def _segments(spans: List[dict]) -> Tuple[List[Tuple[float, float, tuple]], int, float, float]:
    """The window, from the first span's start to the last one's end, cut
    where the innermost open span changes: (start, end, the open spans'
    names, outermost first) in time order, () between top-level spans; and
    the top-level spans' count, the window's start and end (µs). A span that
    overruns its parent is cut at the parent's end."""
    order = sorted(spans, key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
    segs: List[Tuple[float, float, tuple]] = []
    stack: List[Tuple[float, str]] = []      # (end, name)
    cursor, tops = float(order[0]["ts"]), 0

    def emit(until):
        nonlocal cursor
        if until > cursor:
            segs.append((cursor, until, tuple(n for _, n in stack)))
            cursor = until

    for e in order:
        s = float(e["ts"])
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0])
            stack.pop()
        emit(s)
        end = s + float(e.get("dur", 0.0))
        if stack:
            end = min(end, stack[-1][0])
        else:
            tops += 1
        stack.append((end, e["name"]))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    return segs, tops, float(order[0]["ts"]), cursor


def summarize(events: Sequence[dict], device: int = 0) -> Optional[Dict]:
    """The spans' figures (seconds) on card ``device``, as the module says."""
    spans = _spans(events)
    if not spans:
        return None
    tid = spans[0].get("tid")
    segs, tops, w0, w1 = _segments(spans)
    out: Dict[str, Dict] = {}
    for e in spans:
        r = out.setdefault(e["name"], {"count": 0, "wall_s": 0.0, "self_s": 0.0,
                                       "idle_s": 0.0, "idle_in_s": 0.0, "device_s": 0.0,
                                       "launches": 0})
        r["count"] += 1
        r["wall_s"] += float(e.get("dur", 0.0)) * 1e-6
    for s, e, names in segs:
        if names:
            out[names[-1]]["self_s"] += (e - s) * 1e-6

    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATS
           and trace._device_of(e) == device]
    busy = trace.merged([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                         for e in dev])
    idle_total, unspanned, j = 0.0, 0.0, 0
    for s, e, names in segs:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        covered, k = 0.0, j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
        idle = (e - s - covered) * 1e-6
        idle_total += idle
        if not names:
            unspanned += idle
            continue
        out[names[-1]]["idle_s"] += idle
        for n in set(names):
            out[n]["idle_in_s"] += idle

    launched = {(e.get("args") or {}).get("correlation"): float(e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATS and e.get("tid") == tid}
    starts = [s for s, _, _ in segs]
    for e in dev:
        t = launched.get((e.get("args") or {}).get("correlation"))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t >= segs[i][1]:
            continue
        for n in set(segs[i][2]):
            out[n]["device_s"] += float(e.get("dur", 0.0)) * 1e-6
            out[n]["launches"] += 1
    return {"calls": tops, "window_s": (w1 - w0) * 1e-6, "idle_s": idle_total,
            "unspanned_idle_s": unspanned, "spans": out}


# the last trace summarized, by (path, mtime, size): a run's readers share one read
_read: Dict[tuple, Optional[Dict]] = {}


def _latest_trace() -> Optional[str]:
    """The newest ``*.trace.json`` under ``common.OUT_DIR`` written since
    this process started."""
    started = (common.process_start() - 1.0) * 1e9
    found = [(p.stat().st_mtime_ns, p) for p in common.OUT_DIR.glob("*.trace.json")]
    found = [(t, p) for t, p in found if t >= started]
    return str(max(found)[1]) if found else None


def of_run(layer: Dict) -> Optional[Dict]:
    """``summarize`` of the run whose driver gave ``layer``."""
    if "spans" in layer:
        return layer["spans"]
    path = _latest_trace() if "trace" in layer else None
    if path is None:
        return None
    st = os.stat(path)
    key = (path, st.st_mtime_ns, st.st_size)
    if key not in _read:
        _read.clear()
        _read[key] = summarize(trace.load(path))
    return _read[key]


def counters_of_run(layer: Dict) -> Optional[Dict[str, int]]:
    """The program's counters of the run whose driver gave ``layer``."""
    if "counters" in layer:
        return layer["counters"]
    if "trace" not in layer:
        return None
    from gst_tacotron_tpu_torch.utils import profiling

    counted = getattr(profiling, "counters", None)
    return None if counted is None else counted()
