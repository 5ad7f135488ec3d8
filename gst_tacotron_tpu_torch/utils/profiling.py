"""Tracing (counterpart of ``gst_tacotron_tpu/utils/profiling.py``) on
``torch.profiler``: ``profile_trace`` around one call, ``StepWindowProfiler``
over a window of loop steps, and ``maybe_start_server`` for traces that a
client outside the process asks a running trainer or synthesizer for. Each
writes a Chrome/Perfetto ``trace.json``.

The server stands in for ``jax.profiler.start_server``: a daemon thread
serving HTTP on localhost. ``GET /trace?dir=DIR&ms=MS`` traces the whole
process (every thread's host ops and, on the card, its CUDA activity) for
MS milliseconds, writes ``DIR/trace.json`` and answers ``{"trace": path}``
(``request_trace`` is the client). One capture at a time; another request
meanwhile gets 409.

``span(name)`` marks a stage of the program (every name starts ``gst.``).
While a torch profiler records (any of the three above, or one the caller
runs) it is a ``torch.profiler.record_function``: a ``user_annotation``
event in the same trace as the CUDA activity, on the profiler's clock.
Otherwise it costs one check of a flag: no dispatcher call, no allocation,
no synchronize. The top-level span of a synthesis call or a train step
takes the process's next ``next_call()`` number; the three tracers above
write it into that event's ``args`` as ``call``, and the stages of the call
are the spans nested in it on its thread. ``count``, ``counters`` and
``reset_counters`` are the program's counters (bytes copied to the host,
blocking copies, calls and steps begun, decoder steps run, train steps
captured in a CUDA graph and replayed from one, Griffin-Lim's shape-only
tables built and taken from their cache), always on, as the kernels'
launch counters are.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterator, Optional

from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
_calls = itertools.count(1)
# (thread, span name, call number) of each numbered span entered while a
# profiler recorded, in order; the tracers here clear it when they start
_numbered: collections.deque = collections.deque(maxlen=1 << 16)
_counters: Dict[str, int] = {}
_counters_lock = threading.Lock()


def span(name: str, call: Optional[int] = None):
    """A context manager marking a stage ``name`` of the program; ``call``
    (a top-level span's ``next_call()``) is written into its trace event's
    ``args`` by the tracers of this module."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if call is not None:
        _numbered.append((threading.get_native_id(), name, call))
    return _autograd_profiler.record_function(name)


def recording() -> bool:
    """Whether a torch profiler records in this process."""
    return bool(_autograd_profiler._is_profiler_enabled)


def next_call() -> int:
    """The process's next sequence number of a synthesis call or a train
    step; each adds one to the counter ``calls``."""
    count("calls")
    return next(_calls)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the program's counter ``name``."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of the program's counters."""
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    """Set every counter back to 0."""
    with _counters_lock:
        _counters.clear()


def _events(lines):
    """(first line, last line, text) of each event of a Chrome trace as the
    torch profiler writes it: from a line ``  {`` to a line ``  }`` or
    ``  },``."""
    block = None
    for i, line in enumerate(lines):
        if line.rstrip() == "  {":
            block = (i, [line])
        elif block is not None:
            block[1].append(line)
            if line.rstrip() in ("  }", "  },"):
                yield block[0], i, "".join(block[1]).rstrip().rstrip(",")
                block = None


def _export(prof, path: str, numbered) -> None:
    """``prof``'s Chrome trace to ``path``, each numbered span's event with
    ``args["call"]``: the k-th numbered span a thread entered under a name is
    that thread's k-th event of the name, in time order. The trace is read
    and written a line at a time; only those events are parsed."""
    prof.export_chrome_trace(path)
    if not numbered:
        return
    calls = collections.defaultdict(list)
    for tid, name, call in numbered:
        calls[tid, name].append(call)
    found = collections.defaultdict(list)
    with open(path) as f:
        for first, last, text in _events(f):
            if '"user_annotation"' in text and '"gst.' in text:
                e = json.loads(text)
                if (e.get("tid"), e.get("name")) in calls:
                    found[e["tid"], e["name"]].append((e["ts"], first, last, e))
    edits = {}
    for key, evs in found.items():
        for (_, first, last, e), call in zip(sorted(evs, key=lambda r: r[0]), calls[key]):
            e.setdefault("args", {})["call"] = call
            edits[first] = (last, json.dumps(e))
    with open(path) as src, open(path + ".tmp", "w") as dst:
        skip_to = -1
        for i, line in enumerate(src):
            if i in edits:
                skip_to, text = edits[i]
                dst.write(text)
            elif i == skip_to:
                dst.write("," if line.rstrip().endswith(",") else "")
                dst.write("\n")
            elif i > skip_to:
                dst.write(line)
    os.replace(path + ".tmp", path)


def _take_numbered() -> list:
    out = list(_numbered)
    _numbered.clear()
    return out


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], enabled: bool = True) -> Iterator[None]:
    """Trace the body (host and, on the card, CUDA activity) into
    ``log_dir/trace.json``; a no-op unless ``enabled``."""
    if not enabled:
        yield
        return
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    _take_numbered()
    with profile(activities=_activities()) as prof:
        yield
    _export(prof, os.path.join(log_dir, "trace.json"), _take_numbered())


class StepWindowProfiler:
    """Trace a window of hot-loop steps.

    Used by ``train --profile DIR``: skips ``warmup`` iterations, traces the
    next ``active`` ones (host and, on the card, CUDA activity) and writes a
    Chrome/Perfetto trace ``trace.json`` under DIR. ``tick()`` is called once
    a loop iteration; ``stop()`` is idempotent, and the trainer calls it in a
    ``finally``, so a crashed loop still writes its trace.
    """

    def __init__(self, log_dir: Optional[str], warmup: int = 2, active: int = 20):
        self.log_dir = log_dir
        self.warmup = warmup
        self.active = active
        self._n = 0
        self._prof = None
        self._done = log_dir is None

    def tick(self) -> None:
        if self._done:
            return
        if self._n == self.warmup:
            from torch.profiler import profile

            os.makedirs(self.log_dir, exist_ok=True)
            _take_numbered()
            self._prof = profile(activities=_activities())
            self._prof.__enter__()
        elif self._n == self.warmup + self.active:
            self.stop()
        self._n += 1

    def stop(self) -> None:
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            _export(self._prof, os.path.join(self.log_dir, "trace.json"), _take_numbered())
            self._prof = None
        self._done = True


MAX_TRACE_MS = 60_000.0


class ProfilerServer:
    """The trace server on ``localhost:port`` (0 picks a free port; the
    bound one is ``self.port``), on a daemon thread. A window longer than
    ``MAX_TRACE_MS`` or not a number is refused (400), a second capture
    while one runs too (409); a capture that fails (the torch profiler
    already running, a directory that cannot be written) answers 500 with
    its error."""

    def __init__(self, port: int):
        self._lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                url = urllib.parse.urlparse(self.path)
                q = urllib.parse.parse_qs(url.query)
                if url.path != "/trace" or "dir" not in q:
                    return self._reply(404, {"error": "GET /trace?dir=DIR[&ms=MS]"})
                try:
                    ms = float(q.get("ms", ["1000"])[0])
                except ValueError:
                    ms = float("nan")
                if not 0 < ms <= MAX_TRACE_MS:
                    return self._reply(400, {"error": f"ms must be a number in (0, {MAX_TRACE_MS}]"})
                try:
                    path = server.capture(q["dir"][0], ms)
                except BlockingIOError as e:
                    return self._reply(409, {"error": str(e)})
                except Exception as e:
                    return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                self._reply(200, {"trace": path})

            def _reply(self, code, body):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        httpd = ThreadingHTTPServer(("localhost", port), Handler)
        httpd.daemon_threads = True
        self.port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, name="profiler-server",
                         daemon=True).start()

    def capture(self, log_dir: str, ms: float) -> str:
        """Trace every thread of the process for ``ms`` milliseconds into
        ``log_dir/trace.json``; raises BlockingIOError while another capture
        runs."""
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import profile

        if not self._lock.acquire(blocking=False):
            raise BlockingIOError("a capture is already running")
        try:
            os.makedirs(log_dir, exist_ok=True)
            prof = profile(activities=_activities(),
                           experimental_config=_ExperimentalConfig(profile_all_threads=True))
            _take_numbered()
            with prof:
                time.sleep(ms / 1e3)
            path = os.path.join(os.path.abspath(log_dir), "trace.json")
            _export(prof, path, _take_numbered())
            return path
        finally:
            self._lock.release()


_server: Optional[ProfilerServer] = None


def maybe_start_server(port: Optional[int]) -> Optional[ProfilerServer]:
    """Start the trace server on ``localhost:port`` once (later calls return
    the running one); None or 0 is a no-op."""
    global _server
    if port and _server is None:
        _server = ProfilerServer(port)
    return _server


def request_trace(port: int, log_dir: str, ms: float = 1000.0) -> str:
    """Ask the trace server on ``localhost:port`` for an ``ms`` window
    written to ``log_dir``; returns the trace's path."""
    query = urllib.parse.urlencode({"dir": log_dir, "ms": ms})
    with urllib.request.urlopen(f"http://localhost:{port}/trace?{query}",
                                timeout=60 + ms / 1e3) as r:
        return json.loads(r.read())["trace"]
