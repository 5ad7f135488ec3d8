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
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator, Optional


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
    with profile(activities=_activities()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
            self._prof = profile(activities=_activities())
            self._prof.__enter__()
        elif self._n == self.warmup + self.active:
            self.stop()
        self._n += 1

    def stop(self) -> None:
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            self._prof.export_chrome_trace(os.path.join(self.log_dir, "trace.json"))
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
            with prof:
                time.sleep(ms / 1e3)
            path = os.path.join(os.path.abspath(log_dir), "trace.json")
            prof.export_chrome_trace(path)
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
