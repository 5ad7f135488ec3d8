"""The port's tracing hooks on the CPU: ``maybe_start_server`` (the
counterpart of ``jax.profiler.start_server``) is a no-op for None and 0 and
idempotent, and a localhost request to the running server yields a
Chrome/Perfetto trace of the requested window, written where the request
says, holding the ops that another thread of the process ran meanwhile;
a second request while one runs is refused (409), a window that is not a
number or too long is refused (400), and a capture that fails answers 500
with its error, leaving the server able to serve the next request."""

import json
import os
import threading
import urllib.error
import urllib.request

import pytest
import torch

from gst_tacotron_tpu_torch.parallel.mesh import free_port
from gst_tacotron_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def server():
    assert profiling.maybe_start_server(None) is None
    assert profiling.maybe_start_server(0) is None
    port = free_port()
    srv = profiling.maybe_start_server(port)
    assert srv is not None and srv.port == port
    assert profiling.maybe_start_server(port) is srv
    assert profiling.maybe_start_server(free_port()) is srv     # idempotent
    return srv


def test_trace_request_captures_another_threads_work(server, tmp_path):
    stop = threading.Event()

    def work():
        x = torch.randn(32, 32)
        while not stop.is_set():
            x = torch.tanh(x @ x)

    worker = threading.Thread(target=work, daemon=True)
    worker.start()
    try:
        path = profiling.request_trace(server.port, str(tmp_path / "win"), ms=300)
    finally:
        stop.set()
        worker.join()
    assert path == os.path.join(str(tmp_path / "win"), "trace.json")
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_concurrent_request_is_refused_and_bad_paths_404(server, tmp_path):
    first = threading.Thread(target=profiling.request_trace,
                             args=(server.port, str(tmp_path / "a"), 1500))
    first.start()
    try:
        for _ in range(100):
            if server._lock.locked():
                break
            threading.Event().wait(0.02)
        with pytest.raises(urllib.error.HTTPError) as busy:
            profiling.request_trace(server.port, str(tmp_path / "b"), ms=10)
        assert busy.value.code == 409
    finally:
        first.join()
    assert os.path.exists(tmp_path / "a" / "trace.json")
    with pytest.raises(urllib.error.HTTPError) as bad:
        urllib.request.urlopen(f"http://localhost:{server.port}/nothing", timeout=30)
    assert bad.value.code == 404


def test_bad_window_is_refused_and_failed_capture_answers_500(server, tmp_path):
    def status(query):
        url = f"http://localhost:{server.port}/trace?{query}"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(url, timeout=30)
        return err.value.code, json.loads(err.value.read())["error"]

    d = str(tmp_path / "w")
    for ms in ("abc", "nan", "0", "-5", str(profiling.MAX_TRACE_MS * 2)):
        assert status(f"dir={d}&ms={ms}")[0] == 400, ms
    blocker = tmp_path / "file"
    blocker.write_text("")
    code, msg = status(f"dir={blocker / 'sub'}&ms=10")
    assert code == 500 and msg
    assert not server._lock.locked()
    path = profiling.request_trace(server.port, d, ms=10)
    assert os.path.exists(path)
