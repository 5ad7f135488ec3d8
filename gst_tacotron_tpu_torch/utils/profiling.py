"""Tracing (counterpart of ``gst_tacotron_tpu/utils/profiling.py``) on
``torch.profiler``: ``profile_trace`` around one call, ``StepWindowProfiler``
over a window of loop steps. Each writes a Chrome/Perfetto ``trace.json``."""

from __future__ import annotations

import contextlib
import os
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
