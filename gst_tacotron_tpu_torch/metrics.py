"""Metrics logging (counterpart of ``gst_tacotron_tpu/metrics.py``).

JSONL always (``metrics.jsonl``, one record a write). TensorBoard scalars,
images and audio through ``torch.utils.tensorboard`` where it imports, else
off: the JAX module's own fallback around ``clu``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def write(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        scalars = {(f"{prefix}/{k}" if prefix else k): float(v) for k, v in metrics.items()}
        rec = {"step": int(step), "time": time.time(), **scalars}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def write_images(self, step: int, images: Dict[str, np.ndarray]) -> None:
        """(H, W) or (H, W, C) float arrays, scaled to [0, 1] each."""
        if self._tb is None:
            return
        for k, v in images.items():
            a = np.asarray(v, np.float32)
            lo, hi = float(a.min()), float(a.max())
            a = (a - lo) / max(hi - lo, 1e-9)
            self._tb.add_image(k, a[..., None] if a.ndim == 2 else a, step,
                               dataformats="HWC")

    def write_audios(self, step: int, audios: Dict[str, np.ndarray],
                     sample_rate: int) -> None:
        """(S,) float waveforms, clipped to [-1, 1]."""
        if self._tb is None:
            return
        for k, v in audios.items():
            self._tb.add_audio(k, np.clip(np.asarray(v, np.float32), -1.0, 1.0)[None],
                               step, sample_rate=sample_rate)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
