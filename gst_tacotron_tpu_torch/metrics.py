"""Metrics logging and synthesis metrics (counterpart of
``gst_tacotron_tpu/metrics.py``).

JSONL always (``metrics.jsonl``, one record a write). TensorBoard scalars,
images and audio through ``torch.utils.tensorboard`` where it imports, else
off: the JAX module's own fallback around ``clu``. ``mel_cepstral_distortion``
and ``synthesis_metrics`` are numpy copies of the JAX functions.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class MetricLogger:
    """``log_dir`` None writes nothing (the ranks of a parallel run other
    than rank 0)."""

    def __init__(self, log_dir: Optional[str], use_tensorboard: bool = True):
        self._jsonl = self._tb = None
        if log_dir is None:
            return
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def write(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        scalars = {(f"{prefix}/{k}" if prefix else k): float(v) for k, v in metrics.items()}
        if self._jsonl is None:
            return
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
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def mel_cepstral_distortion(mel_a: np.ndarray, mel_b: np.ndarray, num_coeffs: int = 13) -> float:
    """MCD (dB) between two normalized mel sequences (T, M): DCT-II cepstra
    c1..cK (c0, the energy, excluded), 10 * sqrt(2) / ln 10 times the mean
    frame-wise L2 distance, over the shorter length; NaN for no frames."""
    t = min(mel_a.shape[0], mel_b.shape[0])
    if t == 0:
        return float("nan")
    a = np.asarray(mel_a[:t], np.float64)
    b = np.asarray(mel_b[:t], np.float64)
    m = a.shape[1]
    n = np.arange(m)
    k = np.arange(1, num_coeffs + 1)[:, None]
    basis = np.cos(np.pi * k * (2 * n[None, :] + 1) / (2 * m))
    const = 10.0 * np.sqrt(2.0) / np.log(10.0)
    return float(const * np.mean(np.linalg.norm(a @ basis.T - b @ basis.T, axis=1)))


def synthesis_metrics(num_audio_seconds: float, wall_seconds: float,
                      decode_steps: int, num_chips: int) -> Dict[str, float]:
    """Audio seconds a wall second a chip, decode steps a second, and the
    wall seconds."""
    return {
        "audio_seconds_per_sec_per_chip": num_audio_seconds
        / max(wall_seconds, 1e-9) / max(num_chips, 1),
        "decode_steps_per_sec": decode_steps / max(wall_seconds, 1e-9),
        "wall_seconds": wall_seconds,
    }
