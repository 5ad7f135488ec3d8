"""Batched feature extraction on the device (counterpart of
``gst_tacotron_tpu/dsp/device_features.py``).

The host does the O(S) prep that must match the numpy oracle: float64
preemphasis and the per-utterance reflect centre pad, then zero-pads to a
bucket of ``frame_bucket`` frames. Same-bucket utterances go to the device in
groups of ``batch_size``, one call of the chosen STFT route each. Because the
reflect pad is applied before the zero bucketing, every kept frame, the tail
included, matches a per-utterance extraction.

Routes (``stft_kernel``; the JAX extractor's ``use_pallas`` value in
brackets):

  "resident"  K3, ``ops.stft.stft_features`` ["resident"; the default];
  "fused"     K3′, ``ops.stft.stft_features_fused`` ["fused"];
  "frames"    ``TorchDSP.frame_precentered``, then K3″,
              ``ops.stft.stft_features_frames`` [True];
  None        the plain path, ``TorchDSP.features_precentered`` [False].

A kernel route launches its kernel for CUDA tensors and runs its plain
version on the CPU; ``plain=True`` runs the plain version on any device.

The resident route computes K3's bf16 operand mode where ``bf16`` resolves
true: as the JAX extractor's ``bf16=not self.interpret``, None is on for a
CUDA device and off on the CPU (JAX's interpret mode, float32). The other
routes are float32, as in JAX.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import AudioConfig
from ..device import resolve_device, to_numpy
from ..ops import stft
from ..utils.profiling import span
from . import ref as dsp_ref
from .torch_dsp import TorchDSP

ROUTES = ("resident", "fused", "frames", None)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class DeviceFeatureExtractor:
    """wav list -> [(mel (T, M), linear (T, F))] via batched device calls."""

    def __init__(self, cfg: AudioConfig, device=None, batch_size: int = 8,
                 frame_bucket: int = 128, stft_kernel: Optional[str] = "resident",
                 plain: bool = False, bf16: Optional[bool] = None):
        if stft_kernel not in ROUTES:
            raise ValueError(f"stft_kernel {stft_kernel!r} is not one of {ROUTES}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bf16 = self.device.type == "cuda" if bf16 is None else bool(bf16)
        self.batch_size = batch_size
        self.frame_bucket = frame_bucket
        self.stft_kernel = stft_kernel
        self.plain = plain
        self._dsp = TorchDSP(cfg, self.device)
        self._bases = stft.stft_bases(cfg, self.device)

    # -- device call ----------------------------------------------------------

    def _compute(self, batch: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L) preemphasized, centre-padded, zero-bucketed -> (mel, linear)."""
        cfg, route, plain = self.cfg, self.stft_kernel, self.plain
        if route == "resident":
            fn = stft.stft_features_plain if plain else stft.stft_features
            return fn(batch, cfg, self._bases, bf16=self.bf16)
        if route == "fused":
            fn = stft.stft_features_plain if plain else stft.stft_features_fused
            return fn(batch, cfg, self._bases)
        if route == "frames":
            frames = self._dsp.frame_precentered(batch)               # (B, T, n_fft)
            b, t, n = frames.shape
            fn = stft.stft_features_frames_plain if plain else stft.stft_features_frames
            mel, lin = fn(frames.reshape(b * t, n), cfg, self._bases)
            return mel.reshape(b, t, cfg.num_mels), lin.reshape(b, t, cfg.num_freq)
        return self._dsp.features_precentered(batch)

    # -- host prep ------------------------------------------------------------

    def _prep(self, wav: np.ndarray) -> Tuple[np.ndarray, int]:
        """preemphasis + reflect centre pad; returns (prepped, num_frames)."""
        cfg = self.cfg
        wav = np.asarray(wav, np.float64)
        num_frames = 1 + len(wav) // cfg.hop_length
        pre = dsp_ref.preemphasis(wav, cfg.preemphasis)
        pad = cfg.n_fft // 2
        return np.pad(pre, (pad, pad), mode="reflect"), num_frames

    def _bucket_len(self, num_frames: int) -> int:
        t_pad = _round_up(num_frames, self.frame_bucket)
        return (t_pad - 1) * self.cfg.hop_length + self.cfg.n_fft

    def plan(self, num_frames: Sequence[int]) -> List[List[int]]:
        """The device calls of one ``extract``: index groups of same-bucket
        utterances, in bucket order, at most ``batch_size`` each."""
        order = sorted(range(len(num_frames)), key=lambda i: self._bucket_len(num_frames[i]))
        groups: List[List[int]] = []
        for idx in order:
            if (groups and len(groups[-1]) < self.batch_size
                    and self._bucket_len(num_frames[groups[-1][0]])
                    == self._bucket_len(num_frames[idx])):
                groups[-1].append(idx)
            else:
                groups.append([idx])
        return groups

    def extract(self, wavs: Sequence[np.ndarray]) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Bucket by padded frame count, batch same-bucket utterances, one
        device call per batch, slice to the true frame counts. The copies
        back are counted (``device.to_numpy``)."""
        with span("gst.features.prep"):
            prepped = [self._prep(w) for w in wavs]
        results: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [None] * len(wavs)
        for group in self.plan([t for _, t in prepped]):
            with span("gst.features.prep"):
                length = self._bucket_len(prepped[group[0]][1])
                batch = np.zeros((len(group), length), np.float32)
                for row, idx in enumerate(group):
                    # a signal whose length is not a multiple of hop runs a
                    # few samples past the bucket; no kept frame reads them
                    sig = prepped[idx][0][:length]
                    batch[row, : len(sig)] = sig
            with span("gst.features.stft"):
                mel, lin = self._compute(torch.from_numpy(batch).to(self.device))
            with span("gst.features.to_host"):
                mel, lin = to_numpy(mel), to_numpy(lin)
            for row, idx in enumerate(group):
                t = prepped[idx][1]
                results[idx] = (mel[row, :t], lin[row, :t])
        return results  # type: ignore[return-value]
