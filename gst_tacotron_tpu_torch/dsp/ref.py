"""Host-side numpy DSP (counterparts of ``gst_tacotron_tpu/dsp/ref.py``).

The host feature path and the oracle the device routes are held against:
the Hann window padded to ``n_fft``, the preemphasis FIR, the centred STFT,
dB companding, the normalized linear and mel spectrograms and the energy
silence trim of the pattern generator, all in float64 as the JAX package's
numpy oracle computes them. Numpy only (no scipy).
"""

from __future__ import annotations

import numpy as np

from ..config import AudioConfig
from .mel import mel_filterbank


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (librosa/scipy ``sym=False``)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)


def padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """Hann window zero-padded symmetrically to n_fft (librosa convention)."""
    win = hann_window(win_length)
    if win_length == n_fft:
        return win
    pad = n_fft - win_length
    left = pad // 2
    return np.pad(win, (left, pad - left))


def frame_signal(wav: np.ndarray, n_fft: int, hop_length: int,
                 center: bool = True) -> np.ndarray:
    """(samples,) -> (frames, n_fft) with reflect centre padding."""
    if center:
        wav = np.pad(wav, (n_fft // 2, n_fft // 2), mode="reflect")
    num_frames = 1 + (len(wav) - n_fft) // hop_length
    idx = np.arange(num_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]
    return wav[idx]


def stft(wav: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Complex STFT, shape (frames, n_fft // 2 + 1)."""
    frames = frame_signal(wav.astype(np.float64), cfg.n_fft, cfg.hop_length)
    win = padded_window(cfg.win_length, cfg.n_fft)
    return np.fft.rfft(frames * win[None, :], n=cfg.n_fft, axis=-1)


def preemphasis(wav: np.ndarray, coef: float) -> np.ndarray:
    """y[t] = x[t] - coef * x[t-1] with zero initial state, in float64
    (the FIR ``scipy.signal.lfilter([1, -coef], [1], wav)``)."""
    x = np.asarray(wav, np.float64)
    y = x.copy()
    y[1:] -= coef * x[:-1]
    return y


def amp_to_db(x: np.ndarray) -> np.ndarray:
    return 20.0 * np.log10(np.maximum(1e-5, x))


def normalize_db(s: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    unit = (s - cfg.min_level_db) / (-cfg.min_level_db)
    if cfg.symmetric_norm:
        return np.clip(2.0 * cfg.max_abs_value * unit - cfg.max_abs_value,
                       -cfg.max_abs_value, cfg.max_abs_value)
    return np.clip(unit, 0.0, 1.0)


def spectrogram(wav: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """wav -> normalized linear spectrogram (frames, n_fft // 2 + 1)."""
    d = stft(preemphasis(wav, cfg.preemphasis), cfg)
    s = amp_to_db(np.abs(d)) - cfg.ref_level_db
    return normalize_db(s, cfg).astype(np.float32)


def melspectrogram(wav: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """wav -> normalized mel spectrogram (frames, num_mels)."""
    d = stft(preemphasis(wav, cfg.preemphasis), cfg)
    mel_basis = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels,
                               cfg.mel_fmin, cfg.mel_fmax).astype(np.float64)
    s = amp_to_db(np.abs(d) @ mel_basis.T) - cfg.ref_level_db
    return normalize_db(s, cfg).astype(np.float32)


def trim_silence(wav: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Energy silence trim: keep the span of 2048-sample frames (hop 512)
    within ``trim_top_db`` of the loudest frame."""
    frame, hop = 2048, 512
    if len(wav) < frame:
        return wav
    n = 1 + (len(wav) - frame) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    rms = np.sqrt(np.mean(wav[idx] ** 2, axis=-1))
    ref = np.max(rms)
    if ref <= 0:
        return wav
    db = 20.0 * np.log10(np.maximum(rms / ref, 1e-10))
    keep = np.where(db > -cfg.trim_top_db)[0]
    if len(keep) == 0:
        return wav
    start = keep[0] * hop
    end = min(len(wav), keep[-1] * hop + frame)
    return wav[start:end]
