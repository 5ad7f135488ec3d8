"""Host-side numpy DSP (counterparts of ``gst_tacotron_tpu/dsp/ref.py``).

The host feature path and the oracle the device routes are held against:
the Hann window padded to ``n_fft``, the preemphasis FIR, the centred STFT,
dB companding, the normalized linear and mel spectrograms and the energy
silence trim of the pattern generator; and the inverse half, the host
Griffin-Lim of the reference-style bench (``istft``, ``griffin_lim``,
``inv_preemphasis``, ``db_to_amp``, ``denormalize_db``, ``inv_spectrogram``).
All in float64 as the JAX package's numpy oracle computes them; numpy, and
scipy's IIR filter for ``inv_preemphasis``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

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


@functools.lru_cache(maxsize=16)
def live_tap_span(cfg: AudioConfig) -> Tuple[int, int, int]:
    """(j0, j1, n_live): the hop-chunk span [j0, j1) of the padded window
    with a nonzero tap, and its sample count n_live = (j1 - j0) * hop."""
    hop, n_fft = cfg.hop_length, cfg.n_fft
    k = n_fft // hop
    win = padded_window(cfg.win_length, n_fft)
    live = [j for j in range(k) if np.any(win[j * hop:(j + 1) * hop] != 0.0)]
    j0, j1 = (live[0], live[-1] + 1) if live else (0, k)
    return j0, j1, (j1 - j0) * hop


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


def istft(spect: np.ndarray, cfg: AudioConfig, length: Optional[int] = None) -> np.ndarray:
    """Inverse of ``stft``: windowed overlap-add normalized by the summed
    squared window, the centre padding removed; cut or zero-padded to
    ``length`` when given."""
    frames = np.fft.irfft(spect, n=cfg.n_fft, axis=-1)
    win = padded_window(cfg.win_length, cfg.n_fft)
    num_frames = frames.shape[0]
    total = cfg.n_fft + cfg.hop_length * (num_frames - 1)
    out = np.zeros(total)
    norm = np.zeros(total)
    winsq = win * win
    for t in range(num_frames):
        s = t * cfg.hop_length
        out[s: s + cfg.n_fft] += frames[t] * win
        norm[s: s + cfg.n_fft] += winsq
    out = (out / np.maximum(norm, 1e-10))[cfg.n_fft // 2: total - cfg.n_fft // 2]
    if length is not None:
        if len(out) < length:
            out = np.pad(out, (0, length - len(out)))
        out = out[:length]
    return out


def griffin_lim(magnitude: np.ndarray, cfg: AudioConfig, seed: int = 0) -> np.ndarray:
    """(frames, bins) magnitude -> waveform: ``cfg.griffin_lim_iters``
    plain iterations from random phases drawn with ``seed``."""
    rng = np.random.default_rng(seed)
    angles = np.exp(2j * np.pi * rng.random(magnitude.shape))
    s_complex = magnitude.astype(np.complex128) * angles
    for _ in range(cfg.griffin_lim_iters):
        rebuilt = stft(istft(s_complex, cfg), cfg)[: magnitude.shape[0]]
        phase = rebuilt / np.maximum(np.abs(rebuilt), 1e-16)
        s_complex = magnitude[: rebuilt.shape[0]] * phase
    return istft(s_complex, cfg)


def preemphasis(wav: np.ndarray, coef: float) -> np.ndarray:
    """y[t] = x[t] - coef * x[t-1] with zero initial state, in float64
    (the FIR ``scipy.signal.lfilter([1, -coef], [1], wav)``)."""
    x = np.asarray(wav, np.float64)
    y = x.copy()
    y[1:] -= coef * x[:-1]
    return y


def inv_preemphasis(wav: np.ndarray, coef: float) -> np.ndarray:
    """y[t] = x[t] + coef * y[t-1] with zero initial state (the IIR
    ``scipy.signal.lfilter([1], [1, -coef], wav)``)."""
    from scipy.signal import lfilter

    return lfilter([1.0], [1.0, -coef], wav)


def amp_to_db(x: np.ndarray) -> np.ndarray:
    return 20.0 * np.log10(np.maximum(1e-5, x))


def db_to_amp(x: np.ndarray) -> np.ndarray:
    return np.power(10.0, x * 0.05)


def normalize_db(s: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    unit = (s - cfg.min_level_db) / (-cfg.min_level_db)
    if cfg.symmetric_norm:
        return np.clip(2.0 * cfg.max_abs_value * unit - cfg.max_abs_value,
                       -cfg.max_abs_value, cfg.max_abs_value)
    return np.clip(unit, 0.0, 1.0)


def denormalize_db(s: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    if cfg.symmetric_norm:
        unit = ((np.clip(s, -cfg.max_abs_value, cfg.max_abs_value) + cfg.max_abs_value)
                / (2.0 * cfg.max_abs_value))
    else:
        unit = np.clip(s, 0.0, 1.0)
    return unit * (-cfg.min_level_db) + cfg.min_level_db


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


def inv_spectrogram(spect: np.ndarray, cfg: AudioConfig, seed: int = 0) -> np.ndarray:
    """Normalized linear spectrogram (frames, bins) -> waveform through the
    host Griffin-Lim."""
    s = db_to_amp(denormalize_db(spect.astype(np.float64), cfg) + cfg.ref_level_db)
    wav = griffin_lim(s ** cfg.griffin_lim_power, cfg, seed=seed)
    return inv_preemphasis(wav, cfg.preemphasis).astype(np.float32)


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
