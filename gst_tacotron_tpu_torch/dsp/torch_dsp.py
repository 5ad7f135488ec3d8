"""PyTorch DSP — counterpart of ``gst_tacotron_tpu/dsp/jax_dsp.py``.

Batch-first: wav (B, S) -> spectra (B, T, bins). Everything here is plain
PyTorch, as the JAX module is plain jnp: the forward and inverse STFTs use
``torch.fft`` on hop-chunk frames, Griffin-Lim iterates in float32 (the port
ignores ``AudioConfig.griffin_lim_bf16``), and ``features_precentered`` is
the plain feature path of the wav-transport step and of the extractor's
plain route (the STFT kernels live in ``ops/stft.py``). The inverse
preemphasis IIR runs blockwise: a lower-triangular product inside each
block, then the carries across blocks as a second triangular product.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import AudioConfig
from .mel import mel_filterbank
from .ref import padded_window

IIR_BLOCK = 256


def amp_to_db(x: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(torch.clamp(x, min=1e-5))


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x * 0.05)


def normalize_db(s: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    unit = (s - cfg.min_level_db) / (-cfg.min_level_db)
    if cfg.symmetric_norm:
        return torch.clamp(2.0 * cfg.max_abs_value * unit - cfg.max_abs_value,
                           -cfg.max_abs_value, cfg.max_abs_value)
    return torch.clamp(unit, 0.0, 1.0)


def denormalize_db(s: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    if cfg.symmetric_norm:
        unit = (torch.clamp(s, -cfg.max_abs_value, cfg.max_abs_value)
                + cfg.max_abs_value) / (2.0 * cfg.max_abs_value)
    else:
        unit = torch.clamp(s, 0.0, 1.0)
    return unit * (-cfg.min_level_db) + cfg.min_level_db


class TorchDSP:
    """DSP ops for one AudioConfig on one device."""

    def __init__(self, cfg: AudioConfig, device):
        if cfg.n_fft % cfg.hop_length:
            raise ValueError("hop_length must divide n_fft")
        self.cfg = cfg
        self.device = torch.device(device)
        win = padded_window(cfg.win_length, cfg.n_fft)
        self.window = torch.from_numpy(win.astype(np.float32)).to(self.device)
        self.mel_basis = torch.from_numpy(mel_filterbank(
            cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.mel_fmin,
            cfg.mel_fmax)).to(self.device)                     # (M, F)
        self._winsq = win * win

    # -- framing ------------------------------------------------------------

    def _frame(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, S) -> (B, T, n_fft) raw frames with reflect centre padding."""
        pad = self.cfg.n_fft // 2
        wav = F.pad(wav[:, None, :], (pad, pad), mode="reflect")[:, 0]
        return self.frame_precentered(wav)

    def frame_precentered(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, L) already preemphasized and centre-padded -> (B, T, n_fft),
        T = 1 + (L - n_fft) // hop: frame t is samples [t*hop, t*hop + n_fft)
        (a strided view; the batched extractors zero-pad to bucket lengths
        after the per-utterance reflect pad, so no pad happens here)."""
        return wav.unfold(-1, self.cfg.n_fft, self.cfg.hop_length)

    # -- forward STFT / features -------------------------------------------

    def stft_ri_precentered(self, wav: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L) already centre-padded -> real/imag, each (B, T, F)."""
        frames = self.frame_precentered(wav) * self.window
        spec = torch.fft.rfft(frames, n=self.cfg.n_fft, dim=-1)
        return spec.real, spec.imag

    def stft_ri(self, wav: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S) -> real/imag pair with reflect centre padding."""
        pad = self.cfg.n_fft // 2
        wav = F.pad(wav[:, None, :], (pad, pad), mode="reflect")[:, 0]
        return self.stft_ri_precentered(wav)

    def stft(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, S) -> complex (B, T, num_freq)."""
        re, im = self.stft_ri(wav)
        return torch.complex(re, im)

    def magnitude(self, wav: torch.Tensor) -> torch.Tensor:
        re, im = self.stft_ri(wav)
        return torch.sqrt(re * re + im * im)

    def linear_spectrogram(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, S) -> normalized linear dB spectrogram (B, T, num_freq)."""
        return self.features(wav)[1]

    def mel_spectrogram(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, S) -> normalized mel spectrogram (B, T, num_mels)."""
        return self.features(wav)[0]

    def features(self, wav: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S) raw wav -> (mel, linear), one STFT shared by both maps."""
        return self._features_from_mag(self.magnitude(self.preemphasis(wav)))

    def features_from_frames(self, frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, n_fft) raw frames -> (mel, linear), normalized dB."""
        spec = torch.fft.rfft(frames * self.window, n=self.cfg.n_fft, dim=-1)
        return self._features_from_mag(spec.abs())

    def features_precentered(self, wav: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L) preemphasized + centre-padded -> (mel, linear), normalized
        dB, in plain PyTorch (``JaxDSP.features_precentered`` is plain XLA)."""
        re, im = self.stft_ri_precentered(wav)
        return self._features_from_mag(torch.sqrt(re * re + im * im))

    def _features_from_mag(self, mag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        lin = normalize_db(amp_to_db(mag) - cfg.ref_level_db, cfg)
        mel = normalize_db(amp_to_db(mag @ self.mel_basis.T) - cfg.ref_level_db, cfg)
        return mel, lin

    # -- inverse ------------------------------------------------------------

    def _win_norm(self, num_frames: int) -> torch.Tensor:
        cfg = self.cfg
        total = cfg.n_fft + cfg.hop_length * (num_frames - 1)
        norm = np.zeros(total, np.float64)
        for t in range(num_frames):
            norm[t * cfg.hop_length: t * cfg.hop_length + cfg.n_fft] += self._winsq
        return torch.from_numpy(np.maximum(norm, 1e-10).astype(np.float32)).to(self.device)

    def istft_ri(self, re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
        """Real/imag (B, T, F) -> (B, hop * (T - 1)): inverse FFT, window,
        overlap-add as k shifted adds of hop-sized chunks, window-square
        normalization, centre crop."""
        cfg = self.cfg
        b, t, _ = re.shape
        hop, k = cfg.hop_length, cfg.n_fft // cfg.hop_length
        frames = torch.fft.irfft(torch.complex(re, im), n=cfg.n_fft, dim=-1) * self.window
        chunks = frames.reshape(b, t, k, hop)
        out = frames.new_zeros(b, t + k - 1, hop)
        for j in range(k):
            out[:, j: j + t] += chunks[:, :, j]
        total = cfg.n_fft + hop * (t - 1)
        out = out.reshape(b, total) / self._win_norm(t)
        return out[:, cfg.n_fft // 2: total - cfg.n_fft // 2]

    def griffin_lim(self, magnitude: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, T, F) magnitude -> (B, S) waveform. Zero start phase unless a
        generator is given; fast Griffin-Lim momentum
        ``griffin_lim_momentum`` (0 is the plain iteration)."""
        cfg = self.cfg
        if generator is None:
            re, im = magnitude, torch.zeros_like(magnitude)
        else:
            ang = torch.rand(magnitude.shape, generator=generator,
                             device=magnitude.device) * (2.0 * np.pi)
            re, im = magnitude * torch.cos(ang), magnitude * torch.sin(ang)
        alpha = cfg.griffin_lim_momentum
        pre, pim = re, im
        for _ in range(cfg.griffin_lim_iters):
            cre = re + alpha * (re - pre)
            cim = im + alpha * (im - pim)
            re2, im2 = self.stft_ri(self.istft_ri(cre, cim))
            scale = magnitude / torch.clamp(torch.sqrt(re2 * re2 + im2 * im2), min=1e-16)
            re, im, pre, pim = re2 * scale, im2 * scale, re, im
        return self.istft_ri(re, im)

    def inv_linear_spectrogram(self, spect: torch.Tensor,
                               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Normalized linear spectrogram (B, T, F) -> waveform (B, S)."""
        cfg = self.cfg
        s = db_to_amp(denormalize_db(spect, cfg) + cfg.ref_level_db)
        return self.inv_preemphasis(self.griffin_lim(s ** cfg.griffin_lim_power, generator))

    # -- preemphasis --------------------------------------------------------

    def preemphasis(self, wav: torch.Tensor) -> torch.Tensor:
        """y[t] = x[t] - coef * x[t-1]."""
        coef = self.cfg.preemphasis
        if coef == 0.0:
            return wav
        return wav - coef * F.pad(wav, (1, 0))[:, :-1]

    def inv_preemphasis(self, wav: torch.Tensor) -> torch.Tensor:
        """y[t] = x[t] + coef * y[t-1], blockwise."""
        coef = self.cfg.preemphasis
        if coef == 0.0:
            return wav
        b, n = wav.shape
        blk = IIR_BLOCK
        nb = -(-n // blk)
        x = F.pad(wav, (0, nb * blk - n)).reshape(b, nb, blk)
        i = np.arange(blk)
        tri = np.where(i[:, None] >= i[None, :],
                       np.power(coef, np.maximum(i[:, None] - i[None, :], 0)), 0.0)
        y = x @ torch.from_numpy(tri.T.astype(np.float32)).to(wav.device)
        # carries: the true last sample of block m is sum_{m' <= m} a^(m-m')
        # times the local last of block m', with a = coef ** blk
        m = np.arange(nb)
        with np.errstate(under="ignore"):
            tri2 = np.where(m[:, None] >= m[None, :],
                            np.power(coef ** blk, np.maximum(m[:, None] - m[None, :], 0)), 0.0)
        last = y[:, :, -1] @ torch.from_numpy(tri2.T.astype(np.float32)).to(wav.device)
        carry = F.pad(last, (1, 0))[:, :-1]                       # into block m
        decay = torch.from_numpy(np.power(coef, i + 1).astype(np.float32)).to(wav.device)
        y = y + carry[:, :, None] * decay
        return y.reshape(b, nb * blk)[:, :n]
