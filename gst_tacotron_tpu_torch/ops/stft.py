"""The three mel-STFT kernels (counterparts of ``gst_tacotron_tpu/ops/stft_pallas.py``).

All three compute normalized-dB mel and linear features with the window
baked into DFT cos/sin bases over the window's live taps:

  K3   ``stft_features``        <- ``stft_features_pallas_resident``:
       (B, L) wav, every frequency in one block (``csrc/stft_features.cu``);
  K3′  ``stft_features_fused``  <- ``stft_features_pallas_fused``: the same
       function split over 128-bin frequency tiles, the mel summed over the
       tiles by a second launch; ``bf16_bases`` opt-in (``csrc/stft_fused.cu``);
  K3″  ``stft_features_frames`` <- ``stft_features_pallas``: (F, n_fft) raw
       frames -> (F, M), (F, NF) (``csrc/stft_frames.cu``).

The wav input is preemphasized and reflect-padded at the centre per
utterance, zero-padded to a bucket length; outputs are (mel (B, T, M),
linear (B, T, NF)) with T = 1 + (L - n_fft) // hop. ``normalize_linear=False``
returns the linear magnitude instead of its normalized dB (the mel is always
normalized). Each wrapper launches its kernel for CUDA tensors and runs its
plain version (``stft_features_plain`` for K3 and K3′,
``stft_features_frames_plain`` for K3″) for CPU tensors. ``KernelDSP`` is the
``PallasDSP`` counterpart: preemphasis, framing, then K3″.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import AudioConfig
from ..device import resolve_device
from ..dsp.mel import mel_filterbank
from ..dsp.ref import padded_window
from ..dsp.torch_dsp import TorchDSP
from .build import F, I, P, CudaKernel, check_cuda, ptr, stream_ptr

KERNEL = CudaKernel("stft_features.cu", "stft_features_launch",
                    [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, F, F, I, I, P])
FUSED_KERNEL = CudaKernel("stft_fused.cu", "stft_fused_launch",
                          [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, F, F, I, I,
                           I, P])
FRAMES_KERNEL = CudaKernel("stft_frames.cu", "stft_frames_launch",
                           [P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, F, F, I, I, P])
FREQ_TILE = 128  # the kernels' frequency tile; padded bins carry zero bases

Features = Tuple[torch.Tensor, torch.Tensor]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def live_tap_span(cfg: AudioConfig) -> Tuple[int, int, int]:
    """(j0, j1, n_live): the hop-chunk span [j0, j1) of the padded window
    with a nonzero tap, and its sample count n_live = (j1 - j0) * hop."""
    hop, n_fft = cfg.hop_length, cfg.n_fft
    k = n_fft // hop
    win = padded_window(cfg.win_length, n_fft)
    live = [j for j in range(k) if np.any(win[j * hop:(j + 1) * hop] != 0.0)]
    j0, j1 = (live[0], live[-1] + 1) if live else (0, k)
    return j0, j1, (j1 - j0) * hop


@functools.lru_cache(maxsize=4)
def _bases_np(cfg: AudioConfig):
    """Window-baked DFT cos/sin bases over the live taps (n_live, NFp) and the
    transposed mel basis (NFp, M); bins past num_freq are zero."""
    n_fft, n_freq = cfg.n_fft, cfg.num_freq
    n_freq_pad = _round_up(n_freq, FREQ_TILE)
    j0, j1, _ = live_tap_span(cfg)
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_freq_pad)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    win = padded_window(cfg.win_length, n_fft)[:, None]
    cos_b = (np.cos(ang) * win).astype(np.float32)
    sin_b = (-np.sin(ang) * win).astype(np.float32)
    cos_b[:, n_freq:] = 0.0
    sin_b[:, n_freq:] = 0.0
    sl = slice(j0 * cfg.hop_length, j1 * cfg.hop_length)
    mel = mel_filterbank(cfg.sample_rate, n_fft, cfg.num_mels, cfg.mel_fmin,
                         cfg.mel_fmax)
    mel_t = np.zeros((n_freq_pad, cfg.num_mels), np.float32)
    mel_t[:n_freq] = mel.T
    return (np.ascontiguousarray(cos_b[sl]), np.ascontiguousarray(sin_b[sl]),
            mel_t)


def stft_bases(cfg: AudioConfig, device) -> Dict[str, torch.Tensor]:
    cos_b, sin_b, mel_t = _bases_np(cfg)
    return {name: torch.from_numpy(a).to(device)
            for name, a in (("cos", cos_b), ("sin", sin_b), ("mel_t", mel_t))}


def db_normalize(x: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """20*log10(max(x, 1e-5)) - ref_level_db, then the normalized-dB map."""
    db = 20.0 * torch.log10(torch.clamp(x, min=1e-5)) - cfg.ref_level_db
    unit = (db - cfg.min_level_db) / (-cfg.min_level_db)
    if cfg.symmetric_norm:
        return torch.clamp(2.0 * cfg.max_abs_value * unit - cfg.max_abs_value,
                           -cfg.max_abs_value, cfg.max_abs_value)
    return torch.clamp(unit, 0.0, 1.0)


def _num_frames(cfg: AudioConfig, total: int) -> int:
    if cfg.n_fft % cfg.hop_length:
        raise ValueError("the STFT kernels need hop_length | n_fft")
    if total < cfg.n_fft:
        raise ValueError(f"STFT features: {total} samples < n_fft {cfg.n_fft}")
    return 1 + (total - cfg.n_fft) // cfg.hop_length


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bfloat16 and back to float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _live_features(frames: torch.Tensor, cfg: AudioConfig, bases, normalize_linear: bool,
                   bf16_bases: bool = False) -> Features:
    """(..., n_live) frames' live taps -> (mel, linear): two products against
    the window-baked bases, the magnitude, the mel product, dB."""
    nf = cfg.num_freq
    cos_b, sin_b = bases["cos"][:, :nf], bases["sin"][:, :nf]
    if bf16_bases:
        frames, cos_b, sin_b = _bf16(frames), _bf16(cos_b), _bf16(sin_b)
    re = frames @ cos_b
    im = frames @ sin_b
    mag = torch.sqrt(re * re + im * im)
    mel = mag @ bases["mel_t"][:nf]
    return db_normalize(mel, cfg), (db_normalize(mag, cfg) if normalize_linear else mag)


def stft_features_plain(wav: torch.Tensor, cfg: AudioConfig, bases=None, *,
                        normalize_linear: bool = True, bf16_bases: bool = False
                        ) -> Features:
    """The plain version of K3 and K3′ (one function, computed whole here):
    hop-chunk framing of the live taps, then ``_live_features``."""
    hop = cfg.hop_length
    t = _num_frames(cfg, wav.shape[-1])
    bases = bases or stft_bases(cfg, wav.device)
    j0, j1, _ = live_tap_span(cfg)
    num_chunks = wav.shape[-1] // hop
    chunks = wav[:, : num_chunks * hop].reshape(wav.shape[0], num_chunks, hop)
    frames = torch.cat([chunks[:, j: j + t] for j in range(j0, j1)], dim=-1)
    return _live_features(frames, cfg, bases, normalize_linear, bf16_bases)


def stft_features_frames_plain(frames: torch.Tensor, cfg: AudioConfig, bases=None, *,
                               normalize_linear: bool = True) -> Features:
    """The plain version of K3″: the live columns of (F, n_fft) raw frames,
    then ``_live_features``."""
    bases = bases or stft_bases(cfg, frames.device)
    j0, _, n_live = live_tap_span(cfg)
    n0 = j0 * cfg.hop_length
    return _live_features(frames[:, n0: n0 + n_live], cfg, bases, normalize_linear)


def _norm_args(cfg: AudioConfig, normalize_linear: bool):
    return (float(cfg.ref_level_db), float(cfg.min_level_db), float(cfg.max_abs_value),
            int(cfg.symmetric_norm), int(normalize_linear))


def _wav_launch_args(wav: torch.Tensor, cfg: AudioConfig, bases, name: str):
    """Checks and outputs shared by the two wav-input kernels (K3, K3′)."""
    if wav.dim() != 2:
        raise ValueError(f"{name}: expected (B, L) wav, got shape {tuple(wav.shape)}")
    b, total = wav.shape
    t = _num_frames(cfg, total)
    bases = bases or stft_bases(cfg, wav.device)
    wav = wav.to(torch.float32).contiguous()
    check_cuda(name, wav, bases["cos"], bases["sin"], bases["mel_t"])
    mel = torch.empty(b, t, cfg.num_mels, device=wav.device, dtype=torch.float32)
    lin = torch.empty(b, t, cfg.num_freq, device=wav.device, dtype=torch.float32)
    return wav, bases, mel, lin


def stft_features(wav: torch.Tensor, cfg: AudioConfig, bases=None, *,
                  normalize_linear: bool = True) -> Features:
    """K3: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. ``bases`` (from ``stft_bases``) may be passed to reuse the
    device copies."""
    if wav.device.type == "cpu":
        return stft_features_plain(wav, cfg, bases, normalize_linear=normalize_linear)
    wav, bases, mel, lin = _wav_launch_args(wav, cfg, bases, "stft_features")
    b, total = wav.shape
    if b == 0:
        return mel, lin
    j0, _, n_live = live_tap_span(cfg)
    KERNEL(ptr(wav), ptr(bases["cos"]), ptr(bases["sin"]), ptr(bases["mel_t"]),
           ptr(mel), ptr(lin), b, total, mel.shape[1], cfg.hop_length,
           j0 * cfg.hop_length, n_live, cfg.num_freq, bases["cos"].shape[1],
           cfg.num_mels, *_norm_args(cfg, normalize_linear), stream_ptr(wav.device))
    return mel, lin


def stft_features_fused(wav: torch.Tensor, cfg: AudioConfig, bases=None, *,
                        normalize_linear: bool = True, bf16_bases: bool = False
                        ) -> Features:
    """K3′: K3's function split over 128-bin frequency tiles. ``bf16_bases``
    rounds the frames and the cos/sin bases to bfloat16 and sums in float32.
    The kernel for CUDA tensors, the plain version for CPU tensors."""
    if wav.device.type == "cpu":
        return stft_features_plain(wav, cfg, bases, normalize_linear=normalize_linear,
                                   bf16_bases=bf16_bases)
    wav, bases, mel, lin = _wav_launch_args(wav, cfg, bases, "stft_features_fused")
    b, total = wav.shape
    if b == 0:
        return mel, lin
    if b > 65535:
        raise ValueError(f"stft_features_fused: batch {b} > 65535")
    t = mel.shape[1]
    nfp = bases["cos"].shape[1]
    partial = torch.empty(nfp // FREQ_TILE, b * t, cfg.num_mels, device=wav.device,
                          dtype=torch.float32)
    j0, _, n_live = live_tap_span(cfg)
    FUSED_KERNEL(ptr(wav), ptr(bases["cos"]), ptr(bases["sin"]), ptr(bases["mel_t"]),
                 ptr(partial), ptr(mel), ptr(lin), b, total, t, cfg.hop_length,
                 j0 * cfg.hop_length, n_live, cfg.num_freq, nfp, cfg.num_mels,
                 *_norm_args(cfg, normalize_linear), int(bf16_bases),
                 stream_ptr(wav.device))
    return mel, lin


def stft_features_frames(frames: torch.Tensor, cfg: AudioConfig, bases=None, *,
                         normalize_linear: bool = True) -> Features:
    """K3″: (F, n_fft) raw (un-windowed) frames -> (mel (F, M), linear
    (F, NF)). The kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if frames.dim() != 2 or frames.shape[1] != cfg.n_fft:
        raise ValueError(f"stft_features_frames: expected (F, {cfg.n_fft}) frames, "
                         f"got shape {tuple(frames.shape)}")
    if frames.device.type == "cpu":
        return stft_features_frames_plain(frames, cfg, bases,
                                          normalize_linear=normalize_linear)
    n = frames.shape[0]
    bases = bases or stft_bases(cfg, frames.device)
    frames = frames.to(torch.float32).contiguous()
    check_cuda("stft_features_frames", frames, bases["cos"], bases["sin"], bases["mel_t"])
    mel = torch.empty(n, cfg.num_mels, device=frames.device, dtype=torch.float32)
    lin = torch.empty(n, cfg.num_freq, device=frames.device, dtype=torch.float32)
    if n == 0:
        return mel, lin
    nfp = bases["cos"].shape[1]
    partial = torch.empty(nfp // FREQ_TILE, n, cfg.num_mels, device=frames.device,
                          dtype=torch.float32)
    j0, _, n_live = live_tap_span(cfg)
    FRAMES_KERNEL(ptr(frames), ptr(bases["cos"]), ptr(bases["sin"]), ptr(bases["mel_t"]),
                  ptr(partial), ptr(mel), ptr(lin), n, cfg.n_fft, j0 * cfg.hop_length,
                  n_live, cfg.num_freq, nfp, cfg.num_mels,
                  *_norm_args(cfg, normalize_linear), stream_ptr(frames.device))
    return mel, lin


class KernelDSP:
    """Counterpart of ``PallasDSP``: a drop-in for ``TorchDSP.features`` that
    runs preemphasis and reflect-centred framing in plain PyTorch, then K3″
    on the flattened (B*T, n_fft) frames."""

    def __init__(self, cfg: AudioConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._dsp = TorchDSP(cfg, self.device)
        self._bases = stft_bases(cfg, self.device)

    def features(self, wav: torch.Tensor) -> Features:
        """(B, S) raw wav -> (mel (B, T, M), linear (B, T, NF))."""
        wav = wav.to(self.device, torch.float32)
        frames = self._dsp._frame(self._dsp.preemphasis(wav))    # (B, T, n_fft)
        b, t, n = frames.shape
        mel, lin = stft_features_frames(frames.reshape(b * t, n), self.cfg, self._bases)
        return mel.reshape(b, t, self.cfg.num_mels), lin.reshape(b, t, self.cfg.num_freq)

    def mel_spectrogram(self, wav: torch.Tensor) -> torch.Tensor:
        return self.features(wav)[0]

    def linear_spectrogram(self, wav: torch.Tensor) -> torch.Tensor:
        return self.features(wav)[1]
