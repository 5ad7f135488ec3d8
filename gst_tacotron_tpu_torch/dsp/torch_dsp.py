"""PyTorch DSP — counterpart of ``gst_tacotron_tpu/dsp/jax_dsp.py``.

Batch-first: wav (B, S) -> spectra (B, T, bins). Everything here is plain
PyTorch, as the JAX module is plain jnp: the forward and inverse STFTs use
``torch.fft`` on hop-chunk frames, and ``features_precentered`` is the plain
feature path of the wav-transport step and of the extractor's plain route
(the STFT kernels live in ``ops/stft.py``). Griffin-Lim's iterations follow
``AudioConfig.griffin_lim_bf16`` as ``JaxDSP`` does: with it set, both
transforms are the real-pair DFT products over the window's live taps, on
operands rounded to bfloat16 with float32 sums (``low_precision``); the last
inverse is float32 either way. On the card the bf16 iterations run on
``ops/griffin_lim.py``'s kernels; the plain loop here is the CPU's route,
their oracle, and the float32 one. The inverse preemphasis IIR runs blockwise: a
lower-triangular product inside each block, then the carries across blocks
as a second triangular product.

``mel_to_linear`` is Tacotron 2's way back from a mel (Rayhane-mamah's
``inv_mel_spectrogram``): the mel basis's pseudo-inverse over the amplitudes,
floored at 1e-10, before Griffin-Lim's power and iterations
(``inv_amplitude``).

The tables that depend only on the config and a length (the window-square
norm of ``istft_ri`` by frame count, and the inverse preemphasis's three
tables by padded block count) are built on the host once per length and
kept on the device (``TorchDSP._tables``); the counters ``dsp_table_builds``
and ``dsp_table_hits`` count each table built and each taken from there.
"""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import AudioConfig
from ..utils.profiling import count
from .mel import mel_filterbank
from .ref import live_tap_span, padded_window

IIR_BLOCK = 256
# lengths of each kind of shape-only table a TorchDSP keeps on its device;
# the preemphasis carry table is nb x nb floats (4 MB at 999 blocks)
TABLE_LENGTHS = 8


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


@functools.lru_cache(maxsize=4)
def _dft_bases_np(cfg: AudioConfig) -> Tuple[np.ndarray, np.ndarray]:
    """``JaxDSP``'s windowed real-pair DFT bases over the live taps, float32,
    built as JAX builds them (float64 angles, float32 cos/sin and window
    products; each is then rounded once to bfloat16): forward (n_live, 2F),
    inverse (2F, n_live)."""
    n_fft, nf = cfg.n_fft, cfg.num_freq
    j0, _, n_live = live_tap_span(cfg)
    n0 = j0 * cfg.hop_length
    win = padded_window(cfg.win_length, n_fft).astype(np.float32)
    ang = (2.0 * np.pi * np.arange(n_fft)[:, None].astype(np.float64)
           * np.arange(nf)[None, :].astype(np.float64) / n_fft)
    fwd = np.concatenate([np.cos(ang).astype(np.float32),
                          (-np.sin(ang)).astype(np.float32)], axis=1) * win[:, None]
    w = np.full((nf,), 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    inv = np.concatenate([((w[:, None] * np.cos(ang.T)) / n_fft).astype(np.float32),
                          ((-w[:, None] * np.sin(ang.T)) / n_fft).astype(np.float32)],
                         axis=0) * win[None, :]
    sl = slice(n0, n0 + n_live)
    return np.ascontiguousarray(fwd[sl]), np.ascontiguousarray(inv[:, sl])


def frame_indices(num_samples: int, n_fft: int, hop: int) -> np.ndarray:
    """(T, n_fft) sample indices of the frames of a ``num_samples`` signal,
    T = 1 + (num_samples - n_fft) // hop."""
    num_frames = 1 + (num_samples - n_fft) // hop
    return np.arange(num_frames)[:, None] * hop + np.arange(n_fft)[None, :]


def num_frames_for(num_samples: int, cfg: AudioConfig) -> int:
    """Frame count for a center-padded signal of ``num_samples`` samples."""
    return 1 + num_samples // cfg.hop_length


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
        self._bf16_bases = None
        self._mel_pinv: Optional[torch.Tensor] = None
        # (n0, n_live): the first sample and the count of the padded
        # window's live hop-chunks (JaxDSP's tap_j0 * hop and its span)
        j0, _, n_live = live_tap_span(cfg)
        self._live_span = (j0 * cfg.hop_length, n_live)
        self._tables: dict = {}
        self._tables_lock = threading.Lock()

    def _cached_tables(self, kind: str, length: int, device: torch.device,
                       build: Callable[[int], Tuple[np.ndarray, ...]]
                       ) -> Tuple[torch.Tensor, ...]:
        """The device copies of ``build(length)``'s arrays, built and copied
        once per (length, device) and kept for the ``TABLE_LENGTHS`` lengths
        of ``kind`` used last; counts each table as ``dsp_table_builds`` or
        ``dsp_table_hits``."""
        key = (length, device)
        with self._tables_lock:
            lru = self._tables.setdefault(kind, OrderedDict())
            tables = lru.get(key)
            if tables is not None:
                lru.move_to_end(key)
                count("dsp_table_hits", len(tables))
                return tables
            tables = tuple(torch.from_numpy(a).to(device) for a in build(length))
            count("dsp_table_builds", len(tables))
            lru[key] = tables
            if len(lru) > TABLE_LENGTHS:
                lru.popitem(last=False)
            return tables

    # -- bf16 DFT products (griffin_lim_bf16) --------------------------------

    def bf16_bases(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The windowed real-pair DFT bases of ``JaxDSP``'s two conv kernels
        over the live taps, in bfloat16 on this DSP's device: forward
        (n_live, 2F) and inverse (2F, n_live)."""
        if self._bf16_bases is None:
            self._bf16_bases = tuple(torch.from_numpy(b).to(self.device).to(torch.bfloat16)
                                     for b in _dft_bases_np(self.cfg))
        return self._bf16_bases

    @staticmethod
    def _bf16_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """(..., K) @ (K, N) on ``x`` rounded to bfloat16 and the bfloat16
        ``w``, summed in float32. On the CPU the rounded operands are
        multiplied in float32 (a product of two bfloat16 values is exact
        there); on the card one GEMM takes bfloat16 operands and returns
        float32."""
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
        if x.device.type == "cuda":
            out = torch.mm(x2, w, out_dtype=torch.float32)
        else:
            out = x2.float() @ w.float()
        return out.reshape(*lead, w.shape[-1])

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

    def stft_ri(self, wav: torch.Tensor, low_precision: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S) -> real/imag pair with reflect centre padding.
        ``low_precision``: the DFT products of the live taps on bfloat16
        operands with float32 sums (JaxDSP's Griffin-Lim iterations)."""
        pad = self.cfg.n_fft // 2
        wav = F.pad(wav[:, None, :], (pad, pad), mode="reflect")[:, 0]
        if not low_precision:
            return self.stft_ri_precentered(wav)
        cfg = self.cfg
        n0, n_live = self._live_span
        t = 1 + (wav.shape[-1] - cfg.n_fft) // cfg.hop_length
        frames = wav[:, n0:].unfold(-1, n_live, cfg.hop_length)[:, :t]
        out = self._bf16_product(frames, self.bf16_bases()[0])
        return out[..., :cfg.num_freq], out[..., cfg.num_freq:]

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

    def _win_norm_np(self, num_frames: int) -> Tuple[np.ndarray]:
        """The overlap-add window-square norm of ``num_frames`` frames,
        float32 (summed in float64, floored at 1e-10)."""
        cfg = self.cfg
        total = cfg.n_fft + cfg.hop_length * (num_frames - 1)
        norm = np.zeros(total, np.float64)
        for t in range(num_frames):
            norm[t * cfg.hop_length: t * cfg.hop_length + cfg.n_fft] += self._winsq
        return (np.maximum(norm, 1e-10).astype(np.float32),)

    def _win_norm(self, num_frames: int) -> torch.Tensor:
        return self._cached_tables("win_norm", num_frames, self.device, self._win_norm_np)[0]

    def istft_ri(self, re: torch.Tensor, im: torch.Tensor,
                 low_precision: bool = False) -> torch.Tensor:
        """Real/imag (B, T, F) -> (B, hop * (T - 1)): inverse FFT, window,
        overlap-add as shifted adds of hop-sized chunks, window-square
        normalization, centre crop. ``low_precision``: the windowed inverse
        DFT products of the live taps on bfloat16 operands with float32 sums
        (JaxDSP's Griffin-Lim iterations)."""
        cfg = self.cfg
        b, t, _ = re.shape
        hop, k = cfg.hop_length, cfg.n_fft // cfg.hop_length
        if low_precision:
            n0, n_live = self._live_span
            frames = self._bf16_product(torch.cat([re, im], -1), self.bf16_bases()[1])
            j0, nk = n0 // hop, n_live // hop
        else:
            frames = torch.fft.irfft(torch.complex(re, im), n=cfg.n_fft, dim=-1) * self.window
            j0, nk = 0, k
        chunks = frames.reshape(b, t, nk, hop)
        out = frames.new_zeros(b, t + k - 1, hop)
        for j in range(nk):
            out[:, j0 + j: j0 + j + t] += chunks[:, :, j]
        total = cfg.n_fft + hop * (t - 1)
        out = out.reshape(b, total) / self._win_norm(t)
        return out[:, cfg.n_fft // 2: total - cfg.n_fft // 2]

    def istft(self, spect: torch.Tensor) -> torch.Tensor:
        """Complex (B, T, F) -> (B, hop * (T - 1)): ``istft_ri`` of its real
        and imaginary parts (the function of both of ``JaxDSP.istft``'s
        routes)."""
        return self.istft_ri(spect.real, spect.imag)

    def griffin_lim(self, magnitude: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, T, F) magnitude -> (B, S) waveform. Zero start phase unless a
        generator is given; fast Griffin-Lim momentum
        ``griffin_lim_momentum`` (0 is the plain iteration); the iterations'
        transforms on bfloat16 operands when ``griffin_lim_bf16`` is set, on
        the card through ``ops/griffin_lim.py``'s kernels."""
        if generator is None:
            re, im = magnitude, torch.zeros_like(magnitude)
        else:
            ang = torch.rand(magnitude.shape, generator=generator,
                             device=magnitude.device) * (2.0 * np.pi)
            re, im = magnitude * torch.cos(ang), magnitude * torch.sin(ang)
        if magnitude.device.type == "cuda" and self.cfg.griffin_lim_bf16:
            from ..ops.griffin_lim import griffin_lim_iterations

            re, im = griffin_lim_iterations(self, magnitude, re, im)
        else:
            re, im = self.griffin_lim_iterations_plain(magnitude, re, im)
        return self.istft_ri(re, im)

    def griffin_lim_iterations_plain(self, magnitude: torch.Tensor, re: torch.Tensor,
                                     im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Griffin-Lim's iterations in plain PyTorch from the start spectrum
        (``re``, ``im``): the last projected (re, im). The CPU's route (the
        kernels' oracle) and the float32 one; each iteration counts
        ``griffin_lim_plain_iters``."""
        cfg = self.cfg
        alpha, lp = cfg.griffin_lim_momentum, bool(cfg.griffin_lim_bf16)
        pre, pim = re, im
        for _ in range(cfg.griffin_lim_iters):
            cre = re + alpha * (re - pre)
            cim = im + alpha * (im - pim)
            re2, im2 = self.stft_ri(self.istft_ri(cre, cim, lp), lp)
            scale = magnitude / torch.clamp(torch.sqrt(re2 * re2 + im2 * im2), min=1e-16)
            re, im, pre, pim = re2 * scale, im2 * scale, re, im
            count("griffin_lim_plain_iters")
        return re, im

    def inv_linear_spectrogram(self, spect: torch.Tensor,
                               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Normalized linear spectrogram (B, T, F) -> waveform (B, S)."""
        cfg = self.cfg
        s = db_to_amp(denormalize_db(spect, cfg) + cfg.ref_level_db)
        return self.inv_amplitude(s, generator)

    def inv_amplitude(self, amp: torch.Tensor,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Linear amplitudes (B, T, F) -> waveform (B, S): Griffin-Lim on
        their ``griffin_lim_power``, then the inverse preemphasis."""
        return self.inv_preemphasis(self.griffin_lim(amp ** self.cfg.griffin_lim_power,
                                                     generator))

    def mel_to_linear(self, mel: torch.Tensor) -> torch.Tensor:
        """Normalized mel (B, T, M) -> linear amplitudes (B, T, F): the
        amplitudes of the denormalized dB through the mel basis's
        pseudo-inverse (float64 ``np.linalg.pinv``, kept in float32),
        floored at 1e-10."""
        cfg = self.cfg
        if self._mel_pinv is None:
            basis = self.mel_basis.double().cpu().numpy()
            self._mel_pinv = torch.from_numpy(
                np.ascontiguousarray(np.linalg.pinv(basis).T).astype(np.float32)).to(self.device)
        amp = db_to_amp(denormalize_db(mel, cfg) + cfg.ref_level_db)
        return torch.clamp(amp @ self._mel_pinv, min=1e-10)

    # -- preemphasis --------------------------------------------------------

    def preemphasis(self, wav: torch.Tensor) -> torch.Tensor:
        """y[t] = x[t] - coef * x[t-1]."""
        coef = self.cfg.preemphasis
        if coef == 0.0:
            return wav
        return wav - coef * F.pad(wav, (1, 0))[:, :-1]

    def _iir_tables_np(self, nb: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``inv_preemphasis``'s tables for ``nb`` blocks, float32: the
        in-block triangle (transposed, (blk, blk)), the carries' triangle
        (transposed, (nb, nb)) and the decay coef^(i+1), (blk,)."""
        coef, blk = self.cfg.preemphasis, IIR_BLOCK
        i = np.arange(blk)
        tri = np.where(i[:, None] >= i[None, :],
                       np.power(coef, np.maximum(i[:, None] - i[None, :], 0)), 0.0)
        # carries: the true last sample of block m is sum_{m' <= m} a^(m-m')
        # times the local last of block m', with a = coef ** blk
        m = np.arange(nb)
        with np.errstate(under="ignore"):
            tri2 = np.where(m[:, None] >= m[None, :],
                            np.power(coef ** blk, np.maximum(m[:, None] - m[None, :], 0)), 0.0)
        return (tri.T.astype(np.float32), tri2.T.astype(np.float32),
                np.power(coef, i + 1).astype(np.float32))

    def inv_preemphasis(self, wav: torch.Tensor) -> torch.Tensor:
        """y[t] = x[t] + coef * y[t-1], blockwise."""
        coef = self.cfg.preemphasis
        if coef == 0.0:
            return wav
        b, n = wav.shape
        blk = IIR_BLOCK
        nb = -(-n // blk)
        x = F.pad(wav, (0, nb * blk - n)).reshape(b, nb, blk)
        tri, tri2, decay = self._cached_tables("iir", nb, wav.device, self._iir_tables_np)
        y = x @ tri
        last = y[:, :, -1] @ tri2
        carry = F.pad(last, (1, 0))[:, :-1]                       # into block m
        y = y + carry[:, :, None] * decay
        return y.reshape(b, nb * blk)[:, :n]
