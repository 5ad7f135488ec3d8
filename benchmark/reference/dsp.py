"""Plain audio arithmetic of the synthesis path: the reference mels of a style
wav and Griffin-Lim.

A frozen copy of the math the port computes (periodic Hann window padded to
n_fft, Slaney mel filterbank, normalized dB, reflect-centred frames, fast
Griffin-Lim with momentum), in numpy and plain torch, written from the
audio settings of a configuration dict. Where the configuration states
bfloat16 operands (the reference mels' transform, Griffin-Lim's iterations)
the operands are rounded to bfloat16 and the products summed in float32,
which is the function those modes compute.
"""

from __future__ import annotations

import functools
import json
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 under one scale for the tensor (its largest
    magnitude to 448, the format's largest), as an fp8 product takes its
    operands; back to float32."""
    s = torch.clamp(x.abs().max(), min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


# the rounding of a product's operands where a configuration states a
# 16-bit mode, and where the control takes the next format down
LOW = {"bf16": round_bf16, "fp8": round_fp8}


def num_freq(a: dict) -> int:
    return a["n_fft"] // 2 + 1


def padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window (float64), zero-padded symmetrically to n_fft."""
    n = np.arange(win_length)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    pad = n_fft - win_length
    return np.pad(win, (pad // 2, pad - pad // 2))


def live_tap_span(a: dict) -> Tuple[int, int, int]:
    """(j0, j1, n_live): the hop chunks of the padded window with a nonzero
    tap, and their sample count."""
    hop, n_fft = a["hop_length"], a["n_fft"]
    win = padded_window(a["win_length"], n_fft)
    live = [j for j in range(n_fft // hop) if np.any(win[j * hop:(j + 1) * hop] != 0.0)]
    return live[0], live[-1] + 1, (live[-1] + 1 - live[0]) * hop


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    sp, lo = 200.0 / 3, 1000.0
    step = np.log(6.4) / 27.0
    return np.where(f >= lo, lo / sp + np.log(np.maximum(f, 1e-10) / lo) / step, f / sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    sp, lo = 200.0 / 3, 1000.0
    step = np.log(6.4) / 27.0
    return np.where(m >= lo / sp, lo * np.exp(step * (m - lo / sp)), m * sp)


def mel_filterbank(a: dict) -> np.ndarray:
    """Slaney-normalized triangular filters (num_mels, num_freq), float32."""
    nf = num_freq(a)
    freqs = np.linspace(0.0, a["sample_rate"] / 2.0, nf)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(a["mel_fmin"]), _hz_to_mel(a["mel_fmax"]),
                                 a["num_mels"] + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (pts[2: a["num_mels"] + 2] - pts[: a["num_mels"]]))[:, None]
    return w.astype(np.float32)


def normalize_db(db: torch.Tensor, a: dict) -> torch.Tensor:
    unit = (db - a["min_level_db"]) / (-a["min_level_db"])
    if a["symmetric_norm"]:
        m = a["max_abs_value"]
        return torch.clamp(2.0 * m * unit - m, -m, m)
    return torch.clamp(unit, 0.0, 1.0)


def denormalize_db(s: torch.Tensor, a: dict) -> torch.Tensor:
    if a["symmetric_norm"]:
        m = a["max_abs_value"]
        unit = (torch.clamp(s, -m, m) + m) / (2.0 * m)
    else:
        unit = torch.clamp(s, 0.0, 1.0)
    return unit * (-a["min_level_db"]) + a["min_level_db"]


def amp_to_normalized_db(x: torch.Tensor, a: dict) -> torch.Tensor:
    return normalize_db(20.0 * torch.log10(torch.clamp(x, min=1e-5)) - a["ref_level_db"], a)


@functools.lru_cache(maxsize=8)
def _feature_bases(audio_json: str):
    """Window-baked DFT bases over the live taps (n_live, num_freq), built
    from float64 angles and window and cast once to float32, and the
    transposed mel basis (num_freq, num_mels)."""
    a = json.loads(audio_json)
    nf = num_freq(a)
    j0, j1, _ = live_tap_span(a)
    n = np.arange(a["n_fft"])[:, None]
    ang = 2.0 * np.pi * n * np.arange(nf)[None, :] / a["n_fft"]
    win = padded_window(a["win_length"], a["n_fft"])[:, None]
    sl = slice(j0 * a["hop_length"], j1 * a["hop_length"])
    cos_b = (np.cos(ang) * win).astype(np.float32)[sl]
    sin_b = (-np.sin(ang) * win).astype(np.float32)[sl]
    return np.ascontiguousarray(cos_b), np.ascontiguousarray(sin_b), mel_filterbank(a).T.copy()


def reference_mels(wavs: Sequence[np.ndarray], a: dict, device, bf16: bool,
                   pad_multiple: int = 64, low: str = "bf16"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Style wavs -> (normalized-dB mels (B, T, M), T the longest rounded up
    to ``pad_multiple`` frames and zero past each length, lengths (B,)):
    float64 preemphasis, reflect centre pad, 1 + len // hop frames, window,
    DFT magnitude, mel, dB. ``bf16``: frames, bases, magnitudes and mel basis
    rounded to bfloat16 (or to the format ``low`` names), products summed in
    float32."""
    rnd = LOW[low]
    cos_np, sin_np, mel_np = _feature_bases(json.dumps(a, sort_keys=True))
    cos_b, sin_b = torch.from_numpy(cos_np).to(device), torch.from_numpy(sin_np).to(device)
    mel_t = torch.from_numpy(mel_np).to(device)
    hop, n_fft = a["hop_length"], a["n_fft"]
    j0, _, n_live = live_tap_span(a)
    mels: List[torch.Tensor] = []
    for w in wavs:
        x = np.asarray(w, np.float64)
        pre = x.copy()
        pre[1:] -= a["preemphasis"] * x[:-1]
        sig = np.pad(pre, (n_fft // 2, n_fft // 2), mode="reflect").astype(np.float32)
        t = 1 + len(x) // hop
        s = torch.from_numpy(sig).to(device)
        frames = s[j0 * hop:].unfold(0, n_live, hop)[:t]
        if bf16:
            frames, cb, sb = rnd(frames), rnd(cos_b), rnd(sin_b)
        else:
            cb, sb = cos_b, sin_b
        re, im = frames @ cb, frames @ sb
        mag = torch.sqrt(re * re + im * im)
        mel = rnd(mag) @ rnd(mel_t) if bf16 else mag @ mel_t
        mels.append(amp_to_normalized_db(mel, a))
    t_max = -(-max(m.shape[0] for m in mels) // pad_multiple) * pad_multiple
    out = torch.zeros(len(mels), t_max, a["num_mels"], device=device)
    for i, m in enumerate(mels):
        out[i, : m.shape[0]] = m
    return out, torch.tensor([m.shape[0] for m in mels], device=device)


# --- Griffin-Lim ---------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _gl_bases(audio_json: str):
    """The real-pair DFT bases of Griffin-Lim's iterations over the live taps,
    from float32 cos/sin and window products: forward (n_live, 2F), inverse
    (2F, n_live)."""
    a = json.loads(audio_json)
    n_fft, nf = a["n_fft"], num_freq(a)
    j0, _, n_live = live_tap_span(a)
    n0 = j0 * a["hop_length"]
    win = padded_window(a["win_length"], n_fft).astype(np.float32)
    ang = 2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(nf)[None, :] / n_fft
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


class GriffinLim:
    """Normalized linear spectrogram (B, T, F) -> waveform (B, hop * (T - 1)).
    With ``griffin_lim_bf16`` the iterations' transforms take operands
    rounded to bfloat16 (or to the format ``low`` names)."""

    def __init__(self, a: dict, device, low: str = "bf16"):
        self.a, self.device = a, device
        self.rnd = LOW[low]
        fwd, inv = _gl_bases(json.dumps(a, sort_keys=True))
        self.fwd = self.rnd(torch.from_numpy(fwd).to(device))
        self.inv = self.rnd(torch.from_numpy(inv).to(device))
        self.window = torch.from_numpy(
            padded_window(a["win_length"], a["n_fft"]).astype(np.float32)).to(device)
        self._winsq = padded_window(a["win_length"], a["n_fft"]) ** 2

    def _win_norm(self, t: int) -> torch.Tensor:
        a = self.a
        norm = np.zeros(a["n_fft"] + a["hop_length"] * (t - 1))
        for i in range(t):
            norm[i * a["hop_length"]: i * a["hop_length"] + a["n_fft"]] += self._winsq
        return torch.from_numpy(np.maximum(norm, 1e-10).astype(np.float32)).to(self.device)

    def stft(self, wav: torch.Tensor, bf16: bool):
        a = self.a
        hop, n_fft, nf = a["hop_length"], a["n_fft"], num_freq(a)
        wav = F.pad(wav[:, None, :], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
        t = 1 + (wav.shape[-1] - n_fft) // hop
        if not bf16:
            spec = torch.fft.rfft(wav.unfold(-1, n_fft, hop) * self.window, n=n_fft, dim=-1)
            return spec.real, spec.imag
        j0, _, n_live = live_tap_span(a)
        frames = wav[:, j0 * hop:].unfold(-1, n_live, hop)[:, :t]
        out = self.rnd(frames) @ self.fwd
        return out[..., :nf], out[..., nf:]

    def istft(self, re: torch.Tensor, im: torch.Tensor, bf16: bool) -> torch.Tensor:
        a = self.a
        b, t, _ = re.shape
        hop, n_fft = a["hop_length"], a["n_fft"]
        k = n_fft // hop
        if bf16:
            j0, _, n_live = live_tap_span(a)
            frames = self.rnd(torch.cat([re, im], -1)) @ self.inv
            nk = n_live // hop
        else:
            frames = torch.fft.irfft(torch.complex(re, im), n=n_fft, dim=-1) * self.window
            j0, nk = 0, k
        chunks = frames.reshape(b, t, nk, hop)
        out = frames.new_zeros(b, t + k - 1, hop)
        for j in range(nk):
            out[:, j0 + j: j0 + j + t] += chunks[:, :, j]
        total = n_fft + hop * (t - 1)
        out = out.reshape(b, total) / self._win_norm(t)
        return out[:, n_fft // 2: total - n_fft // 2]

    def target(self, linear: torch.Tensor) -> torch.Tensor:
        """The magnitudes Griffin-Lim fits: amplitude of the denormalized
        dB, to the power ``griffin_lim_power``."""
        a = self.a
        mag = torch.pow(10.0, (denormalize_db(linear.float(), a) + a["ref_level_db"]) * 0.05)
        return mag ** a["griffin_lim_power"]

    def convergence(self, wav: np.ndarray, target: torch.Tensor) -> np.ndarray:
        """Each row's spectral convergence: the distance of the magnitudes
        of ``wav`` (preemphasized again, float32 STFT) from ``target``, over
        the target's norm."""
        a = self.a
        x = np.asarray(wav, np.float64).copy()
        x[:, 1:] -= a["preemphasis"] * np.asarray(wav, np.float64)[:, :-1]
        re, im = self.stft(torch.from_numpy(x.astype(np.float32)).to(self.device), False)
        mag = torch.sqrt(re * re + im * im)
        dist = torch.linalg.vector_norm(mag - target, dim=(1, 2))
        return (dist / torch.linalg.vector_norm(target, dim=(1, 2))).cpu().numpy()

    def __call__(self, linear: torch.Tensor) -> np.ndarray:
        """The waveform of ``linear`` on the host (float64 inverse
        preemphasis at the end)."""
        from scipy.signal import lfilter

        a = self.a
        mag = self.target(linear)
        re, im = mag, torch.zeros_like(mag)
        pre, pim = re, im
        alpha, lp = a["griffin_lim_momentum"], bool(a["griffin_lim_bf16"])
        for _ in range(a["griffin_lim_iters"]):
            cre, cim = re + alpha * (re - pre), im + alpha * (im - pim)
            re2, im2 = self.stft(self.istft(cre, cim, lp), lp)
            scale = mag / torch.clamp(torch.sqrt(re2 * re2 + im2 * im2), min=1e-16)
            re, im, pre, pim = re2 * scale, im2 * scale, re, im
        wav = self.istft(re, im, False).double().cpu().numpy()
        if a["preemphasis"] == 0.0:
            return wav
        return lfilter([1.0], [1.0, -a["preemphasis"]], wav, axis=-1)
