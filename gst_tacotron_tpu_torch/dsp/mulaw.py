"""mu-law companding (counterpart of ``gst_tacotron_tpu/dsp/jax_dsp.py``
``mulaw_encode``/``mulaw_decode``): waveforms in [-1, 1] <-> integer classes
in [0, 2**bits)."""

from __future__ import annotations

import math

import torch


def mulaw_encode(wav: torch.Tensor, bits: int) -> torch.Tensor:
    """mu-law compand to int32 classes [0, 2**bits) (the WaveRNN target)."""
    mu = 2 ** bits - 1
    x = torch.clamp(wav, -1.0, 1.0)
    y = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / math.log1p(mu)
    return ((y + 1.0) / 2.0 * mu + 0.5).to(torch.int32)


def mulaw_decode(classes: torch.Tensor, bits: int) -> torch.Tensor:
    """Classes -> float32 waveform, clipped to [-1, 1]: expm1/log1p overshoot
    by about 1e-6 at the extreme classes."""
    mu = 2 ** bits - 1
    y = 2.0 * classes.to(torch.float32) / mu - 1.0
    wav = torch.sign(y) * torch.expm1(torch.abs(y) * math.log1p(mu)) / mu
    return torch.clamp(wav, -1.0, 1.0)
