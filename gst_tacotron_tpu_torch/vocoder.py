"""Pluggable vocoders (counterpart of ``gst_tacotron_tpu/vocoder.py``).

vocoder(outputs, seed) -> waveform (B, S):
  * ``GriffinLimVocoder``: invert the post-net LINEAR spectrogram (cuFFT).
  * ``WaveRNNVocoder``: sample from the MEL with the neural vocoder, through
    the sampling kernel (K5) on the card.

``make_vocoder`` builds the configured one. WaveRNN variables come as the
flat ``params/...`` mapping of ``weights.load_flat``; restoring them from a
vocoder training workdir (the JAX ``load_wavernn_variables``, an orbax
checkpoint) waits for the checkpoint exporter and is not ported.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .config import Config
from .device import resolve_device
from .dsp.torch_dsp import TorchDSP
from .models.wavernn import WaveRNN


def check_vocoder_hop(cfg: Config) -> None:
    """wavernn_hop must equal the audio hop, or the conditioning of each
    sample reads the wrong mel frame."""
    if cfg.model.vocoder.wavernn_hop != cfg.audio.hop_length:
        raise ValueError(
            f"model.vocoder.wavernn_hop={cfg.model.vocoder.wavernn_hop} != "
            f"audio.hop_length={cfg.audio.hop_length}; override both together")


class GriffinLimVocoder:
    kind = "griffin_lim"

    def __init__(self, cfg: Config, *, device=None):
        self.dsp = TorchDSP(cfg.audio, resolve_device(device))

    @torch.no_grad()
    def __call__(self, outputs: Dict[str, torch.Tensor], seed: int = 0,
                 plain: bool = False) -> torch.Tensor:
        return self.dsp.inv_linear_spectrogram(outputs["linear"])


class WaveRNNVocoder:
    """Samples a waveform from ``outputs["mel"]`` (B, T, M) -> (B, T*hop).
    ``greedy`` takes the argmax class at every sample; otherwise sampling at
    ``temperature`` draws from the Philox stream keyed by the call's seed."""

    kind = "wavernn"

    def __init__(self, cfg: Config, model: WaveRNN, *, device=None,
                 temperature: float = 1.0, greedy: bool = False):
        check_vocoder_hop(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.temperature, self.greedy = temperature, greedy

    @torch.no_grad()
    def __call__(self, outputs: Dict[str, torch.Tensor], seed: int = 0,
                 plain: bool = False) -> torch.Tensor:
        """``plain`` samples with the kernel's plain version on any device."""
        return self.model.sample(outputs["mel"].to(self.device), seed=seed,
                                 temperature=self.temperature, greedy=self.greedy,
                                 plain=plain)


def make_vocoder(cfg: Config, wavernn_variables: Optional[Mapping[str, np.ndarray]] = None,
                 *, device=None):
    """The vocoder of ``cfg.model.vocoder.kind``; a WaveRNN takes its flat
    variables."""
    from .weights import build_wavernn

    kind = cfg.model.vocoder.kind
    if kind == "griffin_lim":
        return GriffinLimVocoder(cfg, device=device)
    if kind == "wavernn":
        if wavernn_variables is None:
            raise ValueError("the wavernn vocoder needs its variables (restoring a "
                             "vocoder workdir is not ported)")
        return WaveRNNVocoder(cfg, build_wavernn(cfg, flat=wavernn_variables, device=device),
                              device=device)
    raise ValueError(f"unknown vocoder kind {kind!r}")
