"""Pluggable vocoders (counterpart of ``gst_tacotron_tpu/vocoder.py``).

vocoder(outputs, seed) -> waveform (B, S):
  * ``GriffinLimVocoder``: invert the post-net LINEAR spectrogram (cuFFT).
  * ``WaveRNNVocoder``: sample from the MEL with the neural vocoder, through
    the sampling kernel (K5) on the card.

``make_vocoder`` builds the configured one. WaveRNN variables come as the
flat ``params/...`` mapping of ``weights.load_flat``, or from a vocoder
training workdir (``load_wavernn_variables``: the latest ``vocoder_ckpt/``
checkpoint of ``vocoder_train.VocoderTrainer``, or a JAX vocoder workdir
exported by ``tools/export_jax_workdir.py --vocoder``).
"""

from __future__ import annotations

import os
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


def load_wavernn_variables(vocoder_workdir: str, ckpt_dirname: str = "vocoder_ckpt"
                           ) -> Dict[str, np.ndarray]:
    """The flat ``params/...`` variables of the latest WaveRNN checkpoint
    under ``vocoder_workdir``/``ckpt_dirname``: one that
    ``vocoder_train.VocoderTrainer`` saved, or an exported JAX one."""
    from .checkpoint import CheckpointManager
    from .weights import state_key_to_flat

    directory = os.path.join(vocoder_workdir, ckpt_dirname)
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no vocoder checkpoint directory at {directory}")
    saved = CheckpointManager(directory).restore(map_location="cpu")
    return {state_key_to_flat(k): v.numpy() for k, v in saved["model"].items()}


def make_vocoder(cfg: Config, wavernn_variables: Optional[Mapping[str, np.ndarray]] = None,
                 *, vocoder_workdir: Optional[str] = None, device=None):
    """The vocoder of ``cfg.model.vocoder.kind``; a WaveRNN takes its flat
    variables, or restores them from ``vocoder_workdir``."""
    from .weights import build_wavernn

    kind = cfg.model.vocoder.kind
    if kind == "griffin_lim":
        return GriffinLimVocoder(cfg, device=device)
    if kind == "wavernn":
        if wavernn_variables is None:
            if vocoder_workdir is None:
                raise ValueError("the wavernn vocoder needs its variables or a vocoder "
                                 "workdir to restore them from")
            wavernn_variables = load_wavernn_variables(vocoder_workdir)
        return WaveRNNVocoder(cfg, build_wavernn(cfg, flat=wavernn_variables, device=device),
                              device=device)
    raise ValueError(f"unknown vocoder kind {kind!r}")
