"""Post-nets: the CBHG over the predicted mel -> linear spectrogram
(counterpart of ``gst_tacotron_tpu/models/postnet.py``), and Tacotron 2's
conv post-net -> a mel residual, which has no JAX counterpart
(``model.postnet.kind``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import PostnetConfig
from .modules import CBHG, BatchNorm, Dense, MatmulConv1D, mask_sequence


class PostCBHG(nn.Module):
    def __init__(self, cfg: PostnetConfig, num_mels: int, num_freq: int):
        super().__init__()
        c = cfg
        self.cbhg = CBHG(num_mels, c.cbhg_bank_k, c.cbhg_bank_channels,
                         c.cbhg_proj_channels, c.cbhg_highway_layers,
                         c.cbhg_highway_dim, c.cbhg_gru_dim)
        self.linear_proj = Dense(2 * c.cbhg_gru_dim, num_freq)

    def forward(self, mel: torch.Tensor, mel_lengths: Optional[torch.Tensor] = None,
                *, plain: bool = False, train: bool = False) -> torch.Tensor:
        return self.linear_proj(self.cbhg(mel, mel_lengths, plain=plain, train=train))


class ConvPostnet(nn.Module):
    """Tacotron 2's post-net: ``conv_layers`` x (mask -> SAME conv1d of
    ``conv_kernel_size`` taps -> BatchNorm -> tanh, none after the last),
    ``conv_channels`` wide, the last back to ``num_mels``; returns the
    residual, which ``GSTTacotron`` adds to the decoder's mel. The convs
    carry no bias of their own: before an inference BatchNorm one folds into
    its shift. Dropout (0.5 in training) is off at inference."""

    def __init__(self, cfg: PostnetConfig, num_mels: int):
        super().__init__()
        self.num_layers = cfg.conv_layers
        c_in = num_mels
        for i in range(cfg.conv_layers):
            c_out = num_mels if i + 1 == cfg.conv_layers else cfg.conv_channels
            setattr(self, f"conv_{i}", MatmulConv1D(c_in, c_out, cfg.conv_kernel_size))
            setattr(self, f"bn_{i}", BatchNorm(c_out))
            c_in = c_out

    def forward(self, mel: torch.Tensor, mel_lengths: Optional[torch.Tensor] = None,
                *, plain: bool = False, train: bool = False) -> torch.Tensor:
        x = mel
        for i in range(self.num_layers):
            x = mask_sequence(x, mel_lengths)
            x = getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(x), train)
            if i + 1 < self.num_layers:
                x = torch.tanh(x)
        return mask_sequence(x, mel_lengths)


def make_postnet(cfg: PostnetConfig, num_mels: int, num_freq: int) -> nn.Module:
    if cfg.kind == "cbhg":
        return PostCBHG(cfg, num_mels, num_freq)
    if cfg.kind == "conv":
        return ConvPostnet(cfg, num_mels)
    raise ValueError(f"unknown postnet kind {cfg.kind!r}")
