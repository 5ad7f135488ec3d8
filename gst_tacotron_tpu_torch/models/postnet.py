"""Post-net: CBHG over the predicted mel -> linear spectrogram (counterpart
of ``gst_tacotron_tpu/models/postnet.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import PostnetConfig
from .modules import CBHG, Dense


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
