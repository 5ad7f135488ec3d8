"""Text encoder (counterpart of ``gst_tacotron_tpu/models/encoder.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import EncoderConfig
from .modules import CBHG, Embed, Prenet, mask_sequence


class Taco1Encoder(nn.Module):
    """embedding -> prenet -> CBHG -> (B, T, 2*gru_dim) encoder states."""

    def __init__(self, cfg: EncoderConfig, num_symbols: int):
        super().__init__()
        c = cfg
        self.embedding = Embed(num_symbols, c.embedding_dim)
        self.prenet = Prenet(c.embedding_dim, c.prenet_dims, c.prenet_dropout)
        self.cbhg = CBHG(c.prenet_dims[-1], c.cbhg_bank_k, c.cbhg_bank_channels,
                         c.cbhg_proj_channels, c.cbhg_highway_layers,
                         c.cbhg_highway_dim, c.cbhg_gru_dim)

    def forward(self, tokens: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                *, deterministic_prenet: bool = False,
                generator: Optional[torch.Generator] = None,
                plain: bool = False, train: bool = False) -> torch.Tensor:
        x = self.embedding(tokens)
        x = self.prenet(x, deterministic=deterministic_prenet, generator=generator)
        x = self.cbhg(x, lengths, plain=plain, train=train)
        return mask_sequence(x, lengths)
