"""Text encoders (counterparts of ``gst_tacotron_tpu/models/encoder.py``):
``Taco1Encoder`` (prenet + CBHG) and ``Taco2Encoder`` (conv stack + BiGRU,
or Tacotron 2's BiLSTM with ``model.encoder.rnn = "lstm"``), the
``model.encoder.kind`` switch."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import EncoderConfig
from .modules import CBHG, Conv1dBNStack, Embed, Prenet, mask_sequence
from .rnn import BiGRU, BiLSTM


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


class Taco2Encoder(nn.Module):
    """embedding -> 3 x (5-tap conv + BatchNorm + ReLU) -> BiGRU -> (B, T,
    2*gru_dim) encoder states. No prenet. The BiGRU takes K1 on the card at
    inference (``models/rnn.py``), the plain scans in training and on the
    CPU; the stack's dropout draws from ``generator`` in training only.
    With ``cfg.rnn == "lstm"`` a BiLSTM (module name ``bilstm``) takes the
    BiGRU's place: the library's LSTM on the card at inference."""

    def __init__(self, cfg: EncoderConfig, num_symbols: int):
        super().__init__()
        self.embedding = Embed(num_symbols, cfg.embedding_dim)
        self.convs = Conv1dBNStack(cfg.embedding_dim, [cfg.embedding_dim] * 3, kernel_size=5)
        if cfg.rnn == "gru":
            self.bigru = BiGRU(cfg.embedding_dim, cfg.cbhg_gru_dim)
        elif cfg.rnn == "lstm":
            self.bilstm = BiLSTM(cfg.embedding_dim, cfg.cbhg_gru_dim)
        else:
            raise ValueError(f"unknown encoder rnn {cfg.rnn!r}")

    def forward(self, tokens: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                *, deterministic_prenet: bool = False,
                generator: Optional[torch.Generator] = None,
                plain: bool = False, train: bool = False) -> torch.Tensor:
        x = self.embedding(tokens)
        x = self.convs(x, lengths, train=train, generator=generator)
        rnn = self.bigru if hasattr(self, "bigru") else self.bilstm
        x, _ = rnn(x, lengths, plain=plain, train=train)
        return mask_sequence(x, lengths)


ENCODERS = {"taco1": Taco1Encoder, "taco2": Taco2Encoder}
