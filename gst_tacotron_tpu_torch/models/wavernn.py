"""WaveRNN-style autoregressive neural vocoder (counterpart of
``gst_tacotron_tpu/models/wavernn.py``):

    sample embedding (mu-law class of s_{t-1})  +  frame conditioning
      -> GRU(gru_dim) -> ReLU FC -> logits over 2**bits mu-law classes

The parameters keep the flax names (``sample_embed.embedding``,
``cond_proj``, ``gru``, ``fc1``, ``fc2``), so ``weights.load_flat`` carries a
JAX WaveRNN's variables over unchanged. ``sample`` runs through
``ops.wavernn.wavernn_sample``: the sampling kernel (K5) on the card, its
plain version on the CPU. ``forward`` is the teacher-forced pass of training
and ``loss`` its mu-law cross-entropy: plain PyTorch on every device, over
the parameters themselves, with the input product over all samples one
GEMM, the output layers one GEMM each, and only ``h @ wh`` in the loop.
Under ``modules.data_parallel`` the loss is the rank's share of the global
batch's mean (its sum over the global count), and sampling draws the
shard's rows of the global Gumbel stream.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import VocoderConfig
from ..dsp.mulaw import mulaw_decode, mulaw_encode
from ..losses import masked_mean
from ..ops.wavernn import (pack_wavernn_weights, teacher_forced_logits,
                           wavernn_sample, wavernn_sample_plain)
from .modules import Dense, Embed, data_shard, shard_row0
from .rnn import GRUCell


class WaveRNN(nn.Module):
    def __init__(self, cfg: VocoderConfig, num_mels: int):
        super().__init__()
        self.cfg = cfg
        c = cfg.wavernn_fc_dim
        self.sample_embed = Embed(self.num_classes, c)
        self.cond_proj = Dense(num_mels, c)
        self.gru = GRUCell(c, cfg.wavernn_gru_dim)
        self.fc1 = Dense(cfg.wavernn_gru_dim, c)
        self.fc2 = Dense(c, self.num_classes)

    @property
    def num_classes(self) -> int:
        return 2 ** self.cfg.wavernn_bits

    # -- conditioning -------------------------------------------------------

    def cond_frames(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, M) mel -> (B, T, fc_dim) frame-rate conditioning: what the
        sampler takes; sample s reads frame s // hop."""
        return self.cond_proj(mel)

    def upsample_cond(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, M) mel -> (B, T*hop, fc_dim) per-sample conditioning."""
        return torch.repeat_interleave(self.cond_frames(mel), self.cfg.wavernn_hop, dim=1)

    def _step_logits(self, h: torch.Tensor, prev_class: torch.Tensor, cond_t: torch.Tensor):
        x = self.sample_embed(prev_class) + cond_t
        h_new, out = self.gru(h, x)
        return h_new, self.fc2(torch.relu(self.fc1(out)))

    def pack(self, differentiable: bool = False):
        return pack_wavernn_weights(self, differentiable=differentiable)

    # -- teacher-forced pass ------------------------------------------------

    def forward(self, mel: torch.Tensor, wav: torch.Tensor) -> torch.Tensor:
        """mel (B, T, M), wav (B, T*hop) in [-1, 1] -> logits (B, T*hop, K):
        sample t predicted from the samples before it and the conditioning."""
        classes = mulaw_encode(wav, self.cfg.wavernn_bits)
        return teacher_forced_logits(self.pack(differentiable=True), self.cond_frames(mel),
                                     classes, hop=self.cfg.wavernn_hop)

    def loss(self, mel: torch.Tensor, wav: torch.Tensor,
             sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean negative log-likelihood of each sample's mu-law class
        (masked by ``sample_mask`` (B, T*hop) when given)."""
        logp = torch.log_softmax(self(mel, wav), dim=-1)
        targets = mulaw_encode(wav, self.cfg.wavernn_bits).long()
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        return masked_mean(nll, sample_mask, data_shard(self))

    # -- sampling -----------------------------------------------------------

    def sample_classes(self, mel: torch.Tensor, *, seed: int = 0, temperature: float = 1.0,
                       greedy: bool = False, plain: bool = False) -> torch.Tensor:
        """mel (B, T, M) -> mu-law classes (B, T*hop) int32."""
        run = wavernn_sample_plain if plain else wavernn_sample
        return run(self.pack(), self.cond_frames(mel), hop=self.cfg.wavernn_hop,
                   seed=seed, temperature=temperature, greedy=greedy,
                   row0=shard_row0(self, mel.shape[0]))

    def sample(self, mel: torch.Tensor, *, seed: int = 0, temperature: float = 1.0,
               greedy: bool = False, plain: bool = False) -> torch.Tensor:
        """mel (B, T, M) -> wav (B, T*hop) in [-1, 1]. ``greedy`` takes the
        argmax class each step; otherwise Gumbel-max sampling from the
        Philox stream keyed by ``seed``."""
        classes = self.sample_classes(mel, seed=seed, temperature=temperature,
                                      greedy=greedy, plain=plain)
        return mulaw_decode(classes, self.cfg.wavernn_bits)
