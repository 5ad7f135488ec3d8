"""Bahdanau and location-sensitive attention parameters, the initial
attention state and the alignment diagonality metric (counterparts of
``gst_tacotron_tpu/models/attention.py``).

The per-step score, masked softmax and context of the decoder live in
``ops/decode.py`` (the plain version of the decode kernel) and in the
kernel itself; the modules hold the parameters and project the keys once.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..config import AttentionConfig
from .modules import Dense, MatmulConv1D


def init_attention_state(batch: int, memory_time: int, device=None) -> Dict[str, torch.Tensor]:
    """Initial carry: alignment is a delta on frame 0."""
    alignment = torch.zeros(batch, memory_time, device=device)
    alignment[:, 0] = 1.0
    return {"alignment": alignment,
            "cumulative": torch.zeros(batch, memory_time, device=device)}


class BahdanauAttention(nn.Module):
    """Additive attention: score = v . tanh(W_k memory + W_q query)."""

    def __init__(self, cfg: AttentionConfig, query_dim: int, memory_dim: int):
        super().__init__()
        self.cfg = cfg
        self.query_proj = Dense(query_dim, cfg.dim, use_bias=False)
        self.memory_proj = Dense(memory_dim, cfg.dim, use_bias=False)
        self.score_v = Dense(cfg.dim, 1, use_bias=False)

    def precompute(self, memory: torch.Tensor) -> torch.Tensor:
        """(B, T, M) encoder states -> (B, T, dim) keys, once per utterance."""
        return self.memory_proj(memory)


class LocationSensitiveAttention(BahdanauAttention):
    """Content + location attention (Chorowski 2015):
    score = v . tanh(W_k memory + W_q query + W_f conv([prev ; cum])).
    ``location_conv`` is a (k, c, filters) ``MatmulConv1D`` over c = 2
    channels [prev ; cum] (1, [prev], without ``cumulative``)."""

    def __init__(self, cfg: AttentionConfig, query_dim: int, memory_dim: int):
        super().__init__(cfg, query_dim, memory_dim)
        self.location_conv = MatmulConv1D(cfg.location_channels, cfg.location_filters,
                                          cfg.location_kernel_size)
        self.location_proj = Dense(cfg.location_filters, cfg.dim, use_bias=False)


def make_attention(cfg: AttentionConfig, query_dim: int, memory_dim: int) -> nn.Module:
    if cfg.kind == "bahdanau":
        return BahdanauAttention(cfg, query_dim, memory_dim)
    if cfg.kind == "location_sensitive":
        return LocationSensitiveAttention(cfg, query_dim, memory_dim)
    raise ValueError(f"unknown attention kind {cfg.kind!r}")


def alignment_diagonality(alignments: torch.Tensor, text_lengths: torch.Tensor,
                          frame_lengths: torch.Tensor) -> torch.Tensor:
    """Share in [0, 1] of attention mass inside a band around the ideal
    monotone diagonal, for (B, S, T) alignment stacks."""
    b, s, t = alignments.shape
    dev = alignments.device
    text_lengths = text_lengths.to(dev).float()
    frame_lengths = frame_lengths.to(dev)
    steps = torch.arange(s, device=dev, dtype=torch.float32)[None, :, None]
    tokens = torch.arange(t, device=dev, dtype=torch.float32)[None, None, :]
    rate = text_lengths[:, None, None] / torch.clamp(
        frame_lengths[:, None, None].float(), min=1.0)
    ideal = steps * rate
    band = torch.clamp(0.1 * text_lengths[:, None, None], min=3.0)
    inside = (torch.abs(tokens - ideal) <= band).float()
    step_mask = (torch.arange(s, device=dev)[None, :] < frame_lengths[:, None]).float()
    mass_in = torch.einsum("bst,bst,bs->b", alignments, inside, step_mask)
    total = torch.clamp(step_mask.sum(1), min=1.0)
    return mass_in / total
