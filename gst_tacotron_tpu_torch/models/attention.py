"""Bahdanau and location-sensitive attention: parameters, the step, the
initial attention state and the alignment diagonality metric (counterparts
of ``gst_tacotron_tpu/models/attention.py``).

``attention_step`` is the per-step score, masked softmax and context over
projected keys. The plain decode step (``ops/decode.py::decode_step``, K4's
oracle and the teacher-forced training step) calls it with the packed
weights; the modules' ``forward`` calls it with their own parameters, as the
JAX modules' ``__call__``. Location-sensitive attention folds its conv and
projection into one (k*c, A) tap matrix (``loca``), a linear refolding of
the same sum.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import AttentionConfig
from .modules import Dense, MatmulConv1D


def init_attention_state(batch: int, memory_time: int, device=None) -> Dict[str, torch.Tensor]:
    """Initial carry: alignment is a delta on frame 0."""
    alignment = torch.zeros(batch, memory_time, device=device)
    alignment[:, 0] = 1.0
    return {"alignment": alignment,
            "cumulative": torch.zeros(batch, memory_time, device=device)}


def attention_step(q: torch.Tensor, keys: torch.Tensor, memory: torch.Tensor,
                   valid: Optional[torch.Tensor], prev: torch.Tensor, cum: torch.Tensor,
                   vvec: torch.Tensor, loca: Optional[torch.Tensor] = None,
                   loc_k: int = 1, loc_c: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """score = v . tanh(keys + q [+ taps([prev ; cum]) @ loca]), masked to
    -1e9 where ``valid`` (B, T) is False, softmax over T, context.
    ``q`` (B, A) is the projected query, ``keys`` (B, T, A), ``memory``
    (B, T, M). ``loca`` None is Bahdanau attention. Returns (context (B, M),
    alignment (B, T), previous', cumulative')."""
    t = keys.shape[1]
    arg = keys + q[:, None, :]
    if loca is not None:
        feats = torch.stack([prev, cum][:loc_c], -1)                # (B, T, c)
        fp = F.pad(feats, (0, 0, (loc_k - 1) // 2, loc_k // 2))
        arg = arg + torch.cat([fp[:, j: j + t] for j in range(loc_k)], -1) @ loca
    scores = torch.tanh(arg) @ vvec
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, -1e9))
    m = scores.max(-1, keepdim=True).values
    e = torch.exp(scores - m)
    if valid is not None:
        e = e * valid
    denom = torch.clamp(e.sum(-1, keepdim=True), min=1e-9)
    align = e / denom
    # the context takes the promoted dtype of the alignment and the memory;
    # where that is wider, the quotient is taken in it (XLA keeps a value
    # it promotes at once unrounded), so a bf16 alignment over float32
    # memory weighs with its float32 quotient
    dt = torch.promote_types(align.dtype, memory.dtype)
    weights = align if dt == align.dtype else e.to(dt) / denom.to(dt)
    ctx = torch.einsum("bt,btm->bm", weights, memory.to(dt))
    return ctx, align, align, cum + align


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

    def loca(self) -> Optional[torch.Tensor]:
        """The location conv folded with its projection into one (k*c, dim)
        tap matrix (None: no location term)."""
        return None

    def forward(self, query: torch.Tensor, memory: torch.Tensor, keys: torch.Tensor,
                memory_mask: Optional[torch.Tensor], state: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """One step: (context (B, M), alignment (B, T), new state)."""
        k = self.cfg.location_kernel_size
        ctx, align, prev, cum = attention_step(
            self.query_proj(query), keys, memory, memory_mask, state["alignment"],
            state["cumulative"], self.score_v.kernel[:, 0], self.loca(), k,
            self.cfg.location_channels)
        return ctx, align, {"alignment": prev, "cumulative": cum}


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

    def loca(self) -> torch.Tensor:
        k, c, f = self.location_conv.kernel.shape
        return self.location_conv.kernel.reshape(k * c, f) @ self.location_proj.kernel


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
