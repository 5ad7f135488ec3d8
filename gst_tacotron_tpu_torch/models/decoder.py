"""Mel decoder (counterpart of ``gst_tacotron_tpu/models/decoder.py``),
Bahdanau or location-sensitive attention; with ``model.decoder.kind =
"taco2"`` Tacotron 2's LSTM decoder (``Taco2DecoderCell``, no JAX
counterpart), which K4's LSTM branch runs.

``DecoderCell`` holds the step's parameters under the flax names. The step
itself is ``ops.decode.decode_step`` over the packed weights of
``ops.decode.pack_decoder_weights``. ``Decoder.decode`` is the fixed-length
AR decode (``ops.decode.decode_scan``: the decode kernel (K4) on the card,
its plain version on the CPU) with stop masking and zeroing of the frames
past each stop. ``Decoder.teacher_forced`` drives the same step with the
target frames (``ops.decode.teacher_forced_scan``) over a differentiable
pack, on every device: the training forward.

In the compute dtype (``modules.compute_dtype``) the teacher-forced step
runs on the pack cast to it, as the JAX scan cell casts each operand; the
AR decode stays float32 (K4 and its plain version, as the JAX Pallas decode
kernel, whose products are float32 whatever the dtype), with memory and
keys cast at its entry.

Under ``modules.data_parallel`` both decodes draw their prenet dropout as
the shard's rows of the global batch (the Philox streams' ``row0``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import AttentionConfig, DecoderConfig
from ..ops.decode import (decode_scan, decode_scan_plain, pack_decoder_weights,
                          pack_lstm_decoder_weights, teacher_forced_scan)
from .attention import make_attention
from .modules import Dense, Prenet, compute_dtype, length_mask, shard_row0
from .rnn import GRUCell, LSTMCell


class DecoderCell(nn.Module):
    """Parameters of one decoder step: prenet -> attention GRU -> attention
    -> input projection -> residual GRUs -> frame and stop projections."""

    def __init__(self, cfg: DecoderConfig, attn_cfg: AttentionConfig,
                 num_mels: int, memory_dim: int):
        super().__init__()
        self.cfg, self.attn_cfg = cfg, attn_cfg
        self.num_mels, self.memory_dim = num_mels, memory_dim
        self.prenet = Prenet(num_mels, cfg.prenet_dims, cfg.prenet_dropout)
        self.attention_rnn = GRUCell(cfg.prenet_dims[-1] + memory_dim,
                                     cfg.attention_rnn_dim)
        self.attention = make_attention(attn_cfg, cfg.attention_rnn_dim, memory_dim)
        self.decoder_input_proj = Dense(cfg.attention_rnn_dim + memory_dim,
                                        cfg.decoder_rnn_dim)
        for i in range(cfg.num_decoder_rnn_layers):
            setattr(self, f"decoder_rnn_{i}",
                    GRUCell(cfg.decoder_rnn_dim, cfg.decoder_rnn_dim))
        proj_in = cfg.decoder_rnn_dim + memory_dim
        self.frame_proj = Dense(proj_in, cfg.reduction_factor * num_mels)
        self.stop_proj = Dense(proj_in, cfg.reduction_factor)

    def precompute_keys(self, memory: torch.Tensor) -> torch.Tensor:
        return self.attention.precompute(memory)

    def pack(self, differentiable: bool = False):
        return pack_decoder_weights(self, self.num_mels, self.cfg.reduction_factor,
                                    differentiable=differentiable)


class Taco2DecoderCell(nn.Module):
    """Parameters of Tacotron 2's step (NVIDIA's ``Decoder.decode``):
    prenet -> attention LSTM over [prenet ; context] -> attention over its
    state -> decoder LSTM over [attention state ; context] -> frame and stop
    projections of [decoder state ; context]. The LSTMs' dropout (0.1 in
    training) is off at inference."""

    def __init__(self, cfg: DecoderConfig, attn_cfg: AttentionConfig,
                 num_mels: int, memory_dim: int):
        super().__init__()
        self.cfg, self.attn_cfg = cfg, attn_cfg
        self.num_mels, self.memory_dim = num_mels, memory_dim
        self.prenet = Prenet(num_mels, cfg.prenet_dims, cfg.prenet_dropout)
        self.attention_rnn = LSTMCell(cfg.prenet_dims[-1] + memory_dim, cfg.attention_rnn_dim)
        self.attention = make_attention(attn_cfg, cfg.attention_rnn_dim, memory_dim)
        self.decoder_rnn = LSTMCell(cfg.attention_rnn_dim + memory_dim, cfg.decoder_rnn_dim)
        proj_in = cfg.decoder_rnn_dim + memory_dim
        self.frame_proj = Dense(proj_in, cfg.reduction_factor * num_mels)
        self.stop_proj = Dense(proj_in, cfg.reduction_factor)

    def precompute_keys(self, memory: torch.Tensor) -> torch.Tensor:
        return self.attention.precompute(memory)

    def pack(self, differentiable: bool = False):
        return pack_lstm_decoder_weights(self, self.num_mels, self.cfg.reduction_factor,
                                         differentiable=differentiable)


CELLS = {"taco1": DecoderCell, "taco2": Taco2DecoderCell}


def stop_frame_lengths(stop_logits: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """Frames up to and including the first stop (sigmoid > threshold), or
    all frames when no stop fired."""
    b, n = stop_logits.shape
    if not cfg.use_stop_token:
        return torch.full((b,), n, dtype=torch.int64, device=stop_logits.device)
    stopped = torch.sigmoid(stop_logits) > cfg.stop_threshold
    first = torch.argmax(stopped.to(torch.int32), dim=1) + 1
    return torch.where(stopped.any(dim=1), first, torch.full_like(first, n))


def mask_frames(mel: torch.Tensor, frame_lengths: torch.Tensor) -> torch.Tensor:
    """Zero the frames past each utterance's stop."""
    return mel * length_mask(frame_lengths, mel.shape[1])[..., None].to(mel.dtype)


class Decoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, attn_cfg: AttentionConfig,
                 num_mels: int, memory_dim: int):
        super().__init__()
        self.cfg, self.attn_cfg, self.num_mels = cfg, attn_cfg, num_mels
        if cfg.kind not in CELLS:
            raise ValueError(f"unknown decoder kind {cfg.kind!r}")
        self.cell = CELLS[cfg.kind](cfg, attn_cfg, num_mels, memory_dim)

    def decode(self, memory: torch.Tensor, memory_lengths: torch.Tensor, *,
               max_steps: Optional[int] = None, deterministic_prenet: bool = False,
               seed: int = 0, plain: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Fixed-length AR decode -> (mel (B, S*r, M), stop_logits (B, S*r),
        alignments (B, S, T), frame_lengths (B,))."""
        steps = max_steps if max_steps is not None else self.cfg.max_decode_steps
        keys = self.cell.precompute_keys(memory)
        run = decode_scan_plain if plain else decode_scan
        f32 = torch.float32
        mel, stops, aligns = run(
            self.cell.pack(), memory.to(f32), keys.to(f32), memory_lengths, dec_cfg=self.cfg,
            attn_cfg=self.attn_cfg, num_mels=self.num_mels, steps=steps,
            seed=seed, use_dropout=not deterministic_prenet,
            row0=shard_row0(self, memory.shape[0]))
        frame_lengths = stop_frame_lengths(stops, self.cfg)
        return mask_frames(mel, frame_lengths), stops, aligns, frame_lengths

    def teacher_forced(self, memory: torch.Tensor, memory_lengths: Optional[torch.Tensor],
                       mel_targets: torch.Tensor, *, deterministic_prenet: bool = False,
                       seed=0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Teacher-forced decode of ``mel_targets`` (B, T_mel, M), T_mel % r
        == 0 -> (mel (B, T_mel, M), stop_logits (B, T_mel), alignments (B, S,
        T)); prenet dropout from the Philox stream ``seed``."""
        keys = self.cell.precompute_keys(memory)
        if memory_lengths is None:
            memory_lengths = torch.full((memory.shape[0],), memory.shape[1],
                                        device=memory.device)
        dt = compute_dtype(self)
        packed = {k: v.to(dt) for k, v in self.cell.pack(differentiable=True).items()}
        return teacher_forced_scan(
            packed, memory, keys, memory_lengths, mel_targets,
            dec_cfg=self.cfg, attn_cfg=self.attn_cfg, num_mels=self.num_mels, seed=seed,
            use_dropout=not deterministic_prenet, row0=shard_row0(self, memory.shape[0]))
