"""GSTTacotron (counterpart of ``gst_tacotron_tpu/models/tacotron.py``).

tokens -> Taco1Encoder | Taco2Encoder (model.encoder.kind) -> encoder states (B, T, E)
[GST: ref mel -> ReferenceEncoder -> StyleTokenLayer -> style (B, S)]
[multi-speaker: speaker id -> embedding (B, P)]
memory = concat([encoder states, style and speaker broadcast over T])
memory -> Decoder (teacher-forced | AR decode, K4) -> mel, stops, alignments
mel -> PostCBHG -> linear

``forward`` is the teacher-forced pass of training and eval (the JAX
``__call__``); ``infer`` is synthesis, the composition of the JAX
``Synthesizer``'s kernel stages (``use_pallas_decoder``, with its fused
style path): the style from ``ops/refenc.py::gst_style_from_params`` (K2 and
K1, float32), the decode through K4 (float32), the rest of the model in the
compute dtype (the Taco2 encoder's BiGRU, like every GRU at inference, on
K1).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..decode import chunked_decode
from ..ops.philox import DeviceSeed
from ..ops.refenc import gst_style_from_params
from ..utils.profiling import span
from .decoder import Decoder
from .encoder import ENCODERS
from .gst import GST
from .modules import Embed, set_compute_dtype
from .postnet import PostCBHG


def _generator(seed, device, deterministic: bool) -> Optional[torch.Generator]:
    """A generator seeded ``seed``; a ``DeviceSeed``'s own, which its caller
    seeds before each replay."""
    if deterministic:
        return None
    if isinstance(seed, DeviceSeed):
        return seed.generator
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


class GSTTacotron(nn.Module):
    """``dtype`` is the compute dtype of every module (the JAX model's
    ``dtype``); the parameters stay float32."""

    def __init__(self, cfg: ModelConfig, num_symbols: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.encoder = ENCODERS[cfg.encoder.kind](cfg.encoder, num_symbols)
        self.gst = GST(cfg.gst, cfg.num_mels) if cfg.gst.enabled else None
        self.speaker_embedding = (Embed(cfg.num_speakers, cfg.speaker_dim)
                                  if cfg.num_speakers > 1 else None)
        self.decoder = Decoder(cfg.decoder, cfg.attention, cfg.num_mels, self.memory_dim)
        self.postnet = PostCBHG(cfg.postnet, cfg.num_mels, cfg.num_freq)
        set_compute_dtype(self, dtype)

    @property
    def memory_dim(self) -> int:
        dim = self.cfg.encoder.output_dim
        if self.cfg.gst.enabled:
            dim += self.cfg.gst.style_dim
        if self.cfg.num_speakers > 1:
            dim += self.cfg.speaker_dim
        return dim

    def build_memory(self, tokens: torch.Tensor, token_lengths: Optional[torch.Tensor],
                     ref_mel: Optional[torch.Tensor] = None,
                     ref_mel_lengths: Optional[torch.Tensor] = None,
                     token_weights: Optional[torch.Tensor] = None, *,
                     speaker_ids: Optional[torch.Tensor] = None,
                     deterministic_prenet: bool = False,
                     generator: Optional[torch.Generator] = None,
                     precomputed_style: Optional[torch.Tensor] = None,
                     plain: bool = False, train: bool = False
                     ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Encoder states with the style and the speaker embedding (ids
        default to 0) broadcast-concatenated to every frame.
        ``precomputed_style`` (B, style_dim) skips the GST block; ``train``
        takes the BatchNorms' batch statistics and the plain scans."""
        with span("gst.model.encoder"):
            enc = self.encoder(tokens, token_lengths, deterministic_prenet=deterministic_prenet,
                               generator=generator, plain=plain, train=train)
        b, t = enc.shape[:2]
        parts, aux = [enc], {}
        if self.gst is not None:
            if precomputed_style is not None:
                style = precomputed_style
            else:
                with span("gst.model.gst"):
                    style, aux["style_attention"] = self.gst(
                        ref_mel, ref_mel_lengths, token_weights, plain=plain, train=train)
            aux["style_embedding"] = style
            parts.append(style[:, None, :].expand(b, t, style.shape[-1]))
        if self.speaker_embedding is not None:
            if speaker_ids is None:
                speaker_ids = torch.zeros(b, dtype=torch.int64, device=enc.device)
            spk = self.speaker_embedding(speaker_ids.to(enc.device).long())
            parts.append(spk[:, None, :].expand(b, t, spk.shape[-1]))
        return (torch.cat(parts, dim=-1) if len(parts) > 1 else enc), aux

    def forward(self, tokens: torch.Tensor, token_lengths: Optional[torch.Tensor],
                mel_targets: torch.Tensor, ref_mel: Optional[torch.Tensor] = None,
                ref_mel_lengths: Optional[torch.Tensor] = None,
                speaker_ids: Optional[torch.Tensor] = None,
                token_weights: Optional[torch.Tensor] = None, *,
                train: bool = False, deterministic_prenet: bool = False,
                seed=0) -> Dict[str, torch.Tensor]:
        """Teacher-forced pass (training and eval losses): encode (prenet
        and, in training, Taco2 conv-stack dropout from a generator seeded
        ``seed``), decode the targets
        (dropout stream ``seed + 1``), post-net over the whole decoded mel.
        In training the GST reference is the target mel itself; pass
        ``ref_mel=mel_targets``. ``seed`` is an int, or the
        ``ops.philox.DeviceSeed`` of a train step captured in a CUDA
        graph."""
        # training draws the Taco2 conv stack's dropout from it even with the
        # prenets deterministic
        gen = _generator(seed, tokens.device, deterministic_prenet and not train)
        memory, aux = self.build_memory(
            tokens, token_lengths, ref_mel, ref_mel_lengths, token_weights,
            speaker_ids=speaker_ids, deterministic_prenet=deterministic_prenet,
            generator=gen, train=train)
        with span("gst.model.decoder_teacher_forced"):
            mel, stops, aligns = self.decoder.teacher_forced(
                memory, token_lengths, mel_targets, deterministic_prenet=deterministic_prenet,
                seed=seed + 1)
        with span("gst.model.postnet"):
            linear = self.postnet(mel, None, train=train)
        return {"mel": mel, "linear": linear, "stop_logits": stops, "alignments": aligns,
                **aux}

    def infer(self, tokens: torch.Tensor, token_lengths: torch.Tensor,
              ref_mel: Optional[torch.Tensor] = None,
              ref_mel_lengths: Optional[torch.Tensor] = None,
              token_weights: Optional[torch.Tensor] = None, *,
              speaker_ids: Optional[torch.Tensor] = None,
              max_steps: Optional[int] = None, deterministic_prenet: bool = False,
              seed: int = 0, precomputed_style: Optional[torch.Tensor] = None,
              plain: bool = False, chunk_steps: Optional[int] = None,
              stop_all_reduce=None, bf16: Optional[bool] = None
              ) -> Dict[str, torch.Tensor]:
        """Autoregressive synthesis: encode (prenet dropout from ``seed``),
        decode (dropout stream ``seed + 1``), post-net. ``chunk_steps``
        decodes in chunks with early exit (``decode.chunked_decode``, whose
        ``all_reduce`` is ``stop_all_reduce``; the result then has
        ``chunks_run``). The style is the JAX synthesis fast path's: K2 in
        its bf16 operand mode where ``bf16`` resolves true
        (``refenc.resolve_bf16``: None is on for the card)."""
        gen = _generator(seed, tokens.device, deterministic_prenet)
        style_attn = None
        if self.gst is not None and precomputed_style is None:
            with span("gst.model.gst"):
                precomputed_style, style_attn = gst_style_from_params(
                    self.gst, ref_mel, ref_mel_lengths, token_weights, plain=plain,
                    bf16=bf16)
        memory, aux = self.build_memory(
            tokens, token_lengths, ref_mel, ref_mel_lengths, token_weights,
            speaker_ids=speaker_ids, deterministic_prenet=deterministic_prenet,
            generator=gen, precomputed_style=precomputed_style, plain=plain)
        with span("gst.model.decoder_ar_scan"):
            if chunk_steps is None:
                mel, stops, aligns, frame_lengths = self.decoder.decode(
                    memory, token_lengths, max_steps=max_steps,
                    deterministic_prenet=deterministic_prenet, seed=seed + 1, plain=plain)
            else:
                dec = chunked_decode(self, memory, token_lengths, chunk_steps=chunk_steps,
                                     max_steps=max_steps, all_reduce=stop_all_reduce,
                                     deterministic_prenet=deterministic_prenet,
                                     seed=seed + 1, plain=plain)
                mel, stops, aligns, frame_lengths = (
                    dec["mel"], dec["stop_logits"], dec["alignments"], dec["frame_lengths"])
                aux["chunks_run"] = dec["chunks_run"]
        with span("gst.model.postnet"):
            linear = self.postnet(mel, frame_lengths, plain=plain)
        if style_attn is not None:
            aux["style_attention"] = style_attn
        return {"mel": mel, "linear": linear, "stop_logits": stops,
                "alignments": aligns, "frame_lengths": frame_lengths, **aux}
