"""Global Style Tokens: reference encoder + style-token layer (counterparts of
``gst_tacotron_tpu/models/gst.py``).

At inference in float32 the forward passes are the composition of
``gst_tacotron_tpu/ops/refenc_pallas.py``, ported in ``ops/refenc.py``:
masked, folded-BN conv stack (K2), then the reference GRU (K1), then the
multi-head attention over the tanh tokens, with K2 in float32 as the flax
module computes it. In training (``train=True``),
and at inference in another compute dtype, the reference encoder is the
flax module's own composition in the compute dtype: plain stride-2 convs,
BatchNorm (the batch's statistics in training, the running ones at
inference), ReLU, then the masked GRU (its kernel route on the card at
inference, in float32 with casts). K2 is a float32 kernel, and the JAX
package runs its Pallas stack only where synthesis computes the style
(``GSTTacotron.infer`` here), never inside the bf16 module.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import GSTConfig
from ..ops import refenc
from .modules import BatchNorm, Dense, MatmulConv2DStride2, compute_dtype, mask_sequence
from .rnn import GRU


class ReferenceEncoder(nn.Module):
    """ref mel (B, T, n_mels) -> 6 x [conv 3x3/2, BN, ReLU] -> GRU final
    state (B, ref_gru_dim)."""

    def __init__(self, cfg: GSTConfig, num_mels: int):
        super().__init__()
        self.cfg = cfg
        c_in, f = 1, num_mels
        for i, ch in enumerate(cfg.ref_conv_channels):
            setattr(self, f"conv_{i}", MatmulConv2DStride2(c_in, ch))
            setattr(self, f"bn_{i}", BatchNorm(ch))
            c_in, f = ch, (f + 1) // 2
        self.gru = GRU(f * c_in, cfg.ref_gru_dim)

    def forward(self, ref_mel: torch.Tensor, mel_lengths: Optional[torch.Tensor] = None,
                *, plain: bool = False, train: bool = False) -> torch.Tensor:
        if not train and compute_dtype(self) == torch.float32:
            # float32, as the flax module computes it (the bf16 operand
            # mode is the JAX synthesis fast path's, GSTTacotron.infer)
            return refenc.ref_encoder(self, ref_mel, mel_lengths, plain=plain, bf16=False)
        x = mask_sequence(ref_mel, mel_lengths)[..., None]        # (B, T, F, 1)
        n = len(self.cfg.ref_conv_channels)
        for i in range(n):
            conv, bn = getattr(self, f"conv_{i}"), getattr(self, f"bn_{i}")
            x = torch.relu(bn(conv(x), train=train))
        b, t, f, c = x.shape
        gru_lengths = None
        if mel_lengths is not None:
            gru_lengths = torch.clamp((mel_lengths + 2 ** n - 1) // 2 ** n, min=1)
        _, final = self.gru(x.reshape(b, t, f * c), gru_lengths, plain=plain, train=train)
        return final


class StyleTokenLayer(nn.Module):
    """Multi-head attention of the reference embedding over learned tokens."""

    def __init__(self, cfg: GSTConfig, ref_dim: int):
        super().__init__()
        if cfg.style_dim % cfg.num_heads:
            raise ValueError("style_dim must be a multiple of num_heads")
        self.cfg = cfg
        head_dim = cfg.style_dim // cfg.num_heads
        self.tokens = nn.Parameter(torch.empty(cfg.num_tokens, head_dim))
        self.query_proj = Dense(ref_dim, cfg.style_dim, use_bias=False)
        self.key_proj = Dense(head_dim, cfg.style_dim, use_bias=False)
        self.value_proj = Dense(head_dim, cfg.style_dim, use_bias=False)

    def forward(self, ref_embedding: torch.Tensor,
                token_weights: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (style (B, style_dim), attention (B, heads, tokens)); explicit
        ``token_weights`` (B, tokens) replace the attention distribution."""
        return refenc.style_attention(self, ref_embedding, token_weights,
                                      compute_dtype(self))


class GST(nn.Module):
    """ReferenceEncoder + StyleTokenLayer."""

    def __init__(self, cfg: GSTConfig, num_mels: int):
        super().__init__()
        self.cfg = cfg
        self.reference_encoder = ReferenceEncoder(cfg, num_mels)
        self.stl = StyleTokenLayer(cfg, cfg.ref_gru_dim)

    def forward(self, ref_mel: Optional[torch.Tensor],
                mel_lengths: Optional[torch.Tensor] = None,
                token_weights: Optional[torch.Tensor] = None, *,
                plain: bool = False, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = compute_dtype(self)
        if not train and dt == torch.float32:
            return refenc.gst_style_from_params(self, ref_mel, mel_lengths,
                                                token_weights, plain=plain, bf16=False)
        if ref_mel is None:
            if token_weights is None:
                raise ValueError("GST needs ref_mel or token_weights")
            ref = token_weights.new_zeros(token_weights.shape[0], self.cfg.ref_gru_dim,
                                          dtype=dt)
        else:
            ref = self.reference_encoder(ref_mel, mel_lengths, plain=plain, train=train)
        return self.stl(ref, token_weights)
