"""Plain Tacotron 2 with GST synthesis from a configuration dict and a weights
dict: the equations of NVIDIA's public Tacotron 2 (github.com/NVIDIA/tacotron2,
``model.py``) with Mellotron's GST (the style concatenated to every encoder
state), in plain float32 torch, one operation at a time, no kernel.

- encoder: embedding -> 3 x (conv1d of 5 taps, BatchNorm, ReLU) -> BiLSTM
  over each row's valid steps;
- the GST style: ``tacotron.gst_style`` (the repo's reference encoder and
  style-token attention, 4 heads, 10 tokens);
- decoder step: prenet (2 x dense + ReLU, dropout 0.5 kept at inference,
  drawn from the Philox streams 0 and 1 under the call's seed plus one) ->
  attention LSTMCell over [prenet ; context] -> location-sensitive attention
  (query and memory projections, the location conv over [previous ;
  cumulative] alignment then its dense layer, v . tanh(...), masked
  softmax) -> decoder LSTMCell over [attention state ; context] -> frame and
  stop projections of [decoder state ; context];
- post-net: 5 x (conv1d of 5 taps, BatchNorm, tanh but the last), its
  output added to the mel;
- ``MelGriffinLim``: the mel basis's pseudo-inverse over the amplitudes of
  the denormalized dB, floored at 1e-10 (Rayhane-mamah's Tacotron-2
  ``inv_mel_spectrogram``), then ``dsp.GriffinLim``'s iterations.

Each LSTMCell is ``torch.nn.LSTMCell``'s function (gate order i, f, g, o):
x @ kernel + bias + h @ recurrent_kernel + recurrent_bias, with ``kernel`` its
``weight_ih`` transposed. Weights are keyed by the model's state-dict names.

Departures from NVIDIA's code, each the repo's convention: the convs carry no
bias (before an inference BatchNorm one folds into its shift); the padded
positions are zeroed before each conv; the alignment state starts as a delta
at position 0, not zeros; masked scores are -1e9, with position 0 always
valid; the stop threshold and the step budget are the configuration's. The
dropout of the LSTMs and of the post-net is training's, and off here.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import dsp, philox
from .tacotron import batchnorm, dense, frame_lengths, gst_style, mask, text_ids

W = Dict[str, torch.Tensor]


def conv1d_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME 1-D conv of (B, T, C) with a (k, C, out) kernel: F.conv1d, padded
    (k-1)//2 left and k//2 right."""
    k = kernel.shape[0]
    xp = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
    return F.conv1d(xp, kernel.permute(2, 1, 0)).transpose(1, 2)


def lstm_cell(w: W, name: str, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    gates = (x @ w[f"{name}.kernel"] + w[f"{name}.bias"]
             + h @ w[f"{name}.recurrent_kernel"] + w[f"{name}.recurrent_bias"])
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm(w: W, name: str, xs: torch.Tensor, lengths: torch.Tensor, reverse: bool = False
         ) -> torch.Tensor:
    """A direction of the BiLSTM over each row's valid steps (a packed
    sequence): a step at or past a row's length holds the state."""
    b, t, _ = xs.shape
    hd = w[f"{name}.recurrent_kernel"].shape[0]
    h, c = xs.new_zeros(b, hd), xs.new_zeros(b, hd)
    valid = torch.arange(t, device=xs.device)[None, :] < lengths[:, None]
    ys = [None] * t
    for i in (range(t - 1, -1, -1) if reverse else range(t)):
        hn, cn = lstm_cell(w, name, xs[:, i], h, c)
        keep = valid[:, i, None]
        h, c = torch.where(keep, hn, h), torch.where(keep, cn, c)
        ys[i] = h
    return torch.stack(ys, 1)


def encoder(w: W, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    x = w["encoder.embedding.embedding"][tokens]
    for i in range(3):
        y = conv1d_same(mask(x, lengths), w[f"encoder.convs.conv_{i}.kernel"])
        x = torch.relu(batchnorm(w, f"encoder.convs.bn_{i}", y))
    out = torch.cat([lstm(w, "encoder.bilstm.fwd", x, lengths),
                     lstm(w, "encoder.bilstm.bwd", x, lengths, reverse=True)], -1)
    return mask(out, lengths)


def decode(w: W, memory: torch.Tensor, lengths: torch.Tensor, m: dict, steps: int,
           seed: Optional[int], fed: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tacotron 2's decoder over ``memory`` (B, T, M) -> (mel (B, steps * r,
    M), stop logits (B, steps * r), alignments (B, steps, T)); step s fed
    the last frame of step s - 1 of ``fed`` where given, else its own; the
    go frame zeros; ``seed`` None: no prenet dropout."""
    d, a = m["decoder"], m["attention"]
    r, nm = d["reduction_factor"], m["num_mels"]
    rate = d["prenet_dropout"]
    p = "decoder.cell"
    b, t, _ = memory.shape
    dev = memory.device
    keys = memory @ w[f"{p}.attention.memory_proj.kernel"]
    vvec = w[f"{p}.attention.score_v.kernel"][:, 0]
    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    valid[:, 0] = True
    chans = 2 if a["cumulative"] else 1
    keep = None
    if seed is not None:
        idx = torch.arange(steps, device=dev)
        keep = [philox.uniforms(seed, idx, layer, b, w[f"{p}.prenet.dense_{layer}.kernel"]
                                .shape[1]) >= rate for layer in (0, 1)]
    zeros = lambda n: memory.new_zeros(b, n)
    ha, hd = d["attention_rnn_dim"], d["decoder_rnn_dim"]
    h_a, c_a, h_d, c_d = zeros(ha), zeros(ha), zeros(hd), zeros(hd)
    ctx, prev, cum = zeros(memory.shape[2]), zeros(t), zeros(t)
    prev[:, 0] = 1.0
    frame = zeros(nm)
    mels, stops, aligns = [], [], []
    for s in range(steps):
        x = frame
        for layer in (0, 1):
            x = torch.relu(dense(w, f"{p}.prenet.dense_{layer}", x))
            if keep is not None:
                x = torch.where(keep[layer][s], x / (1.0 - rate), torch.zeros_like(x))
        h_a, c_a = lstm_cell(w, f"{p}.attention_rnn", torch.cat([x, ctx], -1), h_a, c_a)
        feats = torch.stack([prev, cum][:chans], -1)
        loc = conv1d_same(feats, w[f"{p}.attention.location_conv.kernel"]) \
            @ w[f"{p}.attention.location_proj.kernel"]
        arg = keys + (h_a @ w[f"{p}.attention.query_proj.kernel"])[:, None, :] + loc
        scores = torch.where(valid, torch.tanh(arg) @ vvec, torch.full((b, t), -1e9, device=dev))
        e = torch.exp(scores - scores.max(-1, keepdim=True).values) * valid
        align = e / torch.clamp(e.sum(-1, keepdim=True), min=1e-9)
        ctx = torch.einsum("bt,btm->bm", align, memory)
        prev, cum = align, cum + align
        h_d, c_d = lstm_cell(w, f"{p}.decoder_rnn", torch.cat([h_a, ctx], -1), h_d, c_d)
        out = torch.cat([h_d, ctx], -1)
        frames = dense(w, f"{p}.frame_proj", out)
        mels.append(frames.reshape(b, r, nm))
        stops.append(dense(w, f"{p}.stop_proj", out))
        aligns.append(align)
        frame = frames[:, (r - 1) * nm:] if fed is None else fed[:, (s + 1) * r - 1]
    return torch.cat(mels, 1), torch.cat(stops, 1), torch.stack(aligns, 1)


def postnet(w: W, mel: torch.Tensor, lengths: torch.Tensor, layers: int) -> torch.Tensor:
    """mel + the conv post-net's residual, zero past each length."""
    x = mel
    for i in range(layers):
        x = batchnorm(w, f"postnet.bn_{i}", conv1d_same(mask(x, lengths),
                                                         w[f"postnet.conv_{i}.kernel"]))
        if i + 1 < layers:
            x = torch.tanh(x)
    return mask(mel + mask(x, lengths), lengths)


def mel_pinv(a: dict, device) -> torch.Tensor:
    """The (num_mels, num_freq) transpose of the mel basis's pseudo-inverse
    (float64, kept in float32)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.linalg.pinv(dsp.mel_filterbank(a).astype(np.float64)).T).astype(np.float32)).to(device)


def mel_to_linear(mel: torch.Tensor, a: dict) -> torch.Tensor:
    """Normalized mel -> linear amplitudes: pinv(mel basis) over the
    amplitudes of the denormalized dB, floored at 1e-10."""
    amp = torch.pow(10.0, (dsp.denormalize_db(mel.float(), a) + a["ref_level_db"]) * 0.05)
    return torch.clamp(amp @ mel_pinv(a, mel.device), min=1e-10)


class MelGriffinLim(dsp.GriffinLim):
    """``dsp.GriffinLim`` from a normalized mel: its target is the
    pseudo-inverse linear amplitudes to the power ``griffin_lim_power``."""

    def target(self, mel: torch.Tensor) -> torch.Tensor:
        return mel_to_linear(mel, self.a) ** self.a["griffin_lim_power"]


def synthesize(w: W, cfg: dict, texts: Sequence[str], ref_mel: torch.Tensor,
               ref_lengths: torch.Tensor, seed: int, *, fed: Optional[torch.Tensor] = None,
               ref_stack_bf16: bool = False, text_pad: int = 32) -> Dict[str, torch.Tensor]:
    """One call up to the post-net mel: style, memory, decode (fed ``fed``
    where given), stop lengths, masked frames, post-net. Device tensors."""
    m = cfg["model"]
    dev = ref_mel.device
    ids, lens = text_ids(texts, text_pad)
    tokens = torch.from_numpy(ids).to(dev)
    tok_len = torch.from_numpy(lens).to(dev)
    style = gst_style(w, ref_mel, ref_lengths, m["gst"], ref_stack_bf16)
    enc = encoder(w, tokens, tok_len)
    t = enc.shape[1]
    memory = torch.cat([enc, style[:, None, :].expand(-1, t, -1)], -1)
    steps = m["decoder"]["max_decode_steps"]
    mel, stops, aligns = decode(w, memory, tok_len, m, steps, seed + 1, fed)
    lengths = frame_lengths(stops, m["decoder"])
    mel = mask(mel, lengths)
    post = postnet(w, mel, lengths, m["postnet"]["conv_layers"])
    return {"style_embedding": style, "mel": mel, "stop_logits": stops, "alignments": aligns,
            "frame_lengths": lengths, "mel_postnet": post}
