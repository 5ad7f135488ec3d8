"""K4: the fused fixed-length AR decode, Bahdanau and location-sensitive
branches (counterpart of ``ops/decode_pallas.py``).

``decode_scan`` launches ``csrc/decode_scan.cu`` for CUDA tensors and runs
``decode_scan_plain`` for CPU tensors. Both take the packed weights of
``pack_decoder_weights``, memory (B, T, M), keys (B, T, A) and the memory
lengths (B,), and return (mel (B, S*r, num_mels), stop_logits (B, S*r),
alignments (B, S, T)).

Location-sensitive attention adds ``[prev ; cum] (*) conv -> proj`` to the
score's tanh argument, with the conv and the projection folded into one
(k*c, A) tap matrix ``loca`` (rows shift-major, channel-minor; c = 2 with
``cumulative``, else 1). Bahdanau attention packs one zero tap over [prev]
and runs the same score. Both versions take that direct 31-tap sum; the TPU
kernel's banded-Toeplitz ``wloc`` is an MXU device for the same sum and is
not carried over. The alignment state starts as a delta at position 0
(previous) and zeros (cumulative) and, after each masked softmax, becomes
``prev = align``, ``cum += align``.

Prenet dropout draws from one Philox4x32-10 stream shared by the kernel and
the plain version (``dropout_uniforms``), so both give the same output for
the same seed. It is not jax.random's stream, nor the TPU kernel's.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from ..config import AttentionConfig, DecoderConfig
from .build import F, I, P, U64, CudaKernel, check_cuda, ptr, stream_ptr
from .gru import gru_update
from .philox import stream_uniforms

KERNEL = CudaKernel("decode_scan.cu", "decode_scan_launch",
                    [P, P, P, P, P, P, P, P, I, U64, F, I, P],
                    branches=("location_sensitive",))

LANE = 128
# order of the kernel's DecodeWeights struct
_WEIGHT_ORDER = ("pw1", "pb1", "pw2", "pb2", "awi", "abi", "awh", "abh",
                 "qproj", "vvec", "loca", "dwi", "dbi", "g1wi", "g1bi", "g1wh",
                 "g1bh", "g2wi", "g2bi", "g2wh", "g2bh", "fw", "fb")
_KINDS = ("bahdanau", "location_sensitive")


def location_taps(attn_cfg: AttentionConfig) -> Tuple[int, int]:
    """(taps k, feature channels c) of the folded ``loca``: Bahdanau
    attention has one zero tap over [prev], so it runs the same score."""
    if attn_cfg.kind == "location_sensitive":
        return attn_cfg.location_kernel_size, attn_cfg.location_channels
    return 1, 1


def pack_decoder_weights(cell, num_mels: int, r: int) -> Dict[str, torch.Tensor]:
    """Pad and pack a ``models.decoder.DecoderCell`` into the kernel's operand
    layout (the layout of the JAX ``pack_decoder_weights``): the prenet input
    padded to 128 rows, the frame and stop projections packed side by side
    into 256 output columns, and ``loca``, the location conv (k, c, F) folded
    with the location projection (F, A) into (k*c, A) (zeros (1, A) for
    Bahdanau attention)."""
    if len(cell.cfg.prenet_dims) != 2 or cell.cfg.num_decoder_rnn_layers != 2:
        raise ValueError("the decode kernel covers a 2-layer prenet and 2 decoder GRUs")
    if cell.attn_cfg.kind not in _KINDS:
        raise ValueError(f"unknown attention kind {cell.attn_cfg.kind!r}")
    out_dim = 2 * LANE
    if r * num_mels + r > out_dim:
        raise ValueError("packed frame+stop output exceeds 256 columns")
    with torch.no_grad():
        d1 = cell.prenet.dense_0
        pw1 = torch.zeros(LANE, d1.kernel.shape[1], device=d1.kernel.device)
        pw1[:num_mels] = d1.kernel
        fk, fb_ = cell.frame_proj.kernel, cell.frame_proj.bias
        sk, sb = cell.stop_proj.kernel, cell.stop_proj.bias
        fw = torch.zeros(fk.shape[0], out_dim, device=fk.device)
        fb = torch.zeros(out_dim, device=fk.device)
        fw[:, : r * num_mels] = fk
        fb[: r * num_mels] = fb_
        fw[:, r * num_mels: r * num_mels + r] = sk
        fb[r * num_mels: r * num_mels + r] = sb
        att = cell.attention
        if cell.attn_cfg.kind == "location_sensitive":
            conv_k = att.location_conv.kernel
            k, c, f = conv_k.shape
            loca = conv_k.reshape(k * c, f) @ att.location_proj.kernel
        else:
            loca = torch.zeros(1, att.query_proj.kernel.shape[1], device=fk.device)
        packed = dict(
            pw1=pw1, pb1=d1.bias, pw2=cell.prenet.dense_1.kernel,
            pb2=cell.prenet.dense_1.bias,
            awi=cell.attention_rnn.kernel, abi=cell.attention_rnn.bias,
            awh=cell.attention_rnn.recurrent_kernel,
            abh=cell.attention_rnn.recurrent_bias,
            qproj=att.query_proj.kernel, vvec=att.score_v.kernel[:, 0], loca=loca,
            dwi=cell.decoder_input_proj.kernel, dbi=cell.decoder_input_proj.bias,
            fw=fw, fb=fb)
        for i, g in enumerate((cell.decoder_rnn_0, cell.decoder_rnn_1), start=1):
            packed.update({f"g{i}wi": g.kernel, f"g{i}bi": g.bias,
                           f"g{i}wh": g.recurrent_kernel,
                           f"g{i}bh": g.recurrent_bias})
        return {k: v.detach().to(torch.float32).contiguous() for k, v in packed.items()}


def dropout_uniforms(seed: int, steps: int, layer: int, batch: int,
                     units: int) -> np.ndarray:
    """(steps, batch, units) float32 uniforms strictly inside (0, 1): the draw
    the decode kernel makes for prenet ``layer`` at each (step, row, unit)."""
    return stream_uniforms(seed, np.arange(steps), layer, batch, units)


def _gru(x, h, wi, bi, wh, bh):
    return gru_update(x @ wi + bi, h @ wh + bh, h)


def decode_scan_plain(packed: Dict[str, torch.Tensor], memory: torch.Tensor,
                      keys: torch.Tensor, lengths: torch.Tensor, *,
                      dec_cfg: DecoderConfig, attn_cfg: AttentionConfig,
                      num_mels: int, steps: int, seed: int = 0,
                      use_dropout: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same decode in plain PyTorch, one step per loop iteration."""
    if attn_cfg.kind not in _KINDS:
        raise ValueError(f"unknown attention kind {attn_cfg.kind!r}")
    w = packed
    r = dec_cfg.reduction_factor
    rate = float(dec_cfg.prenet_dropout)
    b, t, _ = memory.shape
    dev = memory.device
    valid = torch.arange(t, device=dev)[None, :] < lengths.to(dev)[:, None]
    valid[:, 0] = True
    p1, p2 = w["pw1"].shape[1], w["pw2"].shape[1]
    if use_dropout:
        keep1 = torch.from_numpy(
            dropout_uniforms(seed, steps, 0, b, p1) >= np.float32(rate)).to(dev)
        keep2 = torch.from_numpy(
            dropout_uniforms(seed, steps, 1, b, p2) >= np.float32(rate)).to(dev)
    h_attn = memory.new_zeros(b, w["awh"].shape[0])
    h_d1 = memory.new_zeros(b, w["g1wh"].shape[0])
    h_d2 = memory.new_zeros(b, w["g2wh"].shape[0])
    ctx = memory.new_zeros(b, memory.shape[2])
    last = memory.new_zeros(b, num_mels)
    pw1 = w["pw1"][:num_mels]
    loc_k, loc_c = location_taps(attn_cfg)
    prev = memory.new_zeros(b, t)
    prev[:, 0] = 1.0
    cum = memory.new_zeros(b, t)
    frames, stops, aligns = [], [], []
    for s in range(steps):
        h1 = torch.relu(last @ pw1 + w["pb1"])
        if use_dropout:
            h1 = torch.where(keep1[s], h1 / (1.0 - rate), torch.zeros_like(h1))
        h2 = torch.relu(h1 @ w["pw2"] + w["pb2"])
        if use_dropout:
            h2 = torch.where(keep2[s], h2 / (1.0 - rate), torch.zeros_like(h2))
        h_attn = _gru(torch.cat([h2, ctx], -1), h_attn, w["awi"], w["abi"],
                      w["awh"], w["abh"])
        q = h_attn @ w["qproj"]
        feats = torch.stack([prev, cum][:loc_c], -1)                # (B, T, c)
        fp = Fn.pad(feats, (0, 0, (loc_k - 1) // 2, loc_k // 2))
        taps = torch.cat([fp[:, j: j + t] for j in range(loc_k)], -1)
        arg = keys + q[:, None, :] + taps @ w["loca"]
        scores = (torch.tanh(arg) * w["vvec"]).sum(-1)
        scores = torch.where(valid, scores, torch.full_like(scores, -1e9))
        m = scores.max(-1, keepdim=True).values
        e = torch.exp(scores - m) * valid
        align = e / torch.clamp(e.sum(-1, keepdim=True), min=1e-9)
        prev, cum = align, cum + align
        ctx = torch.einsum("bt,btm->bm", align, memory)
        h = torch.cat([h_attn, ctx], -1) @ w["dwi"] + w["dbi"]
        h_d1 = _gru(h, h_d1, w["g1wi"], w["g1bi"], w["g1wh"], w["g1bh"])
        h = h + h_d1
        h_d2 = _gru(h, h_d2, w["g2wi"], w["g2bi"], w["g2wh"], w["g2bh"])
        h = h + h_d2
        out = torch.cat([h, ctx], -1) @ w["fw"] + w["fb"]
        frames.append(out[:, : r * num_mels])
        stops.append(out[:, r * num_mels: r * num_mels + r])
        aligns.append(align)
        last = out[:, (r - 1) * num_mels: r * num_mels]
    mel = torch.stack(frames, 1).reshape(b, steps * r, num_mels)
    stop_logits = torch.stack(stops, 1).reshape(b, steps * r)
    return mel, stop_logits, torch.stack(aligns, 1)


def decode_scan(packed: Dict[str, torch.Tensor], memory: torch.Tensor,
                keys: torch.Tensor, lengths: torch.Tensor, *,
                dec_cfg: DecoderConfig, attn_cfg: AttentionConfig,
                num_mels: int, steps: int, seed: int = 0,
                use_dropout: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-length decode: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if memory.device.type == "cpu":
        return decode_scan_plain(packed, memory, keys, lengths, dec_cfg=dec_cfg,
                                 attn_cfg=attn_cfg, num_mels=num_mels,
                                 steps=steps, seed=seed, use_dropout=use_dropout)
    if attn_cfg.kind not in _KINDS:
        raise ValueError(f"unknown attention kind {attn_cfg.kind!r}")
    loc_k, loc_c = location_taps(attn_cfg)
    r = dec_cfg.reduction_factor
    b, t, m_dim = memory.shape
    if packed["loca"].shape != (loc_k * loc_c, keys.shape[-1]):
        raise ValueError(f"decode_scan: loca {tuple(packed['loca'].shape)} does not "
                         f"fit k={loc_k}, c={loc_c}, A={keys.shape[-1]}")
    memory, keys = memory.contiguous(), keys.contiguous()
    lens = lengths.to(memory.device, torch.int32).contiguous()
    ws = [packed[k] for k in _WEIGHT_ORDER]
    check_cuda("decode_scan", memory, keys, lens, *ws)
    w = packed
    dims = [t, steps, r, num_mels, w["pw1"].shape[1], w["pw2"].shape[1],
            w["awh"].shape[0], w["qproj"].shape[1], w["g1wh"].shape[0], m_dim,
            w["pw1"].shape[1], w["fw"].shape[1], loc_k, loc_c]
    mel = torch.empty(b, steps * r, num_mels, device=memory.device)
    stop_logits = torch.empty(b, steps * r, device=memory.device)
    aligns = torch.empty(b, steps, t, device=memory.device)
    if b == 0 or steps == 0:
        return mel, stop_logits, aligns
    wptrs = (ctypes.c_void_p * len(ws))(*[x.data_ptr() for x in ws])
    dptrs = (ctypes.c_int * len(dims))(*dims)
    KERNEL(ptr(memory), ptr(keys), ptr(lens), wptrs, dptrs, ptr(mel),
           ptr(stop_logits), ptr(aligns), b, seed & 0xFFFFFFFFFFFFFFFF,
           float(dec_cfg.prenet_dropout), int(use_dropout),
           stream_ptr(memory.device),
           branch="location_sensitive" if attn_cfg.kind == "location_sensitive" else None)
    return mel, stop_logits, aligns
