"""K4: the fused fixed-length AR decode, Bahdanau and location-sensitive
branches (counterpart of ``ops/decode_pallas.py``), and Tacotron 2's LSTM
decoder (no JAX counterpart).

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

The kernel runs each step as nine phase launches over the whole card (see
``csrc/decode_scan.cu``). Everything it needs besides the inputs and
outputs lives in one device workspace: the recurrent state, the step's
vectors, the partial scores, the keys transposed to (B, A, T) and each
product's weights transposed to (columns, k). ``decode_products`` lists the
products, ``decode_phase_plan`` gives each phase's CTAs their slices of
columns, and ``decode_workspace_layout`` places every buffer; the launcher
takes all three as integers (``decode_launch_ints``) and derives none of
them itself.

A decode resumes through a ``DecodeCarry``: the output buffers of all its
steps, the steps done, and the state (the kernel's workspace, or the plain
version's ``DecodeState`` and last frame). ``decode_scan(..., carry=c)``
runs the next ``steps`` steps into ``c``'s buffers at its step offset and
advances it; on a continuation the kernel skips its prologue (the state's
zeroing, the keys' and weights' transposes), and the Philox draw takes the
global step, so any split into calls gives the bits of one call. Every call
of one carry takes the same weights, memory, keys, lengths and seed.
Each call that decodes adds its ``steps`` to the program's counter
``decode_steps`` (``utils/profiling.py``), on either route.

The LSTM branch (``model.decoder.kind = "taco2"``, ``pack_lstm_decoder_weights``)
runs Tacotron 2's step under the same attention: prenet -> attention LSTM
over [prenet ; context] -> attention -> decoder LSTM over [attention
state ; context] -> frame and stop projection of [decoder state ; context].
Each LSTM's two products are one packed matrix, its input rows over its
recurrent rows (``awi``, ``dwi``), and one bias, the two summed (``abi``,
``dbi``); its cell state is one more state buffer. The kernel keeps the
phase design: P3 is the attention LSTM, P7 the decoder LSTM, P9 the
projection; the products of the state alone ([context ; h_attn] and h_dec
over their rows, plus the bias) run beside P7 and P9; P6 and P8 do not
launch.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from ..config import AttentionConfig, DecoderConfig
from ..models.attention import attention_step
from ..utils import profiling
from .build import (F, I, P, U64, CudaKernel, check_cuda, ptr, refuse_grad, sm_count,
                    stream_ptr)
from .gru import gru_update
from .lstm import lstm_update
from .philox import stream_uniforms

KERNEL = CudaKernel("decode_scan.cu", "decode_scan_launch",
                    [P, P, P, P, P, P, P, P, P, U64, F, I, I, I, I, I, P],
                    branches=("location_sensitive", "lstm"))

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


def _pack_shared(cell, num_mels: int, r: int) -> Dict[str, torch.Tensor]:
    """The operands every branch packs alike: the prenet (its input padded
    to 128 rows), the query, v and ``loca`` (the location conv (k, c, F)
    folded with the location projection (F, A) into (k*c, A); zeros (1, A)
    for Bahdanau attention), and the frame and stop projections side by
    side in 256 output columns."""
    if len(cell.cfg.prenet_dims) != 2:
        raise ValueError("the decode kernel covers a 2-layer prenet")
    if cell.attn_cfg.kind not in _KINDS:
        raise ValueError(f"unknown attention kind {cell.attn_cfg.kind!r}")
    out_dim = 2 * LANE
    if r * num_mels + r > out_dim:
        raise ValueError("packed frame+stop output exceeds 256 columns")
    d1 = cell.prenet.dense_0
    fp, sp = cell.frame_proj, cell.stop_proj
    pad = out_dim - r * num_mels - r
    att = cell.attention
    loca = att.loca()
    if loca is None:
        loca = att.query_proj.kernel.new_zeros(1, att.query_proj.kernel.shape[1])
    return dict(
        pw1=Fn.pad(d1.kernel, (0, 0, 0, LANE - num_mels)), pb1=d1.bias,
        pw2=cell.prenet.dense_1.kernel, pb2=cell.prenet.dense_1.bias,
        qproj=att.query_proj.kernel, vvec=att.score_v.kernel[:, 0], loca=loca,
        fw=Fn.pad(torch.cat([fp.kernel, sp.kernel], 1), (0, pad)),
        fb=Fn.pad(torch.cat([fp.bias, sp.bias]), (0, pad)))


def _finish_pack(packed: Dict[str, torch.Tensor], differentiable: bool
                 ) -> Dict[str, torch.Tensor]:
    if differentiable:
        return packed
    return {k: v.detach().to(torch.float32).contiguous() for k, v in packed.items()}


def pack_decoder_weights(cell, num_mels: int, r: int, *,
                         differentiable: bool = False) -> Dict[str, torch.Tensor]:
    """Pad and pack a ``models.decoder.DecoderCell`` into the kernel's operand
    layout (the layout of the JAX ``pack_decoder_weights``): ``_pack_shared``'s
    operands and the GRUs' kernels and biases. Every operand is a torch op on
    the parameters, so with ``differentiable`` the pack stays in the graph
    and a loss on the plain decode reaches every decoder parameter (the
    teacher-forced step); otherwise the operands are detached, contiguous
    copies (the kernel's)."""
    if cell.cfg.num_decoder_rnn_layers != 2:
        raise ValueError("the decode kernel covers a 2-layer prenet and 2 decoder GRUs")
    packed = _pack_shared(cell, num_mels, r)
    packed.update(awi=cell.attention_rnn.kernel, abi=cell.attention_rnn.bias,
                  awh=cell.attention_rnn.recurrent_kernel,
                  abh=cell.attention_rnn.recurrent_bias,
                  dwi=cell.decoder_input_proj.kernel, dbi=cell.decoder_input_proj.bias)
    for i, g in enumerate((cell.decoder_rnn_0, cell.decoder_rnn_1), start=1):
        packed.update({f"g{i}wi": g.kernel, f"g{i}bi": g.bias,
                       f"g{i}wh": g.recurrent_kernel, f"g{i}bh": g.recurrent_bias})
    return _finish_pack(packed, differentiable)


def pack_lstm_decoder_weights(cell, num_mels: int, r: int, *,
                              differentiable: bool = False) -> Dict[str, torch.Tensor]:
    """Pack a ``models.decoder.Taco2DecoderCell`` (Tacotron 2's LSTM decoder)
    into the kernel's LSTM operands: ``_pack_shared``'s; ``awi`` the
    attention LSTM's input rows ([prenet ; context]) over its recurrent
    rows, (P2 + M + Ha, 4 Ha), ``abi`` its two biases summed; ``dwi`` the
    decoder LSTM's ([h_attn ; context] over h_dec), (Ha + M + Hd, 4 Hd),
    ``dbi`` its biases summed."""
    packed = _pack_shared(cell, num_mels, r)
    ar, dr = cell.attention_rnn, cell.decoder_rnn
    packed.update(awi=torch.cat([ar.kernel, ar.recurrent_kernel], 0),
                  abi=ar.bias + ar.recurrent_bias,
                  dwi=torch.cat([dr.kernel, dr.recurrent_kernel], 0),
                  dbi=dr.bias + dr.recurrent_bias)
    return _finish_pack(packed, differentiable)


def packed_cell(packed: Dict[str, torch.Tensor]) -> str:
    """"gru" for ``pack_decoder_weights``' operands, "lstm" for
    ``pack_lstm_decoder_weights``'."""
    return "gru" if "awh" in packed else "lstm"


def dropout_uniforms(seed: int, steps: int, layer: int, batch: int,
                     units: int, row0: int = 0) -> np.ndarray:
    """(steps, batch, units) float32 uniforms strictly inside (0, 1): the draw
    the decode kernel makes for prenet ``layer`` at each (step, row, unit),
    the rows counted from ``row0`` (a data-parallel shard's first row)."""
    return stream_uniforms(seed, np.arange(steps), layer, batch, units, row0)


def _gru(x, h, wi, bi, wh, bh):
    return gru_update(x @ wi + bi, h @ wh + bh, h)


class DecodeState(NamedTuple):
    """The recurrent state a decode step carries: the three GRU states, the
    attention context and the alignment state (previous, cumulative)."""
    h_attn: torch.Tensor
    h_d1: torch.Tensor
    h_d2: torch.Tensor
    ctx: torch.Tensor
    prev: torch.Tensor
    cum: torch.Tensor


class LSTMDecodeState(NamedTuple):
    """The LSTM branch's state: each LSTM's h and c, the context and the
    alignment state (previous, cumulative)."""
    h_attn: torch.Tensor
    c_attn: torch.Tensor
    h_dec: torch.Tensor
    c_dec: torch.Tensor
    ctx: torch.Tensor
    prev: torch.Tensor
    cum: torch.Tensor


def initial_decode_state(packed: Dict[str, torch.Tensor], memory: torch.Tensor):
    """Zero recurrent states and context; the alignment a delta at position
    0; in the packed weights' dtype (the step's compute dtype). A
    ``DecodeState``, or an ``LSTMDecodeState`` for the LSTM branch's
    operands."""
    b, t, m_dim = memory.shape
    zeros = lambda n: memory.new_zeros(b, n, dtype=packed["pw1"].dtype)
    prev = zeros(t)
    prev[:, 0] = 1.0
    if packed_cell(packed) == "lstm":
        ha, hd = packed["awi"].shape[1] // 4, packed["dwi"].shape[1] // 4
        return LSTMDecodeState(zeros(ha), zeros(ha), zeros(hd), zeros(hd), zeros(m_dim), prev,
                               zeros(t))
    return DecodeState(zeros(packed["awh"].shape[0]), zeros(packed["g1wh"].shape[0]),
                       zeros(packed["g2wh"].shape[0]), zeros(m_dim), prev, zeros(t))


def prenet_keep(seed, steps: int, batch: int, p1: int, p2: int, rate: float,
                device, step0: int = 0, row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(steps, batch, P) keep masks of the two prenet layers at steps
    ``step0`` on, rows ``row0`` on: the kernel's Philox draw
    (``dropout_uniforms``), made on ``device``. ``seed`` is an int, or the
    ``philox.DeviceSeed`` of a train step captured in a CUDA graph."""
    idx = torch.arange(step0, step0 + steps, device=device)
    return tuple(stream_uniforms(seed, idx, layer, batch, units, row0) >= rate
                 for layer, units in ((0, p1), (1, p2)))


def decode_step(w: Dict[str, torch.Tensor], st: DecodeState, frame: torch.Tensor,
                memory: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor, *,
                attn_cfg: AttentionConfig, num_mels: int, rate: float = 0.0,
                keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One decoder step (the JAX ``DecoderCell.__call__``) over packed weights:
    prenet of ``frame`` (B, num_mels) -> attention GRU -> attention -> input
    projection -> two residual GRUs -> packed frame and stop projection; or,
    with the LSTM branch's operands and state, Tacotron 2's step
    (``_lstm_step``). ``keep`` holds this step's prenet keep masks (None: no
    dropout). Every product runs in the packed weights' dtype, the input
    frame and the context cast to it (the JAX cell's casts); the context
    itself is taken in the promoted dtype of the alignment and ``memory``.
    Returns (state, out (B, 256): r frames then r stop logits, alignment)."""
    frame = frame.to(w["pw1"].dtype)
    h1 = torch.relu(frame @ w["pw1"][:num_mels] + w["pb1"])
    if keep is not None:
        h1 = torch.where(keep[0], h1 / (1.0 - rate), torch.zeros_like(h1))
    h2 = torch.relu(h1 @ w["pw2"] + w["pb2"])
    if keep is not None:
        h2 = torch.where(keep[1], h2 / (1.0 - rate), torch.zeros_like(h2))
    if isinstance(st, LSTMDecodeState):
        return _lstm_step(w, st, h2, memory, keys, valid, attn_cfg)
    h_attn = _gru(torch.cat([h2, st.ctx], -1), st.h_attn, w["awi"], w["abi"],
                  w["awh"], w["abh"])
    loc_k, loc_c = location_taps(attn_cfg)
    loca = w["loca"] if attn_cfg.kind == "location_sensitive" else None
    ctx, align, prev, cum = attention_step(h_attn @ w["qproj"], keys, memory, valid,
                                           st.prev, st.cum, w["vvec"], loca, loc_k, loc_c)
    ctx = ctx.to(w["pw1"].dtype)
    h = torch.cat([h_attn, ctx], -1) @ w["dwi"] + w["dbi"]
    h_d1 = _gru(h, st.h_d1, w["g1wi"], w["g1bi"], w["g1wh"], w["g1bh"])
    h = h + h_d1
    h_d2 = _gru(h, st.h_d2, w["g2wi"], w["g2bi"], w["g2wh"], w["g2bh"])
    h = h + h_d2
    out = torch.cat([h, ctx], -1) @ w["fw"] + w["fb"]
    return DecodeState(h_attn, h_d1, h_d2, ctx, prev, cum), out, align


def _lstm_step(w: Dict[str, torch.Tensor], st: LSTMDecodeState, h2: torch.Tensor,
               memory: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
               attn_cfg: AttentionConfig) -> Tuple[LSTMDecodeState, torch.Tensor, torch.Tensor]:
    """Tacotron 2's step after the prenet (``h2``): the attention LSTM over
    [h2 ; context] from (h_attn, c_attn), the attention, the decoder LSTM
    over [h_attn ; context] from (h_dec, c_dec), the projection of [h_dec ;
    context]."""
    h_attn, c_attn = lstm_update(torch.cat([h2, st.ctx, st.h_attn], -1) @ w["awi"] + w["abi"],
                                 st.c_attn)
    loc_k, loc_c = location_taps(attn_cfg)
    loca = w["loca"] if attn_cfg.kind == "location_sensitive" else None
    ctx, align, prev, cum = attention_step(h_attn @ w["qproj"], keys, memory, valid,
                                           st.prev, st.cum, w["vvec"], loca, loc_k, loc_c)
    ctx = ctx.to(w["pw1"].dtype)
    h_dec, c_dec = lstm_update(torch.cat([h_attn, ctx, st.h_dec], -1) @ w["dwi"] + w["dbi"],
                               st.c_dec)
    out = torch.cat([h_dec, ctx], -1) @ w["fw"] + w["fb"]
    return LSTMDecodeState(h_attn, c_attn, h_dec, c_dec, ctx, prev, cum), out, align


@dataclass
class DecodeCarry:
    """A decode that can be resumed: its output buffers over all ``total``
    steps (zeros where no step has written), the ``step``s done, and the
    state the next call starts from (None before the first: the kernel's
    workspace, or the plain version's (``DecodeState``, last frame))."""
    mel: torch.Tensor             # (B, total * r, num_mels)
    stop_logits: torch.Tensor     # (B, total * r)
    aligns: torch.Tensor          # (B, total, T)
    total: int
    step: int = 0
    state: Any = None


def decode_carry(memory: torch.Tensor, *, dec_cfg: DecoderConfig, num_mels: int,
                 total_steps: int) -> DecodeCarry:
    """A fresh carry for a decode of ``total_steps`` steps over ``memory``."""
    b, t, _ = memory.shape
    r = dec_cfg.reduction_factor
    z = lambda *shape: torch.zeros(*shape, device=memory.device)
    return DecodeCarry(z(b, total_steps * r, num_mels), z(b, total_steps * r),
                       z(b, total_steps, t), total_steps)


def _run_carried(carry: Optional[DecodeCarry], memory, steps, dec_cfg, num_mels, run):
    """Run ``run(carry)`` for ``steps`` steps of ``carry`` (a fresh one of
    ``steps`` steps when None), count them, advance it, return its
    buffers."""
    if carry is None:
        carry = decode_carry(memory, dec_cfg=dec_cfg, num_mels=num_mels, total_steps=steps)
    if carry.step + steps > carry.total:
        raise ValueError(f"decode: steps {carry.step}..{carry.step + steps} past the "
                         f"carry's {carry.total}")
    if steps > 0 and memory.shape[0] > 0:
        run(carry)
        profiling.count("decode_steps", steps)
    carry.step += steps
    return carry.mel, carry.stop_logits, carry.aligns


def _plain_decode(packed, memory, keys, lengths, inputs, *, dec_cfg, attn_cfg,
                  num_mels, steps, seed, use_dropout, step0=0, state=None, row0=0):
    """Drive ``decode_step`` for ``steps`` steps from global step ``step0``
    and ``state`` (None: the initial state, go frame zeros), the dropout
    rows counted from ``row0``: each step's
    input frame is ``inputs[:, s]`` (teacher forcing) or, with ``inputs``
    None, the last frame of the step before (autoregressive). Returns (mel,
    stop logits, alignments) of these steps and the (state, last frame)
    after them."""
    if attn_cfg.kind not in _KINDS:
        raise ValueError(f"unknown attention kind {attn_cfg.kind!r}")
    w = packed
    r = dec_cfg.reduction_factor
    rate = float(dec_cfg.prenet_dropout)
    b, t, _ = memory.shape
    dev = memory.device
    valid = torch.arange(t, device=dev)[None, :] < lengths.to(dev)[:, None]
    valid[:, 0] = True
    keep = None
    if use_dropout:
        keep = prenet_keep(seed, steps, b, w["pw1"].shape[1], w["pw2"].shape[1], rate, dev,
                           step0, row0)
    if state is None:
        state = (initial_decode_state(w, memory),
                 memory.new_zeros(b, num_mels, dtype=w["pw1"].dtype))
    st, last = state
    frames, stops, aligns = [], [], []
    for s in range(steps):
        frame = last if inputs is None else inputs[:, s]
        st, out, align = decode_step(
            w, st, frame, memory, keys, valid, attn_cfg=attn_cfg, num_mels=num_mels,
            rate=rate, keep=None if keep is None else (keep[0][s], keep[1][s]))
        frames.append(out[:, : r * num_mels])
        stops.append(out[:, r * num_mels: r * num_mels + r])
        aligns.append(align)
        last = out[:, (r - 1) * num_mels: r * num_mels]
    mel = torch.stack(frames, 1).reshape(b, steps * r, num_mels)
    stop_logits = torch.stack(stops, 1).reshape(b, steps * r)
    return mel, stop_logits, torch.stack(aligns, 1), (st, last)


def decode_scan_plain(packed: Dict[str, torch.Tensor], memory: torch.Tensor,
                      keys: torch.Tensor, lengths: torch.Tensor, *,
                      dec_cfg: DecoderConfig, attn_cfg: AttentionConfig,
                      num_mels: int, steps: int, seed: int = 0,
                      use_dropout: bool = False, carry: Optional[DecodeCarry] = None,
                      row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same decode in plain PyTorch, one ``decode_step`` per loop
    iteration, each fed the last frame of the step before; with ``carry``
    the next ``steps`` steps of that decode (see ``DecodeCarry``)."""
    r = dec_cfg.reduction_factor

    def run(c: DecodeCarry) -> None:
        mel, stops, aligns, c.state = _plain_decode(
            packed, memory, keys, lengths, None, dec_cfg=dec_cfg, attn_cfg=attn_cfg,
            num_mels=num_mels, steps=steps, seed=seed, use_dropout=use_dropout,
            step0=c.step, state=c.state, row0=row0)
        c.mel[:, c.step * r: (c.step + steps) * r] = mel
        c.stop_logits[:, c.step * r: (c.step + steps) * r] = stops
        c.aligns[:, c.step: c.step + steps] = aligns

    return _run_carried(carry, memory, steps, dec_cfg, num_mels, run)


def teacher_forced_scan(packed: Dict[str, torch.Tensor], memory: torch.Tensor,
                        keys: torch.Tensor, lengths: torch.Tensor,
                        mel_targets: torch.Tensor, *, dec_cfg: DecoderConfig,
                        attn_cfg: AttentionConfig, num_mels: int, seed=0,
                        use_dropout: bool = False, row0: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The teacher-forced decode (the JAX ``Decoder.teacher_forced``): step i
    takes the target's last frame of group i - 1, the go frame (zeros)
    first, through the same ``decode_step`` as the AR decode. ``mel_targets``
    (B, T_mel, num_mels) with T_mel % r == 0; ``seed`` as ``prenet_keep``
    takes it. No kernel: with a
    differentiable pack (``pack_decoder_weights(differentiable=True)``) a
    loss on the outputs reaches every decoder parameter."""
    r = dec_cfg.reduction_factor
    b, t_mel, _ = mel_targets.shape
    if t_mel % r:
        raise ValueError(f"mel length {t_mel} not divisible by r={r}")
    steps = t_mel // r
    go = mel_targets.new_zeros(b, 1, num_mels)
    inputs = torch.cat([go, mel_targets[:, r - 1:: r][:, :-1]], 1)
    return _plain_decode(packed, memory, keys, lengths, inputs, dec_cfg=dec_cfg,
                         attn_cfg=attn_cfg, num_mels=num_mels, steps=steps, seed=seed,
                         use_dropout=use_dropout, row0=row0)[:3]


# --- the kernel's phases, plan and workspace ---------------------------------

ROWS = 32           # rows of the batch a CTA steps (a row group: grid.y)
WARPS = 8           # warps a CTA (csrc/decode_scan.cu DEC_WARPS)
MAX_SLICE = 256     # context columns a P5 CTA at most (its threads)

# the workspace's state buffers, in the kernel's order (enum Buf): the GRU
# branch's, the shared ones, then the LSTM branch's (a branch's buffers of
# the other are zero wide)
BUFFERS = ("h_attn", "h_d1", "h_d2", "ctx", "p1", "p2", "last", "hdec0", "hdec1",
           "hdec2", "gha", "gxc", "gh1", "gh2", "prev", "cum", "part", "keys_t",
           "c_attn", "h_dec", "c_dec", "gsa", "gsd")
# every product kind, in the kernel's order (enum Kind)
KINDS = ("pre1", "gha", "gxc", "gh1", "gh2", "pre2", "attn", "query", "dec", "g1", "g2",
         "out", "lattn", "gsa", "ldec", "gsd")
# the launcher's header: ``decode_launch_ints``' first integers (NHDR)
NHDR = 19


class DecodeDims(NamedTuple):
    B: int      # rows
    T: int      # memory positions
    S: int      # steps
    r: int      # frames a step
    NM: int     # mel channels
    P1: int     # prenet widths
    P2: int
    Ha: int     # attention GRU
    A: int      # attention columns
    Hd: int     # decoder GRUs
    Md: int     # memory width
    loc_k: int  # location taps
    loc_c: int  # location feature channels
    ld_fw: int  # columns of the packed frame + stop projection
    cell: str = "gru"   # "gru" or "lstm" (the decoder's recurrent cells)

    @property
    def n_out(self) -> int:
        return self.r * self.NM + self.r


class Product(NamedTuple):
    """One product of a phase: Y = [X0 ; X1] @ W[rows of each segment]. A
    GRU product (gates 3) owns units: unit k takes columns k, H + k, 2H + k
    of W, so a CTA holds the z, r and n columns of each unit it owns; an
    LSTM product (gates 4) the i, f, g and o columns k + gH."""
    kind: str
    phase: int
    weight: str                 # key of the packed weights
    gates: int
    n: int                      # output columns, or units when gates == 3
    segs: Tuple[Tuple[int, int], ...]   # (first row of W, rows) per input
    inputs: Tuple[str, ...]     # the workspace buffer of each segment


def _r4(x: int) -> int:
    return (x + 3) // 4 * 4


def decode_dims(packed: Dict[str, torch.Tensor], memory: torch.Tensor, keys: torch.Tensor,
                *, r: int, num_mels: int, steps: int, attn_cfg: AttentionConfig) -> DecodeDims:
    b, t, m_dim = memory.shape
    loc_k, loc_c = location_taps(attn_cfg)
    cell = packed_cell(packed)
    if cell == "lstm":
        ha, hd = packed["awi"].shape[1] // 4, packed["dwi"].shape[1] // 4
    else:
        ha, hd = packed["awh"].shape[0], packed["g1wh"].shape[0]
    return DecodeDims(B=b, T=t, S=steps, r=r, NM=num_mels, P1=packed["pw1"].shape[1],
                      P2=packed["pw2"].shape[1], Ha=ha, A=keys.shape[-1], Hd=hd, Md=m_dim,
                      loc_k=loc_k, loc_c=loc_c, ld_fw=packed["fw"].shape[1], cell=cell)


def decode_products(d: DecodeDims) -> List[Product]:
    """The step's products in the kernel's order (enum Kind), each with the
    phase that launches it: P1 prenet layer 1; P2 prenet layer 2; P3 the
    attention GRU; P4 the query (then the partial scores); P6 the decoder
    input projection; P7, P8 the decoder GRUs; P9 the frame and stop
    projection. The products of the state alone (h_attn @ awh + abh, ctx @
    awi[ctx rows] + abi, h_d1 @ g1wh + g1bh, h_d2 @ g2wh + g2bh), which the
    next step's GRUs add, run on the spare CTAs of the first launch after
    their state is final (P7, P6, P8, P9); the launcher writes their values
    for the zero state, the biases, before step 0.

    The LSTM branch: P1, P2 the prenet; P3 the attention LSTM's prenet rows
    (``lattn``); P4 the query; P7 the decoder LSTM's [h_attn ; ctx] rows
    (``ldec``) beside the attention LSTM's state product [ctx ; h_attn]
    (``gsa``); P9 the projection beside the decoder LSTM's state product
    h_dec (``gsd``)."""
    if d.cell == "lstm":
        return [
            Product("pre1", 1, "pw1", 1, d.P1, ((0, d.NM),), ("last",)),
            Product("pre2", 2, "pw2", 1, d.P2, ((0, d.P1),), ("p1",)),
            Product("lattn", 3, "awi", 4, d.Ha, ((0, d.P2),), ("p2",)),
            Product("query", 4, "qproj", 1, d.A, ((0, d.Ha),), ("h_attn",)),
            Product("gsa", 7, "awi", 4, d.Ha, ((d.P2, d.Md), (d.P2 + d.Md, d.Ha)),
                    ("ctx", "h_attn")),
            Product("ldec", 7, "dwi", 4, d.Hd, ((0, d.Ha), (d.Ha, d.Md)), ("h_attn", "ctx")),
            Product("gsd", 9, "dwi", 4, d.Hd, ((d.Ha + d.Md, d.Hd),), ("h_dec",)),
            Product("out", 9, "fw", 1, d.n_out, ((0, d.Hd), (d.Hd, d.Md)), ("h_dec", "ctx")),
        ]
    return [
        Product("pre1", 1, "pw1", 1, d.P1, ((0, d.NM),), ("last",)),
        Product("gha", 7, "awh", 3, d.Ha, ((0, d.Ha),), ("h_attn",)),
        Product("gxc", 6, "awi", 3, d.Ha, ((d.P2, d.Md),), ("ctx",)),
        Product("gh1", 8, "g1wh", 3, d.Hd, ((0, d.Hd),), ("h_d1",)),
        Product("gh2", 9, "g2wh", 3, d.Hd, ((0, d.Hd),), ("h_d2",)),
        Product("pre2", 2, "pw2", 1, d.P2, ((0, d.P1),), ("p1",)),
        Product("attn", 3, "awi", 3, d.Ha, ((0, d.P2),), ("p2",)),
        Product("query", 4, "qproj", 1, d.A, ((0, d.Ha),), ("h_attn",)),
        Product("dec", 6, "dwi", 1, d.Hd, ((0, d.Ha), (d.Ha, d.Md)), ("h_attn", "ctx")),
        Product("g1", 7, "g1wi", 3, d.Hd, ((0, d.Hd),), ("hdec0",)),
        Product("g2", 8, "g2wi", 3, d.Hd, ((0, d.Hd),), ("hdec1",)),
        Product("out", 9, "fw", 1, d.n_out, ((0, d.Hd), (d.Hd, d.Md)), ("hdec2", "ctx")),
    ]


def product_quads(p: Product) -> int:
    """Column (or unit) quads of a product: a warp's tile is 8 rows x 4."""
    return _r4(p.n) // 4


def product_kp(p: Product) -> int:
    """k of the transposed weights: each segment padded to a multiple of 4."""
    return sum(_r4(n) for _, n in p.segs)


def decode_phase_plan(d: DecodeDims, sms: int) -> dict:
    """Each phase's CTAs and their slices, aiming at about one CTA an SM.

    - Products (P1-P3, P6-P9): a CTA owns ``qpc`` consecutive quads of one
      product for the rows of its row group, over all k; a phase's quads
      cost gates x k each, and each product takes ``qpc`` = the phase's
      cost a CTA over its cost a quad, at least 1 and at most as many as
      give each warp one tile (a CTA's tiles run one after another, so more
      would lengthen the phase).
    - P4: a CTA owns a chunk of ``qpc`` attention-column quads; the chunks
      are the partial scores that P5 sums in order.
    - P5: a CTA owns (row, slice of ``slice_width`` context columns), at
      least 32 columns and about four CTAs an SM: each thread of a slice
      then sums few positions (the phase is a chain of latencies).

    Returns {"row_groups", "qpc": {kind: n}, "ncta": {kind: n}, "jobs":
    {phase: [(kind, q0, q1), ...] in CTA order}, "chunks", "slice_width",
    "slices"}."""
    if sms < 1:
        raise ValueError("sms must be positive")
    row_groups = -(-d.B // ROWS)
    target = max(1, sms // row_groups)
    most = max(1, WARPS // -(-min(d.B, ROWS) // 8))     # quads for one tile a warp
    prods = decode_products(d)
    qpc, ncta = {}, {}
    for ph in sorted({p.phase for p in prods}):
        mine = [p for p in prods if p.phase == ph]
        if ph == 4:
            (p,) = mine
            qpc[p.kind] = -(-product_quads(p) // target)
        else:
            cost = sum(product_quads(p) * p.gates * product_kp(p) for p in mine)
            budget = -(-cost // target)
            for p in mine:
                qpc[p.kind] = max(1, min(most, budget // (p.gates * product_kp(p))))
        for p in mine:
            ncta[p.kind] = -(-product_quads(p) // qpc[p.kind])
    jobs: Dict[int, list] = {}
    for p in prods:
        nq = product_quads(p)
        jobs.setdefault(p.phase, []).extend(
            (p.kind, q0, min(nq, q0 + qpc[p.kind])) for q0 in range(0, nq, qpc[p.kind]))
    cols = -(-d.Md // max(1, 4 * sms // d.B))
    width = min(MAX_SLICE, -(-cols // 32) * 32)
    return {"row_groups": row_groups, "qpc": qpc, "ncta": ncta, "jobs": jobs,
            "chunks": ncta["query"], "slice_width": width, "slices": -(-d.Md // width)}


def _buffer_widths(d: DecodeDims, plan: dict) -> Dict[str, int]:
    """Row stride (floats) of each state buffer; k-side buffers padded to a
    multiple of 4 (zeros past the width) for the products' float4 loads; the
    other branch's buffers zero wide."""
    gru, lstm = int(d.cell == "gru"), int(d.cell == "lstm")
    return {"h_attn": _r4(d.Ha), "h_d1": gru * _r4(d.Hd), "h_d2": gru * _r4(d.Hd),
            "ctx": _r4(d.Md), "p1": _r4(d.P1), "p2": _r4(d.P2), "last": _r4(d.NM),
            "hdec0": gru * _r4(d.Hd), "hdec1": gru * _r4(d.Hd), "hdec2": gru * _r4(d.Hd),
            "gha": gru * 3 * _r4(d.Ha), "gxc": gru * 3 * _r4(d.Ha), "gh1": gru * 3 * _r4(d.Hd),
            "gh2": gru * 3 * _r4(d.Hd), "prev": d.T, "cum": d.T, "part": plan["chunks"] * d.T,
            "keys_t": d.A * d.T, "c_attn": lstm * _r4(d.Ha), "h_dec": lstm * _r4(d.Hd),
            "c_dec": lstm * _r4(d.Hd), "gsa": lstm * 4 * _r4(d.Ha),
            "gsd": lstm * 4 * _r4(d.Hd)}


def decode_workspace_layout(d: DecodeDims, plan: dict) -> Dict[str, Tuple[int, int, int]]:
    """{name: (offset, rows, row stride)} in floats: the state buffers (B
    rows each; ``state`` covers them all, zeroed at the start of a decode),
    then each product's transposed weights ``wt_<kind>`` (gates x r4(n)
    rows of ``product_kp`` floats). Every offset is a multiple of 4."""
    out, off = {}, 0
    for name, ld in _buffer_widths(d, plan).items():
        out[name] = (off, d.B, ld)
        off += _r4(d.B * ld)
    out["state"] = (0, 1, off)
    for p in decode_products(d):
        rows = p.gates * _r4(p.n)
        out[f"wt_{p.kind}"] = (off, rows, product_kp(p))
        off += rows * product_kp(p)
    out["total"] = (0, 1, off)
    return out


def decode_workspace_floats(d: DecodeDims, plan: dict) -> int:
    return decode_workspace_layout(d, plan)["total"][2]


def decode_launch_ints(d: DecodeDims, plan: dict) -> List[int]:
    """The launcher's ``dims``: a header (``NHDR`` integers, the cell 0 GRU
    or 1 LSTM and the count of products last), (offset, stride) of each
    state buffer, then per product (the branch's order) kind (its index in
    ``KINDS``), weights offset, source index in ``_WEIGHT_ORDER``, source row
    stride, n, gates, two (first row, rows) segments, the two input buffers
    (-1: none), qpc and phase."""
    lay = decode_workspace_layout(d, plan)
    prods = decode_products(d)
    out = [d.B, d.T, d.S, d.r, d.NM, d.P1, d.P2, d.Ha, d.A, d.Hd, d.Md, d.loc_k, d.loc_c,
           plan["chunks"], plan["slice_width"], plan["slices"], lay["state"][2],
           int(d.cell == "lstm"), len(prods)]
    for name in BUFFERS:
        out += [lay[name][0], lay[name][2]]
    for p in prods:
        segs = list(p.segs) + [(0, 0)] * (2 - len(p.segs))
        ins = [BUFFERS.index(x) for x in p.inputs] + [-1] * (2 - len(p.inputs))
        out += [KINDS.index(p.kind), lay[f"wt_{p.kind}"][0], _WEIGHT_ORDER.index(p.weight),
                d.ld_fw if p.weight == "fw" else p.gates * p.n, p.n, p.gates,
                *segs[0], *segs[1], *ins, plan["qpc"][p.kind], p.phase]
    if lay["total"][2] >= 2 ** 31:
        raise ValueError("decode_scan: workspace past 2^31 floats")
    return out


def decode_scan(packed: Dict[str, torch.Tensor], memory: torch.Tensor,
                keys: torch.Tensor, lengths: torch.Tensor, *,
                dec_cfg: DecoderConfig, attn_cfg: AttentionConfig,
                num_mels: int, steps: int, seed: int = 0,
                use_dropout: bool = False, carry: Optional[DecodeCarry] = None,
                row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-length decode: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; with ``carry`` the next ``steps`` steps of that
    decode, written into its buffers (one launcher call, the kernel's
    outputs strided by the carry's total steps). The prenet dropout of row
    ``b`` draws as row ``row0 + b`` of a global batch."""
    if memory.device.type == "cpu":
        return decode_scan_plain(packed, memory, keys, lengths, dec_cfg=dec_cfg,
                                 attn_cfg=attn_cfg, num_mels=num_mels,
                                 steps=steps, seed=seed, use_dropout=use_dropout,
                                 carry=carry, row0=row0)
    refuse_grad("decode_scan", memory, keys, *packed.values())
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
    # the LSTM branch's operands leave the GRU-only pointers null
    ws = [packed.get(k) for k in _WEIGHT_ORDER]
    check_cuda("decode_scan", memory, keys, lens, *ws)
    lstm = packed_cell(packed) == "lstm"

    def run(c: DecodeCarry) -> None:
        check_cuda("decode_scan", c.mel, c.stop_logits, c.aligns)
        d = decode_dims(packed, memory, keys, r=r, num_mels=num_mels, steps=c.total,
                        attn_cfg=attn_cfg)
        plan = decode_phase_plan(d, sm_count(memory.device.index))
        ints = decode_launch_ints(d, plan)
        prepared = c.state is not None
        if not prepared:
            c.state = torch.empty(decode_workspace_floats(d, plan), device=memory.device)
        wptrs = (ctypes.c_void_p * len(ws))(*[ptr(x) for x in ws])
        dptrs = (ctypes.c_int * len(ints))(*ints)
        KERNEL(ptr(memory), ptr(keys), ptr(lens), wptrs, dptrs, ptr(c.mel),
               ptr(c.stop_logits), ptr(c.aligns), ptr(c.state), seed & 0xFFFFFFFFFFFFFFFF,
               float(dec_cfg.prenet_dropout), int(use_dropout), c.step, steps, int(prepared),
               row0, stream_ptr(memory.device),
               branch="lstm" if lstm else
               "location_sensitive" if attn_cfg.kind == "location_sensitive" else None)

    return _run_carried(carry, memory, steps, dec_cfg, num_mels, run)
