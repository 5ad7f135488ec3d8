"""The yardstick's arithmetic for Tacotron 2 with GST (the ``gst_taco2``
configuration): K4's LSTM branch and the model FLOPs of a synthesis call.

A frozen copy of the port's kernel-bench counts for the LSTM decoder,
written against a configuration dict as ``work.py`` is: each LSTM counts its
four gates' products over [input ; state] and, a unit and step, the four
operations that carry its cell state c (c' = f c + i g, h' = o tanh c'); the
location term as K4's folded taps; the packed weights once. The call's
stages: the style as ``work.py`` counts it, the encoder's three convs and
BiLSTM, the decode and its keys, the conv post-net, and the vocoder (the
mel basis's pseudo-inverse product, then Griffin-Lim's transforms as real
FFTs). ``benchmark/tests`` holds these equal to the program's kernel bench.
"""

from __future__ import annotations

from typing import Dict, Sequence

from . import work
from .work import LANE, Work

# operations a unit and step that carry an LSTM's cell state, besides its
# gates' products and nonlinearities: f * c, i * g, their sum, o * tanh(c')
CELL_OPS = 4


def _enc_dim(m: dict) -> int:
    return 2 * m["encoder"]["cbhg_gru_dim"] + (m["gst"]["style_dim"] if m["gst"]["enabled"]
                                               else 0)


def _loc_taps(a: dict) -> int:
    return a["location_kernel_size"] * (2 if a["cumulative"] else 1)


def decode_step_flops(cfg: dict, batch: int, t_mem: int) -> float:
    """FLOPs of one LSTM decoder step: the prenet, the attention LSTM over
    [prenet ; context ; state], the query, the location term as its band's
    folded taps, the scores, the context, the decoder LSTM over [h_attn ;
    context ; state], the frame and stop projection, and each LSTM's cell
    arithmetic."""
    m = cfg["model"]
    d, a = m["decoder"], m["attention"]
    nm, r = m["num_mels"], d["reduction_factor"]
    enc = _enc_dim(m)
    p1, p2 = d["prenet_dims"]
    ha, hd = d["attention_rnn_dim"], d["decoder_rnn_dim"]
    mm = nm * p1 + p1 * p2
    mm += (p2 + enc + ha) * 4 * ha
    mm += ha * a["dim"]
    mm += t_mem * a["dim"]
    mm += (2 if a["cumulative"] else 1) * t_mem * min(a["location_kernel_size"], t_mem) \
        * a["dim"]
    mm += t_mem * enc
    mm += (ha + enc + hd) * 4 * hd
    mm += (hd + enc) * (r * nm + r)
    return 2.0 * batch * mm + CELL_OPS * batch * (ha + hd)


def decode_weights(cfg: dict) -> int:
    """Floats of the LSTM decoder's packed operands: the prenet (its input
    padded to 128 rows), each LSTM's input and recurrent rows and summed
    bias, the query, v and the folded location taps, the frame and stop
    projections packed into 256 columns."""
    m = cfg["model"]
    d, a = m["decoder"], m["attention"]
    enc = _enc_dim(m)
    p1, p2 = d["prenet_dims"]
    ha, hd = d["attention_rnn_dim"], d["decoder_rnn_dim"]
    n = LANE * p1 + p1 + p1 * p2 + p2
    n += (p2 + enc + ha) * 4 * ha + 4 * ha
    n += ha * a["dim"] + a["dim"] + _loc_taps(a) * a["dim"]
    n += (ha + enc + hd) * 4 * hd + 4 * hd
    n += (hd + enc) * 2 * LANE + 2 * LANE
    return n


def decode_scan_work(cfg: dict, batch: int, t_mem: int, steps: int, n_weights: int) -> Work:
    """K4's LSTM branch: ``steps`` steps of ``batch`` rows over ``t_mem``
    positions; bytes as ``work.decode_scan_work``'s (the packed weights,
    memory, keys and lengths once, each step's frames, stop logits and
    alignment written)."""
    nbytes = work.decode_scan_work(cfg, batch, t_mem, steps, n_weights).bytes
    return Work(steps * decode_step_flops(cfg, batch, t_mem), nbytes)


def bilstm_flops(batch: int, t: int, d: int, h: int) -> float:
    """Both directions of an LSTM of ``h`` units over (batch, t, d)."""
    return 2 * (2.0 * batch * t * (d + h) * 4 * h + CELL_OPS * batch * t * h)


def conv_stack_flops(batch: int, t: int, widths: Sequence[int], k: int) -> float:
    """SAME convs of ``k`` taps through channel ``widths`` (in, ..., out)."""
    return sum(2.0 * batch * t * k * c_in * c_out for c_in, c_out in zip(widths, widths[1:]))


def synth_call_flops(cfg: dict, batch: int, t_text: int, ref_frames: Sequence[int],
                     t_ref: int) -> Dict[str, float]:
    """Model FLOPs of one ``gst_taco2`` synthesis call by stage."""
    m, a = cfg["model"], cfg["audio"]
    e, d, p = m["encoder"], m["decoder"], m["postnet"]
    steps = d["max_decode_steps"]
    frames = steps * d["reduction_factor"]
    nf = a["n_fft"] // 2 + 1
    emb = e["embedding_dim"]
    post_widths = [m["num_mels"]] + [p["conv_channels"]] * (p["conv_layers"] - 1) \
        + [m["num_mels"]]
    base = work.synth_call_flops(cfg, batch, t_text, ref_frames, t_ref)
    return {
        "reference_mels": base["reference_mels"],
        "style": base["style"],
        "encoder": conv_stack_flops(batch, t_text, [emb] * 4, 5)
        + bilstm_flops(batch, t_text, emb, e["cbhg_gru_dim"]),
        "decode": steps * decode_step_flops(cfg, batch, t_text)
        + 2.0 * batch * t_text * _enc_dim(m) * m["attention"]["dim"],
        "postnet": conv_stack_flops(batch, frames, post_widths, p["conv_kernel_size"]),
        "vocoder": 2.0 * batch * frames * m["num_mels"] * nf
        + batch * frames * (2 * a["griffin_lim_iters"] + 1) * work.fft_frame_flops(a["n_fft"]),
    }
