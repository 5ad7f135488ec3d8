"""The yardstick's arithmetic: published peaks, each kernel's least work, and
the model FLOPs of a cell's call or step.

The work counts are a frozen copy of the port's kernel-bench counts (least
work from the shapes, each input read once and each output written once),
written against a configuration dict so that a change to the program
cannot move them. ``benchmark/tests`` holds them equal to the program's at
each cell's shapes, so drift in either shows.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence

# Published peaks of one card (NVIDIA's data sheets, SXM part, dense rates
# without sparsity) at its full power limit (700 W for the H100): TFLOP/s of
# bf16 and TF32 on the tensor cores, of float32 outside them, and GB/s of
# device memory.
CARD_PEAKS = {
    "h100": {"bf16_tflops": 989.0, "tf32_tflops": 495.0, "f32_tflops": 67.0,
             "hbm_gbps": 3350.0},
}
H100 = CARD_PEAKS["h100"]
# the rate every mfu share is taken against: the highest peak of any
# precision the port computes in, so no change of precision carries a share
# past 1
MFU_PEAK_FLOPS = H100["bf16_tflops"] * 1e12
LANE = 128


class Work(NamedTuple):
    flops: float
    bytes: float
    rate: str = "f32"


def bound_seconds(work: Work, peaks: dict = H100) -> float:
    """The least time of ``work``: the larger of its operations over the peak
    of its rate and its bytes over the memory's."""
    return max(work.flops / (peaks[f"{work.rate}_tflops"] * 1e12),
               work.bytes / (peaks["hbm_gbps"] * 1e9))


def _enc_dim(m: dict) -> int:
    out = 2 * m["encoder"]["cbhg_gru_dim"]
    return out + (m["gst"]["style_dim"] if m["gst"]["enabled"] else 0)


def decode_step_flops(cfg: dict, batch: int, t_mem: int, dense_band: bool = False) -> float:
    """FLOPs of one decoder step (every product; the location term either
    as its band's taps, ``dense_band``, or as the full banded contraction)."""
    m = cfg["model"]
    d, a = m["decoder"], m["attention"]
    nm, r = m["num_mels"], d["reduction_factor"]
    enc = _enc_dim(m)
    p1, p2 = d["prenet_dims"]
    ar, dr = d["attention_rnn_dim"], d["decoder_rnn_dim"]
    mm = nm * p1 + p1 * p2
    mm += (p2 + enc) * 3 * ar + ar * 3 * ar
    mm += ar * a["dim"]
    mm += t_mem * a["dim"]
    if a["kind"] == "location_sensitive":
        c = 2 if a["cumulative"] else 1
        mm += c * t_mem * (min(a["location_kernel_size"], t_mem) if dense_band else t_mem) \
            * a["dim"]
    mm += t_mem * enc
    mm += (ar + enc) * dr
    mm += 2 * (dr * 3 * dr * 2)
    mm += (dr + enc) * (r * nm + r)
    return 2.0 * batch * mm


def decode_weights(cfg: dict) -> int:
    """Floats of the decoder's packed weights (the prenet input padded to
    128 rows, frame and stop projections packed into 256 columns)."""
    m = cfg["model"]
    d, a = m["decoder"], m["attention"]
    enc = _enc_dim(m)
    p1, p2 = d["prenet_dims"]
    ar, dr = d["attention_rnn_dim"], d["decoder_rnn_dim"]
    if a["kind"] == "location_sensitive":
        loca = a["location_kernel_size"] * (2 if a["cumulative"] else 1) * a["dim"]
    else:
        loca = a["dim"]
    n = LANE * p1 + p1 + p1 * p2 + p2
    n += (p2 + enc) * 3 * ar + 3 * ar + ar * 3 * ar + 3 * ar
    n += ar * a["dim"] + a["dim"] + loca
    n += (ar + enc) * dr + dr
    n += 2 * (2 * dr * 3 * dr + 2 * 3 * dr)
    n += (dr + enc) * 2 * LANE + 2 * LANE
    return n


def decode_scan_work(cfg: dict, batch: int, t_mem: int, steps: int, n_weights: int,
                     dense_band: bool = True) -> Work:
    """K4: ``steps`` steps of ``batch`` rows over ``t_mem`` positions."""
    m = cfg["model"]
    enc = _enc_dim(m)
    r = m["decoder"]["reduction_factor"]
    nbytes = 4.0 * (n_weights + batch * t_mem * (enc + m["attention"]["dim"]) + batch
                    + batch * steps * r * (m["num_mels"] + 1) + batch * steps * t_mem)
    return Work(steps * decode_step_flops(cfg, batch, t_mem, dense_band), nbytes)


def gru_scan_work(batch: int, t: int, d: int, h: int, directions: int = 1) -> Work:
    flops = directions * 2.0 * batch * t * (d + h) * 3 * h
    nbytes = 4.0 * (batch * t * d + batch + directions * (batch * t * h + 2 * batch * h
                                                          + (d + h + 2) * 3 * h))
    return Work(flops, nbytes)


def refenc_stack_work(batch: int, t: int, f: int, channels: Sequence[int],
                      bf16: bool = False) -> Work:
    flops, h, w, c_in, wbytes = 0.0, t, f, 1, 0
    for c in channels:
        h, w = (h + 1) // 2, (w + 1) // 2
        flops += 2.0 * batch * h * w * 9 * c_in * c
        wbytes += 9 * c_in * c + 2 * c
        c_in = c
    nbytes = 4.0 * (batch * t * f + batch + wbytes + batch * h * w * c_in)
    return Work(flops, nbytes, "bf16" if bf16 else "f32")


def wavernn_weights(cfg: dict) -> int:
    v = cfg["model"]["vocoder"]
    h, c, k = v["wavernn_gru_dim"], v["wavernn_fc_dim"], 2 ** v["wavernn_bits"]
    return k * c + c * 3 * h + 3 * h + h * 3 * h + 3 * h + h * c + c + c * k + k


def wavernn_sample_work(cfg: dict, batch: int, frames: int, cond_dim: int, n_weights: int,
                        hoisted: bool = False) -> Work:
    """K5: ``batch`` rows of ``frames`` x hop samples; ``hoisted`` counts the
    input product once a class and once a frame."""
    v = cfg["model"]["vocoder"]
    h, f, k = v["wavernn_gru_dim"], v["wavernn_fc_dim"], 2 ** v["wavernn_bits"]
    n = frames * v["wavernn_hop"]
    tail = h * 3 * h + h * f + f * k
    if hoisted:
        flops = 2.0 * ((k + batch * frames) * cond_dim * 3 * h + tail * batch * n)
    else:
        flops = 2.0 * (cond_dim * 3 * h + tail) * batch * n
    return Work(flops, 4.0 * (n_weights + batch * frames * cond_dim + batch * n))


def fft_frame_flops(n_fft: int) -> float:
    """A real transform of n_fft points, as half a complex FFT's 5 N log2 N."""
    return 2.5 * n_fft * math.log2(n_fft)


def _mel_nonzeros(a: dict) -> int:
    from .reference.dsp import mel_filterbank

    return int((mel_filterbank(a) != 0).sum())


def cbhg_flops(batch: int, t: int, c_in: int, c: dict) -> float:
    """A CBHG's products: the bank's live taps (width k reads k inputs), the
    projections, the residual and pre-highway projections, the highways,
    the BiGRU."""
    k, ch = c["cbhg_bank_k"], c["cbhg_bank_channels"]
    mm = c_in * ch * k * (k + 1) / 2
    prev = k * ch
    for p in c["cbhg_proj_channels"]:
        mm += 3 * prev * p
        prev = p
    if prev != c_in:
        mm += c_in * prev
    hw = c["cbhg_highway_dim"]
    if prev != hw:
        mm += prev * hw
    mm += c["cbhg_highway_layers"] * 2 * hw * hw
    g = c["cbhg_gru_dim"]
    mm += 2 * (hw + g) * 3 * g
    return 2.0 * batch * t * mm


def model_flops(cfg: dict, batch: int, t_text: int, t_ref: int, steps: int) -> Dict[str, float]:
    """The model's products by stage for ``batch`` rows of ``t_text``
    tokens, a style mel of ``t_ref`` frames and ``steps`` decoder steps:
    the style (conv stack, GRU, tokens), the encoder, the decode (its keys
    too), the post-net over steps * r frames."""
    m, a = cfg["model"], cfg["audio"]
    d, e, g = m["decoder"], m["encoder"], m["gst"]
    frames = steps * d["reduction_factor"]
    stack = refenc_stack_work(batch, t_ref, m["num_mels"], g["ref_conv_channels"]).flops
    f, n = m["num_mels"], len(g["ref_conv_channels"])
    for _ in range(n):
        f = (f + 1) // 2
    gru_t = -(-t_ref // 2 ** n)
    hd = g["style_dim"] // g["num_heads"]
    stl = 2.0 * batch * g["ref_gru_dim"] * g["style_dim"] + 2.0 * 2 * g["num_tokens"] * hd \
        * g["style_dim"] + 4.0 * batch * g["num_tokens"] * g["style_dim"]
    p1, p2 = e["prenet_dims"]
    return {
        "style": stack + gru_scan_work(batch, gru_t, f * g["ref_conv_channels"][-1],
                                       g["ref_gru_dim"]).flops + stl,
        "encoder": 2.0 * batch * t_text * (e["embedding_dim"] * p1 + p1 * p2)
        + cbhg_flops(batch, t_text, p2, e),
        "decode": steps * decode_step_flops(cfg, batch, t_text, dense_band=True)
        + 2.0 * batch * t_text * _enc_dim(m) * m["attention"]["dim"],
        "postnet": cbhg_flops(batch, frames, m["num_mels"], m["postnet"])
        + 2.0 * batch * frames * 2 * m["postnet"]["cbhg_gru_dim"] * (a["n_fft"] // 2 + 1),
    }


def synth_call_flops(cfg: dict, batch: int, t_text: int, ref_frames: Sequence[int],
                     t_ref: int) -> Dict[str, float]:
    """Model FLOPs of one synthesis call by stage: the style wavs' mels (a
    real FFT a frame and the mel weights), ``model_flops`` at the decode
    budget, and the vocoder (Griffin-Lim's transforms as real FFTs, whatever
    computes them; or K5's hoisted count and the conditioning)."""
    m, a = cfg["model"], cfg["audio"]
    steps = m["decoder"]["max_decode_steps"]
    frames = steps * m["decoder"]["reduction_factor"]
    out = {"reference_mels": float(sum(ref_frames))
           * (fft_frame_flops(a["n_fft"]) + 2.0 * _mel_nonzeros(a))}
    out.update(model_flops(cfg, batch, t_text, t_ref, steps))
    if m["vocoder"]["kind"] == "wavernn":
        v = m["vocoder"]
        out["vocoder"] = 2.0 * batch * frames * m["num_mels"] * v["wavernn_fc_dim"] \
            + wavernn_sample_work(cfg, batch, frames, v["wavernn_fc_dim"], wavernn_weights(cfg),
                                  hoisted=True).flops
    else:
        out["vocoder"] = batch * frames * (2 * a["griffin_lim_iters"] + 1) \
            * fft_frame_flops(a["n_fft"])
    return out


def train_step_flops(cfg: dict, batch: int, t_text: int, frames: int) -> float:
    """A training step's model FLOPs: three times the teacher-forced
    forward's (the backward's products are twice the forward's), the style
    taken from the target mel."""
    steps = frames // cfg["model"]["decoder"]["reduction_factor"]
    return 3.0 * sum(model_flops(cfg, batch, t_text, frames, steps).values())
