"""Kernel microbenchmark of the port (counterpart of ``tools/tpu_kernel_bench.py``):
each CUDA kernel at the JAX tool's shapes, timed against its plain PyTorch
version (where the JAX tool timed the XLA path) and a library call, with a
roofline line of each against the card's published peaks.

    python -m gst_tacotron_tpu_torch.kernel_bench [--steps 200] [--batch 8]
        [--out FILE] [--device cpu] [--quick]

Writes one JSON report (to ``--out``, default stdout); progress on stderr.
Sections, each reading the launch counters (their growth over the section)
to record which kernels served it:

  decode       gst_lj, B=8, ``--steps`` steps, stop threshold 1.0 (K4,
               Bahdanau): kernel and plain ms and µs a step, the marginal µs a
               step and the fixed overhead from 1000 and 2000 steps, parity;
  stft_frames  K3″ on 1024 raw frames;
  stft_routes  8 wavs of 512 frames through K3′, K3 float32, K3 bf16, K3′'s
               bf16 bases and framing + K3″; ``torch.stft`` + mel as the
               library (where JAX timed its conv path); each form's marginal
               (interleaved cycles, median and quartiles), parity;
  refenc       (8, 256, 80) through ``ops/refenc.py::ref_encoder``: K2 float32
               and bf16 (one port kernel serves JAX's "fused" and "batched"
               forms), then K1; the plain path; ``F.conv2d``'s chain as the
               library of the stack; marginals; the floor analysis; parity;
  lsa_decode   gst_r1_location, B=8, 1000 steps (K4's location-sensitive
               branch), both roofline views;
  lstm_decode  gst_taco2 at its cell's shapes, B=32, 192 memory positions,
               1000 steps (K4's LSTM branch, Tacotron 2's 1024-unit LSTMs):
               kernel and plain ms, µs a step, roofline, parity over 50 steps;
  wavernn      4, 16 and 32 streams of 24 frames (K5): µs a sample step,
               samples a second, real-time factor.

Timings on the card are CUDA events around a run of calls after a warm-up,
a synchronize at each end; a marginal is the difference of two loop
lengths over their difference. The work counts (``*_work``) are the
function's unpadded least work from its shapes (no TPU padding to 8 and
128), each bounded by operations or by bytes (``bound``); the kernel table's
bounds in ``PERF.md`` come from them. Without a card the module exits
non-zero unless ``--device cpu`` is given; a CPU run (plain versions, host
clock) reports ``device: "cpu"``, peaks null and no roofline share.
``--quick`` runs every section at a few layers and narrow widths.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import ops
from .config import AudioConfig, Config, apply_overrides, get_preset
from .device import resolve_device


def log(*a) -> None:
    print("[kbench]", *a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# peaks, bounds and roofline
# ---------------------------------------------------------------------------

# Published peaks of one card (NVIDIA's data sheets, SXM parts, dense rates),
# keyed by a substring of its name: TFLOP/s of bf16 on the tensor cores, TF32
# on them, float32 outside them, and GB/s of device memory. They assume the
# card's full power limit (700 W for the H100); the report prints the limit
# the card runs at beside them.
CARD_PEAKS = {
    "h100": {"bf16_tflops": 989.0, "tf32_tflops": 495.0, "f32_tflops": 67.0,
             "hbm_gbps": 3350.0},
}
H100 = CARD_PEAKS["h100"]


def card_peaks(name: str) -> dict:
    """The peaks of the card called ``name``; an unknown card gets null
    peaks ("achieved numbers only", as the JAX tool's unknown chip)."""
    for key, peaks in CARD_PEAKS.items():
        if key in name.lower():
            return {"card": name, **peaks}
    return {"card": name, "bf16_tflops": None, "tf32_tflops": None, "f32_tflops": None,
            "hbm_gbps": None, "note": "unknown card; achieved numbers only"}


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (its first card)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Work(NamedTuple):
    """A kernel call's least work: FLOPs, bytes (each input read once, each
    output written once) and the rate its operations run at ("f32" outside
    the tensor cores, "bf16" on them)."""
    flops: float
    bytes: float
    rate: str = "f32"


def bound(work: Work, peaks: dict = H100):
    """(ms, "operations" or "bytes"): the least time of ``work`` on a card of
    ``peaks``, the larger of its operations over the peak of its rate and its
    bytes over the memory's."""
    t_ops = work.flops / (peaks[f"{work.rate}_tflops"] * 1e12)
    t_bytes = work.bytes / (peaks["hbm_gbps"] * 1e9)
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def roofline(name: str, work: Work, seconds: float, peaks: Optional[dict]) -> dict:
    """Achieved against the least time: the JAX tool's fields, with the
    share of the least time (``fraction_of_sol``) where the peaks are
    known."""
    out = {"kernel": name, "flops": work.flops, "bytes": work.bytes, "rate": work.rate,
           "wall_us": seconds * 1e6, "achieved_tflops": work.flops / seconds / 1e12,
           "achieved_gbps": work.bytes / seconds / 1e9,
           "arithmetic_intensity": work.flops / max(work.bytes, 1)}
    if peaks and peaks.get("hbm_gbps"):
        ms, by = bound(work, peaks)
        out.update({"bound": by, "speed_of_light_us": 1e3 * ms,
                    "fraction_of_sol": 1e-3 * ms / seconds,
                    "pct_peak": 100.0 * out["achieved_tflops"] / peaks[f"{work.rate}_tflops"],
                    "pct_hbm_peak": 100.0 * out["achieved_gbps"] / peaks["hbm_gbps"]})
    return out


# ---------------------------------------------------------------------------
# work counts, one a kernel
# ---------------------------------------------------------------------------


def decode_step_flops(cfg: Config, batch: int, t_mem: int, dense_band: bool = False) -> int:
    """FLOPs of one decoder step from ``cfg``, as ``tools/tpu_kernel_bench.py``
    counts them. ``dense_band=False`` counts the location term as the full
    banded-Toeplitz contraction (the TPU kernel's MXU view, band zeros
    included); ``dense_band=True`` only the band's taps, the useful work
    (K4's direct tap sum)."""
    d = cfg.model.decoder
    a = cfg.model.attention
    m = cfg.model.num_mels
    r = d.reduction_factor
    enc = cfg.model.encoder.output_dim + (cfg.model.gst.style_dim if cfg.model.gst.enabled else 0)
    p1, p2 = d.prenet_dims
    mm = m * p1 + p1 * p2                                         # prenet
    attn_in = p2 + enc
    mm += attn_in * 3 * d.attention_rnn_dim + d.attention_rnn_dim * 3 * d.attention_rnn_dim
    mm += d.attention_rnn_dim * a.dim                             # query projection
    mm += t_mem * a.dim                                           # score reduce
    if a.kind == "location_sensitive":
        c = 2 if a.cumulative else 1
        if dense_band:
            mm += c * t_mem * min(a.location_kernel_size, t_mem) * a.dim
        else:
            mm += c * t_mem * t_mem * a.dim
    mm += t_mem * enc                                             # context
    dec_in = d.attention_rnn_dim + enc
    mm += dec_in * d.decoder_rnn_dim                              # input projection
    mm += 2 * (d.decoder_rnn_dim * 3 * d.decoder_rnn_dim * 2)     # the two GRUs
    mm += (d.decoder_rnn_dim + enc) * (r * m + r)                 # frame and stop
    return 2 * batch * mm


def decode_scan_work(cfg: Config, batch: int, t_mem: int, steps: int, n_weights: int,
                     dense_band: bool = True) -> Work:
    """K4: ``steps`` decoder steps of ``batch`` rows over ``t_mem`` memory
    positions. Bytes: the packed weights, memory, keys and lengths once, then
    each step's frames, stop logits and alignment written. Operations bound
    it (float32)."""
    m = cfg.model
    enc = m.encoder.output_dim + (m.gst.style_dim if m.gst.enabled else 0)
    r = m.decoder.reduction_factor
    nbytes = 4.0 * (n_weights + batch * t_mem * (enc + m.attention.dim) + batch
                    + batch * steps * r * (m.num_mels + 1) + batch * steps * t_mem)
    return Work(float(steps * decode_step_flops(cfg, batch, t_mem, dense_band)), nbytes)


# operations a unit and step that carry an LSTM's cell state besides its
# gates' products: f * c, i * g, their sum, o * tanh(c')
LSTM_CELL_OPS = 4


def lstm_decode_step_flops(cfg: Config, batch: int, t_mem: int) -> float:
    """FLOPs of one step of K4's LSTM branch (Tacotron 2's decoder): the
    prenet, the attention LSTM's four gates over [prenet ; context ; h], the
    query, the scores and the location term as its band's folded taps, the
    context, the decoder LSTM's gates over [h_attn ; context ; h], the frame
    and stop projection, and each LSTM unit's cell arithmetic."""
    d, a, m = cfg.model.decoder, cfg.model.attention, cfg.model.num_mels
    r = d.reduction_factor
    enc = cfg.model.encoder.output_dim + (cfg.model.gst.style_dim if cfg.model.gst.enabled
                                          else 0)
    p1, p2 = d.prenet_dims
    ha, hd = d.attention_rnn_dim, d.decoder_rnn_dim
    c = 2 if a.cumulative else 1
    mm = m * p1 + p1 * p2
    mm += (p2 + enc + ha) * 4 * ha
    mm += ha * a.dim + t_mem * a.dim
    mm += c * t_mem * min(a.location_kernel_size, t_mem) * a.dim
    mm += t_mem * enc
    mm += (ha + enc + hd) * 4 * hd
    mm += (hd + enc) * (r * m + r)
    return 2.0 * batch * mm + LSTM_CELL_OPS * batch * (ha + hd)


def lstm_decode_scan_work(cfg: Config, batch: int, t_mem: int, steps: int,
                          n_weights: int) -> Work:
    """K4's LSTM branch: ``steps`` steps; bytes as ``decode_scan_work``'s."""
    nbytes = decode_scan_work(cfg, batch, t_mem, steps, n_weights).bytes
    return Work(steps * lstm_decode_step_flops(cfg, batch, t_mem), nbytes)


def gru_scan_work(batch: int, t: int, d: int, h: int, directions: int = 1) -> Work:
    """K1: ``directions`` GRU scans of (batch, t, d) to width h, the input and
    recurrent products every step. Bytes: the input, lengths, the outputs,
    initial and final states and the weights."""
    flops = directions * 2.0 * batch * t * (d + h) * 3 * h
    nbytes = 4.0 * (batch * t * d + batch + directions * (batch * t * h + 2 * batch * h
                                                          + (d + h + 2) * 3 * h))
    return Work(flops, nbytes)


def refenc_stack_work(batch: int, t: int, f: int, channels: Sequence[int],
                      bf16: bool = False) -> Work:
    """K2: the stack's 3x3 stride-2 convs (each output pixel's 9 * C_in taps
    a channel; the epilogue is not counted), bytes of the mel, lengths,
    kernels and folded BN, and the last activation. ``bf16`` runs the
    products at the bf16 rate (its operands are rounded inside the kernel;
    its inputs are the same float32 tensors)."""
    flops, h, w, c_in = 0.0, t, f, 1
    wbytes = 0
    for c in channels:
        h, w = (h + 1) // 2, (w + 1) // 2
        flops += 2.0 * batch * h * w * 9 * c_in * c
        wbytes += 9 * c_in * c + 2 * c
        c_in = c
    nbytes = 4.0 * (batch * t * f + batch + wbytes + batch * h * w * c_in)
    return Work(flops, nbytes, "bf16" if bf16 else "f32")


def _stft_sizes(audio: AudioConfig):
    from .ops.stft import live_tap_span, stft_bases

    _, _, n_live = live_tap_span(audio)
    return n_live, stft_bases(audio, "cpu")["mel_w"].numel()


def stft_work(audio: AudioConfig, n_frames: int, in_bytes: float) -> Work:
    """K3, K3′, K3″ in float32: the function's least work, not any kernel's
    method: a real FFT of each n_fft-point frame (2.5 n_fft log2 n_fft, half
    a complex FFT's 5 N log2 N) and a multiply-add for each nonzero mel
    weight; bytes of the input (``in_bytes``), the live window taps and the
    nonzero mel weights read once, the mel and linear outputs written once.
    The magnitudes and the dB maps are not counted."""
    n_live, nnz_mel = _stft_sizes(audio)
    flops = n_frames * (2.5 * audio.n_fft * math.log2(audio.n_fft) + 2.0 * nnz_mel)
    nbytes = in_bytes + 4.0 * (n_live + nnz_mel + n_frames * (audio.num_freq + audio.num_mels))
    return Work(flops, nbytes)


def stft_bf16_work(audio: AudioConfig, n_frames: int, in_bytes: float) -> Work:
    """K3's bf16 mode and K3′'s bf16 bases: no FFT computes the function, so
    its least work is the dense cos and sin products over the live taps and
    the num_freq real bins (the kernel's padding past them is not counted)
    and the mel's nonzero weights, at the bf16 rate; bytes of the input, the
    bf16 bases, the mel weights and the outputs."""
    n_live, nnz_mel = _stft_sizes(audio)
    flops = n_frames * (4.0 * n_live * audio.num_freq + 2.0 * nnz_mel)
    nbytes = (in_bytes + 2.0 * 2 * n_live * audio.num_freq + 4.0 * nnz_mel
              + 4.0 * n_frames * (audio.num_freq + audio.num_mels))
    return Work(flops, nbytes, "bf16")


def wavernn_sample_work(cfg: Config, batch: int, frames: int, cond_dim: int, n_weights: int,
                        hoisted: bool = False) -> Work:
    """K5: ``batch`` rows of ``frames`` x hop samples, each a GRU step (input
    and recurrent products), two dense layers and the class scores. As the
    TPU kernel computes it the input product runs every sample; ``hoisted``
    counts it once a class (the sample embedding) and once a frame (the
    conditioning) instead. Bytes: the weights, the conditioning, the classes."""
    v = cfg.model.vocoder
    h, f, k = v.wavernn_gru_dim, v.wavernn_fc_dim, 2 ** v.wavernn_bits
    n = frames * v.wavernn_hop
    tail = h * 3 * h + h * f + f * k
    if hoisted:
        flops = 2.0 * ((k + batch * frames) * cond_dim * 3 * h + tail * batch * n)
    else:
        flops = 2.0 * (cond_dim * 3 * h + tail) * batch * n
    return Work(flops, 4.0 * (n_weights + batch * frames * cond_dim + batch * n))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timer:
    """Seconds a call: CUDA events around a run of calls on the card (after a
    warm-up, a synchronize at each end), the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.dev = dev

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def run(self, fn: Callable, n: int) -> float:
        """Seconds of ``n`` back-to-back calls (no warm-up)."""
        self.sync()
        if self.dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return time.perf_counter() - t0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize(self.dev)
        return 1e-3 * start.elapsed_time(end)

    def __call__(self, fn: Callable, iters: int, name: str = "", warmup: int = 1) -> float:
        for _ in range(warmup):
            fn()
        dt = self.run(fn, iters) / iters
        if name:
            log(f"{name}: {dt * 1e3:.3f} ms")
        return dt

    def marginal(self, forms: Dict[str, Callable], n_lo: int, n_hi: int, cycles: int):
        """{form: (median, [q1, q3])} seconds a call: per cycle, every form's
        (t(n_hi calls) - t(n_lo calls)) / (n_hi - n_lo), the forms
        interleaved round-robin so that drift spreads over all of them."""
        per = {k: [] for k in forms}
        for fn in forms.values():
            fn()
        for _ in range(cycles):
            for k, fn in forms.items():
                per[k].append((self.run(fn, n_hi) - self.run(fn, n_lo)) / (n_hi - n_lo))
        out = {}
        for k, xs in per.items():
            q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
            out[k] = (statistics.median(xs), [q[0], q[2]])
        return out


def max_err(a, b) -> float:
    a = a if isinstance(a, (list, tuple)) else [a]
    b = b if isinstance(b, (list, tuple)) else [b]
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

# --quick: every section at narrow widths and a few layers (the CPU test)
QUICK_OVERRIDES = {
    "audio.n_fft": 512, "audio.hop_length": 128, "audio.win_length": 512,
    "model.num_freq": 257, "model.encoder.cbhg_gru_dim": 8, "model.attention.dim": 16,
    "model.decoder.prenet_dims": [16, 8], "model.decoder.attention_rnn_dim": 16,
    "model.decoder.decoder_rnn_dim": 16, "model.gst.ref_conv_channels": [4, 4, 8],
    "model.gst.ref_gru_dim": 16, "model.gst.style_dim": 16,
    "model.vocoder.wavernn_gru_dim": 16, "model.vocoder.wavernn_fc_dim": 16,
    "model.vocoder.wavernn_bits": 4, "model.vocoder.wavernn_hop": 16,
}
# (the JAX tool's shapes, --quick's)
SHAPES = {
    "full": dict(text=64, marginal_steps=(1000, 2000), stft_frames=1024, route_batch=8,
                 route_frames=512, stft_cycles=8, stft_loops=(4, 34), refenc=(8, 256),
                 refenc_loops=(2, 10), lsa_steps=1000, streams=(4, 16, 32),
                 wavernn_frames=24, iters=10, lstm=(32, 192, 1000, 50)),
    "quick": dict(text=8, marginal_steps=(4, 8), stft_frames=16, route_batch=2,
                  route_frames=8, stft_cycles=2, stft_loops=(1, 3), refenc=(2, 64),
                  refenc_loops=(1, 2), lsa_steps=6, streams=(1, 2), wavernn_frames=2,
                  iters=1, lstm=(2, 8, 6, 3)),
}

# the JAX package's kernel-test tolerances (ROADMAP.md, "Each tuning PR keeps")
DECODE_TOL = 1e-4        # tests/test_decode_pallas.py
STFT_TOL = 5e-3          # tests/test_pallas.py, normalized dB
REFENC_TOL = 1e-5        # tests/test_refenc_pallas.py
REFENC_BF16_TOL = 0.05   # tests/test_refenc_pallas.py, the bf16 operand mode
WAVERNN_GAP_TOL = 1e-3   # the card tests' score gap (greedy classes exact in JAX's test)


class Bench:
    """One run's state: device, timer, peaks, the report and its checks."""

    def __init__(self, dev: torch.device, quick: bool, steps: int, batch: int):
        self.dev, self.quick, self.steps, self.batch = dev, quick, steps, batch
        self.shape = SHAPES["quick" if quick else "full"]
        self.iters = self.shape["iters"]
        self.time = Timer(dev)
        self.rng = np.random.default_rng(0)
        over = QUICK_OVERRIDES if quick else {}
        self.cfg = apply_overrides(get_preset("gst_lj"), {
            **over, "model.decoder.max_decode_steps": steps,
            "model.decoder.stop_threshold": 1.0})
        self.cfg3 = apply_overrides(get_preset("gst_r1_location"), over)
        self.cfg_taco2 = apply_overrides(get_preset("gst_taco2"), over)
        if dev.type == "cuda":
            card = card_line()
            self.peaks = card_peaks(card.split(",")[0].strip())
            self.peaks["power_limit"] = card.split(",")[-1].strip()
        else:
            card, self.peaks = None, None
        self.report = {"device": dev.type if dev.type == "cpu"
                       else torch.cuda.get_device_name(dev), "card": card,
                       "steps": steps, "batch": batch, "quick": quick,
                       "card_peaks": self.peaks, "roofline": [], "sections": {},
                       "checks": []}

    # -- bookkeeping --------------------------------------------------------

    def section(self, name: str, kernels: Sequence[str], fn: Callable) -> None:
        """Run section ``fn``, recording the growth of the launch counters over
        it and whether each of ``kernels`` launched (on the card)."""
        t0 = time.perf_counter()
        self.time.sync()
        before = ops.launch_counts()
        fn()
        self.time.sync()
        launches = {k: n - before[k] for k, n in ops.launch_counts().items()
                    if n != before[k]}
        self.report["sections"][name] = {
            "kernels": list(kernels), "launches": launches,
            "kernels_launched": self.dev.type != "cuda" or all(launches.get(k) for k in kernels),
            "wall_s": time.perf_counter() - t0}
        log(f"{name} done in {time.perf_counter() - t0:.1f} s; launches {launches}")

    def check(self, section: str, name: str, err: float, tol: float, reason: str) -> float:
        self.report["checks"].append({"section": section, "name": name, "max_err": err,
                                      "tol": tol, "tol_reason": reason})
        return err

    def roof(self, name: str, work: Work, seconds: float) -> None:
        self.report["roofline"].append(roofline(name, work, seconds, self.peaks))

    def failures(self) -> List[str]:
        """What a run on the card must not show: a section whose kernels did
        not launch, a check over its tolerance, a roofline share over 1.05."""
        out = [f"section {k}: launched {v['launches']}, expected each of {v['kernels']}"
               for k, v in self.report["sections"].items() if not v["kernels_launched"]]
        out += [f"{c['section']}/{c['name']}: {c['max_err']} > {c['tol']}"
                for c in self.report["checks"] if not c["max_err"] <= c["tol"]]
        out += [f"roofline {r['kernel']}: fraction_of_sol {r['fraction_of_sol']} > 1.05"
                for r in self.report["roofline"] if r.get("fraction_of_sol", 0.0) > 1.05]
        return out

    def t32(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(self.dev)

    # -- decode (K4) --------------------------------------------------------

    def _decoder(self, cfg: Config, batch: int, seed: int, t: Optional[int] = None):
        """A seeded decoder cell of ``cfg`` (its ``decoder.kind``) and its
        packed weights, random memory of ``batch`` rows of ``t`` positions
        (the shape's text by default; as tests/test_torch_cuda.py's main-path
        K4 test makes it), its keys and full lengths."""
        from .models.decoder import CELLS
        from .weights import init_weights

        m = cfg.model
        mem_dim = m.encoder.output_dim + m.gst.style_dim
        cell = CELLS[m.decoder.kind](m.decoder, m.attention, m.num_mels, mem_dim)
        init_weights(cell, seed=seed)
        cell = cell.to(self.dev)
        packed = cell.pack()
        t = t or self.shape["text"]
        memory = self.t32(self.rng.normal(0, 0.5, (batch, t, mem_dim)))
        with torch.no_grad():
            keys = cell.precompute_keys(memory).contiguous()
        lengths = torch.full((batch,), t, device=self.dev, dtype=torch.int64)
        return packed, memory, keys, lengths

    def _decode_fns(self, cfg: Config, packed, memory, keys, lengths):
        from .ops.decode import decode_scan, decode_scan_plain

        kw = dict(dec_cfg=cfg.model.decoder, attn_cfg=cfg.model.attention,
                  num_mels=cfg.model.num_mels)
        kernel = lambda steps: decode_scan(packed, memory, keys, lengths, steps=steps, **kw)
        plain = lambda steps: decode_scan_plain(packed, memory, keys, lengths, steps=steps, **kw)
        return kernel, plain

    def decode(self) -> None:
        cfg, b, steps, r = self.cfg, self.batch, self.steps, self.report
        packed, memory, keys, lengths = self._decoder(cfg, b, seed=0)
        kernel, plain = self._decode_fns(cfg, packed, memory, keys, lengths)
        dt_k = self.time(lambda: kernel(steps), max(1, self.iters // 2), "kernel decode")
        dt_p = self.time(lambda: plain(steps), 1, "plain decode")
        r["kernel_decode_ms"], r["kernel_us_per_step"] = 1e3 * dt_k, 1e6 * dt_k / steps
        r["plain_decode_ms"], r["plain_us_per_step"] = 1e3 * dt_p, 1e6 * dt_p / steps
        r["decode_speedup"] = dt_p / dt_k
        n0, n1 = self.shape["marginal_steps"]
        k0 = self.time(lambda: kernel(n0), 3 if not self.quick else 1, f"kernel decode {n0}")
        k1 = self.time(lambda: kernel(n1), 3 if not self.quick else 1, f"kernel decode {n1}")
        p0 = self.time(lambda: plain(n0), 1, f"plain decode {n0}", warmup=0)
        p1 = self.time(lambda: plain(n1), 1, f"plain decode {n1}", warmup=0)
        r["bahdanau_marginal"] = {
            "kernel_us_per_step_marginal": (k1 - k0) / (n1 - n0) * 1e6,
            "kernel_fixed_overhead_us": (2 * k0 - k1) * 1e6,
            "plain_us_per_step_marginal": (p1 - p0) / (n1 - n0) * 1e6,
            "plain_fixed_overhead_us": (2 * p0 - p1) * 1e6,
            "marginal_speedup": ((p1 - p0) / (k1 - k0)
                                 if min(p1 - p0, k1 - k0) / (n1 - n0) > 0.2e-6 else None),
            "note": f"marginal = (t_{n1} - t_{n0}) / {n1 - n0}: the long-decode cost a step "
                    "with the fixed launch and set-up removed; the speedup is omitted where "
                    "either marginal is below 0.2 us a step"}
        n_w = sum(x.numel() for x in packed.values())
        self.roof("kernel_decode", decode_scan_work(cfg, b, memory.shape[1], steps, n_w), dt_k)
        r["decode_parity_max_err"] = self.check(
            "decode", "kernel_vs_plain_mel", max_err(kernel(steps)[0], plain(steps)[0]),
            DECODE_TOL, "tests/test_decode_pallas.py's tolerance: float32 sums in another "
            "order fed back through the steps")

    def lsa_decode(self) -> None:
        cfg, b, steps, r = self.cfg3, self.batch, self.shape["lsa_steps"], self.report
        packed, memory, keys, lengths = self._decoder(cfg, b, seed=8)
        kernel, plain = self._decode_fns(cfg, packed, memory, keys, lengths)
        dt_k = self.time(lambda: kernel(steps), 3 if not self.quick else 1, "kernel LSA decode")
        dt_p = self.time(lambda: plain(steps), 1, "plain LSA decode", warmup=0)
        r["kernel_lsa_decode_ms"], r["kernel_lsa_us_per_step"] = 1e3 * dt_k, 1e6 * dt_k / steps
        r["plain_lsa_decode_ms"], r["lsa_decode_speedup"] = 1e3 * dt_p, dt_p / dt_k
        n_w = sum(x.numel() for x in packed.values())
        t = memory.shape[1]
        self.roof("kernel_lsa_decode", decode_scan_work(cfg, b, t, steps, n_w, False), dt_k)
        self.roof("kernel_lsa_decode_useful_band",
                  decode_scan_work(cfg, b, t, steps, n_w, True), dt_k)
        r["lsa_decode_parity_max_err"] = self.check(
            "lsa_decode", "kernel_vs_plain_mel", max_err(kernel(steps)[0], plain(steps)[0]),
            DECODE_TOL, "tests/test_decode_pallas.py's tolerance")

    def lstm_decode(self) -> None:
        cfg, r = self.cfg_taco2, self.report
        b, t, steps, parity_steps = self.shape["lstm"]
        packed, memory, keys, lengths = self._decoder(cfg, b, seed=9, t=t)
        kernel, plain = self._decode_fns(cfg, packed, memory, keys, lengths)
        dt_k = self.time(lambda: kernel(steps), 3 if not self.quick else 1,
                         "kernel LSTM decode")
        dt_p = self.time(lambda: plain(steps), 1, "plain LSTM decode", warmup=0)
        r["kernel_lstm_decode_ms"], r["kernel_lstm_us_per_step"] = 1e3 * dt_k, 1e6 * dt_k / steps
        r["plain_lstm_decode_ms"], r["lstm_decode_speedup"] = 1e3 * dt_p, dt_p / dt_k
        r["lstm_decode_shape"] = {"batch": b, "memory_positions": t, "steps": steps}
        n_w = sum(x.numel() for x in packed.values())
        r["lstm_decode_weight_mb"] = 4e-6 * n_w
        self.roof("kernel_lstm_decode", lstm_decode_scan_work(cfg, b, t, steps, n_w), dt_k)
        r["lstm_decode_parity_max_err"] = self.check(
            "lstm_decode", "kernel_vs_plain_mel",
            max_err(kernel(parity_steps)[0], plain(parity_steps)[0]), DECODE_TOL,
            "tests/test_decode_pallas.py's tolerance, over the card test's 50 steps: float32 "
            "sums of up to 1792 terms in another order, carried by the cell states")

    # -- STFT (K3, K3′, K3″) ------------------------------------------------

    def stft_frames(self) -> None:
        from .ops.stft import (db_normalize, stft_bases, stft_features_frames,
                               stft_features_frames_plain)

        a, n, r = self.cfg.audio, self.shape["stft_frames"], self.report
        frames = self.t32(self.rng.standard_normal((n, a.n_fft)))
        bases = stft_bases(a, self.dev)
        window = torch.from_numpy(np.pad(
            0.5 - 0.5 * np.cos(2 * np.pi * np.arange(a.win_length) / a.win_length),
            ((a.n_fft - a.win_length) // 2, (a.n_fft - a.win_length + 1) // 2)
        ).astype(np.float32)).to(self.dev)
        mel_t = bases["mel_t"][: a.num_freq]

        def library():
            spec = torch.fft.rfft(frames * window, n=a.n_fft, dim=-1).abs()
            return db_normalize(spec @ mel_t, a), db_normalize(spec, a)

        kernel = lambda: stft_features_frames(frames, a, bases)
        dt = self.time(kernel, self.iters * 2, f"K3'' ({n} frames)")
        r["kernel_stft_ms_1024frames"] = 1e3 * dt
        r["plain_stft_ms_1024frames"] = 1e3 * self.time(
            lambda: stft_features_frames_plain(frames, a, bases), self.iters, "plain K3''")
        r["library_stft_ms_1024frames"] = 1e3 * self.time(library, self.iters, "rfft + mel")
        work = stft_work(a, n, 4.0 * n * _stft_sizes(a)[0])
        r["kernel_stft_tflops"] = work.flops / dt / 1e12
        self.roof("kernel_stft_1024f", work, dt)
        r["stft_frames_parity_max_err"] = self.check(
            "stft_frames", "kernel_vs_plain", max_err(kernel(), stft_features_frames_plain(
                frames, a, bases)), STFT_TOL, "tests/test_pallas.py's tolerance (normalized "
            "dB): an FFT's float32 sums against the plain DFT products")

    def stft_routes(self) -> None:
        from .dsp.torch_dsp import TorchDSP
        from .ops.stft import (db_normalize, stft_bases, stft_features, stft_features_frames,
                               stft_features_fused, stft_features_plain)

        a, r = self.cfg.audio, self.report
        bb, t_frames = self.shape["route_batch"], self.shape["route_frames"]
        wav_len = (t_frames - 1) * a.hop_length + a.n_fft
        w = self.t32(0.3 * self.rng.standard_normal((bb, wav_len)))
        bases = stft_bases(a, self.dev)
        dsp = TorchDSP(a, self.dev)
        mel_t = bases["mel_t"][: a.num_freq]
        win = dsp.window

        def library():
            spec = torch.stft(w, a.n_fft, a.hop_length, window=win, center=False,
                              return_complex=True).abs().transpose(1, 2)
            return db_normalize(spec @ mel_t, a), db_normalize(spec, a)

        def frame_then_kernel():
            fr = dsp.frame_precentered(w)
            mel, lin = stft_features_frames(fr.reshape(-1, a.n_fft), a, bases)
            return mel.reshape(bb, -1, a.num_mels), lin.reshape(bb, -1, a.num_freq)

        forms = {"library": library,
                 "fused": lambda: stft_features_fused(w, a, bases),
                 "resident_f32": lambda: stft_features(w, a, bases),
                 "resident_bf16": lambda: stft_features(w, a, bases, bf16=True),
                 "fused_bf16_bases": lambda: stft_features_fused(w, a, bases, bf16_bases=True),
                 "frame_then_kernel": frame_then_kernel}
        ms = {k: 1e3 * self.time(fn, self.iters, f"stft {k} ({bb}x{t_frames}f)")
              for k, fn in forms.items()}
        ms["plain"] = 1e3 * self.time(lambda: dsp.features_precentered(w), self.iters,
                                      "stft plain")
        r["stft_paths_ms"] = {
            "library_torch_stft": ms["library"], "kernel_fused_framing": ms["fused"],
            "kernel_resident_f32": ms["resident_f32"],
            "kernel_resident_bf16": ms["resident_bf16"],
            "kernel_fused_bf16_bases": ms["fused_bf16_bases"],
            "kernel_frame_then_kernel": ms["frame_then_kernel"], "plain": ms["plain"],
            "resident_bf16_vs_library_speedup": ms["library"] / ms["resident_bf16"]}
        n_frames = bb * t_frames
        in_bytes = 4.0 * w.numel()
        f32_work, bf16_work = stft_work(a, n_frames, in_bytes), stft_bf16_work(a, n_frames,
                                                                               in_bytes)
        self.roof("kernel_stft_fused_framing", f32_work, 1e-3 * ms["fused"])
        lo, hi = self.shape["stft_loops"]
        marg = self.time.marginal({k: forms[k] for k in ("library", "fused", "resident_f32",
                                                         "resident_bf16")},
                                  lo, hi, self.shape["stft_cycles"])
        r["stft_marginal_us"] = {k: 1e6 * m for k, (m, _) in marg.items()}
        r["stft_marginal_iqr_us"] = {k: [1e6 * q for q in iqr] for k, (_, iqr) in marg.items()}
        for k, (m, _) in marg.items():
            if k != "library":
                self.roof(f"stft_{k}_marginal", bf16_work if "bf16" in k else f32_work, m)
        plain32 = stft_features_plain(w, a, bases)
        r["stft_fused_parity_max_err"] = self.check(
            "stft_routes", "fused_vs_plain", max_err(forms["fused"](), plain32), STFT_TOL,
            "tests/test_pallas.py's tolerance (normalized dB)")
        r["stft_resident_f32_parity_max_err"] = self.check(
            "stft_routes", "resident_f32_vs_plain", max_err(forms["resident_f32"](), plain32),
            STFT_TOL, "tests/test_pallas.py's tolerance (normalized dB)")
        bf16 = forms["resident_bf16"]()
        r["stft_resident_bf16_parity_max_err"] = self.check(
            "stft_routes", "resident_bf16_vs_plain_bf16",
            max_err(bf16, stft_features_plain(w, a, bases, bf16=True)), STFT_TOL,
            "tests/test_pallas.py's tolerance (normalized dB): the same bf16 operands, float32 "
            "sums in another order; a magnitude on a bf16 rounding boundary moves one step")
        r["stft_resident_bf16_vs_f32_max_err"] = max_err(bf16, plain32)
        r["stft_frame_then_kernel_parity_max_err"] = self.check(
            "stft_routes", "frame_then_kernel_vs_plain", max_err(frame_then_kernel(), plain32),
            STFT_TOL, "tests/test_pallas.py's tolerance (normalized dB)")

    # -- reference encoder (K2, K1) ------------------------------------------

    def refenc(self) -> None:
        import torch.nn.functional as F

        from .models.gst import ReferenceEncoder
        from .ops.refenc import fold_bn, ref_encoder, refenc_stack
        from .weights import init_weights

        g, r = self.cfg.model.gst, self.report
        b, t = self.shape["refenc"]
        f = self.cfg.model.num_mels
        enc = ReferenceEncoder(g, f)
        init_weights(enc, seed=0)
        with torch.no_grad():      # running statistics away from identity
            for i in range(len(g.ref_conv_channels)):
                bn = getattr(enc, f"bn_{i}")
                bn.mean.copy_(torch.from_numpy(self.rng.normal(0, 0.3, bn.mean.shape)))
                bn.var.copy_(torch.from_numpy(self.rng.uniform(0.5, 2.0, bn.var.shape)))
        enc = enc.to(self.dev).eval()
        mel = self.t32(self.rng.random((b, t, f)))
        channels = list(g.ref_conv_channels)
        forms = {"plain": lambda: ref_encoder(enc, mel, None, plain=True, bf16=False),
                 "kernel": lambda: ref_encoder(enc, mel, None, bf16=False),
                 "kernel_bf16": lambda: ref_encoder(enc, mel, None, bf16=True)}
        folded = [fold_bn(getattr(enc, f"bn_{i}").scale, getattr(enc, f"bn_{i}").bias,
                          getattr(enc, f"bn_{i}").mean, getattr(enc, f"bn_{i}").var)
                  for i in range(len(channels))]
        kernels = [getattr(enc, f"conv_{i}").kernel for i in range(len(channels))]
        stack = lambda bf16: refenc_stack(mel, kernels, [s for s, _ in folded],
                                          [x for _, x in folded], bf16=bf16)
        wts = [k.permute(3, 2, 0, 1).contiguous() for k in kernels]

        def library():
            x = mel[:, None]                                      # NCHW
            for wt, (sc, bi) in zip(wts, folded):
                hh, ww = x.shape[2], x.shape[3]
                ph = max(0, ((hh + 1) // 2 - 1) * 2 + 3 - hh)
                pw = max(0, ((ww + 1) // 2 - 1) * 2 + 3 - ww)
                x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
                x = torch.relu(F.conv2d(x, wt, stride=2) * sc[:, None, None]
                               + bi[:, None, None])
            return x

        with torch.no_grad():
            ms = {k: 1e3 * self.time(fn, self.iters * 2, f"ref encoder {k} ({b}x{t})")
                  for k, fn in forms.items()}
            stack_s = {k: self.time(lambda: stack(k == "bf16"), self.iters * 2, f"stack {k}")
                       for k in ("f32", "bf16")}
            lib_s = self.time(library, self.iters * 2, "F.conv2d chain")
            lo, hi = self.shape["refenc_loops"]
            marg = self.time.marginal(forms, lo, hi, 3 if not self.quick else 1)
            outs = {k: fn() for k, fn in forms.items()}
            plain_bf16 = ref_encoder(enc, mel, None, plain=True, bf16=True)
        tag = f"{b}x{t}"
        r[f"ref_encoder_plain_ms_{tag}"] = ms["plain"]
        r[f"ref_encoder_kernel_ms_{tag}"] = ms["kernel"]
        r[f"ref_encoder_kernel_bf16_ms_{tag}"] = ms["kernel_bf16"]
        r["ref_encoder_kernel_speedup_vs_plain"] = ms["plain"] / ms["kernel"]
        r["ref_encoder_stack_ms"] = {"kernel": 1e3 * stack_s["f32"],
                                     "kernel_bf16": 1e3 * stack_s["bf16"],
                                     "library_conv2d": 1e3 * lib_s}
        r["ref_encoder_forms_note"] = (
            "one port kernel (csrc/refenc_stack.cu) serves the JAX package's 'fused' "
            "(per-element grid) and 'batched' forms; its bf16 mode is the batched form's")
        r["ref_encoder_marginal_us"] = {k: 1e6 * m for k, (m, _) in marg.items()}
        w32, w16 = (refenc_stack_work(b, t, f, channels, bf16) for bf16 in (False, True))
        self.roof("ref_encoder_conv_stack_kernel", w32, stack_s["f32"])
        self.roof("ref_encoder_conv_stack_kernel_bf16", w16, stack_s["bf16"])
        for k in ("kernel", "kernel_bf16"):
            self.roof(f"ref_encoder_{k}_marginal", w16 if k.endswith("bf16") else w32,
                      marg[k][0])
        true_weights = sum(p.numel() for p in enc.parameters()) + sum(
            getattr(enc, f"bn_{i}").mean.numel() * 2 for i in range(len(channels)))
        true_min_bytes = 4 * (mel.numel() + true_weights + b * g.ref_gru_dim)
        m32, m16 = marg["kernel"][0], marg["kernel_bf16"][0]
        floor = {"shape": f"({b}, {t}, {f}) incl. the GRU", "true_min_bytes": true_min_bytes,
                 "kernel_flops": w32.flops, "kernel_bytes": w32.bytes,
                 "measured_kernel_us": 1e6 * m32, "measured_kernel_bf16_us": 1e6 * m16}
        if self.peaks and self.peaks.get("hbm_gbps"):
            bw, tf32, tf16 = (self.peaks["hbm_gbps"] * 1e9, self.peaks["f32_tflops"] * 1e12,
                              self.peaks["bf16_tflops"] * 1e12)
            floor.update({
                "true_memory_floor_us": true_min_bytes / bw * 1e6,
                "kernel_compute_floor_f32_us": w32.flops / tf32 * 1e6,
                "kernel_compute_floor_bf16_us": w32.flops / tf16 * 1e6,
                "kernel_vs_own_f32_compute_floor": (w32.flops / tf32) / m32,
                "kernel_bf16_vs_own_bf16_compute_floor": (w32.flops / tf16) / m16,
                "true_floor_fraction_f32": (true_min_bytes / bw) / m32})
        floor["note"] = (
            "the port's kernel does the direct convolution's FLOPs (no dense banded phase "
            "matrices), on the CUDA cores in both modes, so its own floor is the float32 "
            "rate's (67 TFLOP/s) and bf16 is the 989 TFLOP/s tensor cores' it does not use "
            "yet; the marginals include the reference GRU (K1)")
        r["ref_encoder_floor_analysis"] = floor
        r["ref_encoder_parity_max_err"] = self.check(
            "refenc", "kernel_vs_plain", max_err(outs["kernel"], outs["plain"]), REFENC_TOL,
            "tests/test_refenc_pallas.py's tolerance: float32 sums in another order")
        r["ref_encoder_bf16_parity_max_err"] = self.check(
            "refenc", "kernel_bf16_vs_plain_bf16", max_err(outs["kernel_bf16"], plain_bf16),
            REFENC_BF16_TOL, "tests/test_refenc_pallas.py's bf16 budget: the same bf16 "
            "operands, float32 sums in another order")
        r["ref_encoder_bf16_vs_f32_max_err"] = self.check(
            "refenc", "kernel_bf16_vs_f32", max_err(outs["kernel_bf16"], outs["kernel"]),
            REFENC_BF16_TOL, "tests/test_refenc_pallas.py's bf16 budget against float32")

    # -- WaveRNN (K5) -------------------------------------------------------

    def wavernn(self) -> None:
        from .ops.wavernn import score_gaps, wavernn_sample
        from .weights import build_wavernn

        cfg, r = self.cfg, self.report
        v = cfg.model.vocoder
        model = build_wavernn(cfg, seed=0, device=self.dev)
        packed = model.pack()
        n_w = sum(x.numel() for x in packed.values())
        frames = self.shape["wavernn_frames"]
        s = frames * v.wavernn_hop
        r["wavernn_scaling"] = []
        for wb in self.shape["streams"]:
            mel = self.t32(self.rng.standard_normal((wb, frames, cfg.model.num_mels)))
            with torch.no_grad():
                cond = model.cond_frames(mel).contiguous()
            fn = lambda: wavernn_sample(packed, cond, hop=v.wavernn_hop, seed=7)
            dt = self.time(fn, 3 if not self.quick else 1, f"wavernn sample B={wb}")
            r["wavernn_scaling"].append({
                "streams": wb, "us_per_sample_step": dt / s * 1e6,
                "aggregate_samples_per_sec": wb * s / dt,
                "aggregate_realtime_x": wb * s / dt / cfg.audio.sample_rate})
            self.roof(f"kernel_wavernn_{wb}_streams",
                      wavernn_sample_work(cfg, wb, frames, cond.shape[-1], n_w), dt)
        with torch.no_grad():
            greedy = wavernn_sample(packed, cond, hop=v.wavernn_hop, greedy=True)
            gaps = score_gaps(packed, cond, greedy, hop=v.wavernn_hop, greedy=True)
        r["wavernn_greedy_score_gap_max"] = self.check(
            "wavernn", "greedy_score_gap", float(gaps.max()), WAVERNN_GAP_TOL,
            "score units: each greedy class against the plain teacher-forced pass's best")


def run(device=None, steps: int = 200, batch: int = 8, quick: bool = False) -> dict:
    """Every section; returns the report (``failures`` lists what a run must
    not show)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from .ops.build import build_all

        t0 = time.perf_counter()
        build_all(ops.all_kernels())
        log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    bench = Bench(dev, quick, steps, batch)
    with torch.no_grad():
        bench.section("decode", ["decode_scan"], bench.decode)
        bench.section("stft_frames", ["stft_frames"], bench.stft_frames)
        bench.section("stft_routes", ["stft_fused", "stft_features", "stft_features:bf16",
                                      "stft_frames"], bench.stft_routes)
        bench.section("refenc", ["refenc_stack", "refenc_stack:bf16", "gru_scan"],
                      bench.refenc)
        bench.section("lsa_decode", ["decode_scan", "decode_scan:location_sensitive"],
                      bench.lsa_decode)
        bench.section("lstm_decode", ["decode_scan", "decode_scan:lstm"], bench.lstm_decode)
        bench.section("wavernn", ["wavernn_sample"], bench.wavernn)
    bench.report["failures"] = bench.failures()
    return bench.report


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Kernel microbenchmark of the PyTorch port")
    p.add_argument("--steps", type=int, default=None,
                   help="decode steps (gst_lj; default 200, with --quick 8)")
    p.add_argument("--batch", type=int, default=8, help="decode rows")
    p.add_argument("--out", default=None, help="report file (default stdout)")
    p.add_argument("--device", default=None, help="default cuda; 'cpu' runs the plain "
                                                  "versions on the CPU (no device metric)")
    p.add_argument("--quick", action="store_true", help="every section at narrow widths")
    args = p.parse_args(argv)
    steps = args.steps or (8 if args.quick else 200)
    if steps < 1 or args.batch < 1:
        p.error("--steps and --batch must be >= 1")
    report = run(args.device, steps, args.batch, args.quick)
    text = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        print(text)
    log("report written")
    if report["failures"]:
        log("FAILED: " + "; ".join(report["failures"]))
        sys.exit(1)


if __name__ == "__main__":
    main()
