#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gst_tacotron_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build: nvcc compiles every CUDA kernel of the port (one process per
   source, all at once) and the libraries are loaded;
2. kernels: K1-K5, K3′, K3″ and K4's location-sensitive branch each run at
   the shapes their main path gives them and are held against their plain
   PyTorch versions on the card, in float32 with TF32 off; each is timed
   beside its plain version, a PyTorch library yardstick where one exists,
   and its least possible time on an H100;
3. paths: three configurations synthesize through ``Synthesizer`` on the
   card with seeded random weights, B=32 texts of 64 tokens and 32
   reference wavs of 128 frames, stop threshold 1.0 (every step decodes):
     gst_lj           200 decode steps at r=2 (the bench workload's cut),
                      15 Griffin-Lim iterations with momentum 0.99;
     gst_r1_location  its 1000 steps at r=1, its 30 Griffin-Lim iterations;
     gst_wavernn      the WaveRNN vocoder, decode cut to 64 steps (128
                      frames, 32,768 samples a row).
   Before each path every launch counter is set to 0, and after it the
   counts must show that the path went through each of its kernels; outputs
   must be finite with the expected shapes, the wav within [-1, 1], and the
   path must agree with the plain path on the card;
4. corpus: the training-corpus path on gst_lj (192 synthetic utterances of
   varied length): patterns with device features (K3), every route of the
   feature extractor and ``KernelDSP`` (K3′, K3″), the bucketed loader in
   both transports and the wav-transport features on the card, each held
   against the host numpy oracle, with launch counts per route.

It prints one JSON line per kernel check and per path, one
``{"kernels": [...]}`` line, the card's name and power limit, and last
``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth. Every kernel of this slice computes in
# float32 on the CUDA cores.
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

B = 32
TEXT_TOKENS = 64
REF_SAMPLES = 32512     # 1 + 32512 // 256 = 128 mel frames


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(torch, fn, iters: int = 5, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# K1: GRU scan
# ---------------------------------------------------------------------------


def check_gru(torch, rng, dev):
    from gst_tacotron_tpu_torch.ops.gru import gru_scan, gru_scan_plain

    h = 128
    # (T, D, directions) of the main path's GRU scans: encoder BiGRU,
    # post-net BiGRU, reference-encoder GRU
    calls = [(TEXT_TOKENS, 128, (False, True)), (400, 128, (False, True)), (2, 256, (False,))]
    t32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    err, flops, nbytes, jobs = 0.0, 0.0, 0.0, []
    for t, d, dirs in calls:
        lim_i, lim_h = np.sqrt(6 / (d + 3 * h)), np.sqrt(6 / (4 * h))
        wi = t32(rng.uniform(-lim_i, lim_i, (d, 3 * h)))
        wh = t32(rng.uniform(-lim_h, lim_h, (h, 3 * h)))
        bi, bh = t32(rng.normal(0, 0.1, 3 * h)), t32(rng.normal(0, 0.1, 3 * h))
        xs = t32(rng.normal(0, 1, (B, t, d)))
        h0 = torch.zeros(B, h, device=dev)
        ragged = torch.from_numpy(rng.integers(1, t + 1, B)).to(dev)
        full = torch.full((B,), t, device=dev, dtype=torch.int64)
        for rev in dirs:
            for lens in (ragged, full):
                got = gru_scan(xs, h0, wi, bi, wh, bh, lengths=lens, reverse=rev)
                ref = gru_scan_plain(xs, h0, wi, bi, wh, bh, lengths=lens, reverse=rev)
                err = max(err, max_err(got, ref))
            jobs.append((xs, h0, wi, bi, wh, bh, full, rev))
            flops += 2.0 * B * t * (d + h) * 3 * h
            nbytes += 4.0 * (B * t * d + B * t * h + 2 * B * h + (d + h + 2) * 3 * h + B)

    def run(fn):
        return lambda: [fn(*j[:6], lengths=j[6], reverse=j[7]) for j in jobs]

    gru_mods = []
    for xs, h0, wi, bi, wh, bh, _, rev in jobs:
        d = wi.shape[0]
        m = torch.nn.GRU(d, h, batch_first=True).to(dev)
        reorder = lambda w: torch.cat([w[..., h:2 * h], w[..., :h], w[..., 2 * h:]], -1)
        with torch.no_grad():
            m.weight_ih_l0.copy_(reorder(wi).T)
            m.weight_hh_l0.copy_(reorder(wh).T)
            m.bias_ih_l0.copy_(reorder(bi))
            m.bias_hh_l0.copy_(reorder(bh))
        gru_mods.append((m, xs, h0, rev))

    def library():
        with torch.no_grad():
            for m, xs, h0, rev in gru_mods:
                m(torch.flip(xs, [1]) if rev else xs, h0[None])

    torch.cuda.synchronize()
    ms = time_ms(torch, run(gru_scan))
    plain = time_ms(torch, run(gru_scan_plain), iters=2)
    lib = time_ms(torch, library)
    b_ms, b_by = bound(flops, nbytes)
    return dict(name="gru_scan", route="cuda", source="gst_tacotron_tpu_torch/csrc/gru_scan.cu",
                replaces="gst_tacotron_tpu/ops/gru_pallas.py:56", max_err=err, tol=1e-4,
                tol_reason="float32 sums over D+H terms in another order, carried "
                           "through up to 400 recurrent steps",
                kernel_ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                library="torch.nn.GRU (cuDNN), weights reordered to r,z,n; the main "
                        "path's rows are full length, so it computes the same function",
                work="the 5 GRU scans of one synthesis")


# ---------------------------------------------------------------------------
# K2: reference-encoder conv stack
# ---------------------------------------------------------------------------


def check_refenc(torch, rng, dev):
    import torch.nn.functional as F

    from gst_tacotron_tpu_torch.ops.refenc import refenc_stack, refenc_stack_plain

    t, f = 128, 80
    channels = [32, 32, 64, 64, 128, 128]
    t32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    kernels, scales, biases = [], [], []
    c_in, flops, h, w = 1, 0.0, t, f
    for c in channels:
        lim = np.sqrt(6 / (9 * c_in + 9 * c))
        kernels.append(t32(rng.uniform(-lim, lim, (3, 3, c_in, c))))
        scales.append(t32(rng.uniform(0.5, 1.5, c)))
        biases.append(t32(rng.normal(0, 0.1, c)))
        h, w = (h + 1) // 2, (w + 1) // 2
        flops += 2.0 * B * h * w * 9 * c_in * c
        c_in = c
    mel = t32(rng.uniform(0, 1, (B, t, f)))
    full = torch.full((B,), t, device=dev, dtype=torch.int64)
    ragged = torch.from_numpy(rng.integers(1, t + 1, B)).to(dev)
    err = 0.0
    for lens in (ragged, full, None):
        got = refenc_stack(mel, kernels, scales, biases, lengths=lens)
        ref = refenc_stack_plain(mel, kernels, scales, biases, lengths=lens)
        err = max(err, max_err([got], [ref]))
    # a T that is not a multiple of 64 (the per-element Pallas form's case)
    odd = mel[:, :101]
    err = max(err, max_err([refenc_stack(odd, kernels, scales, biases)],
                           [refenc_stack_plain(odd, kernels, scales, biases)]))

    wts = [k.permute(3, 2, 0, 1).contiguous() for k in kernels]

    def library():
        x = mel[:, None]                                          # NCHW
        for wt, sc, bi in zip(wts, scales, biases):
            hh, ww = x.shape[2], x.shape[3]
            ph = max(0, ((hh + 1) // 2 - 1) * 2 + 3 - hh)
            pw = max(0, ((ww + 1) // 2 - 1) * 2 + 3 - ww)
            x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
            x = torch.relu(F.conv2d(x, wt, stride=2) * sc[:, None, None] + bi[:, None, None])
        return x

    ms = time_ms(torch, lambda: refenc_stack(mel, kernels, scales, biases, lengths=full), iters=20)
    plain = time_ms(torch, lambda: refenc_stack_plain(mel, kernels, scales, biases, lengths=full), iters=20)
    lib = time_ms(torch, library, iters=20)
    nbytes = 4.0 * (mel.numel() + B + sum(k.numel() + 2 * k.shape[-1] for k in kernels)
                    + B * h * w * c_in)
    b_ms, b_by = bound(flops, nbytes)
    return dict(name="refenc_stack", route="cuda",
                source="gst_tacotron_tpu_torch/csrc/refenc_stack.cu",
                replaces="gst_tacotron_tpu/ops/refenc_pallas.py:298", max_err=err, tol=1e-4,
                tol_reason="float32 sums over up to 9*128 terms in another order, "
                           "six layers deep",
                kernel_ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                library="F.pad + F.conv2d (cuDNN, TF32 off) + folded BN + ReLU, six layers",
                work="one (32, 128, 80) stack")


# ---------------------------------------------------------------------------
# K3, K3′, K3″: STFT features
# ---------------------------------------------------------------------------

STFT_FRAMES = 128       # a reference wav's frames on the main path
STFT_TOL = 5e-3
STFT_TOL_REASON = ("normalized-dB units, the JAX kernels' own test tolerance "
                   "(tests/test_pallas.py); float32 DFT sums over 1024 taps in "
                   "another order, and the log amplifies errors of quiet bins")


def stft_groups(torch, rng, dev, a):
    """K3's main-path inputs: 4 launches of 8 wavs of 128 frames."""
    length = (STFT_FRAMES - 1) * a.hop_length + a.n_fft
    groups = []
    for _ in range(B // 8):
        env = rng.uniform(0.05, 0.5, (8, 1))
        wav = rng.uniform(-1, 1, (8, length)) * env
        groups.append(torch.from_numpy(wav.astype(np.float32)).to(dev))
    return groups


def stft_bound(a, n_frames: int, in_bytes: float):
    """The bound of n_frames frames of features over the live taps: two DFT
    products and the mel product, against the input bytes plus the bases read
    once and the outputs written once."""
    from gst_tacotron_tpu_torch.ops.stft import live_tap_span

    _, _, n_live = live_tap_span(a)
    flops = n_frames * (2.0 * 2 * n_live * a.num_freq + 2.0 * a.num_freq * a.num_mels)
    nbytes = in_bytes + 4.0 * (2 * n_live * a.num_freq + a.num_freq * a.num_mels
                               + n_frames * (a.num_freq + a.num_mels))
    return bound(flops, nbytes)


def torch_stft_yardstick(torch, a, groups, bases):
    """The library yardstick of K3 and K3′ on ``groups``: torch.stft (cuFFT)
    + abs + mel product + dB normalization."""
    from gst_tacotron_tpu_torch.ops.stft import db_normalize

    window = torch.from_numpy(np.pad(
        0.5 - 0.5 * np.cos(2 * np.pi * np.arange(a.win_length) / a.win_length),
        ((a.n_fft - a.win_length) // 2, (a.n_fft - a.win_length + 1) // 2)
    ).astype(np.float32)).to(groups[0].device)
    mel_t = bases["mel_t"][: a.num_freq]

    def run():
        for g in groups:
            spec = torch.stft(g, a.n_fft, a.hop_length, window=window, center=False,
                              return_complex=True).abs().transpose(1, 2)
            db_normalize(spec @ mel_t, a), db_normalize(spec, a)

    return run


def check_stft(torch, rng, dev, cfg):
    from gst_tacotron_tpu_torch.ops.stft import stft_bases, stft_features, stft_features_plain

    a = cfg.audio
    bases = stft_bases(a, dev)
    groups = stft_groups(torch, rng, dev, a)
    err = 0.0
    for g in groups:
        got = stft_features(g, a, bases)
        ref = stft_features_plain(g, a, bases)
        err = max(err, max_err(got, ref))

    ms = time_ms(torch, lambda: [stft_features(g, a, bases) for g in groups], iters=10)
    plain = time_ms(torch, lambda: [stft_features_plain(g, a, bases) for g in groups], iters=10)
    lib = time_ms(torch, torch_stft_yardstick(torch, a, groups, bases), iters=10)
    b_ms, b_by = stft_bound(a, B * STFT_FRAMES, 4.0 * sum(g.numel() for g in groups))
    return dict(name="stft_features", route="cuda",
                source="gst_tacotron_tpu_torch/csrc/stft_features.cu",
                replaces="gst_tacotron_tpu/ops/stft_pallas.py:417", max_err=err, tol=STFT_TOL,
                tol_reason=STFT_TOL_REASON,
                kernel_ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                library="torch.stft (cuFFT) + abs + mel product + dB normalization",
                work="the 4 launches (32 wavs of 128 frames) of one synthesis")


def check_stft_fused(torch, dev, cfg):
    """K3′ at K3's shapes, in float32 (the extractor's route) and with bf16
    bases (held against the plain version's bf16 rounding)."""
    from gst_tacotron_tpu_torch.ops.stft import (stft_bases, stft_features_fused,
                                                 stft_features_plain)

    a = cfg.audio
    bases = stft_bases(a, dev)
    groups = stft_groups(torch, np.random.default_rng(11), dev, a)
    err = err_bf16 = 0.0
    for g in groups:
        err = max(err, max_err(stft_features_fused(g, a, bases), stft_features_plain(g, a, bases)))
        err_bf16 = max(err_bf16, max_err(stft_features_fused(g, a, bases, bf16_bases=True),
                                         stft_features_plain(g, a, bases, bf16_bases=True)))
    first = stft_features_fused(groups[0], a, bases)
    if max_err(first, stft_features_fused(groups[0], a, bases)) != 0.0:
        fail("stft_fused: two runs on the same input differ (the tile sum must be ordered)")

    ms = time_ms(torch, lambda: [stft_features_fused(g, a, bases) for g in groups], iters=10)
    ms_bf16 = time_ms(torch, lambda: [stft_features_fused(g, a, bases, bf16_bases=True)
                                      for g in groups], iters=10)
    plain = time_ms(torch, lambda: [stft_features_plain(g, a, bases) for g in groups], iters=10)
    lib = time_ms(torch, torch_stft_yardstick(torch, a, groups, bases), iters=10)
    b_ms, b_by = stft_bound(a, B * STFT_FRAMES, 4.0 * sum(g.numel() for g in groups))
    return dict(name="stft_fused", route="cuda",
                source="gst_tacotron_tpu_torch/csrc/stft_fused.cu",
                replaces="gst_tacotron_tpu/ops/stft_pallas.py:265",
                max_err=max(err, err_bf16), max_err_f32=err, max_err_bf16=err_bf16,
                tol=STFT_TOL, tol_reason=STFT_TOL_REASON,
                kernel_ms=ms, kernel_ms_bf16=ms_bf16, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib,
                library="torch.stft (cuFFT) + abs + mel product + dB normalization",
                work="K3's 4 launches (32 wavs of 128 frames), float32 bases")


def check_stft_frames(torch, dev, cfg):
    """K3″ at K3's shapes: the (1024, n_fft) frames of each 8-wav launch."""
    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP
    from gst_tacotron_tpu_torch.ops.stft import (db_normalize, live_tap_span, stft_bases,
                                                 stft_features_frames,
                                                 stft_features_frames_plain)

    a = cfg.audio
    bases = stft_bases(a, dev)
    dsp = TorchDSP(a, dev)
    frames = [dsp.frame_precentered(g).reshape(-1, a.n_fft).contiguous()
              for g in stft_groups(torch, np.random.default_rng(12), dev, a)]
    err = 0.0
    for f in frames:
        err = max(err, max_err(stft_features_frames(f, a, bases),
                               stft_features_frames_plain(f, a, bases)))

    window = dsp.window
    mel_t = bases["mel_t"][: a.num_freq]

    def library():
        for f in frames:
            spec = torch.fft.rfft(f * window, n=a.n_fft, dim=-1).abs()
            db_normalize(spec @ mel_t, a), db_normalize(spec, a)

    ms = time_ms(torch, lambda: [stft_features_frames(f, a, bases) for f in frames], iters=10)
    plain = time_ms(torch, lambda: [stft_features_frames_plain(f, a, bases) for f in frames],
                    iters=10)
    lib = time_ms(torch, library, iters=10)
    _, _, n_live = live_tap_span(a)
    n_frames = sum(f.shape[0] for f in frames)
    # the function reads only the live columns of each frame
    b_ms, b_by = stft_bound(a, n_frames, 4.0 * n_frames * n_live)
    return dict(name="stft_frames", route="cuda",
                source="gst_tacotron_tpu_torch/csrc/stft_frames.cu",
                replaces="gst_tacotron_tpu/ops/stft_pallas.py:118", max_err=err, tol=STFT_TOL,
                tol_reason=STFT_TOL_REASON,
                kernel_ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                library="torch.fft.rfft (cuFFT) of the windowed frames + abs + mel product "
                        "+ dB normalization",
                work="4 launches of 1024 frames (the frames of K3's 4 x 8 wavs)")


# ---------------------------------------------------------------------------
# K4: decode
# ---------------------------------------------------------------------------


def check_decode(torch, rng, dev, cfg, init_seed=7):
    """K4 at ``cfg``'s shapes: the Bahdanau branch (gst_lj) or the
    location-sensitive one (gst_r1_location)."""
    from gst_tacotron_tpu_torch.models.decoder import DecoderCell
    from gst_tacotron_tpu_torch.ops.decode import decode_scan, decode_scan_plain
    from gst_tacotron_tpu_torch.weights import init_weights

    m = cfg.model
    lsa = m.attention.kind == "location_sensitive"
    mem_dim = m.encoder.output_dim + m.gst.style_dim
    steps = m.decoder.max_decode_steps
    cell = DecoderCell(m.decoder, m.attention, m.num_mels, mem_dim)
    init_weights(cell, seed=init_seed)
    cell = cell.to(dev)
    packed = cell.pack()
    memory = torch.from_numpy(rng.normal(0, 0.5, (B, TEXT_TOKENS, mem_dim)).astype(np.float32)).to(dev)
    with torch.no_grad():
        keys = cell.precompute_keys(memory).contiguous()
    lens = rng.integers(TEXT_TOKENS // 2, TEXT_TOKENS + 1, B)
    lens[0], lens[1] = TEXT_TOKENS, 1
    lengths = torch.from_numpy(lens).to(dev)
    kw = dict(dec_cfg=m.decoder, attn_cfg=m.attention, num_mels=m.num_mels, steps=steps)

    got = decode_scan(packed, memory, keys, lengths, **kw)
    ref = decode_scan_plain(packed, memory, keys, lengths, **kw)
    err = max_err(got, ref)
    # dropout on: the kernel and the plain version share one Philox stream
    d1 = decode_scan(packed, memory, keys, lengths, seed=1, use_dropout=True, **kw)
    d1b = decode_scan(packed, memory, keys, lengths, seed=1, use_dropout=True, **kw)
    d2 = decode_scan(packed, memory, keys, lengths, seed=2, use_dropout=True, **kw)
    p1 = decode_scan_plain(packed, memory, keys, lengths, seed=1, use_dropout=True, **kw)
    if not all(bool(torch.isfinite(x).all()) for x in d1 + d2):
        fail("decode_scan with dropout produced non-finite values")
    if max_err(d1, d1b) != 0.0:
        fail("decode_scan with dropout: the same seed gave different outputs")
    if max_err(d1[:1], d2[:1]) == 0.0:
        fail("decode_scan with dropout: two seeds gave the same mel")
    err_dropout = max_err(d1, p1)

    full = torch.full((B,), TEXT_TOKENS, device=dev, dtype=torch.int64)
    ms = time_ms(torch, lambda: decode_scan(packed, memory, keys, full, seed=3,
                                            use_dropout=True, **kw), iters=3)
    plain = time_ms(torch, lambda: decode_scan_plain(packed, memory, keys, full, seed=3,
                                                     use_dropout=True, **kw), iters=1)
    n_w = sum(x.numel() for x in packed.values())
    d = m.decoder
    per_step = 2.0 * (m.num_mels * d.prenet_dims[0] + d.prenet_dims[0] * d.prenet_dims[1]
                      + (d.prenet_dims[1] + mem_dim + d.attention_rnn_dim) * 3 * d.attention_rnn_dim
                      + d.attention_rnn_dim * m.attention.dim
                      + (d.attention_rnn_dim + mem_dim) * d.decoder_rnn_dim
                      + 2 * 2 * d.decoder_rnn_dim * 3 * d.decoder_rnn_dim
                      + (d.decoder_rnn_dim + mem_dim) * (d.reduction_factor * (m.num_mels + 1))
                      + TEXT_TOKENS * (m.attention.dim + mem_dim))
    if lsa:
        per_step += 2.0 * TEXT_TOKENS * m.attention.location_kernel_size \
            * m.attention.location_channels * m.attention.dim
    flops = per_step * B * steps
    r = d.reduction_factor
    nbytes = 4.0 * (n_w + memory.numel() + keys.numel() + B
                    + B * steps * r * (m.num_mels + 1) + B * steps * TEXT_TOKENS)
    b_ms, b_by = bound(flops, nbytes)
    # a kernel row is named by the launch counter its path reads
    return dict(name="decode_scan:location_sensitive" if lsa else "decode_scan", route="cuda",
                source="gst_tacotron_tpu_torch/csrc/decode_scan.cu",
                replaces="gst_tacotron_tpu/ops/decode_pallas.py:328", max_err=err, tol=1e-3,
                max_err_dropout=err_dropout,
                tol_reason=f"float32 GEMV sums in another order, fed back through {steps} "
                           "autoregressive steps (the last frame re-enters the prenet"
                           + (", the alignment the location taps)" if lsa else ")"),
                kernel_ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                library="none: no single PyTorch call runs an autoregressive decode",
                work=f"one {steps}-step decode of 32 utterances at r={r}, "
                     f"{m.attention.kind} attention, dropout on")


# ---------------------------------------------------------------------------
# K5: WaveRNN sampling
# ---------------------------------------------------------------------------


def check_wavernn(torch, rng, dev, cfg, frames=128):
    """K5 at config 5's widths, B=32 rows of ``frames`` mel frames. A
    reordered float32 sum can flip a near-tie, after which the kernel's and
    the plain version's histories part, so the kernel is held teacher-forced:
    the plain pass runs on the kernel's own classes and every class must
    score within the tolerance of its step's best."""
    from gst_tacotron_tpu_torch.ops.wavernn import (score_gaps, wavernn_sample,
                                                    wavernn_sample_plain)
    from gst_tacotron_tpu_torch.weights import build_wavernn

    v = cfg.model.vocoder
    model = build_wavernn(cfg, seed=3, device=dev)
    mel = torch.from_numpy(rng.uniform(0, 1, (B, frames, cfg.model.num_mels))
                           .astype(np.float32)).to(dev)
    with torch.no_grad():
        cond = model.cond_frames(mel).contiguous()
    packed = model.pack()
    hop, k = v.wavernn_hop, model.num_classes
    n = frames * hop

    greedy = wavernn_sample(packed, cond, hop=hop, greedy=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    c1 = wavernn_sample(packed, cond, hop=hop, seed=1)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    # sampling is causal: on the first 8 frames the same seed must repeat the
    # first 8 * hop classes exactly, and another seed must not
    head = cond[:, :8].contiguous()
    c1b = wavernn_sample(packed, head, hop=hop, seed=1)
    c2 = wavernn_sample(packed, head, hop=hop, seed=2)
    torch.cuda.synchronize()
    for c in (greedy, c1):
        if c.shape != (B, n) or int(c.min()) < 0 or int(c.max()) >= k:
            fail(f"wavernn_sample: classes of shape {tuple(c.shape)} in "
                 f"[{int(c.min())}, {int(c.max())}]")
    if not torch.equal(c1[:, : 8 * hop], c1b):
        fail("wavernn_sample: the same seed gave different classes")
    if torch.equal(c1b, c2):
        fail("wavernn_sample: two seeds gave the same classes")
    with torch.no_grad():
        gaps_greedy = score_gaps(packed, cond, greedy, hop=hop, greedy=True)
        gaps = score_gaps(packed, cond, c1, hop=hop, seed=1)
    plain = time_ms(torch, lambda: wavernn_sample_plain(packed, cond, hop=hop, seed=1),
                    iters=1, warmup=0)
    c, h, f = cond.shape[-1], v.wavernn_gru_dim, v.wavernn_fc_dim
    flops = 2.0 * (c * 3 * h + h * 3 * h + h * f + f * k) * B * n
    nbytes = 4.0 * (sum(x.numel() for x in packed.values()) + cond.numel() + B * n)
    b_ms, b_by = bound(flops, nbytes)
    return dict(name="wavernn_sample", route="cuda",
                source="gst_tacotron_tpu_torch/csrc/wavernn_sample.cu",
                replaces="gst_tacotron_tpu/ops/wavernn_pallas.py:119",
                max_err=max(float(gaps_greedy.max()), float(gaps.max())), tol=1e-3,
                max_err_greedy=float(gaps_greedy.max()), max_err_sampled=float(gaps.max()),
                share_plain_argmax=float((gaps == 0).float().mean()),
                share_plain_argmax_greedy=float((gaps_greedy == 0).float().mean()),
                err_unit="score (logit / temperature + Gumbel noise) below the plain "
                         "teacher-forced pass's best at each step",
                tol_reason="float32 GEMV sums over 512 terms in another order than the "
                           "plain version's products, through 32,768 recurrent steps",
                kernel_ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                library="none: no single PyTorch call runs autoregressive sampling",
                work=f"32 rows of {frames} frames ({n} samples), Gumbel-max at temperature 1")


# ---------------------------------------------------------------------------
# the paths
# ---------------------------------------------------------------------------


def make_inputs(rng, sr):
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    texts = []
    for _ in range(B):
        chars = rng.choice(letters, TEXT_TOKENS - 1)
        chars[rng.choice(np.arange(2, TEXT_TOKENS - 3, 4), 8, replace=False)] = " "
        texts.append("".join(chars))
    t = np.arange(REF_SAMPLES) / sr
    wavs = []
    for _ in range(B):
        f0 = rng.uniform(90, 250)
        wav = sum(0.5 ** k * np.sin(2 * np.pi * (k + 1) * f0 * t + rng.uniform(0, 6.3))
                  for k in range(4))
        wav = wav * (0.3 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.5, 3) * t))
        wavs.append((wav + rng.normal(0, 0.01, REF_SAMPLES)).astype(np.float32))
    return texts, wavs


def run_path(torch, rng, dev, name, cfg, expected, vocoder_seed=None, timed_runs=3):
    """Synthesize one batch through the path ``name`` and check it.
    ``vocoder_seed``: the seed of a seeded WaveRNN vocoder (None: inline
    Griffin-Lim). Returns the launch counts of the counted run."""
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.dsp.mulaw import mulaw_encode
    from gst_tacotron_tpu_torch.ops.wavernn import score_gaps
    from gst_tacotron_tpu_torch.synthesize import VOCODER_SEED_OFFSET, Synthesizer
    from gst_tacotron_tpu_torch.vocoder import WaveRNNVocoder
    from gst_tacotron_tpu_torch.weights import build_model, build_wavernn

    model = build_model(cfg, seed=0, device=dev)
    vocoder = None
    if vocoder_seed is not None:
        vocoder = WaveRNNVocoder(cfg, build_wavernn(cfg, seed=vocoder_seed, device=dev),
                                 device=dev)
    texts, wavs = make_inputs(rng, cfg.audio.sample_rate)
    synth = Synthesizer(cfg, model, device=dev, vocoder=vocoder)

    ops.reset_launch_counts()
    out = synth(texts, reference_wavs=wavs, seed=0)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"{name}: launches {counts}")
    if counts != expected:
        fail(f"{name}: launch counts {counts}, expected {expected}")

    steps, r = cfg.model.decoder.max_decode_steps, cfg.model.decoder.reduction_factor
    n_frames, hop = steps * r, cfg.audio.hop_length
    wav_len = n_frames * hop if vocoder is not None else hop * (n_frames - 1)
    shapes = {"mel": (B, n_frames, cfg.model.num_mels), "linear": (B, n_frames, cfg.model.num_freq),
              "alignments": (B, steps, TEXT_TOKENS), "wav": (B, wav_len),
              "style_embedding": (B, cfg.model.gst.style_dim)}
    for key, shape in shapes.items():
        if out[key].shape != shape:
            fail(f"{name}: {key} has shape {out[key].shape}, expected {shape}")
        if not np.all(np.isfinite(out[key])):
            fail(f"{name}: {key} has non-finite values")
    if not np.abs(out["wav"]).max() <= 1.0:
        fail(f"{name}: wav leaves [-1, 1]: max |wav| {np.abs(out['wav']).max()}")
    if not np.all(out["frame_lengths"] == n_frames):
        fail(f"{name}: frame_lengths {out['frame_lengths']} (stop threshold 1.0 decodes every step)")
    if not np.all(out["wav_lengths"] == n_frames * hop):
        fail(f"{name}: wav_lengths {out['wav_lengths']}")
    if not np.allclose(out["alignments"].sum(-1), 1.0, atol=1e-4):
        fail(f"{name}: alignments are not distributions")

    walls = []
    for i in range(timed_runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = synth(texts, reference_wavs=wavs, seed=i + 1)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    audio_s = float(np.sum(o["wav_lengths"])) / cfg.audio.sample_rate

    det = Synthesizer(cfg, model, device=dev, deterministic_prenet=True, vocoder=vocoder)(
        texts, reference_wavs=wavs, seed=0)
    t0 = time.perf_counter()
    plain = Synthesizer(cfg, model, device=dev, deterministic_prenet=True, plain=True,
                        vocoder=vocoder)(texts, reference_wavs=wavs, seed=0)
    plain_wall = time.perf_counter() - t0
    mel_err = float(np.abs(det["mel"] - plain["mel"]).max())
    wav_err = float(np.abs(det["wav"] - plain["wav"]).max())
    mel_tol = 2e-3
    info = {"name": name, "batch": B, "text_tokens": TEXT_TOKENS, "ref_frames": 128,
            "decode_steps": steps, "reduction_factor": r, "launches": counts,
            "wall_ms_per_batch": 1e3 * wall, "wall_ms_runs": [1e3 * w for w in walls],
            "audio_seconds": audio_s, "audio_s_per_s": audio_s / wall,
            "plain_path_wall_ms": 1e3 * plain_wall,
            "mel_max_abs_err_vs_plain": mel_err, "mel_tol": mel_tol,
            "wav_max_abs_err_vs_plain": wav_err,
            "wav_max_abs": float(np.abs(plain["wav"]).max()),
            "note": "informational, a first unoptimized baseline"}
    gap_tol = 1e-3
    if vocoder is not None:
        # the kernel path's samples, held teacher-forced on the plain path's mel
        with torch.no_grad():
            mel_plain = torch.from_numpy(plain["mel"]).to(dev)
            classes = mulaw_encode(torch.from_numpy(det["wav"]).to(dev),
                                   cfg.model.vocoder.wavernn_bits)
            gaps = score_gaps(vocoder.model.pack(), vocoder.model.cond_frames(mel_plain),
                              classes, hop=hop, seed=VOCODER_SEED_OFFSET)
        info.update({"vocoder": "wavernn", "cut": "decode 64 steps (128 frames) of the "
                     "preset's 500", "sample_score_gap_max": float(gaps.max()),
                     "sample_score_gap_tol": gap_tol,
                     "samples_equal_to_plain_path": float(np.mean(det["wav"] == plain["wav"]))})
    print(json.dumps({"path": info}), flush=True)
    if not mel_err <= mel_tol:
        fail(f"{name}: mel differs from the plain path by {mel_err} > {mel_tol}")
    if vocoder is not None and not info["sample_score_gap_max"] <= gap_tol:
        fail(f"{name}: a sampled class scores {info['sample_score_gap_max']} below the "
             f"plain path's best > {gap_tol}")
    print(json.dumps(profile_path(torch, dev, name, cfg, model, texts, wavs, vocoder)),
          flush=True)
    return counts


def profile_path(torch, dev, name, cfg, model, texts, wavs, vocoder=None):
    """Where one synthesis spends its time: host-clock stage times (each
    stage ends in a synchronize) and the device time of each kernel from
    torch.profiler, with the device's idle share of the profiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gst_tacotron_tpu_torch.dsp.device_features import DeviceFeatureExtractor
    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP
    from gst_tacotron_tpu_torch.synthesize import Synthesizer
    from gst_tacotron_tpu_torch.text import batch_text_to_ids

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    stages = {}
    with torch.no_grad():
        ex = DeviceFeatureExtractor(cfg.audio, dev)
        mels, stages["reference_mels"] = timed(lambda: [m for m, _ in ex.extract(wavs)])
        ref = torch.from_numpy(np.stack(mels)).to(dev)
        ref_len = torch.full((B,), ref.shape[1], device=dev)
        ids, lens = batch_text_to_ids(texts)
        tok = torch.from_numpy(ids.astype(np.int64)).to(dev)
        tok_len = torch.from_numpy(lens.astype(np.int64)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        (memory, _), stages["encode_and_gst"] = timed(lambda: model.build_memory(
            tok, tok_len, ref, ref_len, generator=gen))
        dec_out, stages["decode"] = timed(lambda: model.decoder.decode(memory, tok_len, seed=1))
        linear, stages["postnet"] = timed(lambda: model.postnet(dec_out[0], dec_out[3]))
        if vocoder is None:
            dsp = TorchDSP(cfg.audio, dev)
            _, stages["griffin_lim"] = timed(lambda: dsp.inv_linear_spectrogram(linear))
        else:
            _, stages["wavernn"] = timed(lambda: vocoder({"mel": dec_out[0]}, seed=2))

    # the path's timed runs came before: kernels, plans and caches are warm
    synth = Synthesizer(cfg, model, device=dev, vocoder=vocoder)

    def profiled():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            synth(texts, reference_wavs=wavs, seed=6)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        rows = []
        for e in prof.key_averages():
            # device-side events only (kernels and copies); host ops report
            # the device time of their kernels again
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                rows.append((e.key[:60], us / 1e3, e.count))
        rows.sort(key=lambda r: -r[1])
        return rows, wall, sum(r[1] for r in rows)

    # the device is busy at least as long as the longest stage takes; a
    # profile below that lost events (one lost K5 whole), so take it once
    # more, and flag the line if the second is short too
    rows, wall, busy = profiled()
    longest = max(stages.values())
    reprofiled = busy < longest
    if reprofiled:
        log(f"{name}: profiled device busy {busy:.1f} ms < the longest stage "
            f"{longest:.1f} ms; profiling once more")
        rows, wall, busy = profiled()
    return {"profile": {"name": name, "stage_ms": stages, "profiled_wall_ms": wall,
                        "device_busy_ms": busy,
                        "device_idle_share": max(0.0, 1.0 - busy / wall),
                        "reprofiled": reprofiled, "suspect": busy < longest,
                        "top_device_ms": [list(r) for r in rows[:14]]}}


# ---------------------------------------------------------------------------
# the training-corpus path
# ---------------------------------------------------------------------------

CORPUS_UTTERANCES = 192   # with batch 32, every gst_lj bucket fills a batch
CORPUS_TOL = 5e-4         # normalized dB, tests/test_device_features.py's oracle budget
# KernelDSP preemphasizes and frames in float32 on the card, as PallasDSP does
# on the TPU: tests/test_pallas.py's budget for that drop-in
DSP_TOL = 5e-3
# tests/test_wav_transport.py's budgets for features from the float16 wire
# against the feature batches. Its linear max (1e-1) is not enforced here: the
# wire's dither lifts single near-cancellation bins (mostly DC, true level
# ~1e-4) above it, as that test's note says, and at this corpus's 130 M bins
# a few cross it; the line reports the max and the count of such bins, and
# the card's features are held against the float64 oracle of the same wire
# rows instead (CORPUS_TOL).
WIRE_MAE, WIRE_MAX = 1e-3, {"mel": 2e-2, "linear": 1e-1}


def wire_oracle(row: np.ndarray, a, frames: int):
    """Host float64 (mel, linear) of the first ``frames`` frames of one wire
    row (preemphasized and centre-padded already): the numpy oracle's
    arithmetic without its own preemphasis and pad."""
    from gst_tacotron_tpu_torch.dsp import ref as dsp_ref
    from gst_tacotron_tpu_torch.dsp.mel import mel_filterbank

    fr = dsp_ref.frame_signal(row.astype(np.float64), a.n_fft, a.hop_length,
                              center=False)[:frames]
    mag = np.abs(np.fft.rfft(fr * dsp_ref.padded_window(a.win_length, a.n_fft), axis=-1))
    basis = mel_filterbank(a.sample_rate, a.n_fft, a.num_mels, a.mel_fmin,
                           a.mel_fmax).astype(np.float64)
    db = lambda x: dsp_ref.normalize_db(dsp_ref.amp_to_db(x) - a.ref_level_db, a)
    return db(mag @ basis.T), db(mag)


def run_corpus(torch, dev, cfg):
    """The training-corpus path on ``cfg`` (gst_lj): a variable-length
    synthetic corpus -> ``generate_patterns(device_features=True)`` (K3) ->
    every extractor route and ``KernelDSP`` on the same prepared wavs (K3′,
    K3″, the plain route) -> ``BucketedLoader`` batches in both transports ->
    ``_materialize_features`` on the card. Each route is held against the
    host numpy oracle and the resident route's patterns, the wire features
    against the feature batches. Counts are set to 0 once before the path
    and read after it; each phase's launches are the counts' growth over
    it. Returns the path's launch counts."""
    import tempfile

    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import apply_overrides
    from gst_tacotron_tpu_torch.data import (BucketedLoader, PatternDataset, generate_patterns,
                                             synthetic_utterances)
    from gst_tacotron_tpu_torch.dsp import ref as dsp_ref
    from gst_tacotron_tpu_torch.dsp.device_features import DeviceFeatureExtractor
    from gst_tacotron_tpu_torch.ops.stft import KernelDSP
    from gst_tacotron_tpu_torch.train import _materialize_features

    a = cfg.audio
    t_path = time.perf_counter()
    launches, before = {}, {}

    def start():
        torch.cuda.synchronize()
        before.update(ops.launch_counts())
        return time.perf_counter()

    def stop(phase, t0):
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[phase] = {k: n - before[k] for k, n in ops.launch_counts().items()
                           if n != before[k]}
        return dt

    def errs(results, refs):
        return [max(float(np.abs(r[i] - f[i]).max()) for r, f in zip(results, refs))
                for i in (0, 1)]

    utts = synthetic_utterances(CORPUS_UTTERANCES, variable=True)
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as out:
        t0 = start()
        generate_patterns(utts, a, out, store_wav=True, device_features=True, device=dev)
        patterns_s = stop("patterns", t0)
        ds = PatternDataset(out)
        items = [ds.load(i) for i in range(len(ds))]
        wavs = [it["wav"] for it in items]
        resident = [(it["mel"], it["linear"]) for it in items]
        num_frames = [1 + len(w) // a.hop_length for w in wavs]
        t0 = time.perf_counter()
        oracle = [(dsp_ref.melspectrogram(w, a), dsp_ref.spectrogram(w, a)) for w in wavs]
        oracle_s = time.perf_counter() - t0

        err_oracle = {"patterns (resident)": errs(resident, oracle)}
        err_resident, route_ms = {}, {}
        min_calls = len(DeviceFeatureExtractor(a, dev).plan(num_frames))
        kernel_of = {"resident": "stft_features", "fused": "stft_fused",
                     "frames": "stft_frames", None: None}
        for route, kname in kernel_of.items():
            ex = DeviceFeatureExtractor(a, dev, stft_kernel=route)
            label = str(route)
            t0 = start()
            res = ex.extract(wavs)
            route_ms[label] = 1e3 * stop(label, t0)
            calls = len(ex.plan(num_frames))
            if launches[label] != ({kname: calls} if kname else {}):
                fail(f"corpus: route {label} launched {launches[label]}, expected "
                     f"{calls} launches of {kname}")
            err_oracle[label] = errs(res, oracle)
            err_resident[label] = errs(res, resident)
        kd = KernelDSP(a, dev)
        t0 = start()
        res = []
        for w in wavs:
            mel, lin = kd.features(torch.from_numpy(w)[None].to(dev))
            res.append((mel[0].cpu().numpy(), lin[0].cpu().numpy()))
        route_ms["KernelDSP"] = 1e3 * stop("KernelDSP", t0)
        if launches["KernelDSP"] != {"stft_frames": len(wavs)}:
            fail(f"corpus: KernelDSP launched {launches['KernelDSP']}, expected "
                 f"{len(wavs)} launches of stft_frames")
        err_oracle["KernelDSP"] = errs(res, oracle)
        err_resident["KernelDSP"] = errs(res, resident)
        # the generator extracts in chunks, so at least the one-call plan's count
        if launches["patterns"].keys() != {"stft_features"} or \
                launches["patterns"]["stft_features"] < min_calls:
            fail(f"corpus: generate_patterns launched {launches['patterns']}")
        del oracle, resident, res

        r = cfg.model.decoder.reduction_factor
        wire_cfg = apply_overrides(cfg, {"data.wav_transport": True})
        feat = BucketedLoader(ds, cfg.data, r, seed=0)
        wire = BucketedLoader(ds, wire_cfg.data, r, seed=0, audio_cfg=a)
        sizes = [len(m) for m in feat.bucket_members]
        if min(sizes) < cfg.data.batch_size:
            fail(f"corpus: bucket sizes {sizes}: a bucket fills no batch of "
                 f"{cfg.data.batch_size}; raise CORPUS_UTTERANCES")
        stream = feat.stream()
        first = next(stream)
        stream.close()
        wire_err = {"mel": [0.0, 0.0], "linear": [0.0, 0.0]}
        wire_vs_oracle, lin_over = [0.0, 0.0], 0
        zeros_ok, n_batches, mat_ms, feat_s, wire_s = True, 0, 0.0, 0.0, 0.0
        t0 = start()
        feat_batches, wire_batches = feat.epoch(0), wire.epoch(0)
        while True:
            t1 = time.perf_counter()
            fb = next(feat_batches, None)
            t2 = time.perf_counter()
            wb = next(wire_batches, None)
            feat_s, wire_s = feat_s + t2 - t1, wire_s + time.perf_counter() - t2
            if fb is None or wb is None:
                if fb is not wb:
                    fail("corpus: the two transports' epochs differ in length")
                break
            if n_batches == 0 and any(not np.array_equal(first[k], fb[k]) for k in fb):
                fail("corpus: the prefetching stream's first batch is not the epoch's")
            batch = {k: torch.from_numpy(v).to(dev) for k, v in wb.items()}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mat = _materialize_features(wire_cfg, batch)
            torch.cuda.synchronize()
            mat_ms += 1e3 * (time.perf_counter() - t1)
            for k in ("tokens", "token_lengths", "mel_lengths", "speaker_ids"):
                if not np.array_equal(mat[k].cpu().numpy(), fb[k]):
                    fail(f"corpus: the wire batch's {k} differ from the feature batch's")
            t = fb["mel"].shape[1]
            true_frames = torch.from_numpy(wb["ints"][:, -2]).to(dev)
            past = torch.arange(mat["mel"].shape[1], device=dev)[None, :] >= true_frames[:, None]
            for k in ("mel", "linear"):
                d = (mat[k][:, :t] - torch.from_numpy(fb[k]).to(dev)).abs()
                wire_err[k][0] = max(wire_err[k][0], float(d.mean()))
                wire_err[k][1] = max(wire_err[k][1], float(d.max()))
                zeros_ok &= bool((mat[k][past] == 0).all())
                if k == "linear":
                    lin_over += int((d >= WIRE_MAX[k]).sum())
            got = [mat[k].cpu().numpy() for k in ("mel", "linear")]
            for j, (row, tf) in enumerate(zip(wb["wav"], wb["ints"][:, -2])):
                for i, ref in enumerate(wire_oracle(row, a, tf)):
                    wire_vs_oracle[i] = max(wire_vs_oracle[i],
                                            float(np.abs(got[i][j, :tf] - ref).max()))
            n_batches += 1
        stop("loader", t0)

    info = {"name": "corpus (gst_lj)", "utterances": len(wavs), "frames": sum(num_frames),
            "audio_seconds": sum(len(w) for w in wavs) / a.sample_rate,
            "wall_s": time.perf_counter() - t_path, "patterns_s": patterns_s,
            "oracle_host_s": oracle_s, "extractor_ms": route_ms, "launches": launches,
            "max_err_vs_oracle": err_oracle, "max_err_vs_resident": err_resident,
            "tol": CORPUS_TOL, "tol_kernel_dsp": DSP_TOL, "buckets": sizes,
            "batches_per_transport": n_batches,
            "feature_batches_s": feat_s, "wire_batches_s": wire_s,
            "materialize_ms": mat_ms,
            "wire_vs_feature_mae_max": wire_err, "wire_budget": [WIRE_MAE, WIRE_MAX],
            "wire_linear_bins_over_max": lin_over,
            "wire_vs_wire_oracle_max": wire_vs_oracle,
            "wire_zeros_past_length": zeros_ok,
            "note": "errors are [mel, linear] max abs in normalized dB; routes by "
                    "stft_kernel (None is the plain path); extractor ms include host prep"}
    print(json.dumps({"path": info}), flush=True)
    for label, (em, el) in err_oracle.items():
        tol = DSP_TOL if label == "KernelDSP" else CORPUS_TOL
        if not max(em, el) <= tol:
            fail(f"corpus: {label} differs from the host oracle by {max(em, el)} > {tol}")
    if not max(wire_vs_oracle) <= CORPUS_TOL:
        fail(f"corpus: wire features differ from the wire's host oracle by "
             f"{max(wire_vs_oracle)} > {CORPUS_TOL}")
    for k, (mae, mx) in wire_err.items():
        if not (mae < WIRE_MAE and (k == "linear" or mx < WIRE_MAX[k])):
            fail(f"corpus: wire {k} MAE {mae} / max {mx} outside ({WIRE_MAE}, {WIRE_MAX[k]})")
    if not zeros_ok or n_batches < len(sizes):
        fail(f"corpus: zeros past length {zeros_ok}, {n_batches} batches")
    return ops.launch_counts()


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    try:
        from gst_tacotron_tpu_torch import ops
        from gst_tacotron_tpu_torch.config import apply_overrides, get_preset
        from gst_tacotron_tpu_torch.ops.build import build_all
    except ImportError as e:
        fail(f"the port is not importable here: {e}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    build_all(ops.all_kernels())
    log(f"built and loaded {len(ops.all_kernels())} kernels in {time.perf_counter() - t0:.1f} s")

    cfg = apply_overrides(get_preset("gst_lj"), {
        "model.decoder.max_decode_steps": 200,
        "audio.griffin_lim_iters": 15,
        "audio.griffin_lim_momentum": 0.99,
        "model.decoder.stop_threshold": 1.0,
    })
    cfg3 = apply_overrides(get_preset("gst_r1_location"), {"model.decoder.stop_threshold": 1.0})
    cfg5 = apply_overrides(get_preset("gst_wavernn"), {
        "model.decoder.max_decode_steps": 64,
        "model.decoder.stop_threshold": 1.0,
    })
    rng = np.random.default_rng(0)
    kernels = []
    for check in (lambda: check_gru(torch, rng, dev),
                  lambda: check_refenc(torch, rng, dev),
                  lambda: check_stft(torch, rng, dev, cfg),
                  lambda: check_stft_fused(torch, dev, cfg),
                  lambda: check_stft_frames(torch, dev, cfg),
                  lambda: check_decode(torch, rng, dev, cfg),
                  lambda: check_decode(torch, np.random.default_rng(1), dev, cfg3, init_seed=8),
                  lambda: check_wavernn(torch, np.random.default_rng(2), dev, cfg5)):
        t0 = time.perf_counter()
        res = check()
        log(f"{res['name']} checked in {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"kernel_check": res}), flush=True)
        if not res["max_err"] <= res["tol"]:
            fail(f"{res['name']} differs from its plain version by "
                 f"{res['max_err']} > {res['tol']}")
        if not res.get("max_err_dropout", 0.0) <= res["tol"]:
            fail(f"{res['name']} with dropout differs from its plain version by "
                 f"{res['max_err_dropout']} > {res['tol']}")
        kernels.append(res)

    taco = {**dict.fromkeys(ops.launch_counts(), 0), "gru_scan": 5, "refenc_stack": 1,
            "stft_features": 4, "decode_scan": 1}
    # (path, config, launches beyond taco's, run_path options); each kernel
    # row takes its launches from the first path that launches it
    paths = (("gst_lj", cfg, {}, {}),
             ("gst_r1_location", cfg3, {"decode_scan:location_sensitive": 1}, {}),
             ("gst_wavernn", cfg5, {"wavernn_sample": 1}, {"vocoder_seed": 1, "timed_runs": 2}))
    for i, (name, c, extra, opts) in enumerate(paths):
        t0 = time.perf_counter()
        # the gst_lj path keeps drawing its inputs from the checks' generator
        path_rng = rng if i == 0 else np.random.default_rng(2 + i)
        counts = run_path(torch, path_rng, dev, name, c, {**taco, **extra}, **opts)
        for r in kernels:
            if "launches" not in r and counts[r["name"]]:
                r["launches"] = counts[r["name"]]
        log(f"{name} path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = run_corpus(torch, dev, get_preset("gst_lj"))
    for r in kernels:
        if "launches" not in r and counts[r["name"]]:
            r["launches"] = counts[r["name"]]
    log(f"corpus path done in {time.perf_counter() - t0:.1f} s")
    for r in kernels:
        if "launches" not in r:
            fail(f"{r['name']}: no path launched it")

    line = [{"name": r["name"], "route": r["route"], "source": r["source"],
             "replaces": r["replaces"], "launches": r["launches"],
             "max_abs_err": r["max_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": r["library_ms"]} for r in kernels]
    print(json.dumps({"kernels": line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
