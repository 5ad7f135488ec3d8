#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gst_tacotron_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build: nvcc compiles every CUDA kernel of the port (one process per
   source, all at once) and the libraries are loaded;
2. kernels: K1-K5 and K4's location-sensitive branch each run at the shapes
   their main path gives them and are held against their plain PyTorch
   versions on the card, in float32 with TF32 off; each is timed beside its
   plain version, a PyTorch library yardstick where one exists, and its
   least possible time on an H100;
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
   path must agree with the plain path on the card.

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
# K3: STFT features
# ---------------------------------------------------------------------------


def check_stft(torch, rng, dev, cfg):
    from gst_tacotron_tpu_torch.ops.stft import (db_normalize, live_tap_span, stft_bases,
                                                 stft_features, stft_features_plain)

    a = cfg.audio
    frames = 128
    length = (frames - 1) * a.hop_length + a.n_fft
    bases = stft_bases(a, dev)
    groups = []
    for _ in range(B // 8):
        env = rng.uniform(0.05, 0.5, (8, 1))
        wav = rng.uniform(-1, 1, (8, length)) * env
        groups.append(torch.from_numpy(wav.astype(np.float32)).to(dev))
    err = 0.0
    for g in groups:
        got = stft_features(g, a, bases)
        ref = stft_features_plain(g, a, bases)
        err = max(err, max_err(got, ref))

    window = torch.from_numpy(np.pad(
        0.5 - 0.5 * np.cos(2 * np.pi * np.arange(a.win_length) / a.win_length),
        ((a.n_fft - a.win_length) // 2, (a.n_fft - a.win_length + 1) // 2)
    ).astype(np.float32)).to(dev)
    mel_t = bases["mel_t"][: a.num_freq]

    def library():
        for g in groups:
            spec = torch.stft(g, a.n_fft, a.hop_length, window=window, center=False,
                              return_complex=True).abs().transpose(1, 2)
            db_normalize(spec @ mel_t, a), db_normalize(spec, a)

    ms = time_ms(torch, lambda: [stft_features(g, a, bases) for g in groups], iters=10)
    plain = time_ms(torch, lambda: [stft_features_plain(g, a, bases) for g in groups], iters=10)
    lib = time_ms(torch, library, iters=10)
    _, _, n_live = live_tap_span(a)
    n_frames = B * frames
    flops = n_frames * (2.0 * 2 * n_live * a.num_freq + 2.0 * a.num_freq * a.num_mels)
    nbytes = 4.0 * (B * length + 2 * n_live * a.num_freq + a.num_freq * a.num_mels
                    + n_frames * (a.num_freq + a.num_mels))
    b_ms, b_by = bound(flops, nbytes)
    return dict(name="stft_features", route="cuda",
                source="gst_tacotron_tpu_torch/csrc/stft_features.cu",
                replaces="gst_tacotron_tpu/ops/stft_pallas.py:417", max_err=err, tol=5e-3,
                tol_reason="normalized-dB units, the JAX kernel's own test tolerance "
                           "(tests/test_pallas.py); float32 DFT sums over 1024 taps in "
                           "another order, and the log amplifies errors of quiet bins",
                kernel_ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                library="torch.stft (cuFFT) + abs + mel product + dB normalization",
                work="the 4 launches (32 wavs of 128 frames) of one synthesis")


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
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        synth(texts, reference_wavs=wavs, seed=6)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels and copies); host ops report the
        # device time of their kernels again
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((e.key[:60], us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"profile": {"name": name, "stage_ms": stages, "profiled_wall_ms": wall,
                        "device_busy_ms": busy,
                        "device_idle_share": max(0.0, 1.0 - busy / wall),
                        "top_device_ms": [list(r) for r in rows[:14]]}}


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
