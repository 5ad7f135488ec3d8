#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gst_tacotron_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build: nvcc compiles every CUDA kernel of the port (one process per
   source, all at once) and the libraries are loaded;
2. kernels: K1-K5, K3′, K3″, K4's location-sensitive branch and the bf16
   operand modes of K2 and K3 (the main path's on the card) each run at
   the shapes their main path gives them and are held against their plain
   PyTorch versions on the card, TF32 off (a bf16 mode against the plain
   version's bf16 rounding; the checks held to float32 references pin
   ``bf16=False``); K1, K2 and K3 in both modes, K3′ in both modes and K3″
   also give the same bits on two runs; K1 also runs
   at H = 256 and 512 (1e-5); K3 at n_fft 1200 and 1536 against the float64
   oracle (5e-4); K3′ and K3″ at n_fft 1536, 1026 and odd 1575: the radix-3
   and -5 stages, the generic stage and the unpacked transform; K3, K3′ and
   K3″ at n_fft 32768 and odd 15625, past one block's shared memory; K3′'s
   bf16 bases at n_fft 6144, past 8 bin windows); each is timed beside its
   plain version, a PyTorch library yardstick where one exists, and its
   least possible time on an H100 (device time from torch.profiler for K1's
   two phases, K2, the STFT kernels, K5 and K4, K4 also by phase kernel with
   its launches and microseconds a step; K5 also at width 8, where its
   samples are its grid barriers alone; K4 and K5 also on rows 16-31 alone
   at ``row0`` 16, a data-parallel rank's rows, against the plain version);
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
   path must agree with the plain path on the card (the reference path in
   K3's and K2's bf16 modes on both, each mode's branch counter read);
   Griffin-Lim runs under
   both settings of ``audio.griffin_lim_bf16`` (gst_lj's default, True, is
   the path's), finite and different from each other;
4. corpus: the training-corpus path on gst_lj (192 synthetic utterances of
   varied length): patterns with device features (K3, float32 by name),
   every route of the feature extractor and ``KernelDSP`` (K3′, K3″), the
   bucketed loader in both transports and the wav-transport features on the
   card, each held against the host numpy oracle, with launch counts per
   route; the resident route in K3's bf16 mode (the card's default) against
   its plain version;
5. train: on the corpus phase's patterns, ``Trainer`` on gst_lj at its
   published widths, B=32: 6 steps on the feature transport (checkpoints
   every 4, the held-out eval and ``default_eval_hook`` at step 6), a second
   ``Trainer`` restoring step 6 bit for bit, 2 steps on the wav transport
   with the corpus on the card, then synthesis of 32 texts with 32
   reference wavs from the trained state. Every train step launches no
   kernel (every counter reads 0 after it) and gives every parameter a
   nonzero gradient at step 1; the eval hook launches K1 and K4; the
   synthesis gives the gst_lj path's counts (K1 3, K2 1, K3 4, K4 1). One
   step at the CPU tests' widths on the card against the same step on the
   CPU (loss 1e-5 relative, parameters 1e-5, gradients 1e-4 of each
   tensor's largest); gst_wavernn's WaveRNN at its widths, 2
   ``VocoderTrainer`` steps of 16 x 24 frames and a restore;
6. chunked (before the corpus phase): ``decode.chunked_decode`` at gst_lj's
   widths (200 steps in chunks of 64) and gst_r1_location's (cut to 256
   steps), B=32, stop threshold 1.0, dropout on: one K4 launch a chunk
   (counted), the fixed-length call's bits over the first steps, one chunk
   at stop threshold 0.0; the fixed and chunked decode's times;
7. bf16: gst_lj synthesis at ``model.compute_dtype="bfloat16"`` (finite,
   apart from float32 with mean |d| of the mel < 0.05, the float32 path's
   launches) with its stage times, and one bf16 ``Trainer`` step at
   gst_lj's widths (finite loss, float32 parameters);
8. CLI: ``synthesize.main`` on the train phase's workdir (decode cut to 64
   steps) with Griffin-Lim and two reference wavs, with
   ``--chunked-decoder``, and with ``--vocoder wavernn --vocoder-workdir``
   on the vocoder's workdir: each writes its wavs, and the three runs'
   launch counters show K1-K5;
9. bench: ``gst_tacotron_tpu_torch.bench``'s functions at its workload;
   its JSON line (informational) with the card, and its details;
10. parallel (after the chunked phase): ``gst_tacotron_tpu_torch.parallel``
   at gst_lj's widths, B=32, 200 steps, reference wavs through K3 (see
   ``run_parallel``): world size 1 over NCCL (``DistributedSynthesizer`` and
   a meshed train step give the single-process bits), two ranks on the one
   card over gloo (dp=2 synthesis within 1e-5, the chunked path's
   ``chunks_run`` agreed, dp=2 and tp=2 train steps within 1e-5 relative,
   the tp=2 ranks' replicated parameters and buffers bit-equal after 4
   steps, K5 at dp=2 the single-process classes, each rank's launch counts), and
   the dp=2 checks over NCCL where there are two cards;
11. taco2 (after the three paths): gst_lj with ``model.encoder.kind=taco2``
   (embedding 256, three 5-tap 256-channel convs with BatchNorm, BiGRU
   2 x 128) through ``run_path`` at the gst_lj path's workload (K1 3, K2 1,
   K3 4, K4 1 counted, the mel within 2e-3 of the plain path, stage
   times); the encoder alone launches K1 once (counted), K1 at its BiGRU's
   shape against its plain scans, timed beside cuDNN and its bound; one
   taco2 train step on the card against the CPU at the CPU tests' widths;
12. jax_export (after the CLI phase): tests/fixtures/jax_export, a JAX
   workdir exported by tools/export_jax_workdir.py, served by the
   synthesize CLI (K1-K4 counted), its mel within 2e-3 of the stored JAX
   CPU mel, and resumed by ``Trainer`` for step 3 against the stored JAX
   step (1e-4 relative);
13. train bench (last): ``bench --train-bench``'s function, cut to 3 timed
   steps a transport, its line with the card;
14. scaling (after the parallel phase): ``bench.bench_scaling("cuda")`` at
   the card count, one rank over NCCL a card (see ``run_scaling``): the
   train step, the contention control, chunked ``DistributedSynthesizer``
   (K1, K4) and WaveRNN sampling (K5) on every rank, each rank's launch
   counts;
15. style (after the jax_export phase): the style contrast on the train
   phase's gst_lj workdir (see ``run_style``): the deterministic pass's
   bits under two seeds, every one-hot pair apart, K1-K4 launched;
16. kernel_bench (after the bench): ``python -m
   gst_tacotron_tpu_torch.kernel_bench`` at the JAX tool's defaults (see
   ``run_kernel_bench``): every section launched its kernels, parity
   within the JAX kernel tests' tolerances, every roofline share <= 1.05;
17. alignment_gate (a process of its own, started after the three paths
   and waited for after the style phase: its 800 host-bound steps run
   beside the phases between): tests/test_alignment_gate.py's gate on the
   port's ``Trainer`` (``alignment_gate.run_gate``: config 3 at the JAX
   gate's widths, its token-pattern corpus, 800 steps), the trained
   teacher-forced diagonality above 0.85 and more than 0.3 above the
   untrained; then the probe batch synthesized from the trained state,
   K4-LSA and K1 counted (``GATE_LAUNCHES``), the mel within 2e-3 of the
   plain path's;
18. determinism (after the train phase): tests/test_determinism.py on the
   card, gst_lj at its published widths, B=32, over the corpus phase's
   patterns: two ``Trainer`` runs with seed 7, 6 steps each (the second
   1200-frame batch captures the step's CUDA graph, the next two replay
   it), agree in every bit of every parameter, buffer and Adam moment;
   seed 8 differs.

It prints one JSON line per kernel check, per path and per training run
(``{"train": ...}``), per chunked, bf16 and CLI run, the parallel phase's
``{"parallel": ...}``, the taco2 phase's ``{"taco2": ...}``, the
``{"jax_export": ...}`` line, the ``{"scaling": ...}`` and ``{"style":
...}`` lines, the bench's two lines, the ``{"kernel_bench": ...}`` line, the
``{"train_bench": ...}`` line, the ``{"alignment_gate": ...}`` and
``{"determinism": ...}`` lines, one ``{"kernels": [...]}`` line (every
kernel and both bf16 modes, their bounds from ``kernel_bench``'s work
counts), the card's name and power limit, and last ``{"ok": true,
"device": ...}``.

    python3 chip_smoke.py --decode-only

builds K4 alone and prints its two rows (Bahdanau at gst_lj, location-
sensitive at gst_r1_location; per-phase device time, launches and
microseconds a step) and the card.

    python3 chip_smoke.py --train-only

builds every kernel and runs the train phase alone, on a fresh corpus of
the corpus phase's kind (patterns through K3), then prints the card.

    python3 chip_smoke.py --parallel-only

builds every kernel and runs the parallel phase alone, then prints the
card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np

B = 32
TEXT_TOKENS = 64
REF_SAMPLES = 32512     # 1 + 32512 // 256 = 128 mel frames


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def bound(work):
    """(ms, "operations" or "bytes"): the least time of a kernel call's work
    (``gst_tacotron_tpu_torch.kernel_bench``'s counts) on an H100 at its
    published peaks: float32 outside the tensor cores, bf16 on them, HBM3."""
    from gst_tacotron_tpu_torch.kernel_bench import bound as least_time

    return least_time(work)


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


def device_rows(prof):
    """(name, device ms, count) of each device-side event (kernels and
    copies) with time in a torch.profiler run; host ops, which report their
    kernels' time again, are left out."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    return rows


def kernel_device_ms(torch, fn, names, counts=False):
    """Device ms of one call of ``fn`` by kernel: {label: summed device time
    of the kernels whose name contains names[label]} from torch.profiler
    ("" sums every device event); ``counts`` adds {label + "_launches":
    their launches}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    out = {label: sum(ms for key, ms, _ in rows if sub in key) for label, sub in names.items()}
    if counts:
        out.update({f"{label}_launches": sum(n for key, _, n in rows if sub in key)
                    for label, sub in names.items()})
    return out


def required_device_ms(torch, fn, names, what, counts=False):
    """``kernel_device_ms`` of kernels that must have run: a second profile
    where the first read 0 for a label (the profiler once lost every event
    of a call), then a failure for any label still at 0."""
    for _ in range(2):
        device = kernel_device_ms(torch, fn, names, counts)
        if all(device[label] > 0 for label in names):
            return device
    fail(f"{what}: the profiler saw no device time of {sorted(names.values())}: {device}")


# ---------------------------------------------------------------------------
# K1: GRU scan
# ---------------------------------------------------------------------------


def check_gru(torch, rng, dev):
    """K1 at the main path's three calls, each with ragged and full lengths:
    the encoder and post-net BiGRUs (both directions in one launch,
    ``bigru_scan``, which must give the bits of two one-direction calls) and
    the reference-encoder GRU (``gru_scan``); two runs give the same bits."""
    from gst_tacotron_tpu_torch.kernel_bench import Work, gru_scan_work
    from gst_tacotron_tpu_torch.ops.gru import bigru_scan, gru_scan, gru_scan_plain

    h = 128
    # (T, D, directions) of the main path's GRU calls: encoder BiGRU,
    # post-net BiGRU, reference-encoder GRU
    calls = [(TEXT_TOKENS, 128, 2), (400, 128, 2), (2, 256, 1)]
    t32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def kernel(xs, dirs, lens):
        if len(dirs) == 2:
            ys, finals = bigru_scan(xs, *dirs, lengths=lens)
            return [ys, *finals]
        return list(gru_scan(xs, *dirs[0], lengths=lens))

    def plain(xs, dirs, lens):
        outs = [gru_scan_plain(xs, *dr, lengths=lens, reverse=i == 1)
                for i, dr in enumerate(dirs)]
        return [torch.cat([ys for ys, _ in outs], -1), *(f for _, f in outs)]

    err, works, jobs = 0.0, [], []
    for t, d, ndir in calls:
        lim_i, lim_h = np.sqrt(6 / (d + 3 * h)), np.sqrt(6 / (4 * h))
        dirs = [(torch.zeros(B, h, device=dev), t32(rng.uniform(-lim_i, lim_i, (d, 3 * h))),
                 t32(rng.normal(0, 0.1, 3 * h)), t32(rng.uniform(-lim_h, lim_h, (h, 3 * h))),
                 t32(rng.normal(0, 0.1, 3 * h))) for _ in range(ndir)]
        xs = t32(rng.normal(0, 1, (B, t, d)))
        ragged = torch.from_numpy(rng.integers(1, t + 1, B)).to(dev)
        full = torch.full((B,), t, device=dev, dtype=torch.int64)
        for lens in (ragged, full):
            got = kernel(xs, dirs, lens)
            err = max(err, max_err(got, plain(xs, dirs, lens)))
            if max_err(got, kernel(xs, dirs, lens)) != 0.0:
                fail("gru_scan: two runs on the same input differ")
            if ndir == 2:
                f = gru_scan(xs, *dirs[0], lengths=lens)
                b = gru_scan(xs, *dirs[1], lengths=lens, reverse=True)
                if max_err(got, [torch.cat([f[0], b[0]], -1), f[1], b[1]]) != 0.0:
                    fail("bigru_scan differs from two one-direction gru_scan calls")
        jobs.append((xs, dirs, full))
        works.append(gru_scan_work(B, t, d, h, ndir))

    def run(fn):
        return lambda: [fn(*j) for j in jobs]

    reorder = lambda w: torch.cat([w[..., h:2 * h], w[..., :h], w[..., 2 * h:]], -1)

    def cudnn(dirs, bidirectional):
        m = torch.nn.GRU(dirs[0][1].shape[0], h, batch_first=True,
                         bidirectional=bidirectional).to(dev)
        with torch.no_grad():
            for sfx, (_, wi, bi, wh, bh) in zip(("", "_reverse"), dirs):
                getattr(m, "weight_ih_l0" + sfx).copy_(reorder(wi).T)
                getattr(m, "weight_hh_l0" + sfx).copy_(reorder(wh).T)
                getattr(m, "bias_ih_l0" + sfx).copy_(reorder(bi))
                getattr(m, "bias_hh_l0" + sfx).copy_(reorder(bh))
        return m

    # the library call of each kernel call (bidirectional cuDNN for a BiGRU),
    # and the earlier yardstick, one unidirectional cuDNN call a direction
    bi_mods = [(cudnn(dirs, len(dirs) == 2), xs, torch.stack([dr[0] for dr in dirs]))
               for xs, dirs, _ in jobs]
    uni_mods = [(cudnn([dr], False), xs, dr[0], i == 1)
                for xs, dirs, _ in jobs for i, dr in enumerate(dirs)]

    def library():
        with torch.no_grad():
            for m, xs, h0 in bi_mods:
                m(xs, h0)

    def library_uni():
        with torch.no_grad():
            for m, xs, h0, rev in uni_mods:
                m(torch.flip(xs, [1]) if rev else xs, h0[None])

    torch.cuda.synchronize()
    ms = time_ms(torch, run(kernel))
    plain_ms = time_ms(torch, run(plain), iters=2)
    lib = time_ms(torch, library)
    lib_uni = time_ms(torch, library_uni)
    phases = {}
    for _ in range(2):      # the profiler once lost every event of a call
        phases = kernel_device_ms(torch, run(kernel), {"input_gemm_ms": "gru_input_gemm",
                                                       "recurrence_ms": "gru_recur_kernel"})
        if phases["recurrence_ms"] > 0:
            break
    phases.update(kernel_device_ms(torch, library, {"library_device_ms": ""}))
    b_ms, b_by = bound(Work(sum(w.flops for w in works), sum(w.bytes for w in works)))
    # past H = 128: 16 weights a lane (H = 256) and the streamed form (512),
    # a BiGRU of the encoder's shape, ragged lengths, held at 1e-5 and twice
    wide = {}
    for hw in (256, 512):
        lim = np.sqrt(6 / (4 * hw))
        dirs = [(t32(rng.normal(0, 0.1, (B, hw))), t32(rng.uniform(-lim, lim, (128, 3 * hw))),
                 t32(rng.normal(0, 0.1, 3 * hw)), t32(rng.uniform(-lim, lim, (hw, 3 * hw))),
                 t32(rng.normal(0, 0.1, 3 * hw))) for _ in range(2)]
        xs = t32(rng.normal(0, 1, (B, TEXT_TOKENS, 128)))
        lens = torch.from_numpy(rng.integers(1, TEXT_TOKENS + 1, B)).to(dev)
        got = kernel(xs, dirs, lens)
        wide[f"max_err_h{hw}"] = max_err(got, plain(xs, dirs, lens))
        if max_err(got, kernel(xs, dirs, lens)) != 0.0:
            fail(f"gru_scan at H={hw}: two runs on the same input differ")
        if not wide[f"max_err_h{hw}"] <= 1e-5:
            fail(f"gru_scan at H={hw} differs from its plain version by "
                 f"{wide[f'max_err_h{hw}']} > 1e-5")
        wide[f"kernel_ms_h{hw}"] = time_ms(torch, lambda: kernel(xs, dirs, lens))
    return dict(name="gru_scan", route="cuda", source="gst_tacotron_tpu_torch/csrc/gru_scan.cu",
                replaces="gst_tacotron_tpu/ops/gru_pallas.py:56", max_err=err, tol=1e-4,
                **wide, wide_work="one BiGRU call, B=32, T=64, D=128, tol 1e-5",
                tol_reason="float32 sums over D+H terms in another order, carried "
                           "through up to 400 recurrent steps",
                kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                library_ms_unidirectional=lib_uni, **phases,
                library="torch.nn.GRU (cuDNN), bidirectional for the two BiGRUs, weights "
                        "reordered to r,z,n; the main path's rows are full length, so it "
                        "computes the same function; library_ms_unidirectional: one "
                        "unidirectional call a direction (5 calls)",
                work="the 3 K1 calls (2 BiGRUs, 1 GRU; 5 scans) of one synthesis; phases "
                     "are device time by kernel name over one run of the 3 (torch.profiler)")


# ---------------------------------------------------------------------------
# K2: reference-encoder conv stack
# ---------------------------------------------------------------------------


REFENC_SHAPE = (128, 80)          # a reference mel's frames and bins on the main path
REFENC_CHANNELS = [32, 32, 64, 64, 128, 128]


def refenc_inputs(torch, rng, dev):
    """Glorot-scaled kernels, folded BN (scales, biases) and a (B, 128, 80)
    mel, drawn from ``rng`` in that order."""
    t32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    kernels, scales, biases, c_in = [], [], [], 1
    for c in REFENC_CHANNELS:
        lim = np.sqrt(6 / (9 * c_in + 9 * c))
        kernels.append(t32(rng.uniform(-lim, lim, (3, 3, c_in, c))))
        scales.append(t32(rng.uniform(0.5, 1.5, c)))
        biases.append(t32(rng.normal(0, 0.1, c)))
        c_in = c
    return kernels, scales, biases, t32(rng.uniform(0, 1, (B, *REFENC_SHAPE)))


def conv2d_chain(torch, mel, kernels, scales, biases, dtype=None):
    """K2's library yardstick: F.pad + F.conv2d (cuDNN) + folded BN + ReLU a
    layer; ``dtype`` bfloat16 runs each conv on bf16 operands."""
    import torch.nn.functional as F

    dt = dtype or torch.float32
    wts = [k.permute(3, 2, 0, 1).contiguous().to(dt) for k in kernels]

    def library():
        x = mel[:, None]                                          # NCHW
        for wt, sc, bi in zip(wts, scales, biases):
            hh, ww = x.shape[2], x.shape[3]
            ph = max(0, ((hh + 1) // 2 - 1) * 2 + 3 - hh)
            pw = max(0, ((ww + 1) // 2 - 1) * 2 + 3 - ww)
            x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
            y = F.conv2d(x.to(dt), wt, stride=2).float()
            x = torch.relu(y * sc[:, None, None] + bi[:, None, None])
        return x

    return library


def check_refenc(torch, rng, dev):
    from gst_tacotron_tpu_torch.kernel_bench import refenc_stack_work
    from gst_tacotron_tpu_torch.ops.refenc import layer_plan, refenc_stack, refenc_stack_plain

    t, f = REFENC_SHAPE
    kernels, scales, biases, mel = refenc_inputs(torch, rng, dev)
    full = torch.full((B,), t, device=dev, dtype=torch.int64)
    ragged = torch.from_numpy(rng.integers(1, t + 1, B)).to(dev)
    err = 0.0
    for lens in (ragged, full, None):
        got = refenc_stack(mel, kernels, scales, biases, lengths=lens)
        ref = refenc_stack_plain(mel, kernels, scales, biases, lengths=lens)
        err = max(err, max_err([got], [ref]))
        same_bits("refenc_stack", [got], [refenc_stack(mel, kernels, scales, biases,
                                                       lengths=lens)])
    channels = REFENC_CHANNELS
    plan = layer_plan(B, t, f, channels, torch.cuda.get_device_properties(dev).multi_processor_count)
    if min(p["blocks"] for p in plan[:3]) < 132:
        fail(f"refenc_stack: layers L0-L2 launch {[p['blocks'] for p in plan[:3]]} blocks, "
             "fewer than the card's 132 SMs")
    # a T that is not a multiple of 64 (the per-element Pallas form's case)
    odd = mel[:, :101]
    err = max(err, max_err([refenc_stack(odd, kernels, scales, biases)],
                           [refenc_stack_plain(odd, kernels, scales, biases)]))

    library = conv2d_chain(torch, mel, kernels, scales, biases)
    kernel = lambda: refenc_stack(mel, kernels, scales, biases, lengths=full)
    ms = time_ms(torch, kernel, iters=20)
    plain = time_ms(torch, lambda: refenc_stack_plain(mel, kernels, scales, biases, lengths=full), iters=20)
    lib = time_ms(torch, library, iters=20)
    device = {}
    for _ in range(2):      # the profiler once lost every event of a call
        device = kernel_device_ms(torch, kernel, {"kernel_device_ms": "refenc_layer_kernel"})
        if device["kernel_device_ms"] > 0:
            break
    device.update(kernel_device_ms(torch, library, {"library_device_ms": ""}))
    # each layer's device time: the stacks of its first 1..6 layers, differenced
    # (5 calls a profile)
    layer_ms, prev = [], 0.0
    for n in range(1, len(channels) + 1):
        stack = lambda: [refenc_stack(mel, kernels[:n], scales[:n], biases[:n], lengths=full)
                         for _ in range(5)]
        d = kernel_device_ms(torch, stack, {"d": "refenc_layer_kernel"})["d"] / 5
        layer_ms.append(d - prev)
        prev = d
    b_ms, b_by = bound(refenc_stack_work(B, t, f, REFENC_CHANNELS))
    return dict(name="refenc_stack", route="cuda",
                source="gst_tacotron_tpu_torch/csrc/refenc_stack.cu",
                replaces="gst_tacotron_tpu/ops/refenc_pallas.py:298", max_err=err, tol=1e-4,
                tol_reason="float32 sums over up to 9*128 terms in another order, "
                           "six layers deep",
                kernel_ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                **device, layer_device_ms=layer_ms, layer_blocks=[p["blocks"] for p in plan],
                layer_splits=[[p["ks"], p["px"]] for p in plan],
                library="F.pad + F.conv2d (cuDNN, TF32 off) + folded BN + ReLU, six layers",
                work="one (32, 128, 80) stack: six launches, one a layer; device ms sums "
                     "them (torch.profiler), kernel ms is CUDA events over the call")


# the bf16 modes' budget against float32: tests/test_refenc_pallas.py's (the
# embedding) and tests/test_pallas.py's (loud mel bins)
BF16_VS_F32_TOL = 0.05


def check_refenc_bf16(torch, dev):
    """K2's bf16 operand mode (the main path's on the card: the batched
    Pallas form's ``bf16=True``) at the main path's (32, 128, 80) stack,
    ragged and full lengths: against the plain version's bf16 rounding (the
    same operands, float32 sums), apart from float32 by far more on average;
    the same bits twice, and rows 16-31 alone give the 32-row launch's bits
    (the launch plan depends on the shape alone, so one sum order whatever
    the batch); one launch a stack at this shape."""
    from gst_tacotron_tpu_torch.kernel_bench import refenc_stack_work
    from gst_tacotron_tpu_torch.ops.refenc import bf16_plan, refenc_stack, refenc_stack_plain

    rng = np.random.default_rng(21)
    t, f = REFENC_SHAPE
    kernels, scales, biases, mel = refenc_inputs(torch, rng, dev)
    full = torch.full((B,), t, device=dev, dtype=torch.int64)
    ragged = torch.from_numpy(rng.integers(1, t + 1, B)).to(dev)
    err = mean = gap = 0.0
    for lens in (ragged, full):
        got = refenc_stack(mel, kernels, scales, biases, lengths=lens, bf16=True)
        ref = refenc_stack_plain(mel, kernels, scales, biases, lengths=lens, bf16=True)
        f32 = refenc_stack_plain(mel, kernels, scales, biases, lengths=lens)
        err = max(err, max_err([got], [ref]))
        mean = max(mean, float((got - ref).abs().mean()))
        gap = max(gap, float((got - f32).abs().mean()))
        same_bits("refenc_stack:bf16", [got], [refenc_stack(mel, kernels, scales, biases,
                                                            lengths=lens, bf16=True)])
        half = refenc_stack(mel[B // 2:].contiguous(), kernels, scales, biases,
                            lengths=lens[B // 2:], bf16=True)
        if not torch.equal(half, got[B // 2:]):
            fail("refenc_stack:bf16: rows 16-31 alone differ from the 32-row launch's")
    if not mean < gap / 5:
        fail(f"refenc_stack:bf16: mean error {mean} against the plain bf16 version is not "
             f"far below its mean distance {gap} from float32")
    kernel = lambda: refenc_stack(mel, kernels, scales, biases, lengths=full, bf16=True)
    ms = time_ms(torch, kernel, iters=20)
    plain = time_ms(torch, lambda: refenc_stack_plain(mel, kernels, scales, biases,
                                                      lengths=full, bf16=True), iters=5)
    library = conv2d_chain(torch, mel, kernels, scales, biases, torch.bfloat16)
    lib = time_ms(torch, library, iters=20)
    device = required_device_ms(torch, kernel, {"kernel_device_ms": "refenc_bf16_kernel"},
                                "refenc_stack:bf16", counts=True)
    device.update(kernel_device_ms(torch, library, {"library_device_ms": ""}))
    plan = bf16_plan(t, f, REFENC_CHANNELS)
    if device["kernel_device_ms_launches"] != len(plan["launches"]) or len(plan["launches"]) > 2:
        fail(f"refenc_stack:bf16: {device['kernel_device_ms_launches']} launches a stack, the "
             f"plan's {len(plan['launches'])} (at most 2 at the main shape)")
    b_ms, b_by = bound(refenc_stack_work(B, t, f, REFENC_CHANNELS, bf16=True))
    return dict(name="refenc_stack:bf16", route="cuda",
                source="gst_tacotron_tpu_torch/csrc/refenc_bf16.cuh",
                replaces="gst_tacotron_tpu/ops/refenc_pallas.py:298", max_err=err,
                tol=BF16_VS_F32_TOL, mean_err=mean, mean_dist_from_f32=gap,
                tol_reason="tests/test_refenc_pallas.py's bf16 budget; the same bf16 operands "
                           "as the plain version, float32 sums in another order, so only a "
                           "value on a bf16 rounding boundary moves (one bf16 step); the mean "
                           "error must be under a fifth of the mean distance from float32",
                kernel_ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                **device,
                library="F.pad + F.conv2d on bf16 operands (cuDNN, float32 epilogue) + "
                        "folded BN + ReLU, six layers",
                cluster=plan["launches"][0]["bands"], band_rows=plan["bh"], k_parts=plan["ks"],
                work="one (32, 128, 80) stack in the bf16 operand mode: one clustered launch "
                     "(a cluster of CTAs an utterance, layers 1-5 on mma.sync bf16 tensor "
                     "cores, layer 0 on the CUDA cores); bound: its FLOPs at 989 TFLOP/s "
                     "(bf16 tensor cores)")


# ---------------------------------------------------------------------------
# K3, K3′, K3″: STFT features
# ---------------------------------------------------------------------------

STFT_FRAMES = 128       # a reference wav's frames on the main path
STFT_TOL = 5e-3
STFT_TOL_REASON = ("normalized-dB units, the JAX kernels' own test tolerance "
                   "(tests/test_pallas.py); float32 sums (an FFT; K3′'s bf16 bases: "
                   "tensor-core sums over 1024 taps) in another order than the plain "
                   "version's DFT products, and the log amplifies errors of quiet bins")


def stft_groups(torch, rng, dev, a):
    """K3's main-path inputs: 4 launches of 8 wavs of 128 frames."""
    length = (STFT_FRAMES - 1) * a.hop_length + a.n_fft
    groups = []
    for _ in range(B // 8):
        env = rng.uniform(0.05, 0.5, (8, 1))
        wav = rng.uniform(-1, 1, (8, length)) * env
        groups.append(torch.from_numpy(wav.astype(np.float32)).to(dev))
    return groups


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


def same_bits(name: str, a, b) -> None:
    if max_err(a, b) != 0.0:
        fail(f"{name}: two runs on the same input differ")


# n_fft past one block's shared memory (the FFT on a device-memory scratch):
# even 32768, odd 15625 = 5^6 (past 14527)
BIG_SIZES = ((32768, 4096, 28672), (15625, 3125, 12500))
# K3 off the powers of two, held to the float64 oracle
ORACLE_SIZES = ((1200, 300, 1200), (1536, 256, 1024))


def big_errs(torch, dev, cfg, fn, frames_input: bool):
    """One call at each of BIG_SIZES on 2 wavs of 7 frames against torch.fft's
    features of the same input (the dense plain version would build
    n_live x n_fft/2 bases): {"max_err_n_fft_<n_fft>": error}."""
    import dataclasses

    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP

    out = {}
    for n_fft, hop, win in BIG_SIZES:
        a = dataclasses.replace(cfg.audio, n_fft=n_fft, hop_length=hop, win_length=win)
        rng = np.random.default_rng(n_fft)
        wav = torch.from_numpy((rng.uniform(-1, 1, (2, n_fft + 6 * hop + 5)) * 0.3)
                               .astype(np.float32)).to(dev)
        dsp = TorchDSP(a, dev)
        ref = dsp.features_precentered(wav)
        if frames_input:
            x = dsp.frame_precentered(wav).reshape(-1, n_fft).contiguous()
            got = [y.reshape(r.shape) for y, r in zip(fn(x, a), ref)]
        else:
            got = fn(wav, a)
        out[f"max_err_n_fft_{n_fft}"] = max_err(got, ref)
    return out


def oracle_errs(torch, dev, cfg):
    """K3 at ORACLE_SIZES on 2 wavs of about 128 frames, prepared as the
    extractor prepares them (preemphasis, reflect pad), against the host
    float64 oracle of the raw wavs: {"max_err_oracle_n_fft_<n_fft>": error}."""
    import dataclasses

    from gst_tacotron_tpu_torch.dsp import ref as dsp_ref
    from gst_tacotron_tpu_torch.ops.stft import stft_features

    out = {}
    for n_fft, hop, win in ORACLE_SIZES:
        a = dataclasses.replace(cfg.audio, n_fft=n_fft, hop_length=hop, win_length=win)
        rng = np.random.default_rng(n_fft + 1)
        raw = rng.uniform(-1, 1, (2, hop * 127)) * 0.3
        pre = [np.pad(dsp_ref.preemphasis(w, a.preemphasis), n_fft // 2, mode="reflect")
               for w in raw]
        # float32 by name: the oracle is the float64 host function
        got = stft_features(torch.from_numpy(np.stack(pre).astype(np.float32)).to(dev), a,
                            bf16=False)
        err = 0.0
        for i, w in enumerate(raw):
            for x, y in zip(got, (dsp_ref.melspectrogram(w, a), dsp_ref.spectrogram(w, a))):
                err = max(err, float(np.abs(x[i].cpu().numpy() - y).max()))
        out[f"max_err_oracle_n_fft_{n_fft}"] = err
    return out


def check_stft(torch, rng, dev, cfg):
    from gst_tacotron_tpu_torch.kernel_bench import stft_work
    from gst_tacotron_tpu_torch.ops.stft import stft_bases, stft_features, stft_features_plain

    a = cfg.audio
    bases = stft_bases(a, dev)
    groups = stft_groups(torch, rng, dev, a)
    err = 0.0
    for g in groups:
        got = stft_features(g, a, bases, bf16=False)
        ref = stft_features_plain(g, a, bases)
        err = max(err, max_err(got, ref))
        same_bits("stft_features", got, stft_features(g, a, bases, bf16=False))

    ms = time_ms(torch, lambda: [stft_features(g, a, bases, bf16=False) for g in groups],
                 iters=10)
    plain = time_ms(torch, lambda: [stft_features_plain(g, a, bases) for g in groups], iters=10)
    lib = time_ms(torch, torch_stft_yardstick(torch, a, groups, bases), iters=10)
    # device time alone: at microseconds a launch, the timed loop may wait on
    # the host's calls rather than on the card
    device = kernel_device_ms(torch, lambda: [stft_features(g, a, bases, bf16=False)
                                              for g in groups],
                              {"kernel_device_ms": "stft_wav_kernel"})
    device.update(kernel_device_ms(torch, torch_stft_yardstick(torch, a, groups, bases),
                                   {"library_device_ms": ""}))
    # the function's least work: a real FFT a frame and the nonzero mel weights
    b_ms, b_by = bound(stft_work(a, B * STFT_FRAMES, 4.0 * sum(g.numel() for g in groups)))
    oracle = oracle_errs(torch, dev, cfg)
    if not max(oracle.values()) <= CORPUS_TOL:
        fail(f"stft_features off the powers of two: {oracle} > {CORPUS_TOL} from the oracle")
    big = big_errs(torch, dev, cfg, lambda x, c: stft_features(x, c, bf16=False), False)
    return dict(name="stft_features", route="cuda",
                source="gst_tacotron_tpu_torch/csrc/stft_features.cu",
                replaces="gst_tacotron_tpu/ops/stft_pallas.py:417",
                max_err=max(err, *big.values()), max_err_n_fft_2048=err, **big, **oracle,
                oracle_tol=CORPUS_TOL, tol=STFT_TOL, tol_reason=STFT_TOL_REASON,
                kernel_ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                **device,
                library="torch.stft (cuFFT) + abs + mel product + dB normalization",
                work="the 4 launches (32 wavs of 128 frames) of one synthesis")


def check_stft_bf16(torch, dev, cfg):
    """K3's bf16 operand mode (the main path's reference mels on the card, as
    the JAX extractor's ``bf16=not self.interpret`` on its accelerator) at
    K3's main-path launches (4 x 8 wavs of 128 frames): against the plain
    version's bf16 rounding (the same operands, float32 sums), apart from
    float32 by far more on average and within 0.05 of it on loud mel bins
    (tests/test_pallas.py's bf16 check); the same bits twice; n_fft 6144
    (past 8 bin windows: the magnitudes through the device-memory scratch);
    timed beside the plain version and the bf16 GEMMs of the library."""
    import dataclasses

    from gst_tacotron_tpu_torch.kernel_bench import stft_bf16_work
    from gst_tacotron_tpu_torch.ops.stft import (db_normalize, dft_bases, live_tap_span,
                                                 stft_bases, stft_features, stft_features_plain)

    a = cfg.audio
    bases = stft_bases(a, dev)
    groups = stft_groups(torch, np.random.default_rng(13), dev, a)
    err = mean = gap = loud = 0.0
    for g in groups:
        got = stft_features(g, a, bases, bf16=True)
        ref = stft_features_plain(g, a, bases, bf16=True)
        f32 = stft_features_plain(g, a, bases)
        err = max(err, max_err(got, ref))
        mean = max(mean, float((got[0] - ref[0]).abs().mean()))
        gap = max(gap, float((got[0] - f32[0]).abs().mean()))
        loud = max(loud, float((got[0] - f32[0]).abs()[f32[0] > 0.5].max()))
        same_bits("stft_features:bf16", got, stft_features(g, a, bases, bf16=True))
    if not (mean < gap / 5 and loud <= BF16_VS_F32_TOL):
        fail(f"stft_features:bf16: mean error {mean} against the plain bf16 version (its "
             f"mean distance from float32 {gap}), loud mel bins {loud} from float32")
    a6 = dataclasses.replace(a, n_fft=6144, hop_length=1536, win_length=4608)
    w6 = torch.from_numpy((np.random.default_rng(6144).uniform(-1, 1, (2, 6144 + 1536 * 30))
                           * 0.3).astype(np.float32)).to(dev)
    err_6144 = max_err(stft_features(w6, a6, bf16=True), stft_features_plain(w6, a6, bf16=True))

    kernel = lambda: [stft_features(g, a, bases, bf16=True) for g in groups]
    j0, _, n_live = live_tap_span(a)
    cos16, sin16 = (x.to(torch.bfloat16) for x in dft_bases(a, str(dev)))
    mel16 = bases["mel_t"][: a.num_freq].to(torch.bfloat16)
    n0 = j0 * a.hop_length

    def library():
        # the mode's function as bf16 GEMMs with float32 outputs: the two DFT
        # products, the magnitude, the mel product on bf16 operands, dB
        for g in groups:
            fr = g[:, n0:].unfold(-1, n_live, a.hop_length)[:, :STFT_FRAMES]
            fr = fr.to(torch.bfloat16).reshape(-1, n_live)
            re = torch.mm(fr, cos16, out_dtype=torch.float32)
            im = torch.mm(fr, sin16, out_dtype=torch.float32)
            mag = torch.sqrt(re * re + im * im)
            mel = torch.mm(mag.to(torch.bfloat16), mel16, out_dtype=torch.float32)
            db_normalize(mel, a), db_normalize(mag, a)

    ms = time_ms(torch, kernel, iters=10)
    plain = time_ms(torch, lambda: [stft_features_plain(g, a, bases, bf16=True)
                                    for g in groups], iters=10)
    lib = time_ms(torch, library, iters=10)
    device = required_device_ms(torch, kernel, {"kernel_device_ms": "stft_bf16_wgmma"},
                                "stft_features:bf16")
    device.update(kernel_device_ms(torch, library, {"library_device_ms": ""}))
    b_ms, b_by = bound(stft_bf16_work(a, B * STFT_FRAMES, 4.0 * sum(g.numel() for g in groups)))
    return dict(name="stft_features:bf16", route="cuda",
                source="gst_tacotron_tpu_torch/csrc/stft_bf16.cuh",
                replaces="gst_tacotron_tpu/ops/stft_pallas.py:417",
                max_err=max(err, err_6144), max_err_n_fft_2048=err, max_err_n_fft_6144=err_6144,
                mean_err_mel=mean, mean_dist_from_f32_mel=gap, max_err_loud_vs_f32=loud,
                loud_vs_f32_tol=BF16_VS_F32_TOL, tol=STFT_TOL,
                tol_reason=STFT_TOL_REASON + "; bf16 mode: the plain version rounds the same "
                           "operands, so only a magnitude on a bf16 rounding boundary moves "
                           "(one bf16 step); the mean error must be under a fifth of the mean "
                           "distance from float32",
                kernel_ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                **device,
                library="torch.mm of the bf16 frames and bases, then of the bf16 magnitude "
                        "and mel basis, float32 outputs, + dB normalization",
                work="K3's 4 launches (32 wavs of 128 frames) in the bf16 mode (wgmma on "
                     "TMA-fed bases, 64-frame tiles, clusters of 8 CTAs over the 144-bin "
                     "windows, a bf16 mel product); bound: the dense bf16 products and the "
                     "mel at 989 TFLOP/s")


# (n_fft, hop, win) whose FFTs run the other stages on the card: 768 =
# 4^4 * 3 (radix 3), 513 = 3^3 * 19 (the generic stage), odd 1575 = 3^2 *
# 5^2 * 7 (radix 5, the generic stage, the unpacked real transform)
MIXED_SIZES = ((1536, 256, 1024), (1026, 342, 1000), (1575, 525, 1500))


def mixed_radix_errs(torch, dev, cfg, fn, plain, frames_input: bool, suffix: str = ""):
    """One call at each of MIXED_SIZES against the plain version, on 2 wavs
    of 128 frames: {"max_err_n_fft_<n_fft><suffix>": error}."""
    import dataclasses

    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP

    out = {}
    for n_fft, hop, win in MIXED_SIZES:
        a = dataclasses.replace(cfg.audio, n_fft=n_fft, hop_length=hop, win_length=win)
        rng = np.random.default_rng(n_fft)
        wav = torch.from_numpy((rng.uniform(-1, 1, (2, (STFT_FRAMES - 1) * hop + n_fft))
                                * 0.3).astype(np.float32)).to(dev)
        x = TorchDSP(a, dev).frame_precentered(wav).reshape(-1, n_fft).contiguous() \
            if frames_input else wav
        out[f"max_err_n_fft_{n_fft}{suffix}"] = max_err(fn(x, a), plain(x, a))
    return out


def check_stft_fused(torch, dev, cfg):
    """K3′ at K3's shapes, in float32 (the extractor's route; compared with K3
    too, which runs the same arithmetic) and with bf16 bases on the tensor
    cores (held against the plain version's bf16 rounding); both give the
    same bits twice; one float32 and one bf16 call at each of MIXED_SIZES."""
    from gst_tacotron_tpu_torch.kernel_bench import stft_bf16_work, stft_work
    from gst_tacotron_tpu_torch.ops.stft import (bf16_plan, db_normalize, dft_bases,
                                                 live_tap_span, stft_bases, stft_features,
                                                 stft_features_fused, stft_features_plain)

    a = cfg.audio
    bases = stft_bases(a, dev)
    groups = stft_groups(torch, np.random.default_rng(11), dev, a)
    err = err_bf16 = err_k3 = 0.0
    k3_bits = True
    for g in groups:
        got = stft_features_fused(g, a, bases)
        err = max(err, max_err(got, stft_features_plain(g, a, bases)))
        k3 = stft_features(g, a, bases, bf16=False)
        err_k3 = max(err_k3, max_err(got, k3))
        k3_bits &= all(bool(torch.equal(x, y)) for x, y in zip(got, k3))
        err_bf16 = max(err_bf16, max_err(stft_features_fused(g, a, bases, bf16_bases=True),
                                         stft_features_plain(g, a, bases, bf16_bases=True)))
    same_bits("stft_fused", stft_features_fused(groups[0], a, bases),
              stft_features_fused(groups[0], a, bases))
    same_bits("stft_fused (bf16 bases)", stft_features_fused(groups[0], a, bases, bf16_bases=True),
              stft_features_fused(groups[0], a, bases, bf16_bases=True))
    if not err_k3 <= 1e-6:
        fail(f"stft_fused differs from K3 (the same arithmetic) by {err_k3} > 1e-6")
    mixed = mixed_radix_errs(torch, dev, cfg, lambda x, c: stft_features_fused(x, c),
                             lambda x, c: stft_features_plain(x, c), False)
    mixed.update(mixed_radix_errs(
        torch, dev, cfg, lambda x, c: stft_features_fused(x, c, bf16_bases=True),
        lambda x, c: stft_features_plain(x, c, bf16_bases=True), False, "_bf16"))
    mixed.update(big_errs(torch, dev, cfg, lambda x, c: stft_features_fused(x, c), False))
    # bf16 bases past 8 bin windows: several windows a CTA, the magnitudes
    # through the device-memory scratch
    import dataclasses

    a6 = dataclasses.replace(a, n_fft=6144, hop_length=1536, win_length=4608)
    w6 = torch.from_numpy((np.random.default_rng(6144).uniform(-1, 1, (2, 6144 + 1536 * 30))
                           * 0.3).astype(np.float32)).to(dev)
    mixed["max_err_n_fft_6144_bf16"] = max_err(
        stft_features_fused(w6, a6, bf16_bases=True),
        stft_features_plain(w6, a6, bf16_bases=True))

    f32 = lambda: [stft_features_fused(g, a, bases) for g in groups]
    bf16 = lambda: [stft_features_fused(g, a, bases, bf16_bases=True) for g in groups]
    library = torch_stft_yardstick(torch, a, groups, bases)
    # the bf16 mode's library call: the plain version's two products on
    # bf16 operands, as bf16 GEMMs with float32 outputs, then the magnitude,
    # the mel product and the dB maps (framing included, as the plain does)
    j0, _, n_live = live_tap_span(a)
    cos16, sin16 = (x.to(torch.bfloat16) for x in dft_bases(a, str(dev)))
    mel_t = bases["mel_t"][: a.num_freq]
    n0 = j0 * a.hop_length

    def library_bf16():
        for g in groups:
            fr = g[:, n0:].unfold(-1, n_live, a.hop_length)[:, :STFT_FRAMES]
            fr = fr.to(torch.bfloat16).reshape(-1, n_live)
            re = torch.mm(fr, cos16, out_dtype=torch.float32)
            im = torch.mm(fr, sin16, out_dtype=torch.float32)
            mag = torch.sqrt(re * re + im * im)
            db_normalize(mag @ mel_t, a), db_normalize(mag, a)

    ms = time_ms(torch, f32, iters=10)
    ms_bf16 = time_ms(torch, bf16, iters=10)
    plain = time_ms(torch, lambda: [stft_features_plain(g, a, bases) for g in groups], iters=10)
    lib = time_ms(torch, library, iters=10)
    lib_bf16 = time_ms(torch, library_bf16, iters=10)
    device = kernel_device_ms(torch, f32, {"kernel_device_ms": "stft_wav_kernel"})
    device.update(required_device_ms(torch, bf16, {"kernel_device_ms_bf16": "stft_bf16_wgmma"},
                                     "stft_fused (bf16 bases)"))
    device.update(kernel_device_ms(torch, library, {"library_device_ms": ""}))
    device.update(kernel_device_ms(torch, library_bf16, {"library_device_ms_bf16": ""}))
    n_frames = B * STFT_FRAMES
    wav_bytes = 4.0 * sum(g.numel() for g in groups)
    b_ms, b_by = bound(stft_work(a, n_frames, wav_bytes))
    # the dense products over the live taps and the num_freq real bins (the
    # kernel's zero padding past them is not the function's work) and the mel
    b_bf16, b_bf16_by = bound(stft_bf16_work(a, n_frames, wav_bytes))
    return dict(name="stft_fused", route="cuda",
                source="gst_tacotron_tpu_torch/csrc/stft_fused.cu",
                replaces="gst_tacotron_tpu/ops/stft_pallas.py:265",
                max_err=max(err, err_bf16, *mixed.values()), max_err_f32=err,
                max_err_bf16=err_bf16, **mixed,
                bf16_plan_n_fft_6144=bf16_plan(6144, 1536, live_tap_span(a6)[2], a6.num_mels),
                max_err_vs_k3=err_k3,
                bits_equal_k3=k3_bits, tol=STFT_TOL, tol_reason=STFT_TOL_REASON,
                kernel_ms=ms, kernel_ms_bf16=ms_bf16, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, bound_ms_bf16_products=b_bf16, bound_by_bf16=b_bf16_by,
                library_ms=lib, library_ms_bf16=lib_bf16, **device,
                library="torch.stft (cuFFT) + abs + mel product + dB normalization; bf16: "
                        "torch.mm of the bf16 frames and bases with float32 outputs + abs "
                        "+ mel product + dB normalization",
                work="K3's 4 launches (32 wavs of 128 frames), float32 (mixed-radix FFT) "
                     "and bf16 bases (tensor cores); bound_ms_bf16_products: the dense "
                     "bf16 products at 989 TFLOP/s")


def check_stft_frames(torch, dev, cfg):
    """K3″ at K3's shapes: the (1024, n_fft) frames of each 8-wav launch; the
    same bits twice; one call at each of MIXED_SIZES."""
    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP
    from gst_tacotron_tpu_torch.kernel_bench import stft_work
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
    same_bits("stft_frames", stft_features_frames(frames[0], a, bases),
              stft_features_frames(frames[0], a, bases))
    mixed = mixed_radix_errs(torch, dev, cfg, lambda x, c: stft_features_frames(x, c),
                             lambda x, c: stft_features_frames_plain(x, c), True)
    mixed.update(big_errs(torch, dev, cfg, lambda x, c: stft_features_frames(x, c), True))

    window = dsp.window
    mel_t = bases["mel_t"][: a.num_freq]

    def library():
        for f in frames:
            spec = torch.fft.rfft(f * window, n=a.n_fft, dim=-1).abs()
            db_normalize(spec @ mel_t, a), db_normalize(spec, a)

    kernel = lambda: [stft_features_frames(f, a, bases) for f in frames]
    ms = time_ms(torch, kernel, iters=10)
    plain = time_ms(torch, lambda: [stft_features_frames_plain(f, a, bases) for f in frames],
                    iters=10)
    lib = time_ms(torch, library, iters=10)
    device = kernel_device_ms(torch, kernel, {"kernel_device_ms": "stft_frames_kernel"})
    device.update(kernel_device_ms(torch, library, {"library_device_ms": ""}))
    _, _, n_live = live_tap_span(a)
    n_frames = sum(f.shape[0] for f in frames)
    # the function reads only the live columns of each frame
    b_ms, b_by = bound(stft_work(a, n_frames, 4.0 * n_frames * n_live))
    return dict(name="stft_frames", route="cuda",
                source="gst_tacotron_tpu_torch/csrc/stft_frames.cu",
                replaces="gst_tacotron_tpu/ops/stft_pallas.py:118",
                max_err=max(err, *mixed.values()), max_err_n_fft_2048=err, **mixed,
                tol=STFT_TOL, tol_reason=STFT_TOL_REASON,
                kernel_ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                **device,
                library="torch.fft.rfft (cuFFT) of the windowed frames + abs + mel product "
                        "+ dB normalization",
                work="4 launches of 1024 frames (the frames of K3's 4 x 8 wavs)")


# ---------------------------------------------------------------------------
# K4: decode
# ---------------------------------------------------------------------------


# K4's kernels by profiler name: the nine phases of a step and the one-off
# preparation (keys and weights transposed, the alignment state)
DECODE_PHASES = {"P1_prenet1_state_products": "decode_phase<1>", "P2_prenet2": "decode_phase<2>",
                 "P3_attention_gru": "decode_phase<3>", "P4_query_scores": "decode_scores",
                 "P5_softmax_context": "decode_attend", "P6_decoder_input": "decode_phase<6>",
                 "P7_gru1": "decode_phase<7>", "P8_gru2": "decode_phase<8>",
                 "P9_frame_stop": "decode_phase<9>", "prep": "decode_prep"}
DECODE_STEP_KERNELS = ("decode_phase<", "decode_scores", "decode_attend")


def check_decode(torch, rng, dev, cfg, init_seed=7):
    """K4 at ``cfg``'s shapes: the Bahdanau branch (gst_lj) or the
    location-sensitive one (gst_r1_location)."""
    from gst_tacotron_tpu_torch.kernel_bench import decode_scan_work
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
    # a data-parallel rank's rows: the last 16 at row0 16 draw those rows'
    # dropout of the whole batch
    half = B // 2
    shard = (memory[half:].contiguous(), keys[half:].contiguous(), lengths[half:])
    dr = decode_scan(packed, *shard, seed=1, use_dropout=True, row0=half, **kw)
    err_row0 = max_err(dr, decode_scan_plain(packed, *shard, seed=1, use_dropout=True,
                                             row0=half, **kw))
    err_row0_vs_batch = max_err(dr, tuple(x[half:] for x in d1))

    full = torch.full((B,), TEXT_TOKENS, device=dev, dtype=torch.int64)
    ms = time_ms(torch, lambda: decode_scan(packed, memory, keys, full, seed=3,
                                            use_dropout=True, **kw), iters=3)
    plain = time_ms(torch, lambda: decode_scan_plain(packed, memory, keys, full, seed=3,
                                                     use_dropout=True, **kw), iters=1)
    # device time by phase kernel (csrc/decode_scan.cu), one profiled decode
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode_scan(packed, memory, keys, full, seed=3, use_dropout=True, **kw)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    per_phase = {label: sum(ms for key, ms, _ in rows if sub in key)
                 for label, sub in DECODE_PHASES.items()}
    step_launches = sum(n for key, _, n in rows
                        if any(sub in key for sub in DECODE_STEP_KERNELS))
    device_ms = sum(ms for key, ms, _ in rows if "decode_" in key)
    n_w = sum(x.numel() for x in packed.values())
    r = m.decoder.reduction_factor
    # the useful work: the location taps of the band only (LSA)
    b_ms, b_by = bound(decode_scan_work(cfg, B, TEXT_TOKENS, steps, n_w, dense_band=True))
    # a kernel row is named by the launch counter its path reads
    return dict(name="decode_scan:location_sensitive" if lsa else "decode_scan", route="cuda",
                source="gst_tacotron_tpu_torch/csrc/decode_scan.cu",
                replaces="gst_tacotron_tpu/ops/decode_pallas.py:328", max_err=err, tol=1e-3,
                max_err_dropout=err_dropout, max_err_row0=err_row0,
                max_err_row0_vs_whole_batch=err_row0_vs_batch,
                tol_reason=f"float32 GEMV sums in another order, fed back through {steps} "
                           "autoregressive steps (the last frame re-enters the prenet"
                           + (", the alignment the location taps)" if lsa else ")"),
                kernel_ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                kernel_device_ms=device_ms, phase_device_ms=per_phase,
                launches_per_step=step_launches / steps, us_per_step=1e3 * ms / steps,
                device_us_per_step=1e3 * device_ms / steps,
                library="none: no single PyTorch call runs an autoregressive decode",
                work=f"one {steps}-step decode of 32 utterances at r={r}, "
                     f"{m.attention.kind} attention, dropout on; max_err_row0: rows 16-31 "
                     "alone at row0 16 against the plain version, and (vs_whole_batch) "
                     "against those rows of the 32-row launch")


# ---------------------------------------------------------------------------
# K5: WaveRNN sampling
# ---------------------------------------------------------------------------


def check_wavernn(torch, rng, dev, cfg, frames=128):
    """K5 at config 5's widths, B=32 rows of ``frames`` mel frames. A
    reordered float32 sum can flip a near-tie, after which the kernel's and
    the plain version's histories part, so the kernel is held teacher-forced:
    the plain pass runs on the kernel's own classes and every class must
    score within the tolerance of its step's best."""
    from gst_tacotron_tpu_torch.kernel_bench import wavernn_sample_work
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
    # a data-parallel rank's rows: the last 16 at row0 16 sample with those
    # rows' noise of the whole batch
    half = B // 2
    c_row0 = wavernn_sample(packed, cond[half:].contiguous(), hop=hop, seed=1, row0=half)
    with torch.no_grad():
        gaps_greedy = score_gaps(packed, cond, greedy, hop=hop, greedy=True)
        gaps = score_gaps(packed, cond, c1, hop=hop, seed=1)
        gaps_row0 = score_gaps(packed, cond[half:], c_row0, hop=hop, seed=1, row0=half)
    plain = time_ms(torch, lambda: wavernn_sample_plain(packed, cond, hop=hop, seed=1),
                    iters=1, warmup=0)
    device = {}
    for _ in range(2):      # the profiler once lost every event of a call
        device = kernel_device_ms(torch, lambda: wavernn_sample(packed, cond, hop=hop, seed=1),
                                  {"kernel_device_ms": "wavernn_sample_kernel"})
        if device["kernel_device_ms"] > 0:
            break
    # the latency floor: the same launch on a model of width 8 (8 classes),
    # whose samples are three grid barriers and next to no work
    w8 = lambda *shape: torch.full(shape, 0.01 if len(shape) == 2 else 0.0, device=dev)
    tiny = dict(embed=w8(8, 8), wi=w8(8, 24), bi=w8(24), wh=w8(8, 24), bh=w8(24),
                fc1=w8(8, 8), fb1=w8(8), fc2=w8(8, 8), fb2=w8(8))
    tiny_cond = torch.zeros(B, frames, 8, device=dev)
    tiny_ms = time_ms(torch, lambda: wavernn_sample(tiny, tiny_cond, hop=hop, seed=1),
                      iters=1)
    nw = sum(x.numel() for x in packed.values())
    b_ms, b_by = bound(wavernn_sample_work(cfg, B, frames, cond.shape[-1], nw))
    # the least work once the input product is hoisted: the two tables
    # (embed and cond against wi) once, then 3H*H + H*F + F*K a row and sample
    b_hoisted, b_hoisted_by = bound(wavernn_sample_work(cfg, B, frames, cond.shape[-1], nw,
                                                        hoisted=True))
    return dict(name="wavernn_sample", route="cuda",
                source="gst_tacotron_tpu_torch/csrc/wavernn_sample.cu",
                replaces="gst_tacotron_tpu/ops/wavernn_pallas.py:119",
                max_err=max(float(gaps_greedy.max()), float(gaps.max())), tol=1e-3,
                max_err_greedy=float(gaps_greedy.max()), max_err_sampled=float(gaps.max()),
                max_err_row0=float(gaps_row0.max()),
                row0_classes_equal_whole_batch_rows=bool(torch.equal(c_row0, c1[half:])),
                share_plain_argmax=float((gaps == 0).float().mean()),
                share_plain_argmax_greedy=float((gaps_greedy == 0).float().mean()),
                err_unit="score (logit / temperature + Gumbel noise) below the plain "
                         "teacher-forced pass's best at each step",
                tol_reason="float32 GEMV sums over 512 terms in another order than the "
                           "plain version's products, through 32,768 recurrent steps",
                kernel_ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                **device, bound_ms_hoisted=b_hoisted, bound_by_hoisted=b_hoisted_by,
                width8_ms=tiny_ms, barrier_us_per_sample_width8=1e3 * tiny_ms / n,
                library="none: no single PyTorch call runs autoregressive sampling",
                work=f"32 rows of {frames} frames ({n} samples), Gumbel-max at temperature 1, "
                     "one launch; bound_ms counts the input product every sample (the TPU "
                     "kernel's work), bound_ms_hoisted the tables once; width8_ms: the "
                     "same launch at width 8, three grid barriers a sample")


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
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from gst_tacotron_tpu_torch.dsp.device_features import DeviceFeatureExtractor
    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP
    from gst_tacotron_tpu_torch.ops.refenc import gst_style_from_params
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
        # as GSTTacotron.infer: the style from the fast path (K2 in its bf16
        # mode on the card, K1)
        (memory, _), stages["encode_and_gst"] = timed(lambda: model.build_memory(
            tok, tok_len, generator=gen,
            precomputed_style=gst_style_from_params(model.gst, ref, ref_len)[0]))
        dec_out, stages["decode"] = timed(lambda: model.decoder.decode(memory, tok_len, seed=1))
        linear, stages["postnet"] = timed(lambda: model.postnet(dec_out[0], dec_out[3]).float())
        gl = {}
        if vocoder is None:
            # the config's own setting (gst_lj's default: the iterations'
            # DFTs on bf16 operands), then the other one
            wavs_gl = {}
            for flag in (cfg.audio.griffin_lim_bf16, not cfg.audio.griffin_lim_bf16):
                dsp = TorchDSP(dataclasses.replace(cfg.audio, griffin_lim_bf16=flag), dev)
                label = "griffin_lim" if flag == cfg.audio.griffin_lim_bf16 else \
                    f"griffin_lim_bf16_{flag}"
                dsp.inv_linear_spectrogram(linear)      # bases, plans: set-up, not the stage
                wavs_gl[flag], stages[label] = timed(lambda: dsp.inv_linear_spectrogram(linear))
            diff = float((wavs_gl[True] - wavs_gl[False]).abs().max())
            if not all(bool(torch.isfinite(w).all()) for w in wavs_gl.values()) or diff == 0.0:
                fail(f"{name}: Griffin-Lim with griffin_lim_bf16 True and False: finite "
                     f"outputs that differ expected, max difference {diff}")
            gl = {"griffin_lim_bf16": cfg.audio.griffin_lim_bf16,
                  "griffin_lim_bf16_vs_f32_max_abs": diff}
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
        rows = sorted(((k[:60], ms, n) for k, ms, n in device_rows(prof)),
                      key=lambda r: -r[1])
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
    return {"profile": {"name": name, "stage_ms": stages, **gl, "profiled_wall_ms": wall,
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


def run_corpus(torch, dev, cfg, out):
    """The training-corpus path on ``cfg`` (gst_lj): a variable-length
    synthetic corpus -> ``generate_patterns(device_features=True)`` (K3),
    into the directory ``out`` (the train phase's corpus) ->
    every extractor route and ``KernelDSP`` on the same prepared wavs (K3′,
    K3″, the plain route) -> ``BucketedLoader`` batches in both transports ->
    ``_materialize_features`` on the card. Each route is held against the
    host numpy oracle and the resident route's patterns, the wire features
    against the feature batches. Counts are set to 0 once before the path
    and read after it; each phase's launches are the counts' growth over
    it. Returns the path's launch counts."""
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
    t0 = start()
    # float32 by name (the card's default is K3's bf16 mode): the patterns are
    # held against the float64 host oracle, and the wire features against them
    generate_patterns(utts, a, out, store_wav=True, device_features=True, device=dev,
                      bf16=False)
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
        # float32 by name: each route is held against the float64 oracle
        ex = DeviceFeatureExtractor(a, dev, stft_kernel=route, bf16=False)
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
    # the resident route as the card runs it by default: K3's bf16 mode, held
    # against its plain version (the same bf16 rounding) and, on loud mel bins,
    # against the float64 oracle (tests/test_pallas.py's bf16 budget)
    label = "resident bf16"
    t0 = start()
    res_bf16 = DeviceFeatureExtractor(a, dev).extract(wavs)
    route_ms[label] = 1e3 * stop(label, t0)
    calls = len(DeviceFeatureExtractor(a, dev).plan(num_frames))
    if launches[label] != {"stft_features": calls, "stft_features:bf16": calls}:
        fail(f"corpus: route {label} launched {launches[label]}, expected {calls} launches "
             "of stft_features, each in its bf16 branch")
    plain_bf16 = DeviceFeatureExtractor(a, dev, plain=True).extract(wavs)
    bf16_errs = {"vs_plain_bf16": errs(res_bf16, plain_bf16),
                 "loud_mel_vs_oracle": max(
                     float(np.abs(r[0] - o[0])[o[0] > 0.5].max(initial=0.0))
                     for r, o in zip(res_bf16, oracle))}
    del res_bf16, plain_bf16
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
            "tol": CORPUS_TOL, "tol_kernel_dsp": DSP_TOL, "resident_bf16": bf16_errs,
            "tol_bf16": [STFT_TOL, BF16_VS_F32_TOL], "buckets": sizes,
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
    if not (max(bf16_errs["vs_plain_bf16"]) <= STFT_TOL
            and bf16_errs["loud_mel_vs_oracle"] <= BF16_VS_F32_TOL):
        fail(f"corpus: the resident route's bf16 mode: {bf16_errs} (tolerances {STFT_TOL} "
             f"against its plain version, {BF16_VS_F32_TOL} on loud mel bins)")
    if not max(wire_vs_oracle) <= CORPUS_TOL:
        fail(f"corpus: wire features differ from the wire's host oracle by "
             f"{max(wire_vs_oracle)} > {CORPUS_TOL}")
    for k, (mae, mx) in wire_err.items():
        if not (mae < WIRE_MAE and (k == "linear" or mx < WIRE_MAX[k])):
            fail(f"corpus: wire {k} MAE {mae} / max {mx} outside ({WIRE_MAE}, {WIRE_MAX[k]})")
    if not zeros_ok or n_batches < len(sizes):
        fail(f"corpus: zeros past length {zeros_ok}, {n_batches} batches")
    return ops.launch_counts()


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

TRAIN_STEPS, WIRE_STEPS = 6, 2
# tests/test_train_smoke.py::small_cfg's widths (the CPU tests' sizes)
SMALL_WIDTHS = {
    "audio.n_fft": 512, "audio.hop_length": 128, "audio.win_length": 512,
    "model.num_freq": 257, "model.encoder.embedding_dim": 32,
    "model.encoder.prenet_dims": [32, 16], "model.encoder.cbhg_bank_k": 4,
    "model.encoder.cbhg_bank_channels": 16, "model.encoder.cbhg_proj_channels": [16, 16],
    "model.encoder.cbhg_highway_layers": 2, "model.encoder.cbhg_highway_dim": 16,
    "model.encoder.cbhg_gru_dim": 16, "model.gst.ref_conv_channels": [4, 8, 16],
    "model.gst.ref_gru_dim": 16, "model.gst.style_dim": 16, "model.attention.dim": 16,
    "model.decoder.prenet_dims": [32, 16], "model.decoder.attention_rnn_dim": 16,
    "model.decoder.decoder_rnn_dim": 16, "model.postnet.cbhg_bank_k": 2,
    "model.postnet.cbhg_bank_channels": 8, "model.postnet.cbhg_proj_channels": [16, 80],
    "model.postnet.cbhg_highway_layers": 1, "model.postnet.cbhg_highway_dim": 16,
    "model.postnet.cbhg_gru_dim": 16}
TRAIN_TOL = 1e-5          # card against CPU: loss (relative), parameters (absolute)
GRAD_TOL = 1e-4           # gradients, relative to each tensor's largest |g|


def nonzero_counts(ops):
    return {k: n for k, n in ops.launch_counts().items() if n}


def drive_trainer(torch, ops, trainer, steps, eval_fn=None):
    """``trainer.train(steps)`` with every step timed (a synchronize at its
    end) and held to zero kernel launches, and every parameter's gradient
    nonzero at step 1. Returns (per-step records, eval hook launches)."""
    records, eval_launches = [], {}
    t_last = [time.perf_counter()]

    def on_step(tr, step, metrics, frames):
        torch.cuda.synchronize()
        now = time.perf_counter()
        records.append({"step": step, "frames": frames, "ms": 1e3 * (now - t_last[0]),
                        **{k: float(v) for k, v in metrics.items()}})
        counts = nonzero_counts(ops)
        if counts:
            fail(f"train: step {step} launched kernels {counts}")
        if step == 1:
            dead = [k for k, p in tr.state.model.named_parameters()
                    if p.grad is None or not bool(p.grad.abs().max() > 0)]
            if dead:
                fail(f"train: no gradient at step 1 for {dead}")
        t_last[0] = time.perf_counter()

    def hook(tr, step):
        before = ops.launch_counts()
        eval_launches["run_eval"] = nonzero_counts(ops)
        eval_fn(tr, step)
        torch.cuda.synchronize()
        eval_launches["eval_hook"] = {k: n - before[k] for k, n in ops.launch_counts().items()
                                      if n != before[k]}
        ops.reset_launch_counts()
        t_last[0] = time.perf_counter()

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer.train(steps, eval_fn=hook if eval_fn else None, on_step=on_step)
    return records, eval_launches


def train_line(cfg, transport, records, restored, **extra):
    by_bucket = {}
    for r in records:
        by_bucket.setdefault(str(r["frames"]), []).append(r["ms"])
    losses = [r["loss"] for r in records]
    if not all(np.isfinite(v) for r in records for k, v in r.items() if k.endswith("loss")):
        fail(f"train ({transport}): non-finite loss in {records}")
    return {"train": {"config": cfg.name, "transport": transport, "steps": len(records),
                      "batch": cfg.data.batch_size,
                      "ms_per_step": {b: float(np.median(v)) for b, v in by_bucket.items()},
                      "step_ms": [r["ms"] for r in records],
                      "bucket_frames": [r["frames"] for r in records],
                      "peak_mem_gb": torch_peak_gb(), "loss_first": losses[0],
                      "loss_last": losses[-1], "grad_norm": records[-1]["grad_norm"],
                      "restored": restored,
                      "note": "step ms: from one step's end to the next's, a synchronize at "
                              "each end; the step after a checkpoint includes its save",
                      **extra}}


def torch_peak_gb() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 1e9


def same_state(torch, a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def run_train(torch, dev, pattern_dir, rng, work):
    """The training path on gst_lj at its published widths, B=32, over the
    corpus phase's patterns: 6 steps on the feature transport
    (checkpoint_every 4, the held-out eval and ``default_eval_hook`` at
    step 6), a second ``Trainer`` restoring step 6 bit for bit, 2 steps on
    the wav transport with the corpus on the card, then synthesis of 32
    texts with 32 reference wavs from the trained state. No train step may
    launch a kernel; the eval hook launches K1 and K4, the synthesis the
    gst_lj path's counts. The feature run's workdir stays in ``work``/feat
    for the CLI phase."""
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import apply_overrides, get_preset
    from gst_tacotron_tpu_torch.synthesize import Synthesizer
    from gst_tacotron_tpu_torch.train import Trainer, default_eval_hook

    cfg = apply_overrides(get_preset("gst_lj"), {
        "train.checkpoint_every": 4, "train.eval_every": TRAIN_STEPS, "train.log_every": 1})
    lines = []
    t0 = time.perf_counter()
    trainer = Trainer(cfg, pattern_dir, f"{work}/feat", device=dev)
    setup_s = time.perf_counter() - t0
    records, ev = drive_trainer(torch, ops, trainer, TRAIN_STEPS, default_eval_hook)
    for k in ("gru_scan", "decode_scan"):
        if not ev.get("eval_hook", {}).get(k):
            fail(f"train: the eval hook launched {ev.get('eval_hook')}, no {k}")
    log = [json.loads(x) for x in open(f"{work}/feat/logs/metrics.jsonl")]
    evals = [r for r in log if r["step"] == TRAIN_STEPS and "eval/diagonality" in r]
    if not evals or any("eval/eval_error" in r for r in log):
        fail("train: the eval hook did not synthesize (eval/eval_error or no diagonality)")
    if not any("eval/eval_loss" in r and np.isfinite(r["eval/eval_loss"]) for r in log):
        fail("train: the held-out eval logged no finite eval_loss")
    again = Trainer(cfg, pattern_dir, f"{work}/feat", device=dev)
    restored = (again.restore_if_available() and again.state.step == TRAIN_STEPS
                and same_state(torch, trainer.state.model, again.state.model)
                and all(torch.equal(trainer.state.opt.mu[k], again.state.opt.mu[k])
                        and torch.equal(trainer.state.opt.nu[k], again.state.opt.nu[k])
                        for k in trainer.state.opt.mu))
    eval_loss = next(r["eval/eval_loss"] for r in log if "eval/eval_loss" in r)
    lines.append(train_line(cfg, "features", records, restored, setup_s=setup_s,
                            eval_launches=ev["eval_hook"],
                            run_eval_launches=ev["run_eval"], eval_loss=eval_loss,
                            eval_diagonality=evals[0]["eval/diagonality"]))
    print(json.dumps(lines[-1]), flush=True)
    if not restored:
        fail("train: the restored state differs from the trained one")

    wire = apply_overrides(cfg, {"data.wav_transport": True, "data.device_corpus": True})
    t0 = time.perf_counter()
    wt = Trainer(wire, pattern_dir, f"{work}/wire", device=dev)
    setup_s = time.perf_counter() - t0
    records, _ = drive_trainer(torch, ops, wt, WIRE_STEPS)
    lines.append(train_line(wire, "wav + device corpus", records, None, setup_s=setup_s,
                            device_corpus_gb=wt.device_corpus_gb,
                            profiled_step=profile_train_step(torch, ops, wt)))
    print(json.dumps(lines[-1]), flush=True)

    texts, wavs = make_inputs(rng, cfg.audio.sample_rate)
    synth = Synthesizer(cfg, trainer.state.model, device=dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = synth(texts, reference_wavs=wavs, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    expected = {**dict.fromkeys(counts, 0), "gru_scan": 3, "refenc_stack": 1,
                "refenc_stack:bf16": 1, "stft_features": 4, "stft_features:bf16": 4,
                "decode_scan": 1}
    info = {"config": "gst_lj", "transport": "synthesis from the trained state",
            "batch": B, "launches": nonzero_counts(ops), "wall_ms": 1e3 * wall,
            "frames": out["mel"].shape[1],
            "finite": bool(all(np.all(np.isfinite(out[k])) for k in ("mel", "linear", "wav")))}
    print(json.dumps({"train": info}), flush=True)
    if counts != expected:
        fail(f"train: synthesis from the trained state launched {counts}, expected {expected}")
    if not info["finite"]:
        fail("train: synthesis from the trained state is not finite")
    return counts


def profile_train_step(torch, ops, trainer):
    """One more step of ``trainer`` (the next batch of its index stream)
    under torch.profiler: host wall, device busy time, the device's idle
    share and the kernels the step ran. The profiler's own host cost
    inflates the wall, so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    b, rows, spec = next(trainer.loader.stream_indices(trainer.state.step))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step_rows(b, rows, spec)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    if nonzero_counts(ops):
        fail(f"train: the profiled step launched kernels {nonzero_counts(ops)}")
    dev_rows = device_rows(prof)
    busy = sum(ms for _, ms, _ in dev_rows)
    top = sorted(dev_rows, key=lambda r: -r[1])[:5]
    return {"frames": spec.max_frames, "wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "device_kernels": sum(n for k, _, n in dev_rows if "Memcpy" not in k
                                  and "Memset" not in k),
            "top_device_ms": {k[:60]: ms for k, ms, _ in top}}


def small_train_batch(rng, cfg, b=4, t_text=24, t_mel=64):
    """A seeded feature batch at ``cfg``'s widths. No token twice in a row:
    equal neighbours tie in the encoder's maxpool, and which side takes the
    gradient then rests on a one-ulp rounding difference."""
    tl = np.array([t_text] + [int(x) for x in rng.integers(5, t_text, b - 1)])
    ml = np.array([t_mel] + [2 * int(x) for x in rng.integers(8, t_mel // 2, b - 1)])
    tokens = 1 + (rng.integers(0, 39, (b, 1)) + np.cumsum(rng.integers(1, 39, (b, t_text)), 1)) % 39
    tokens = tokens * (np.arange(t_text)[None] < tl[:, None])
    fmask = (np.arange(t_mel)[None] < ml[:, None])[..., None]
    return {"tokens": tokens.astype(np.int32), "token_lengths": tl.astype(np.int32),
            "mel": (rng.uniform(0, 1, (b, t_mel, 80)) * fmask).astype(np.float32),
            "mel_lengths": ml.astype(np.int32),
            "linear": (rng.uniform(0, 1, (b, t_mel, cfg.model.num_freq)) * fmask
                       ).astype(np.float32),
            "speaker_ids": np.zeros(b, np.int32)}


def check_train_card_vs_cpu(torch, dev, overrides=None, label="gst_lj"):
    """One train step of gst_lj (with ``overrides``) at the CPU tests'
    widths (dropout off: the prenets' and a Taco2 conv stack's; the constant
    schedule at lr 1e-3 of tests/test_torch_train_parity.py) on the card
    (TF32 off) and on the CPU, from the same weights and batch."""
    import copy

    from gst_tacotron_tpu_torch.config import apply_overrides, get_preset
    from gst_tacotron_tpu_torch.train import TrainState, make_optimizer, train_step
    from gst_tacotron_tpu_torch.weights import build_model

    cfg = apply_overrides(get_preset("gst_lj"), {
        **SMALL_WIDTHS, "model.encoder.prenet_dropout": 0.0,
        "model.decoder.prenet_dropout": 0.0, "optimizer.schedule": "constant",
        "optimizer.learning_rate": 1e-3, **(overrides or {})})
    batch = small_train_batch(np.random.default_rng(11), cfg)
    cpu_model = build_model(cfg, seed=5, device="cpu")
    if hasattr(cpu_model.encoder, "convs"):
        # the card's and the CPU's generators draw different masks
        cpu_model.encoder.convs.dropout_rate = 0.0
    card_model = copy.deepcopy(cpu_model).to(dev)
    res = {}
    for name, model, d in (("cpu", cpu_model, "cpu"), ("card", card_model, dev)):
        tx = make_optimizer(cfg.optimizer)
        st = TrainState(0, model, tx.init(dict(model.named_parameters())), 0)
        m = train_step(tx, cfg, st, {k: torch.from_numpy(v).to(d) for k, v in batch.items()})
        res[name] = ({k: float(v) for k, v in m.items()},
                     {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
                     {k: v.detach().cpu() for k, v in model.state_dict().items()})
    (mc, gc, pc), (mg, gg, pg) = res["cpu"], res["card"]
    loss_rel = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30) for k in mc)
    grad_rel = max(float((gg[k] - gc[k]).abs().max() / max(float(gc[k].abs().max()), 1e-30))
                   for k in gc)
    param_err = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
    info = {"config": f"{label} at the CPU tests' widths", "transport": "card vs CPU, one step",
            "loss_max_rel_err": loss_rel, "grad_max_err_rel_to_max": grad_rel,
            "param_max_abs_err": param_err, "tol": TRAIN_TOL, "grad_tol": GRAD_TOL,
            "loss": mg["loss"]}
    print(json.dumps({"train": info}), flush=True)
    if not (loss_rel <= TRAIN_TOL and param_err <= TRAIN_TOL and grad_rel <= GRAD_TOL):
        fail(f"train: the card's step differs from the CPU's: {info}")


def run_vocoder_train(torch, dev, pattern_dir, work):
    """gst_wavernn's WaveRNN at its widths: 2 ``VocoderTrainer`` steps of
    batch 16 x 24 frames over the corpus phase's patterns, then a restore;
    the workdir ``work`` stays for the CLI phase."""
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import apply_overrides, get_preset
    from gst_tacotron_tpu_torch.vocoder_train import VocoderTrainer

    cfg = apply_overrides(get_preset("gst_wavernn"), {"train.log_every": 1,
                                                      "train.checkpoint_every": 2})
    steps = 2
    t0 = time.perf_counter()
    vt = VocoderTrainer(cfg, pattern_dir, work, device=dev, segment_frames=24,
                        batch_size=16)
    setup_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for step in range(1, steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vt.train(step)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        if nonzero_counts(ops):
            fail(f"vocoder train: step {step} launched kernels {nonzero_counts(ops)}")
    log = [json.loads(x) for x in open(f"{work}/vocoder_logs/metrics.jsonl")]
    again = VocoderTrainer(cfg, pattern_dir, work, device=dev, segment_frames=24,
                           batch_size=16)
    restored = (again.restore_if_available() and again.state.step == steps
                and same_state(torch, vt.model, again.model))
    losses = [r["vocoder/loss"] for r in log]
    info = {"config": cfg.name, "transport": "vocoder segments 16 x 24 frames",
            "steps": steps, "batch": 16, "samples_per_row": 24 * cfg.audio.hop_length,
            "ms_per_step": float(np.median(times)), "step_ms": times,
            "peak_mem_gb": torch_peak_gb(), "loss_first": losses[0], "loss_last": losses[-1],
            "restored": restored, "setup_s": setup_s,
            "note": "each step includes its checkpoint save (checkpoint_every 2: step 2)"}
    print(json.dumps({"train": info}), flush=True)
    if not all(np.isfinite(losses)) or len(losses) != steps:
        fail(f"vocoder train: losses {losses}")
    if not restored:
        fail("vocoder train: the restored state differs from the trained one")


def run_train_phase(torch, dev, corpus_dir, work):
    """The train phase; leaves the trainer's workdir in ``work``/feat and
    the vocoder's in ``work``/voc."""
    t_train = time.perf_counter()
    run_train(torch, dev, corpus_dir, np.random.default_rng(9), work)
    log(f"train path done in {time.perf_counter() - t_train:.1f} s")
    t0 = time.perf_counter()
    check_train_card_vs_cpu(torch, dev)
    log(f"train card vs CPU done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_vocoder_train(torch, dev, corpus_dir, f"{work}/voc")
    log(f"vocoder train done in {time.perf_counter() - t0:.1f} s; train phase "
        f"{time.perf_counter() - t_train:.1f} s")


# ---------------------------------------------------------------------------
# the alignment gate and same-seed determinism
# ---------------------------------------------------------------------------

# the gate's synthesis with GST off: K1 for the encoder and post-net BiGRUs,
# K4's location-sensitive branch at r=1
GATE_LAUNCHES = {"gru_scan": 2, "decode_scan": 1, "decode_scan:location_sensitive": 1}
GATE_MEL_TOL = 2e-3
GATE_WAIT_S = 900
# seed 7's bucket order over the corpus is 800, 400, 1200, 1200, 1200, 1200
# frames: six steps reach the graph's capture and two replays
DETERMINISM_STEPS = 6
DETERMINISM_SEEDS = (7, 7, 8)


def alignment_gate_checks(torch, dev, work):
    """``alignment_gate.run_gate`` on the card: the JAX gate's config 3
    (location-sensitive attention, r=1), its token-pattern corpus and its
    800 ``Trainer`` steps; the trained teacher-forced diagonality must end
    above 0.85 and more than 0.3 above the untrained, the loss finite.
    Then ``GSTTacotron.infer`` synthesizes the probe batch's tokens from the
    trained state (the gate's 33 linear bins have no waveform), kernel path
    (counted: ``GATE_LAUNCHES``) and plain path, prenets deterministic,
    stop threshold 1.0, the probe's frames as the step budget: the mels
    within ``GATE_MEL_TOL``. Returns (the phase's line, what failed)."""
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.alignment_gate import gate_failures, run_gate
    from gst_tacotron_tpu_torch.models.attention import alignment_diagonality

    t0 = time.perf_counter()
    res = run_gate(work, device=dev)
    bad = gate_failures(res)
    _, model = with_threshold(torch, res.trainer.state.model, res.trainer.cfg, 1.0)
    tok, tok_len = res.probe["tokens"].long(), res.probe["token_lengths"].long()
    r = res.trainer.cfg.model.decoder.reduction_factor
    steps = res.probe["mel"].shape[1] // r
    outs, launches = {}, {}
    for plain in (False, True):
        ops.reset_launch_counts()
        with torch.no_grad():
            outs[plain] = model.infer(tok, tok_len, max_steps=steps, deterministic_prenet=True,
                                      seed=0, plain=plain)
        torch.cuda.synchronize()
        launches[plain] = ops.launch_counts()
    mel = outs[False]["mel"]
    mel_err = float((mel - outs[True]["mel"]).abs().max())
    diag = alignment_diagonality(outs[False]["alignments"], tok_len,
                                 torch.clamp(outs[False]["frame_lengths"] // r, min=1))
    expected = {**dict.fromkeys(launches[False], 0), **GATE_LAUNCHES}
    info = {**res.summary(), "config": "gst_r1_location at the JAX gate's widths",
            "batch": int(tok.shape[0]), "probe_frames": int(res.probe["mel"].shape[1]),
            "synthesis_steps": steps, "launches": {k: n for k, n in launches[False].items() if n},
            "plain_launches": {k: n for k, n in launches[True].items() if n},
            "mel_max_abs_err_vs_plain": mel_err, "mel_tol": GATE_MEL_TOL,
            "synthesis_diagonality": float(diag.mean()),
            "finite": bool(torch.isfinite(mel).all()), "seconds": time.perf_counter() - t0}
    if launches[False] != expected or any(launches[True].values()):
        bad.append(f"the trained-state synthesis launched {launches[False]} (plain path "
                   f"{launches[True]}), expected {expected}")
    if not (info["finite"] and mel_err <= GATE_MEL_TOL):
        bad.append(f"K4-LSA's mel differs from the plain path's by {mel_err} > "
                   f"{GATE_MEL_TOL} (finite: {info['finite']})")
    return info, bad


def alignment_gate_process(out):
    """The alignment gate in a spawned process on card 0: loads the built
    kernels, runs ``alignment_gate_checks`` and puts (ok, (line, failures)
    or traceback) on ``out``."""
    import traceback

    import torch

    try:
        from gst_tacotron_tpu_torch import ops
        from gst_tacotron_tpu_torch.ops.build import build_all

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        build_all(ops.all_kernels())     # built by the parent: loads them
        with tempfile.TemporaryDirectory() as work:
            out.put((True, alignment_gate_checks(torch, dev, work)))
    except Exception:
        out.put((False, traceback.format_exc()))


def start_alignment_gate():
    """Start the alignment gate phase in a process of its own: its 800
    steps are host-bound (~0.5 s each on the card), so it runs beside the
    other host-bound phases; the timed kernel checks and paths come before
    it starts and the benches after ``finish_alignment_gate``. A daemon:
    if the script fails first, the process ends with it."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=alignment_gate_process, args=(out,), daemon=True)
    proc.start()
    return proc, out, time.perf_counter()


def finish_alignment_gate(gate):
    """Wait for the gate's process, print its ``{"alignment_gate": ...}``
    line and fail on anything it found."""
    import queue

    proc, out, t0 = gate
    t_wait = time.perf_counter()
    try:
        ok, value = out.get(timeout=GATE_WAIT_S)
    except queue.Empty:
        fail(f"alignment_gate: no result within {GATE_WAIT_S} s of waiting")
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
    if not ok:
        fail(f"alignment_gate: the process failed:\n{value}")
    info, bad = value
    info["waited_s"] = time.perf_counter() - t_wait
    info["note"] = "ran beside the phases from taco2 to style, in a process of its own"
    print(json.dumps({"alignment_gate": info}), flush=True)
    if bad:
        fail("alignment_gate: " + "; ".join(bad))
    log(f"alignment_gate phase done in {time.perf_counter() - t0:.1f} s "
        f"(waited {info['waited_s']:.1f} s for it)")


def host_train_state(torch, state):
    """A trainer state's parameters, BatchNorm buffers, Adam moments and
    update count, copied to the host by name."""
    cpu = lambda prefix, d: {f"{prefix}/{k}": v.detach().cpu().clone() for k, v in d.items()}
    return {**cpu("model", state.model.state_dict()), **cpu("mu", state.opt.mu),
            **cpu("nu", state.opt.nu), "count": torch.tensor(state.opt.count)}


def state_diff(torch, a, b):
    """(names of the tensors that differ in any bit, largest |a - b|)."""
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    largest = max((float((a[k].double() - b[k].double()).abs().max()) for k in differ),
                  default=0.0)
    return differ, largest


def run_determinism(torch, dev, pattern_dir, work):
    """The counterpart of tests/test_determinism.py on the card: gst_lj at
    its published widths, B=32, over the corpus phase's patterns; one
    ``Trainer`` a seed of ``DETERMINISM_SEEDS``, ``DETERMINISM_STEPS`` steps
    each through ``Trainer.train``. The two same-seed runs must agree in
    every bit of every parameter, buffer and Adam moment; the other seed
    must differ. The same-seed runs must have replayed the step's CUDA
    graph (``train_graph_replays``)."""
    from gst_tacotron_tpu_torch.config import apply_overrides, get_preset
    from gst_tacotron_tpu_torch.train import Trainer
    from gst_tacotron_tpu_torch.utils.profiling import counters

    cfg = apply_overrides(get_preset("gst_lj"), {
        "train.log_every": 10 ** 6, "train.checkpoint_every": 10 ** 7,
        "train.eval_every": 10 ** 8})
    states, seconds, graphs = [], [], []
    for i, seed in enumerate(DETERMINISM_SEEDS):
        t0 = time.perf_counter()
        before = counters()
        trainer = Trainer(apply_overrides(cfg, {"train.seed": seed}), pattern_dir,
                          f"{work}/det{i}", device=dev)
        state = trainer.train(DETERMINISM_STEPS)
        states.append(host_train_state(torch, state))
        seconds.append(time.perf_counter() - t0)
        graphs.append({k: counters().get(k, 0) - before.get(k, 0)
                       for k in ("train_graph_captures", "train_graph_replays",
                                 "train_graph_failures")})
        del trainer, state
    same, same_max = state_diff(torch, states[0], states[1])
    other, other_max = state_diff(torch, states[0], states[2])
    info = {"config": "gst_lj", "batch": cfg.data.batch_size, "steps": DETERMINISM_STEPS,
            "seeds": list(DETERMINISM_SEEDS), "tensors": len(states[0]),
            "same_seed_tensors_differing": len(same), "same_seed_max_abs_diff": same_max,
            "same_seed_differing": same[:10],
            "other_seed_tensors_differing": len(other), "other_seed_max_abs_diff": other_max,
            "trainer_seconds": seconds, "graphs": graphs}
    print(json.dumps({"determinism": info}), flush=True)
    if not all(g["train_graph_replays"] for g in graphs[:2]):
        fail(f"determinism: the same-seed runs replayed no CUDA graph: {graphs}")
    if same:
        fail(f"determinism: two trainers with seed {DETERMINISM_SEEDS[0]} differ after "
             f"{DETERMINISM_STEPS} steps in {len(same)} tensors (largest {same_max}): "
             f"{same[:10]}")
    if not other:
        fail(f"determinism: seeds {DETERMINISM_SEEDS[0]} and {DETERMINISM_SEEDS[2]} gave the "
             "same state")


# ---------------------------------------------------------------------------
# the taco2 encoder, JAX workdirs exported into the port, the train bench
# ---------------------------------------------------------------------------

TACO2 = {"model.encoder.kind": "taco2"}


def taco2_encoder_k1(torch, dev, model, tok, tok_len):
    """K1 on the Taco2 encoder's BiGRU (B=32, T=64, D=256 -> 2 x 128, one
    launch, the model's seeded weights, the path's token lengths): error
    against the plain scans, kernel / plain / cuDNN times, device time by
    phase (the mean of 10 profiled calls), and its bound."""
    from gst_tacotron_tpu_torch.kernel_bench import gru_scan_work
    from gst_tacotron_tpu_torch.ops.gru import bigru_scan, gru_scan_plain

    with torch.no_grad():
        x = model.encoder.convs(model.encoder.embedding(tok), tok_len)
    g = model.encoder.bigru
    h = g.fwd.features
    d = x.shape[-1]
    dirs = [(torch.zeros(B, h, device=dev), m.kernel.detach(), m.bias.detach(),
             m.recurrent_kernel.detach(), m.recurrent_bias.detach()) for m in (g.fwd, g.bwd)]

    def kernel():
        return bigru_scan(x, *dirs, lengths=tok_len)

    def plain():
        f = gru_scan_plain(x, *dirs[0], lengths=tok_len)
        b = gru_scan_plain(x, *dirs[1], lengths=tok_len, reverse=True)
        return torch.cat([f[0], b[0]], -1), (f[1], b[1])

    got, ref = kernel(), plain()
    err = max_err([got[0], *got[1]], [ref[0], *ref[1]])
    reorder = lambda w: torch.cat([w[..., h:2 * h], w[..., :h], w[..., 2 * h:]], -1)
    lib = torch.nn.GRU(d, h, batch_first=True, bidirectional=True).to(dev)
    with torch.no_grad():
        for sfx, (_, wi, bi, wh, bh) in zip(("", "_reverse"), dirs):
            getattr(lib, "weight_ih_l0" + sfx).copy_(reorder(wi).T)
            getattr(lib, "weight_hh_l0" + sfx).copy_(reorder(wh).T)
            getattr(lib, "bias_ih_l0" + sfx).copy_(reorder(bi))
            getattr(lib, "bias_hh_l0" + sfx).copy_(reorder(bh))
    h0 = torch.zeros(2, B, h, device=dev)

    def library():
        with torch.no_grad():
            lib(x, h0)

    t = x.shape[1]
    b_ms, b_by = bound(gru_scan_work(B, t, d, h, directions=2))
    # device time by phase, over 10 calls in one profile (one call's events
    # were lost twice in a row); None where the profiler saw none
    reps = 10
    phases = {}
    for _ in range(3):
        phases = kernel_device_ms(torch, lambda: [kernel() for _ in range(reps)],
                                  {"input_gemm_ms": "gru_input_gemm",
                                   "recurrence_ms": "gru_recur_kernel"})
        if phases["recurrence_ms"] > 0:
            break
    phases = {k: v / reps if v > 0 else None for k, v in phases.items()}
    return {"shape": f"B={B}, T={t}, D={d} -> 2 x {h}", "max_abs_err": err, "tol": 1e-4,
            "kernel_ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain, iters=2),
            "library_ms": time_ms(torch, library), "bound_ms": b_ms, "bound_by": b_by,
            **phases,
            "library": "torch.nn.GRU (cuDNN), bidirectional, full length (the path's rows "
                       "are ragged: the library computes more than the kernel)"}


def run_taco2(torch, dev, cfg, expected):
    """gst_lj with ``model.encoder.kind=taco2`` at its widths (embedding
    256, three 5-tap 256-channel convs with BatchNorm, BiGRU 2 x 128; the
    rest at gst_lj's), seeded weights, the gst_lj path's workload
    (``run_path``: B=32 texts of 64 tokens, 32 reference wavs of 128 frames,
    200 steps, stop threshold 1.0, Griffin-Lim; K1 3, K2 1, K3 4, K4 1
    counted; the mel within 2e-3 of the plain path; stage times); the
    encoder alone: one K1 launch for its BiGRU (counted), K1 at its shape;
    one taco2 train step on the card against the CPU at the CPU tests'
    widths. Returns the path's launch counts."""
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import apply_overrides
    from gst_tacotron_tpu_torch.text import batch_text_to_ids
    from gst_tacotron_tpu_torch.weights import build_model

    cfg2 = apply_overrides(cfg, TACO2)
    counts = run_path(torch, np.random.default_rng(12), dev, "gst_lj taco2", cfg2, expected)
    model = build_model(cfg2, seed=0, device=dev)
    texts, _ = make_inputs(np.random.default_rng(13), cfg2.audio.sample_rate)
    ids, lens = batch_text_to_ids(texts)
    tok = torch.from_numpy(ids.astype(np.int64)).to(dev)
    tok_len = torch.from_numpy(lens.astype(np.int64)).to(dev)
    with torch.no_grad():
        ops.reset_launch_counts()
        enc = model.encoder(tok, tok_len)
        torch.cuda.synchronize()
        enc_counts = nonzero_counts(ops)
        enc_err = float((enc - model.encoder(tok, tok_len, plain=True)).abs().max())
        enc_ms = time_ms(torch, lambda: model.encoder(tok, tok_len))
        enc_plain_ms = time_ms(torch, lambda: model.encoder(tok, tok_len, plain=True), iters=2)
    info = {"name": "gst_lj taco2 encoder", "batch": B, "text_tokens": int(tok.shape[1]),
            "encoder_launches": enc_counts, "encoder_max_abs_err_vs_plain": enc_err,
            "encoder_ms": enc_ms, "encoder_plain_ms": enc_plain_ms,
            "k1_encoder_bigru": taco2_encoder_k1(torch, dev, model, tok, tok_len)}
    print(json.dumps({"taco2": info}), flush=True)
    if enc_counts != {"gru_scan": 1}:
        fail(f"taco2: the encoder launched {enc_counts}, expected one gru_scan")
    k1 = info["k1_encoder_bigru"]
    if not (enc_err <= 1e-4 and k1["max_abs_err"] <= k1["tol"]):
        fail(f"taco2: the encoder's K1 differs from its plain scans: {enc_err}, "
             f"{k1['max_abs_err']}")
    check_train_card_vs_cpu(torch, dev, TACO2, "gst_lj taco2")
    return counts


def fixture_dir(name: str) -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", name)


def run_jax_export(torch, dev, work):
    """tests/fixtures/jax_export (a tiny gst_lj state trained 2 steps by the
    JAX package and exported by tools/export_jax_workdir.py, with the JAX
    CPU outputs beside it) on the card: the synthesize CLI serves it (its
    wavs, K1-K4 counted); the ``Synthesizer`` restored as the CLI restores
    it gives the stored JAX mel within 2e-3 (``deterministic_prenet=True``,
    equal frame lengths); ``Trainer`` resumes it at step 2 and takes step 3,
    its losses against the JAX ``Trainer``'s stored step 3 (1e-4 relative,
    tests/test_torch_train_parity.py's step budget)."""
    import contextlib
    import io
    import os
    import shutil

    from scipy.io import wavfile

    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.checkpoint import CheckpointManager
    from gst_tacotron_tpu_torch.config import load_config
    from gst_tacotron_tpu_torch.data import generate_patterns, synthetic_utterances
    from gst_tacotron_tpu_torch.synthesize import Synthesizer
    from gst_tacotron_tpu_torch.synthesize import main as synthesize_main
    from gst_tacotron_tpu_torch.train import Trainer
    from gst_tacotron_tpu_torch.weights import build_model

    src = fixture_dir("jax_export")
    exp = dict(np.load(os.path.join(src, "expected.npz")))
    wd = os.path.join(work, "jax_export")
    shutil.copytree(src, wd)
    cfg = load_config(os.path.join(wd, "config.json"))
    texts = [str(t) for t in exp["texts"]]
    ref_path = os.path.join(work, "jax_export_ref.wav")
    wavfile.write(ref_path, cfg.audio.sample_rate, exp["ref_wav"])
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        paths = synthesize_main(["--workdir", wd, "--out", os.path.join(work, "jax_export_out"),
                                 "--reference-wavs", ref_path, ref_path, "--texts", *texts])
    torch.cuda.synchronize()
    cli_counts = nonzero_counts(ops)
    wavs = [p for p in paths if p.endswith(".wav")]

    saved = CheckpointManager(os.path.join(wd, cfg.train.checkpoint_dir)).restore(
        map_location=dev)
    model = build_model(cfg, seed=0, device=dev)
    model.load_state_dict(saved["model"])
    # float32 by name: the stored mel is the JAX package's on the CPU
    out = Synthesizer(cfg, model, device=dev, deterministic_prenet=True, bf16=False)(
        texts, reference_wavs=[exp["ref_wav"]] * 2, seed=0)
    mel_err = float(np.abs(out["mel"] - exp["mel"]).max())

    patterns = os.path.join(work, "jax_export_patterns")
    generate_patterns(synthetic_utterances(8, num_speakers=1), cfg.audio, patterns)
    trainer = Trainer(cfg, patterns, wd, device=dev)
    resumed = trainer.restore_if_available() and trainer.state.step == 2
    trainer.train(3)
    last = [json.loads(x) for x in open(os.path.join(wd, "logs", "metrics.jsonl"))][-1]
    loss_rel = {str(n): abs(last[f"train/{n}"] - float(v)) / abs(float(v))
                for n, v in zip(exp["next_loss_names"], exp["next_losses"])}
    info = {"name": "jax_export", "fixture": "tests/fixtures/jax_export",
            "cli_wavs": len(wavs), "cli_launches": cli_counts,
            "cli_printed": printed.getvalue().strip().splitlines()[:1],
            "mel_max_abs_err_vs_jax": mel_err, "mel_tol": 2e-3,
            "frame_lengths": out["frame_lengths"].tolist(),
            "jax_frame_lengths": exp["frame_lengths"].tolist(),
            "resumed_at_step_2": bool(resumed), "step_after": trainer.state.step,
            "step3_rel_err_vs_jax": loss_rel, "step3_tol": 1e-4}
    print(json.dumps({"jax_export": info}), flush=True)
    if len(wavs) != 2:
        fail(f"jax_export: the CLI wrote {paths}")
    for k in ("gru_scan", "refenc_stack", "stft_features", "decode_scan"):
        if not cli_counts.get(k):
            fail(f"jax_export: the CLI launched {cli_counts}, no {k}")
    if not (mel_err <= 2e-3 and info["frame_lengths"] == info["jax_frame_lengths"]):
        fail(f"jax_export: the mel differs from the stored JAX mel by {mel_err} > 2e-3 or "
             f"the frame lengths differ")
    if not (resumed and trainer.state.step == 3 and max(loss_rel.values()) <= 1e-4):
        fail(f"jax_export: the resumed step: {info}")


TRAIN_BENCH_STEPS = 3


def run_train_bench(torch, card):
    """``python -m gst_tacotron_tpu_torch.bench --train-bench``'s function
    (``bench.py --train-bench``'s workload: gst_lj, 8 x 64 tokens x 400
    frames, fresh host batches, the three transports) cut to
    ``TRAIN_BENCH_STEPS`` timed steps a transport (its default 15)."""
    from gst_tacotron_tpu_torch import bench

    t0 = time.perf_counter()
    line = bench.train_bench_line(TRAIN_BENCH_STEPS)
    print(json.dumps({"train_bench": line, "card": card,
                      "cut": f"{TRAIN_BENCH_STEPS} timed steps a transport, not "
                             f"{bench.TRAIN_STEPS}"}), flush=True)
    if not all(np.isfinite(r["loss"]) and r["ms_per_step"] > 0 for r in line["rows"]):
        fail(f"train bench: {line}")
    log(f"train bench done in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the synthesis entry points: chunked decode, bf16 compute, the CLI, the bench
# ---------------------------------------------------------------------------


def run_chunked(torch, dev, cfg, cfg3):
    """K4 resumed chunk by chunk (``decode.chunked_decode``) at gst_lj's
    widths (200 steps, chunks of 64: a budget of 256) and gst_r1_location's
    (its 1000 steps cut to 256, chunks of 64), B=32, stop threshold 1.0,
    dropout on: one K4 launch a chunk, and the first steps give the bits of
    one fixed-length call over them; at stop threshold 0.0 one chunk runs.
    Times the fixed-length and the chunked decode (host wall, a synchronize
    at each end)."""
    import math

    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import apply_overrides
    from gst_tacotron_tpu_torch.decode import chunked_decode
    from gst_tacotron_tpu_torch.weights import build_model

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    for name, c, steps, chunk in (("gst_lj", cfg, 200, 64), ("gst_r1_location", cfg3, 256, 64)):
        model = build_model(c, seed=11, device=dev)
        rng = np.random.default_rng(steps)
        memory = torch.from_numpy(rng.normal(0, 0.5, (B, TEXT_TOKENS, model.memory_dim))
                                  .astype(np.float32)).to(dev)
        lens = rng.integers(TEXT_TOKENS // 2, TEXT_TOKENS + 1, B)
        lens[0], lens[1] = TEXT_TOKENS, 1
        lengths = torch.from_numpy(lens).to(dev)
        counter = "decode_scan:location_sensitive" if name == "gst_r1_location" else "decode_scan"
        with torch.no_grad():
            fixed, fixed_ms = wall(lambda: model.decoder.decode(memory, lengths, max_steps=steps,
                                                                seed=5))
            fixed, fixed_ms = wall(lambda: model.decoder.decode(memory, lengths, max_steps=steps,
                                                                seed=5))
            ops.reset_launch_counts()
            out, chunked_ms = wall(lambda: chunked_decode(model, memory, lengths,
                                                          chunk_steps=chunk, max_steps=steps,
                                                          seed=5))
            counts = ops.launch_counts()
            zero = build_model(apply_overrides(c, {"model.decoder.stop_threshold": 0.0}),
                               seed=11, device=dev)
            ops.reset_launch_counts()
            out0 = chunked_decode(zero, memory, lengths, chunk_steps=chunk, max_steps=steps,
                                  seed=5)
            torch.cuda.synchronize()
            counts0 = ops.launch_counts()
        n = fixed[0].shape[1]
        bits = (torch.equal(out["mel"][:, :n], fixed[0])
                and torch.equal(out["stop_logits"][:, :n], fixed[1])
                and torch.equal(out["alignments"][:, :steps], fixed[2]))
        want = math.ceil(steps / chunk)
        info = {"name": name, "batch": B, "steps": steps, "chunk_steps": chunk,
                "budget_steps": want * chunk, "chunks_run": out["chunks_run"],
                "k4_launches": counts[counter], "bits_equal_fixed": bits,
                "threshold0_chunks_run": out0["chunks_run"],
                "threshold0_k4_launches": counts0[counter],
                "fixed_ms": fixed_ms, "chunked_ms": chunked_ms,
                "fixed_us_per_step": 1e3 * fixed_ms / steps,
                "chunked_us_per_step": 1e3 * chunked_ms / (want * chunk),
                "dropout": True, "stop_threshold": 1.0}
        print(json.dumps({"chunked": info}), flush=True)
        if out["chunks_run"] != want or counts[counter] != want or counts["decode_scan"] != want:
            fail(f"chunked {name}: {out['chunks_run']} chunks, launches {counts}, "
                 f"expected {want} of each")
        if not bits:
            fail(f"chunked {name}: the chunked decode is not the fixed-length call's bits")
        if out0["chunks_run"] != 1 or counts0[counter] != 1:
            fail(f"chunked {name}: at stop threshold 0 ran {out0['chunks_run']} chunks, "
                 f"{counts0[counter]} launches")


# ---------------------------------------------------------------------------
# the parallel phase: torch.distributed, data and tensor parallel
# ---------------------------------------------------------------------------

PARALLEL_TOL = 1e-5
PARALLEL_TRAIN_FRAMES = 128
PARALLEL_CHUNK = 64
PARALLEL_TP_STEPS = 4


def parallel_inputs(cfg, cfg5):
    """The phase's inputs, the same in every process: 32 texts and reference
    wavs, a train batch of 32 rows at gst_lj's widths (128 frames), and a
    (32, 128, 80) mel for K5."""
    rng = np.random.default_rng(21)
    texts, wavs = make_inputs(rng, cfg.audio.sample_rate)
    batch = small_train_batch(rng, cfg, b=B, t_text=TEXT_TOKENS, t_mel=PARALLEL_TRAIN_FRAMES)
    mel5 = rng.uniform(0, 1, (B, PARALLEL_TRAIN_FRAMES, cfg5.model.num_mels)).astype(np.float32)
    return texts, wavs, batch, mel5


def with_threshold(torch, model, cfg, threshold):
    """``model``'s weights in a model whose decoder stops at ``threshold``."""
    from gst_tacotron_tpu_torch.config import apply_overrides
    from gst_tacotron_tpu_torch.models.tacotron import GSTTacotron
    from gst_tacotron_tpu_torch.text import NUM_SYMBOLS

    c = apply_overrides(cfg, {"model.decoder.stop_threshold": threshold})
    m = GSTTacotron(c.model, c.model.num_symbols or NUM_SYMBOLS).to(next(model.parameters()).device)
    m.load_state_dict(model.state_dict())
    return c, m.eval()


def parallel_train_state(torch, cfg, dev, batch, mesh=None, steps=1):
    """The loss of the first of ``steps`` train steps from the seeded init on
    ``batch`` (this rank's rows under ``mesh``), and the state after them."""
    from gst_tacotron_tpu_torch.parallel import place_state, shard_batch
    from gst_tacotron_tpu_torch.train import init_state, make_optimizer, train_step

    _, state = init_state(cfg, dev)
    rows = batch
    if mesh is not None:
        place_state(state, mesh)
        rows = shard_batch(batch, mesh)
    tx = make_optimizer(cfg.optimizer)
    rows = {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}
    losses = [train_step(tx, cfg, state, rows)["loss"] for _ in range(steps)]
    return float(losses[0]), state


def replicated_digests(state):
    """sha256 of the state's replicated parameters and of its buffers, each
    over the tensors' bytes in key order: on every rank of a model group
    they must be equal."""
    import hashlib

    from gst_tacotron_tpu_torch.parallel.sharding import named_parameters

    def digest(tree):
        h = hashlib.sha256()
        for k in sorted(tree):
            h.update(k.encode())
            h.update(tree[k].detach().cpu().numpy().tobytes())
        return h.hexdigest()

    params = {k: p for k, p in named_parameters(state.model).items() if k not in state.sharded}
    return {"params": digest(params), "buffers": digest(dict(state.model.named_buffers())),
            "params_count": len(params)}


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parallel_rank_checks(torch, dev, cfg, cfg5):
    """What each rank of a two-rank group runs: DistributedSynthesizer at
    dp=2 (fixed, dropout on, and timed; chunked at stop thresholds 1.0 and
    0.0), one dp=2 train step and four tp=2 steps (the first one's loss,
    the digests of the replicated copies after the four), K5 sampling at
    dp=2."""
    from gst_tacotron_tpu_torch.models.modules import data_parallel
    from gst_tacotron_tpu_torch.parallel import DistributedSynthesizer, make_mesh, shard_batch
    from gst_tacotron_tpu_torch.parallel.mesh import all_gather
    from gst_tacotron_tpu_torch.weights import build_model, build_wavernn

    texts, wavs, batch, mel5 = parallel_inputs(cfg, cfg5)
    mesh = make_mesh(1)
    model = build_model(cfg, seed=0, device=dev)
    ds = DistributedSynthesizer(cfg, model, mesh, device=dev)
    out = ds.synthesize(texts, reference_wavs=wavs, seed=5)
    sync(torch, dev)
    t0 = time.perf_counter()
    ds.synthesize(texts, reference_wavs=wavs, seed=6)
    sync(torch, dev)
    ms = 1e3 * (time.perf_counter() - t0)
    chunks = {}
    for t in (1.0, 0.0):
        c, m = with_threshold(torch, model, cfg, t)
        chunks[t] = DistributedSynthesizer(c, m, mesh, device=dev).synthesize(
            texts, reference_wavs=wavs, seed=5, chunked=True,
            chunk_steps=PARALLEL_CHUNK)["chunks_run"]
    tp_loss, tp_state = parallel_train_state(torch, cfg, dev, batch, make_mesh(2),
                                             steps=PARALLEL_TP_STEPS)
    losses = {"dp2": parallel_train_state(torch, cfg, dev, batch, mesh)[0], "tp2": tp_loss}
    wmodel = build_wavernn(cfg5, seed=1, device=dev)
    local = shard_batch({"mel": torch.from_numpy(mel5).to(dev)}, mesh)["mel"]
    with torch.no_grad(), data_parallel(wmodel, mesh.data_shard()):
        classes = all_gather(wmodel.sample_classes(local, seed=9), mesh.data_group)
    return {"mel": out["mel"], "chunks_run": chunks, "losses": losses,
            "tp2_digests": replicated_digests(tp_state),
            "classes": classes.cpu().numpy(), "ms_per_batch": ms}


def parallel_rank(rank, world, port, backend, device, out):
    """One rank of the phase's two-rank group (a spawned process) on
    ``device``: joins the group, loads the built kernels, runs
    ``parallel_rank_checks`` with every launch counter at 0 before it, and
    puts (rank, ok, result or traceback) on ``out``."""
    import traceback

    import torch

    try:
        from gst_tacotron_tpu_torch import ops
        from gst_tacotron_tpu_torch.config import apply_overrides, get_preset
        from gst_tacotron_tpu_torch.ops.build import build_all
        from gst_tacotron_tpu_torch.parallel import initialize_distributed

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            build_all(ops.all_kernels())     # built by the parent: loads them
        initialize_distributed(f"localhost:{port}", world, rank, backend=backend)
        cfg, cfg5 = parallel_configs(apply_overrides, get_preset)
        ops.reset_launch_counts()
        res = parallel_rank_checks(torch, dev, cfg, cfg5)
        sync(torch, dev)
        res["launches"] = {k: n for k, n in ops.launch_counts().items() if n}
        out.put((rank, True, res))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def parallel_configs(apply_overrides, get_preset):
    """gst_lj as the paths run it (200 steps, Griffin-Lim 15 iterations,
    stop threshold 1.0) and gst_wavernn's vocoder widths."""
    cfg = apply_overrides(get_preset("gst_lj"), {
        "model.decoder.max_decode_steps": 200, "audio.griffin_lim_iters": 15,
        "audio.griffin_lim_momentum": 0.99, "model.decoder.stop_threshold": 1.0})
    return cfg, get_preset("gst_wavernn")


def run_two_ranks(torch, backend, devices):
    """``parallel_rank`` on two spawned processes, rank r on ``devices[r]``;
    their results by rank."""
    import multiprocessing

    from gst_tacotron_tpu_torch.parallel.mesh import free_port

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=parallel_rank, args=(r, 2, port, backend, devices[r], out))
             for r in range(2)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, ok, value = out.get(timeout=600)
            if not ok:
                fail(f"parallel rank {rank} ({backend}) failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    return [results[0], results[1]]


def run_parallel(torch, dev):
    """The parallel phase (``gst_tacotron_tpu_torch.parallel``) at gst_lj's
    widths, B=32, 200 steps, the reference wavs through K3:

    1. one rank over NCCL (world size 1, mesh (1, 1)): ``DistributedSynthesizer``
       gives the ``Synthesizer``'s mel bit for bit, and one ``train_step``
       under the mesh the unmeshed step's loss bit for bit;
    2. two ranks on this one card over gloo (NCCL refuses two ranks on one
       device): ``DistributedSynthesizer`` at dp=2 (16 rows a rank, dropout
       on) within 1e-5 of the single-process mel; the chunked path's
       ``chunks_run`` equal on both ranks and to the single-process chunked
       call's at stop thresholds 1.0 and 0.0; one dp=2 and one tp=2 train
       step within 1e-5 relative of the single-process loss; after four
       tp=2 steps the two ranks' replicated parameters and buffers bit-equal
       (``sharding.step_gradients`` keeps them so); K5 at dp=2,
       gst_wavernn's widths, 128 frames, the single-process classes; each
       rank's launch counts;
    3. with two cards or more, the dp=2 checks of 2 over NCCL, one rank a card.
    """
    import torch.distributed as dist

    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import apply_overrides, get_preset
    from gst_tacotron_tpu_torch.parallel import DistributedSynthesizer, make_mesh
    from gst_tacotron_tpu_torch.parallel.mesh import free_port
    from gst_tacotron_tpu_torch.synthesize import Synthesizer
    from gst_tacotron_tpu_torch.weights import build_model, build_wavernn

    t_phase = time.perf_counter()
    cfg, cfg5 = parallel_configs(apply_overrides, get_preset)
    texts, wavs, batch, mel5 = parallel_inputs(cfg, cfg5)
    model = build_model(cfg, seed=0, device=dev)
    ops.reset_launch_counts()
    ref = Synthesizer(cfg, model, device=dev)(texts, reference_wavs=wavs, seed=5)
    ref_chunks = {}
    for t in (1.0, 0.0):
        c, m = with_threshold(torch, model, cfg, t)
        ref_chunks[t] = Synthesizer(c, m, device=dev, use_chunked_decoder=True,
                                    chunk_steps=PARALLEL_CHUNK)(
            texts, reference_wavs=wavs, seed=5)["chunks_run"]
    ref_loss = parallel_train_state(torch, cfg, dev, batch)[0]
    with torch.no_grad():
        ref_classes = build_wavernn(cfg5, seed=1, device=dev).sample_classes(
            torch.from_numpy(mel5).to(dev), seed=9).cpu().numpy()
    sync(torch, dev)
    single_launches = {k: n for k, n in ops.launch_counts().items() if n}

    # 1. world size 1 over NCCL
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        ops.reset_launch_counts()
        got = DistributedSynthesizer(cfg, model, mesh, device=dev).synthesize(
            texts, reference_wavs=wavs, seed=5)
        sync(torch, dev)
        ws1_launches = {k: n for k, n in ops.launch_counts().items() if n}
        ws1_loss = parallel_train_state(torch, cfg, dev, batch, mesh)[0]
    finally:
        dist.destroy_process_group()
    ws1 = {"backend": backend, "mesh": [1, 1],
           "synth_bits_equal": all(np.array_equal(got[k], ref[k]) for k in
                                   ("mel", "linear", "stop_logits", "alignments", "wav")),
           "train_loss_bits_equal": ws1_loss == ref_loss, "train_loss": ws1_loss,
           "launches": ws1_launches}

    # 2. (and 3.) two ranks
    def two(backend, devices):
        ranks = run_two_ranks(torch, backend, devices)
        errs = [float(np.abs(r["mel"] - ref["mel"]).max()) for r in ranks]
        return {"backend": backend, "devices": devices,
                "mesh": {"synth": [2, 1], "train": {"dp2": [2, 1], "tp2": [1, 2]}},
                "mel_max_abs_err": max(errs), "mel_tol": PARALLEL_TOL,
                "mel_bits_equal": [bool(np.array_equal(r["mel"], ref["mel"])) for r in ranks],
                "chunks_run": {str(t): [r["chunks_run"][t] for r in ranks] for t in ref_chunks},
                "chunks_run_single": {str(t): n for t, n in ref_chunks.items()},
                "train_loss": {k: [r["losses"][k] for r in ranks] for k in ("dp2", "tp2")},
                "train_loss_single": ref_loss,
                "train_loss_max_rel_err": max(abs(r["losses"][k] - ref_loss) / abs(ref_loss)
                                              for r in ranks for k in ("dp2", "tp2")),
                "tp2_steps": PARALLEL_TP_STEPS,
                "tp2_replicated_params": ranks[0]["tp2_digests"]["params_count"],
                "tp2_replicated_bits_equal": {
                    k: ranks[0]["tp2_digests"][k] == ranks[1]["tp2_digests"][k]
                    for k in ("params", "buffers")},
                "k5_classes_equal": [bool(np.array_equal(r["classes"], ref_classes))
                                     for r in ranks],
                "ms_per_batch": [r["ms_per_batch"] for r in ranks],
                "launches": [r["launches"] for r in ranks]}

    gloo = two("gloo", [str(dev)] * 2)
    gloo["note"] = ("two ranks share one card (time-sliced), so ms_per_batch is not a "
                    "scaling number")
    cards = torch.cuda.device_count()
    nccl2 = (two("nccl", ["cuda:0", "cuda:1"]) if dev.type == "cuda" and cards >= 2 else
             f"not run: {cards} card(s); needs 2")
    info = {"world_size_1": ws1, "two_ranks_gloo": gloo, "two_ranks_nccl": nccl2,
            "single_process_launches": single_launches, "batch": B,
            "decode_steps": cfg.model.decoder.max_decode_steps,
            "train_frames": PARALLEL_TRAIN_FRAMES, "seconds": time.perf_counter() - t_phase}
    print(json.dumps({"parallel": info}), flush=True)
    if not ws1["synth_bits_equal"]:
        fail("parallel: DistributedSynthesizer at world size 1 is not the Synthesizer's bits")
    if not ws1["train_loss_bits_equal"]:
        fail(f"parallel: the (1, 1) mesh's step loss {ws1_loss} is not the unmeshed "
             f"{ref_loss}")
    for part in [gloo] + ([nccl2] if isinstance(nccl2, dict) else []):
        tag = f"parallel ({part['backend']})"
        if not part["mel_max_abs_err"] <= PARALLEL_TOL:
            fail(f"{tag}: dp=2 mel differs by {part['mel_max_abs_err']} > {PARALLEL_TOL}")
        for t, n in part["chunks_run"].items():
            if n != [ref_chunks[float(t)]] * 2:
                fail(f"{tag}: chunks_run {n} at threshold {t}, single {ref_chunks[float(t)]}")
        if not part["train_loss_max_rel_err"] <= PARALLEL_TOL:
            fail(f"{tag}: train loss {part['train_loss']} vs single {ref_loss}")
        if not all(part["tp2_replicated_bits_equal"].values()):
            fail(f"{tag}: after {PARALLEL_TP_STEPS} tp=2 steps the model ranks' replicated "
                 f"copies differ: {part['tp2_replicated_bits_equal']}")
        if not all(part["k5_classes_equal"]):
            fail(f"{tag}: K5 at dp=2 gave other classes than the single-process call")
        for rank, launches in enumerate(part["launches"]):
            missing = [k for k in ("gru_scan", "refenc_stack", "stft_features", "decode_scan",
                                   "wavernn_sample") if not launches.get(k)]
            if missing:
                fail(f"{tag}: rank {rank} launched no {missing}")


def run_scaling(torch):
    """``bench --scaling``'s rows (``bench.bench_scaling("cuda")``) at this
    machine's card count: one rank over NCCL on one card, the curve where
    there are more. Each row must carry the four rates and efficiencies,
    every rank of a row the same synthesis ``chunks_run`` (at the bench's
    stop threshold 1.0 the whole budget's chunks), and every rank's
    launch counts (each workload's counters set to 0 just before it) must
    show K1 and K4 in its synthesis and K5 in its WaveRNN sampling."""
    from gst_tacotron_tpu_torch import bench

    t0 = time.perf_counter()
    rows = bench.bench_scaling("cuda")
    info = {"rows": rows, "cards": torch.cuda.device_count(),
            "seconds": time.perf_counter() - t0}
    print(json.dumps({"scaling": info}), flush=True)
    for row in rows:
        tag = f"scaling at {row['ranks']} rank(s)"
        for key, eff in bench.EFFICIENCIES:
            if not all(np.isfinite(row.get(k, np.nan)) and row[k] > 0 for k in (key, eff)):
                fail(f"{tag}: no positive {key} / {eff}")
        budget = -(-row["synth_max_steps"] // row["chunk_steps"])
        if row["chunks_run"] != [budget] * row["ranks"]:
            fail(f"{tag}: the ranks ran {row['chunks_run']} synthesis chunks; at stop "
                 f"threshold 1.0 each runs the budget's {budget}")
        for rank, launches in enumerate(row["launches"]):
            missing = [k for k in ("gru_scan", "decode_scan") if not launches["synth"].get(k)]
            if missing or not launches["wavernn"].get("wavernn_sample"):
                fail(f"{tag}: rank {rank} launched {launches}: no {missing} in synthesis "
                     "or no wavernn_sample in WaveRNN sampling")


def run_style(torch, work):
    """``style_contrast.main`` on the train phase's gst_lj workdir
    (``work``/feat, its published widths and decode budget): the report's
    summary, its wall and the launch counts (set to 0 just before it). The
    deterministic pass must give the same bits under two seeds, every
    condition must be there, no pair of one-hot conditions may give the same
    mel (style would do nothing), and the run must launch K1, K2, K3 and
    K4."""
    import contextlib
    import io

    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.style_contrast import main as style_main

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        report = style_main(["--workdir", f"{work}/feat", "--out", f"{work}/style.json"])
    torch.cuda.synchronize()
    det = report["deterministic_pass"]
    onehot = {k: v["mel_l1"] for k, v in det["pairwise"].items()
              if all(n.startswith("token") for n in k.split("|"))}
    info = {"workdir": "the train phase's gst_lj workdir", "step": report["step"],
            "conditions": report["conditions"], "summary": report["summary"],
            "seed_floor_bit_identical": det["seed_floor_bit_identical"],
            "onehot_pair_mel_l1": onehot, "acoustic_stats": det["acoustic_stats"],
            "stochastic_floor_mel_l1": report["stochastic_pass"]["seed_floor_mel_l1"],
            "wall_s": time.perf_counter() - t0, "launches": nonzero_counts(ops),
            "printed": printed.getvalue().strip().splitlines()[-1:]}
    print(json.dumps({"style": info}), flush=True)
    if not info["seed_floor_bit_identical"]:
        fail(f"style: the deterministic pass differs between seeds by "
             f"{det['seed_floor_mel_l1']}")
    want = sorted(["token0", "token3", "token5", "token7", "uniform", "ref_wav"])
    if report["conditions"] != want:
        fail(f"style: conditions {report['conditions']}, expected {want}")
    if len(onehot) != 6 or not min(onehot.values()) > 0:
        fail(f"style: one-hot pairs with the same mel: {onehot}")
    missing = [k for k in ("gru_scan", "refenc_stack", "stft_features", "decode_scan")
               if not info["launches"].get(k)]
    if missing:
        fail(f"style: the run launched {info['launches']}, none of {missing}")


def run_bf16(torch, dev, cfg, corpus_dir, work):
    """``model.compute_dtype="bfloat16"`` on the card: gst_lj synthesis
    (B=32 with reference wavs, decoder dropout off on both) finite, apart
    from the float32 one yet within the JAX contract (mean |d| of the mel
    < 0.05), the same launches; its stage times; and one bf16 ``Trainer``
    step at gst_lj's widths on the corpus phase's patterns: a finite loss,
    float32 parameters."""
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import apply_overrides
    from gst_tacotron_tpu_torch.synthesize import Synthesizer
    from gst_tacotron_tpu_torch.train import Trainer
    from gst_tacotron_tpu_torch.weights import build_model

    cfg16 = apply_overrides(cfg, {"model.compute_dtype": "bfloat16"})
    texts, wavs = make_inputs(np.random.default_rng(16), cfg.audio.sample_rate)
    outs, counts = {}, {}
    for tag, c in (("float32", cfg), ("bfloat16", cfg16)):
        model = build_model(c, seed=0, device=dev)
        synth = Synthesizer(c, model, device=dev, deterministic_prenet=True)
        synth(texts, reference_wavs=wavs, seed=0)
        ops.reset_launch_counts()
        outs[tag] = synth(texts, reference_wavs=wavs, seed=0)
        torch.cuda.synchronize()
        counts[tag] = nonzero_counts(ops)
    d = {k: np.abs(outs["bfloat16"][k] - outs["float32"][k]) for k in ("mel", "linear")}
    finite = all(np.all(np.isfinite(outs["bfloat16"][k])) for k in ("mel", "linear", "wav"))
    info = {"name": "gst_lj bf16 synthesis", "batch": B, "launches": counts["bfloat16"],
            "launches_float32": counts["float32"], "finite": finite,
            "mel_mean_abs_vs_float32": float(d["mel"].mean()),
            "mel_max_abs_vs_float32": float(d["mel"].max()),
            "linear_max_abs_vs_float32": float(d["linear"].max())}
    print(json.dumps({"bf16": info}), flush=True)
    if not finite:
        fail("bf16: synthesis is not finite")
    if counts["bfloat16"] != counts["float32"]:
        fail(f"bf16: launches {counts['bfloat16']} differ from float32's {counts['float32']}")
    if not 0.0 < info["mel_mean_abs_vs_float32"] < 0.05:
        fail(f"bf16: mel mean |d| from float32 {info['mel_mean_abs_vs_float32']} (want in "
             f"(0, 0.05))")
    model16 = build_model(cfg16, seed=0, device=dev)
    print(json.dumps(profile_path(torch, dev, "gst_lj bf16", cfg16, model16, texts, wavs)),
          flush=True)

    trainer = Trainer(apply_overrides(cfg16, {"train.log_every": 1}), corpus_dir,
                      f"{work}/bf16", device=dev)
    batch = next(iter(trainer.loader.epoch(0)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = trainer.step_batch(batch)
    loss = float(metrics["loss"])
    step_ms = 1e3 * (time.perf_counter() - t0)
    f32 = all(p.dtype == torch.float32 for p in trainer.state.model.parameters())
    info = {"config": "gst_lj", "transport": "features, compute_dtype bfloat16", "batch": B,
            "frames": int(batch["mel"].shape[1]), "loss": loss,
            "grad_norm": float(metrics["grad_norm"]), "step_ms_first": step_ms,
            "params_float32": f32}
    print(json.dumps({"train": info}), flush=True)
    if not (np.isfinite(loss) and f32):
        fail(f"bf16 train step: loss {loss}, parameters float32 {f32}")


def run_cli(torch, dev, work):
    """``synthesize.main`` on the train phase's workdir (``work``/feat,
    decode cut to 64 steps): Griffin-Lim with two reference wavs, then
    ``--chunked-decoder``, then ``--vocoder wavernn`` from the vocoder
    phase's workdir (``work``/voc). Each run writes its wavs (and PNGs
    where matplotlib imports), and the launch counters show K1-K5 across
    the three."""
    import contextlib
    import io
    import os

    from scipy.io import wavfile

    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import get_preset
    from gst_tacotron_tpu_torch.synthesize import main as synthesize_main

    sr = get_preset("gst_lj").audio.sample_rate
    texts, wavs = make_inputs(np.random.default_rng(21), sr)
    refs = []
    for i, w in enumerate(wavs[:2]):
        refs.append(f"{work}/ref_{i}.wav")
        wavfile.write(refs[-1], sr, (w * 32767).astype(np.int16))
    try:
        import matplotlib  # noqa: F401
        pngs_expected = True
    except ImportError:
        pngs_expected = False
    runs = (("griffin_lim", ["--reference-wavs", *refs]),
            ("chunked", ["--reference-wavs", *refs, "--chunked-decoder"]),
            ("wavernn", ["--vocoder", "wavernn", "--vocoder-workdir", f"{work}/voc"]))
    seen = {}
    for label, extra in runs:
        out = f"{work}/cli_{label}"
        argv = ["--workdir", f"{work}/feat", "--out", out, "model.decoder.max_decode_steps=64",
                *extra, "--texts", *texts[:2]]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            synthesize_main(argv)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        counts = nonzero_counts(ops)
        for k, n in counts.items():
            seen[k] = seen.get(k, 0) + n
        names = sorted(os.listdir(out))
        info = {"run": label, "launches": counts, "wall_ms": wall,
                "wavs": sum(n.endswith(".wav") for n in names),
                "pngs": sum(n.endswith("_align.png") for n in names),
                "printed": printed.getvalue().strip().splitlines()[-1:]}
        print(json.dumps({"cli": info}), flush=True)
        if info["wavs"] != 2 or (pngs_expected and info["pngs"] != 2):
            fail(f"cli {label}: wrote {names}")
    missing = [k for k in ("gru_scan", "refenc_stack", "stft_features", "decode_scan",
                           "wavernn_sample") if not seen.get(k)]
    if missing:
        fail(f"cli: the three runs launched {seen}, none of {missing}")


def run_bench(torch, card):
    """The bench's functions at its workload (``bench.run``: gst_lj, B=32,
    200 steps, 15 Griffin-Lim iterations): its JSON line, informational,
    with the card, and its details (median and spread)."""
    import argparse

    from gst_tacotron_tpu_torch import bench

    args = argparse.Namespace(quick=False, batch=32, checkpoint=None, config5=False,
                              vocoder_workdir=None, details=None)
    t0 = time.perf_counter()
    result, details = bench.run(args)
    details["card"] = card
    print(json.dumps({"bench_details": details}), flush=True)
    print(json.dumps({"bench": result, "card": card}), flush=True)
    log(f"bench done in {time.perf_counter() - t0:.1f} s")


def run_kernel_bench(torch, card):
    """``python -m gst_tacotron_tpu_torch.kernel_bench`` at the JAX tool's
    defaults (gst_lj B=8 200 steps, 1000 and 2000 for the marginal; K3″ on
    1024 frames; 8 wavs of 512 frames through every STFT route; the (8, 256,
    80) reference encoder in float32 and bf16; gst_r1_location 1000 steps;
    WaveRNN at 4, 16 and 32 streams): its report with the card on one line.
    Fails where a section did not launch its kernels, a parity error exceeds
    the JAX package's kernel-test tolerance, or a roofline share reads over
    1.05."""
    from gst_tacotron_tpu_torch import kernel_bench

    report = kernel_bench.run("cuda")
    print(json.dumps({"kernel_bench": report, "card": card}), flush=True)
    if report["failures"]:
        fail("kernel_bench: " + "; ".join(report["failures"]))


def main() -> None:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    try:
        from gst_tacotron_tpu_torch import ops
        from gst_tacotron_tpu_torch.config import apply_overrides, get_preset
        from gst_tacotron_tpu_torch.kernel_bench import card_line
        from gst_tacotron_tpu_torch.ops.build import build_all
    except ImportError as e:
        fail(f"the port is not importable here: {e}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        card = card_line()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        fail(str(e))
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    decode_only = sys.argv[1:] == ["--decode-only"]
    train_only = sys.argv[1:] == ["--train-only"]
    parallel_only = sys.argv[1:] == ["--parallel-only"]
    t0 = time.perf_counter()
    from gst_tacotron_tpu_torch.ops import decode as decode_ops

    build_all([decode_ops.KERNEL] if decode_only else ops.all_kernels())
    log(f"built and loaded the kernels in {time.perf_counter() - t0:.1f} s")

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
    if decode_only:   # K4's two rows alone (its phase times), then stop
        for c, seed in ((cfg, 7), (cfg3, 8)):
            row = check_decode(torch, np.random.default_rng(seed), dev, c, init_seed=seed)
            print(json.dumps({"kernel_check": row}), flush=True)
        print(card)
        return
    if parallel_only:   # the parallel phase alone, then stop
        run_parallel(torch, dev)
        print(card)
        return
    if train_only:   # the train phase alone, on a fresh corpus, then stop
        from gst_tacotron_tpu_torch.data import generate_patterns, synthetic_utterances

        with tempfile.TemporaryDirectory() as corpus_dir, \
                tempfile.TemporaryDirectory() as work:
            generate_patterns(synthetic_utterances(CORPUS_UTTERANCES, variable=True),
                              get_preset("gst_lj").audio, corpus_dir, store_wav=True,
                              device_features=True, device=dev, bf16=False)
            run_train_phase(torch, dev, corpus_dir, work)
        print(card)
        return
    rng = np.random.default_rng(0)
    kernels = []
    for check in (lambda: check_gru(torch, rng, dev),
                  lambda: check_refenc(torch, rng, dev),
                  lambda: check_refenc_bf16(torch, dev),
                  lambda: check_stft(torch, rng, dev, cfg),
                  lambda: check_stft_bf16(torch, dev, cfg),
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
        if not res.get("max_err_row0", 0.0) <= res["tol"]:
            fail(f"{res['name']} at row0 {B // 2} differs from its plain version by "
                 f"{res['max_err_row0']} > {res['tol']}")
        kernels.append(res)

    # gru_scan: the encoder and post-net BiGRUs (one launch each, both
    # directions) and the reference-encoder GRU; on the card the reference
    # path runs K3's and K2's bf16 modes (their branch counters)
    taco = {**dict.fromkeys(ops.launch_counts(), 0), "gru_scan": 3, "refenc_stack": 1,
            "refenc_stack:bf16": 1, "stft_features": 4, "stft_features:bf16": 4,
            "decode_scan": 1}
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
    gate = start_alignment_gate()
    t0 = time.perf_counter()
    run_taco2(torch, dev, cfg, taco)
    log(f"taco2 phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_chunked(torch, dev, cfg, apply_overrides(cfg3, {"model.decoder.max_decode_steps": 256}))
    log(f"chunked phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_parallel(torch, dev)
    log(f"parallel phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_scaling(torch)
    log(f"scaling phase done in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as corpus_dir, tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        counts = run_corpus(torch, dev, get_preset("gst_lj"), corpus_dir)
        for r in kernels:
            if "launches" not in r and counts[r["name"]]:
                r["launches"] = counts[r["name"]]
        log(f"corpus path done in {time.perf_counter() - t0:.1f} s")
        run_train_phase(torch, dev, corpus_dir, work)
        t0 = time.perf_counter()
        run_determinism(torch, dev, corpus_dir, work)
        log(f"determinism phase done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        run_bf16(torch, dev, cfg, corpus_dir, work)
        log(f"bf16 phase done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        run_cli(torch, dev, work)
        log(f"CLI phase done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        run_jax_export(torch, dev, work)
        log(f"jax_export phase done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        run_style(torch, work)
        log(f"style phase done in {time.perf_counter() - t0:.1f} s")
    finish_alignment_gate(gate)
    run_bench(torch, card)
    t0 = time.perf_counter()
    run_kernel_bench(torch, card)
    log(f"kernel_bench phase done in {time.perf_counter() - t0:.1f} s")
    run_train_bench(torch, card)
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
    log(f"chip_smoke done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
