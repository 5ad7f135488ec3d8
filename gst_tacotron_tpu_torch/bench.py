"""Synthesis throughput of the port on one card: prints ONE JSON line,
``{"metric": "audio_seconds_per_sec_per_chip", "value", "unit",
"vs_baseline"}``, as the JAX package's ``bench.py`` does.

    python -m gst_tacotron_tpu_torch.bench [--quick] [--batch B]
        [--checkpoint WORKDIR] [--config5 [--vocoder-workdir DIR]]
        [--details FILE] [--watchdog SECONDS]

The workload is ``bench.py::build``'s: ``gst_lj`` at its published widths,
200 decode steps, Griffin-Lim 15 iterations at momentum 0.99, stop
threshold 1.0 (every step decodes, as a trained model near its length);
B = 32 texts of 64 random token ids in [2, 40) and a random 128-frame
reference mel, drawn in ``bench.py``'s order from ``default_rng(0)`` (so
both benches see the same arrays); seeded random weights, or a trainer
workdir's latest checkpoint with ``--checkpoint`` (the port's, or a JAX
workdir exported by ``tools/export_jax_workdir.py``; then the workdir's
config with its own stop threshold and its ``eval_sentences``).

``bench_fused`` times what ``bench.py::bench_fused`` times: the style
through ``ops/refenc.py::gst_style_from_params`` (K2, K1), ``GSTTacotron
.infer`` (K1, K4) and ``TorchDSP.inv_linear_spectrogram`` (Griffin-Lim),
the waveform kept on the card; a checksum of it chains the iterations and
is the one value fetched (one sync a timed loop), and each iteration draws
a fresh dropout seed. The timed loop runs ``repeats`` times; the headline is
the median, the spread goes to ``--details``.

``benchmark/`` (``python3 -m benchmark.run``) is the port's measure;
``bench_fused``, ``bench_reference_style`` and ``vs_baseline`` stay as ports
of the JAX bench, held to it by tests/test_torch_bench.py.

``vs_baseline`` divides by ``bench_reference_style``: the same weights driven
as the reference drives them, one host-dispatched ``ops/decode.py::
decode_step`` a step with its output copied to the host (the per-step cost
capped at 2 ms, as ``bench.py`` caps it), then the host numpy Griffin-Lim
(``dsp/ref.py::griffin_lim``), both measured short and extrapolated.

``--config5`` adds the WaveRNN pipeline (text -> mel -> K5 -> waveform) to
the details. ``benchmark_synthesis`` (the ``Synthesizer`` with its host
copies) is reported there too; it is not the headline. The bench needs the
card: without one it raises "CUDA is not available".

    python -m gst_tacotron_tpu_torch.bench --scaling [--device cpu]

measures instead weak scaling (``bench.py::bench_scaling``'s curve): a
fixed size a rank, one process a rank on one mesh, over 1 ..
``torch.cuda.device_count()`` cards on NCCL, one rank a card (with
``--device cpu`` over 1, 2 and 4 gloo processes at the JAX scaling child's
widths), for the JAX child's four workloads:

  * the data-parallel GST train step (``train.train_step``) at gst_lj's
    own training batch a rank (``configs/gst_lj.json``: ``data.batch_size``
    32 rows at its first bucket, 64 tokens and 400 frames; on the CPU 2
    rows of 16 frames);
  * the contention control: 30 elementwise updates of a rank's own (64,
    512) rows, no collective; its falloff bounds what contention for the
    host's cores costs, so what the other rows lose beyond it is the
    collectives';
  * chunked-consensus synthesis through ``DistributedSynthesizer``
    (uniform token weights, the stop consensus a chunk, Griffin-Lim, the
    all-gather of the outputs): the bench's 32 texts of 64 tokens a rank,
    200 steps in chunks of 64 (on the CPU 2 rows, 8 steps in chunks of 4);
    its rate counts the step budget's frames, as the JAX child's does;
  * WaveRNN sampling of a rank's rows of a global mel (``gst_wavernn``'s
    vocoder on 32 rows of 128 frames a rank, K5; on the CPU the JAX child's
    16-wide vocoder on 2 rows of 6 frames).

It prints one JSON line of rows (ranks; each workload's slowest-rank time,
global rate and efficiency against one rank, under the JAX names; the
synthesis ``chunks_run`` and the launch counts of each rank); on one card,
its one point, and says so.

``--watchdog SECONDS`` (default 2400, 0 off; ``bench.py``'s flag) guards
the headline run and ``--scaling``: if no result line is printed in time
(a wedged card, a hung rank), every live child process is killed, one
line with the run's metric, value 0.0 and an ``error`` is printed, and the
bench exits with code 3. ``--train-bench`` is not guarded, as in
``bench.py``, which returns from that mode before arming its watchdog.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import statistics
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Config, apply_overrides, get_preset, load_config
from .device import resolve_device

WORKLOAD = {"model.decoder.max_decode_steps": 200, "audio.griffin_lim_iters": 15,
            "audio.griffin_lim_momentum": 0.99, "model.decoder.stop_threshold": 1.0}
QUICK = {"model.decoder.max_decode_steps": 50, "audio.griffin_lim_iters": 8}
T_TEXT, T_MEL = 64, 128
# the per-step dispatch of the reference-style decode is capped at this
# (bench.py's local eager-dispatch estimate), so vs_baseline favours the
# baseline
STEP_CAP_S = 0.002
WATCHDOG_S = 2400.0     # bench.py's default


def log(*a) -> None:
    print("[bench]", *a, file=sys.stderr, flush=True)


def workload(batch: int = 32, checkpoint: Optional[str] = None,
             overrides: Optional[Dict[str, Any]] = None
             ) -> Tuple[Config, Dict[str, np.ndarray]]:
    """The config and the inputs: ``bench.py::build``'s, drawn in its order."""
    ov = dict(WORKLOAD, **(overrides or {}))
    if checkpoint is not None:
        ov.pop("model.decoder.stop_threshold")
        cfg = apply_overrides(load_config(os.path.join(checkpoint, "config.json")), ov)
    else:
        cfg = apply_overrides(get_preset("gst_lj"), ov)
    rng = np.random.default_rng(0)
    if checkpoint is not None:
        from .text import batch_text_to_ids

        sents = list(cfg.train.eval_sentences)
        tok, tok_len = batch_text_to_ids([sents[i % len(sents)] for i in range(batch)])
        tokens = np.zeros((batch, T_TEXT), np.int32)
        tokens[:, : min(T_TEXT, tok.shape[1])] = tok[:, :T_TEXT]
        token_lengths = np.minimum(tok_len, T_TEXT).astype(np.int32)
    else:
        tokens = rng.integers(2, 40, (batch, T_TEXT)).astype(np.int32)
        token_lengths = np.full((batch,), T_TEXT, np.int32)
    sample = {"tokens": tokens, "token_lengths": token_lengths,
              "mel": rng.random((batch, T_MEL, cfg.model.num_mels), np.float32),
              "mel_lengths": np.full((batch,), T_MEL, np.int32)}
    return cfg, sample


def build(batch: int = 32, checkpoint: Optional[str] = None,
          overrides: Optional[Dict[str, Any]] = None, device=None):
    """(cfg, model, sample, step): the workload and the model on the card
    (``device`` another when named); ``step`` the checkpoint's, or None."""
    from .checkpoint import CheckpointManager
    from .weights import build_model

    dev = resolve_device(device)
    cfg, sample = workload(batch, checkpoint, overrides)
    model = build_model(cfg, seed=0, device=dev)
    step = None
    if checkpoint is not None:
        saved = CheckpointManager(os.path.join(checkpoint, cfg.train.checkpoint_dir)).restore(
            map_location=dev)
        model.load_state_dict(saved["model"])
        step = int(saved["step"])
        log(f"restored trained checkpoint at step {step}")
    return cfg, model, sample, step


def _inputs(sample, dev):
    t = lambda k, dt: torch.as_tensor(sample[k], dtype=dt, device=dev)
    return (t("tokens", torch.int64), t("token_lengths", torch.int64), t("mel", torch.float32),
            t("mel_lengths", torch.int64))


@torch.no_grad()
def bench_fused(cfg: Config, model, sample, iterations: int = 10, repeats: int = 5
                ) -> Dict[str, Any]:
    """The headline path (see the module docstring). Returns the audio
    seconds a batch, each repeat's ms a batch, their median, and the frame
    total."""
    from .dsp.torch_dsp import TorchDSP
    from .ops.refenc import gst_style_from_params

    dev = next(model.parameters()).device
    dsp = TorchDSP(cfg.audio, dev)
    tokens, lengths, ref_mel, ref_lengths = _inputs(sample, dev)

    def synth(acc, seed):
        style = None
        if model.gst is not None:
            style, _ = gst_style_from_params(model.gst, ref_mel, ref_lengths)
        out = model.infer(tokens, lengths, ref_mel, ref_lengths, precomputed_style=style,
                          seed=seed)
        wav = dsp.inv_linear_spectrogram(out["linear"].float())
        return out["frame_lengths"], wav[:, ::997].sum() + acc * 1e-9

    t0 = time.perf_counter()
    fl, csum = synth(torch.zeros((), device=dev), 0)
    float(csum)
    log(f"first call (kernel builds included) {time.perf_counter() - t0:.1f} s")
    ms = []
    for rep in range(repeats):
        t0 = time.perf_counter()
        for i in range(iterations):
            fl, csum = synth(csum, 100 + rep * iterations + i)
        float(csum)                     # the one fetch: every iteration has run
        ms.append(1e3 * (time.perf_counter() - t0) / iterations)
    frames = int(fl.sum())
    audio_seconds = frames * cfg.audio.hop_length / cfg.audio.sample_rate
    med = statistics.median(ms)
    log(f"fused: {med:.2f} ms a batch (median of {repeats} x {iterations}; "
        f"{min(ms):.2f}..{max(ms):.2f})")
    return {"audio_seconds": audio_seconds, "frames": frames, "ms_per_batch": ms,
            "median_ms": med, "decode_steps": frames // cfg.model.decoder.reduction_factor}


@torch.no_grad()
def bench_reference_style(cfg: Config, model, sample, max_steps: int = 40
                          ) -> Tuple[float, float]:
    """(seconds a decode step, host Griffin-Lim seconds a frame) of the
    reference-style emulation."""
    from .dsp import ref as dsp_ref
    from .ops.decode import decode_step, initial_decode_state, prenet_keep

    dev = next(model.parameters()).device
    tokens, lengths, ref_mel, ref_lengths = _inputs(sample, dev)
    memory, _ = model.build_memory(tokens, lengths, ref_mel, ref_lengths)
    dec = model.decoder
    keys = dec.cell.precompute_keys(memory)
    w = dec.cell.pack()
    memory, keys = memory.float(), keys.float()
    b, t, _ = memory.shape
    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    valid[:, 0] = True
    rate = float(dec.cfg.prenet_dropout)
    kw = dict(attn_cfg=dec.attn_cfg, num_mels=dec.num_mels, rate=rate)
    nm, r = dec.num_mels, dec.cfg.reduction_factor

    def step(st, frame, i):
        keep = prenet_keep(1, 1, b, w["pw1"].shape[1], w["pw2"].shape[1], rate, dev, i)
        st, out, _ = decode_step(w, st, frame, memory, keys, valid,
                                 keep=(keep[0][0], keep[1][0]), **kw)
        return st, out

    st, frame = initial_decode_state(w, memory), memory.new_zeros(b, nm)
    st, out = step(st, frame, 0)                      # warm-up
    out.cpu()
    t0 = time.perf_counter()
    for i in range(max_steps):
        st, out = step(st, frame, i)
        frame = out[:, (r - 1) * nm: r * nm]
        out.cpu().numpy()                 # the reference copies each step's output
    per_step = (time.perf_counter() - t0) / max_steps
    gl_frames = 64
    mag = np.abs(np.random.default_rng(0).standard_normal((gl_frames, cfg.model.num_freq)))
    t0 = time.perf_counter()
    dsp_ref.griffin_lim(mag, cfg.audio)
    return per_step, (time.perf_counter() - t0) / gl_frames


@torch.no_grad()
def bench_config5(cfg: Config, model, sample, iterations: int = 3,
                  vocoder_workdir: Optional[str] = None) -> Dict[str, Any]:
    """gst_wavernn end to end (``bench.py::bench_config5``): style (K2, K1),
    infer (K1, K4), then the WaveRNN sampler (K5) on the decoded mel, all B
    rows; the checksum of the waveform chains the iterations."""
    from .vocoder import load_wavernn_variables
    from .weights import build_wavernn
    from .ops.refenc import gst_style_from_params

    vcfg = apply_overrides(cfg, {"model.vocoder.kind": "wavernn"})
    dev = next(model.parameters()).device
    if vocoder_workdir:
        wmodel = build_wavernn(vcfg, flat=load_wavernn_variables(vocoder_workdir), device=dev)
    else:
        wmodel = build_wavernn(vcfg, seed=1, device=dev)
    tokens, lengths, ref_mel, ref_lengths = _inputs(sample, dev)

    def pipeline(acc, seed):
        style, _ = gst_style_from_params(model.gst, ref_mel, ref_lengths)
        out = model.infer(tokens, lengths, ref_mel, ref_lengths, precomputed_style=style,
                          seed=seed)
        wav = wmodel.sample(out["mel"], seed=seed + 104729)
        return wav[:, ::997].sum() + acc * 1e-9

    float(pipeline(torch.zeros((), device=dev), 7))
    t0 = time.perf_counter()
    acc = torch.zeros((), device=dev)
    for i in range(iterations):
        acc = pipeline(acc, 100 + i)
    float(acc)
    dt = (time.perf_counter() - t0) / iterations
    b = sample["tokens"].shape[0]
    frames = b * cfg.model.decoder.max_decode_steps * cfg.model.decoder.reduction_factor
    audio_seconds = frames * cfg.audio.hop_length / cfg.audio.sample_rate
    log(f"config5 (WaveRNN): {dt * 1e3:.1f} ms a batch, {audio_seconds / dt:.1f} audio-s/s")
    return {"audio_seconds_per_sec_per_chip": audio_seconds / dt, "wall_s_per_batch": dt,
            "batch": b, "wav_samples_per_batch": frames * cfg.audio.hop_length,
            "vocoder": "wavernn (K5), " + ("trained" if vocoder_workdir else "seeded weights")}


def run(args) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The result line and the details of one bench."""
    from .synthesize import Synthesizer, benchmark_synthesis

    cfg, model, sample, step = build(args.batch, args.checkpoint,
                                     QUICK if args.quick else None)
    dev = next(model.parameters()).device
    fused = bench_fused(cfg, model, sample, iterations=5 if args.quick else 10,
                        repeats=3 if args.quick else 5)
    per_step, gl_per_frame = bench_reference_style(cfg, model, sample,
                                                   max_steps=20 if args.quick else 40)
    med_s = fused["median_ms"] / 1e3
    tput = fused["audio_seconds"] / med_s
    used = min(per_step, STEP_CAP_S)
    ref_dt = used * fused["decode_steps"] + gl_per_frame * fused["frames"]
    ref_tput = fused["audio_seconds"] / ref_dt
    result = {"metric": "audio_seconds_per_sec_per_chip", "value": round(tput, 3),
              "unit": "audio-s/s/chip", "vs_baseline": round(tput / ref_tput, 2)}
    synth = Synthesizer(cfg, model, device=dev)
    texts = [f"benchmark sentence number {i}." for i in range(sample["tokens"].shape[0])]
    details = {
        **result,
        "ms_per_batch": fused["ms_per_batch"], "median_ms": fused["median_ms"],
        "spread_ms": [min(fused["ms_per_batch"]), max(fused["ms_per_batch"])],
        "audio_seconds": fused["audio_seconds"],
        "decode_steps_per_sec": fused["decode_steps"] / med_s,
        "emulated_reference_wall_s": ref_dt, "emulated_reference_tput": ref_tput,
        "per_step_dispatch_s": per_step, "per_step_dispatch_used_s": used,
        "gl_host_s_per_frame": gl_per_frame,
        "benchmark_synthesis": benchmark_synthesis(synth, texts, iterations=3),
        "synthesis_batch": sample["tokens"].shape[0],
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "num_chips": 1,
    }
    if step is not None:
        details["trained_checkpoint"] = {"workdir": args.checkpoint, "step": step,
                                         "stop_threshold": cfg.model.decoder.stop_threshold}
    if args.config5:
        details["config5_wavernn_pipeline"] = bench_config5(
            cfg, model, sample, vocoder_workdir=args.vocoder_workdir)
    return result, details


# the JAX bench's fake-mesh widths (``__graft_entry__._tiny_overrides``)
TINY = {"audio.n_fft": 512, "audio.hop_length": 128, "audio.win_length": 512,
        "audio.griffin_lim_iters": 4, "model.num_freq": 257,
        "model.encoder.embedding_dim": 64,
        "model.encoder.prenet_dims": [64, 32], "model.encoder.cbhg_bank_k": 4,
        "model.encoder.cbhg_bank_channels": 32, "model.encoder.cbhg_proj_channels": [32, 32],
        "model.encoder.cbhg_highway_layers": 2, "model.encoder.cbhg_highway_dim": 32,
        "model.encoder.cbhg_gru_dim": 32, "model.gst.ref_conv_channels": [8, 16, 32],
        "model.gst.ref_gru_dim": 32, "model.gst.style_dim": 32, "model.attention.dim": 32,
        "model.decoder.prenet_dims": [64, 32], "model.decoder.attention_rnn_dim": 32,
        "model.decoder.decoder_rnn_dim": 32, "model.postnet.cbhg_bank_k": 2,
        "model.postnet.cbhg_bank_channels": 16, "model.postnet.cbhg_proj_channels": [32, 80],
        "model.postnet.cbhg_highway_layers": 1, "model.postnet.cbhg_highway_dim": 32,
        "model.postnet.cbhg_gru_dim": 32}
# the JAX scaling child's contention control (bench.py:825-848): rows a rank,
# their width, and the elementwise updates an iteration
CONTROL_ROWS, CONTROL_WIDTH, CONTROL_UPDATES = 64, 512, 30
# its WaveRNN on the CPU (bench.py:880-907), and the sampling seed of the row
CPU_VOCODER = {"model.vocoder.wavernn_gru_dim": 16, "model.vocoder.wavernn_fc_dim": 16,
               "model.vocoder.wavernn_hop": 4}
WAVERNN_SEED = 3


def scaling_shape(cfg: Config, cpu: bool) -> Tuple[int, int, int]:
    """(rows, tokens, frames) a rank of the weak-scaling step: on the card
    the config's training batch (``data.batch_size`` rows at its first
    bucket's text and frame lengths); on the CPU the JAX bench's fake-mesh
    size (2 rows, 32 tokens, 16 frames)."""
    if cpu:
        return 2, 32, 16
    t_text, frames = cfg.data.buckets[0]
    return cfg.data.batch_size, t_text, frames


def synth_workload(cpu: bool) -> Tuple[Config, int, int, int]:
    """(config, rows a rank, decode steps, chunk steps) of the synthesis
    row: on the CPU the JAX child's (its fake-mesh config, 2 rows, 8 steps in
    chunks of 4); on the card the bench's workload (``gst_lj``, ``WORKLOAD``:
    stop threshold 1.0, 15 Griffin-Lim iterations) on 32 rows, 200 steps in
    chunks of 64."""
    if cpu:
        return apply_overrides(get_preset("gst_lj"), TINY), 2, 8, 4
    cfg = apply_overrides(get_preset("gst_lj"), WORKLOAD)
    return cfg, 32, cfg.model.decoder.max_decode_steps, 64


def wavernn_workload(cpu: bool) -> Tuple[Config, int, int]:
    """(config, rows a rank, mel frames) of the WaveRNN row: on the CPU the
    JAX child's vocoder (GRU 16, fc 16, hop 4) on 2 rows of 6 frames; on the
    card ``gst_wavernn``'s (GRU 512, fc 512, hop 256) on 32 rows of 128
    frames."""
    if cpu:
        return apply_overrides(get_preset("gst_lj"), {**TINY, **CPU_VOCODER}), 2, 6
    return get_preset("gst_wavernn"), 32, 128


def wavernn_mel(cfg: Config, rows: int, frames: int) -> np.ndarray:
    """The WaveRNN row's global conditioning mel, (rows, frames, mels)."""
    return np.random.default_rng(0).random((rows, frames, cfg.model.num_mels), np.float32)


def classes_digest(classes: torch.Tensor) -> str:
    """A digest of int32 classes (a rank's WaveRNN samples, compared
    exactly without sending them)."""
    import hashlib

    return hashlib.sha256(classes.to("cpu", torch.int32).numpy().tobytes()).hexdigest()[:16]


def scaling_batch(cfg: Config, rows: int, t_text: int, frames: int, seed: int = 0
                  ) -> Dict[str, np.ndarray]:
    """A seeded global feature batch of ``rows`` rows (the same on every
    rank): texts of ``t_text // 2 .. t_text`` tokens, even mel lengths of
    ``frames // 2 .. frames``."""
    rng = np.random.default_rng(seed)
    tl = rng.integers(t_text // 2, t_text + 1, rows)
    ml = 2 * rng.integers(frames // 4, frames // 2 + 1, rows)
    fmask = (np.arange(frames)[None] < ml[:, None])[..., None]
    return {"tokens": rng.integers(2, 40, (rows, t_text)) * (np.arange(t_text)[None] < tl[:, None]),
            "token_lengths": tl, "mel_lengths": ml, "speaker_ids": np.zeros(rows, np.int64),
            "mel": (rng.random((rows, frames, cfg.model.num_mels)) * fmask).astype(np.float32),
            "linear": (rng.random((rows, frames, cfg.model.num_freq)) * fmask
                       ).astype(np.float32)}


def _timed(fn, iters: int, sync) -> float:
    """Seconds a call of ``fn``: one untimed call, then ``iters`` calls,
    ``sync`` at each end of the timed loop."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters


def scaling_rank(rank: int, world: int, port: int, device: str, steps: int, out) -> None:
    """One rank of a weak-scaling point (a spawned process), in a process
    group of ``world`` ranks (gloo on the CPU, NCCL a card each), on the JAX
    scaling child's four workloads, each at a fixed size a rank:

    1. the data-parallel train step from the seeded init on its rows of a
       global batch, ``steps`` steps;
    2. the contention control: ``CONTROL_UPDATES`` elementwise updates of
       its own (64, 512) rows an iteration, no collective, ``steps``
       iterations;
    3. chunked-consensus synthesis through ``DistributedSynthesizer`` over
       the same mesh (uniform token weights, no reference; on the card K1 and
       K4), ``max(3, steps // 2)`` calls;
    4. WaveRNN sampling of its rows of a global mel under ``data_parallel``
       (each rank draws its rows of the global batch; on the card one K5
       launch a call), ``max(3, steps // 2)`` calls.

    Puts (rank, ok, {times, chunks_run, WaveRNN digest, launches of rows 3
    and 4} or a traceback) on ``out``."""
    import torch.distributed as dist

    from . import ops
    from .models.modules import data_parallel
    from .parallel import DistributedSynthesizer, make_mesh, place_state, shard_batch
    from .parallel.mesh import rank_device
    from .train import init_state, make_optimizer, train_step
    from .weights import build_model, build_wavernn

    cpu = device == "cpu"
    try:
        if cpu:
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group("gloo" if cpu else "nccl",
                                init_method=f"tcp://localhost:{port}", world_size=world,
                                rank=rank)
        dev = rank_device("cpu" if cpu else None)
        sync = (lambda: None) if cpu else (lambda: torch.cuda.synchronize(dev))
        iters = max(3, steps // 2)
        cfg = apply_overrides(get_preset("gst_lj"), TINY if cpu else {})
        rows, t_text, frames = scaling_shape(cfg, cpu)
        mesh = make_mesh(1)
        _, state = init_state(cfg, dev)
        place_state(state, mesh)
        batch = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in
                 shard_batch(scaling_batch(cfg, rows * world, t_text, frames), mesh).items()}
        tx = make_optimizer(cfg.optimizer)
        float(train_step(tx, cfg, state, batch)["loss"])      # warm-up
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = train_step(tx, cfg, state, batch)["loss"]
        float(loss)                                          # the sync point
        res = {"train_ms": 1e3 * (time.perf_counter() - t0) / steps}

        x = torch.ones((CONTROL_ROWS, CONTROL_WIDTH), dtype=torch.float32, device=dev)

        def control():
            nonlocal x
            for _ in range(CONTROL_UPDATES):
                x = torch.tanh(x) * 1.0001 + 0.0001
        res["control_s"] = _timed(control, steps, sync)

        scfg, srows, max_steps, chunk = synth_workload(cpu)
        sample = workload(srows * world)[1]
        n_tok = scfg.model.gst.num_tokens
        weights = np.full((srows * world, n_tok), 1.0 / n_tok, np.float32)
        # the trained weights in a model of the synthesis config: its decoder's
        # stop threshold is the model's
        smodel = build_model(scfg, seed=0, device=dev)
        smodel.load_state_dict(state.model.state_dict())
        ds = DistributedSynthesizer(scfg, smodel, mesh, device=dev)
        chunks = []

        def synth():
            chunks.append(ds(sample["tokens"], sample["token_lengths"], token_weights=weights,
                             chunked=True, chunk_steps=chunk, max_steps=max_steps)["chunks_run"])
        ops.reset_launch_counts()
        res["synth_s"] = _timed(synth, iters, sync)
        res["synth_launches"] = {k: n for k, n in ops.launch_counts().items() if n}
        if len(set(chunks)) != 1:
            raise RuntimeError(f"chunks_run changed between calls: {chunks}")
        res["chunks_run"] = chunks[0]

        wcfg, wrows, wframes = wavernn_workload(cpu)
        vocoder = build_wavernn(wcfg, seed=1, device=dev)
        mel = torch.from_numpy(shard_batch(
            {"mel": wavernn_mel(wcfg, wrows * world, wframes)}, mesh)["mel"]).to(dev)
        classes = None

        def sample_classes():
            nonlocal classes
            with data_parallel(vocoder, mesh.data_shard()):
                classes = vocoder.sample_classes(mel, seed=WAVERNN_SEED)
        ops.reset_launch_counts()
        with torch.no_grad():
            res["wavernn_s"] = _timed(sample_classes, iters, sync)
        res["wavernn_launches"] = {k: n for k, n in ops.launch_counts().items() if n}
        res["wavernn_digest"] = classes_digest(classes)
        out.put((rank, True, res))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# each rate and its weak-scaling efficiency (bench.py:939-952's names)
EFFICIENCIES = (("global_samples_per_sec", "weak_scaling_efficiency"),
                ("control_global_rows_per_sec", "control_efficiency"),
                ("synth_global_frames_per_sec", "synth_efficiency"),
                ("wavernn_global_samples_per_sec", "wavernn_efficiency"))


def bench_scaling(device: str = "cuda", counts: Optional[Sequence[int]] = None,
                  steps: int = 3) -> List[Dict[str, Any]]:
    """The weak-scaling rows: for each rank count, ``scaling_rank`` on that
    many spawned processes. Each workload's time is its slowest rank's;
    its rate is its global work over that time, and its efficiency the rate
    a rank over one rank's (``EFFICIENCIES``). On the card the kernels are
    built here first, so the ranks only load them."""
    from .parallel.mesh import free_port

    cpu = device == "cpu"
    if counts is None:
        counts = (1, 2, 4) if cpu else range(1, torch.cuda.device_count() + 1)
    if not cpu:
        from . import ops
        from .ops.build import build_all

        build_all(ops.all_kernels())
    rows_per_rank, t_text, frames = scaling_shape(get_preset("gst_lj"), cpu)
    scfg, srows, max_steps, chunk = synth_workload(cpu)
    wcfg, wrows, wframes = wavernn_workload(cpu)
    r = scfg.model.decoder.reduction_factor
    ctx = multiprocessing.get_context("spawn")
    out_rows = []
    for n in counts:
        q = ctx.Queue()
        port = free_port()
        procs = [ctx.Process(target=scaling_rank, args=(rank, n, port, device, steps, q))
                 for rank in range(n)]
        for proc in procs:
            proc.start()
        res = {}
        try:
            for _ in procs:
                rank, ok, value = q.get(timeout=900)
                if not ok:
                    raise RuntimeError(f"scaling rank {rank} of {n} failed:\n{value}")
                res[rank] = value
        finally:
            for proc in procs:
                proc.join(timeout=60)
                if proc.is_alive():
                    proc.kill()
        ranks = [res[i] for i in range(n)]
        slowest = lambda key: max(x[key] for x in ranks)
        step_ms = slowest("train_ms")
        out_rows.append({
            "ranks": n, "ms_per_step": step_ms, "rows_per_rank": rows_per_rank,
            "tokens": t_text, "frames": frames,
            "global_samples_per_sec": rows_per_rank * n / (step_ms / 1e3),
            "control_s": slowest("control_s"),
            "control_global_rows_per_sec": CONTROL_ROWS * n / slowest("control_s"),
            "synth_s": slowest("synth_s"), "synth_rows_per_rank": srows,
            "synth_max_steps": max_steps, "chunk_steps": chunk,
            "synth_global_frames_per_sec": srows * n * max_steps * r / slowest("synth_s"),
            "chunks_run": [x["chunks_run"] for x in ranks],
            "wavernn_s": slowest("wavernn_s"), "wavernn_rows_per_rank": wrows,
            "wavernn_frames": wframes,
            "wavernn_global_samples_per_sec":
                wrows * n * wframes * wcfg.model.vocoder.wavernn_hop / slowest("wavernn_s"),
            "wavernn_digests": [x["wavernn_digest"] for x in ranks],
            "launches": [{"synth": x["synth_launches"], "wavernn": x["wavernn_launches"]}
                         for x in ranks]})
        log(f"scaling {n} rank(s): {step_ms:.1f} ms a step, synthesis "
            f"{1e3 * slowest('synth_s'):.1f} ms, WaveRNN {1e3 * slowest('wavernn_s'):.1f} ms")
    for key, eff in EFFICIENCIES:
        base = out_rows[0][key] / out_rows[0]["ranks"]
        for row in out_rows:
            row[eff] = row[key] / row["ranks"] / base
    return out_rows


def scaling_line(device: str, steps: int) -> Dict[str, Any]:
    """The ``--scaling`` result line."""
    if device != "cpu":
        resolve_device(None)
    rows = bench_scaling(device, steps=steps)
    kind = "cpu (gloo processes)" if device == "cpu" else torch.cuda.get_device_name(0)
    note = ("weak scaling at a fixed size a rank of the data-parallel GST train step, "
            "a contention control with no collective, chunked-consensus synthesis and "
            "WaveRNN sampling; "
            + ("gloo processes on the host's cores (the curve's shape, not a device rate)"
               if device == "cpu" else "NCCL, one rank a card"))
    if device != "cpu" and len(rows) == 1:
        note += "; one card: one point, no curve"
    return {"metric": "weak_scaling_efficiency", "rows": rows, "device": kind, "note": note}


# bench.py::bench_train's workload: gst_lj, 8 rows of 64 tokens and 400 frames
TRAIN_BATCH, TRAIN_T_TEXT, TRAIN_T_MEL, TRAIN_STEPS = 8, 64, 400, 15
TRANSPORTS = ("features", "wav", "corpus")
CORPUS_ROWS = 64


def train_bench_wire(cfg: Config, transport: str, batch: int, t_text: int, t_mel: int
                     ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], np.random.Generator]:
    """(feature batch, wire batch, the generator after them):
    ``bench.py::bench_train``'s arrays, drawn in its order from
    ``default_rng(0)``; the wire is the feature batch (``features``) or the
    float16 wav + int32 block of the wav transport (``wav``, ``corpus``)."""
    rng = np.random.default_rng(0)
    a = cfg.audio
    feat = {
        "tokens": rng.integers(2, 40, (batch, t_text)).astype(np.int32),
        "token_lengths": np.full((batch,), t_text, np.int32),
        "mel": rng.random((batch, t_mel, cfg.model.num_mels), np.float32),
        "mel_lengths": np.full((batch,), t_mel, np.int32),
        "linear": rng.random((batch, t_mel, cfg.model.num_freq), np.float32),
        "speaker_ids": np.zeros((batch,), np.int32),
    }
    if transport == "features":
        return feat, feat, rng
    sig_len = (t_mel - 1) * a.hop_length + a.n_fft
    ints = np.zeros((batch, t_text + 4), np.int32)
    ints[:, :t_text] = feat["tokens"]
    ints[:, t_text] = t_text
    ints[:, t_text + 1] = t_mel
    ints[:, t_text + 2] = t_mel
    wire = {"wav": (rng.standard_normal((batch, sig_len)) * 0.05).astype(np.float16),
            "ints": ints}
    return feat, wire, rng


def bench_train(transport: str, steps: int = TRAIN_STEPS, batch: int = TRAIN_BATCH,
                t_text: int = TRAIN_T_TEXT, t_mel: int = TRAIN_T_MEL, device=None,
                overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Train-step time of one batch transport, as ``bench.py::bench_train``
    measures it: the seeded gst_lj state, one untimed step, then ``steps``
    steps each fed a FRESH host batch (one element perturbed a copy), the
    loss of the last fetched once at the end (every step feeds the next).
    ``features``: the 6-tensor float32 feature batch; ``wav``: the float16
    wav + int32 wire, features computed in the step
    (``train._materialize_features``); ``corpus``: a 64-row corpus resident
    on the device, a fresh (B,) index a step. ``overrides`` cut the model
    (the CPU tests)."""
    from .train import init_state, make_optimizer, train_step, train_step_device_corpus

    dev = resolve_device(device)
    cfg = apply_overrides(get_preset("gst_lj"), {
        **(overrides or {}), "data.wav_transport": transport in ("wav", "corpus"),
        "data.batch_size": batch})
    _, wire, rng = train_bench_wire(cfg, transport, batch, t_text, t_mel)
    bytes_per_batch = batch * 4 if transport == "corpus" else sum(
        v.nbytes for v in wire.values())
    _, state = init_state(cfg, dev)
    tx = make_optimizer(cfg.optimizer)
    to_dev = lambda b: {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    if transport == "corpus":
        c_wav, c_ints = (torch.from_numpy(np.concatenate([wire[k]] * (CORPUS_ROWS // batch)))
                         .to(dev) for k in ("wav", "ints"))
        sig_len = wire["wav"].shape[1]

        def step(idx):
            return train_step_device_corpus(tx, cfg, t_text, sig_len, t_text, state, c_wav,
                                            c_ints, torch.from_numpy(idx).to(dev))
        first = np.arange(batch, dtype=np.int64)
        timed = [rng.integers(0, CORPUS_ROWS, batch).astype(np.int64) for _ in range(steps)]
    else:
        def step(b):
            return train_step(tx, cfg, state, to_dev(b))
        first = wire
        timed = []
        for i in range(steps):
            b = {k: v.copy() for k, v in wire.items()}
            (b["wav"] if "wav" in b else b["mel"])[0, 0] = i * 1e-3
            timed.append(b)
    t0 = time.perf_counter()
    float(step(first)["loss"])
    log(f"train[{transport}] first step {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for b in timed:
        metrics = step(b)
    loss = float(metrics["loss"])        # the sync point: every step feeds the next
    dt = (time.perf_counter() - t0) / steps
    log(f"train[{transport}]: {dt * 1e3:.1f} ms/step, loss {loss:.4f}")
    return {"transport": transport, "ms_per_step": dt * 1e3, "steps_per_sec": 1.0 / dt,
            "wire_mb_per_batch": bytes_per_batch / 1e6,
            "arg_buffers": 1 if transport == "corpus" else len(wire), "batch": batch,
            "t_mel_frames": t_mel, "steps": steps, "loss": loss}


def train_bench_line(steps: int = TRAIN_STEPS, device=None,
                     overrides: Optional[Dict[str, Any]] = None, **shape) -> Dict[str, Any]:
    """The ``--train-bench`` line: ``bench.py``'s ``train_ms_per_step``
    (the wav transport's ms a step) with a row per transport.
    ``vs_baseline`` is this run's features-transport time over its
    wav-transport time, the ratio the JAX bench prints from its own two
    rows; no TPU number enters it."""
    rows = [bench_train(t, steps, device=device, overrides=overrides, **shape)
            for t in TRANSPORTS]
    dev = resolve_device(device)
    return {"metric": "train_ms_per_step", "value": rows[1]["ms_per_step"],
            "unit": "ms/step (wav transport)",
            "vs_baseline": rows[0]["ms_per_step"] / rows[1]["ms_per_step"],
            "baseline": "the features transport's ms a step, this run",
            "rows": rows,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)}


def watchdog_line(scaling: bool) -> Dict[str, Any]:
    """The line a fired watchdog prints, less its ``error``: the keys and
    values of ``bench.py::_arm_watchdog``'s line, under the metric of the
    mode that was running."""
    if scaling:
        return {"metric": "weak_scaling_efficiency", "value": 0.0,
                "unit": "rate a rank / one rank's", "vs_baseline": 0.0}
    return {"metric": "audio_seconds_per_sec_per_chip", "value": 0.0,
            "unit": "audio-s/s/chip", "vs_baseline": 0.0}


def arm_watchdog(seconds: float, line: Dict[str, Any]) -> threading.Timer:
    """``bench.py::_arm_watchdog`` for the card: a daemon timer that, unless
    cancelled within ``seconds``, kills every live child process (the
    spawned scaling ranks, which would hold the card), prints ``line`` with
    an ``error``, flushes and ends the process with exit code 3."""

    def fire():
        for child in multiprocessing.active_children():
            child.kill()
            child.join(5)
        print(json.dumps({**line, "error": f"watchdog: no result within {seconds:.0f}s — "
                                           "the device did not respond"}), flush=True)
        os._exit(3)

    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    return timer


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Synthesis throughput of the PyTorch port")
    p.add_argument("--quick", action="store_true", help="smaller workload (50 steps)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--checkpoint", help="a trainer workdir (the port's, or an exported JAX "
                                        "one): bench the trained model with real "
                                        "stop-token termination")
    p.add_argument("--config5", action="store_true",
                   help="also time the WaveRNN pipeline (K5), into --details")
    p.add_argument("--vocoder-workdir", help="vocoder_train workdir for --config5")
    p.add_argument("--details", help="write the detailed JSON here")
    p.add_argument("--scaling", action="store_true",
                   help="measure weak scaling instead: the data-parallel train step, a "
                        "contention control, chunked synthesis and WaveRNN sampling")
    p.add_argument("--device", default=None,
                   help="with --scaling: 'cpu' runs gloo processes on the CPU; with "
                        "--train-bench: the device (default cuda)")
    p.add_argument("--steps", type=int, help="with --scaling (default 3) or --train-bench "
                                              f"(default {TRAIN_STEPS}): timed steps")
    p.add_argument("--train-bench", action="store_true",
                   help="train-step time per batch transport (features, wav, corpus) "
                        "instead; prints one JSON line")
    p.add_argument("--watchdog", type=float, default=WATCHDOG_S,
                   help="seconds before a failure line is printed and the bench exits with "
                        "code 3 when no result came (a wedged card, a hung rank); 0 "
                        "disables; not armed for --train-bench")
    args = p.parse_args(argv)
    if args.batch < 1:
        p.error(f"--batch {args.batch}: must be >= 1")
    if args.train_bench:
        line = train_bench_line(args.steps or TRAIN_STEPS, device=args.device)
        if args.details:
            with open(args.details, "w") as f:
                json.dump(line, f, indent=2)
        print(json.dumps(line))
        return
    watchdog = None
    if args.watchdog > 0:
        watchdog = arm_watchdog(args.watchdog, watchdog_line(args.scaling))
    try:
        if args.scaling:
            result = scaling_line(args.device or "cuda", args.steps or 3)
        else:
            result, details = run(args)
            if args.details:
                with open(args.details, "w") as f:
                    json.dump(details, f, indent=2)
    finally:
        if watchdog is not None:
            watchdog.cancel()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
