"""The port's synthesis and feature paths end to end on the card, each at the
smallest size that shows what it holds:

* every kernel builds and loads, and ``nvidia-smi`` reads the card;
* ``Synthesizer`` on gst_lj, its Taco2 encoder, gst_r1_location and
  gst_wavernn (B=32 texts of 64 tokens with 32 reference wavs of 128
  frames, stop threshold 1.0, decode cut short): the launch counts of each
  kernel and of K2's and K3's bf16 branches, the outputs' shapes and
  ranges, and the kernel path within 2e-3 of the plain path's mel (the
  WaveRNN's samples held teacher-forced on the plain path's mel);
  Griffin-Lim under both settings of ``audio.griffin_lim_bf16``; the Taco2
  encoder's one K1 launch;
* ``model.compute_dtype="bfloat16"``: the float32 path's launches, finite,
  apart from float32 within the JAX contract;
* the training-corpus path at gst_lj's audio: patterns with device
  features, every extractor route and ``KernelDSP`` against the host numpy
  oracle with their launch counts, and the bucketed loader's two
  transports, the wire batch's features held against its own host oracle;
* tests/fixtures/jax_export (a JAX workdir exported into the port) served
  by the synthesize CLI, against the stored JAX mel, and resumed for a step.

Needs an NVIDIA GPU and nvcc; skipped without a card. Imports no JAX, so
it runs on the GPU machine with ``--noconftest`` (tests/test_torch_cuda.py
gives the card command).
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

# by its own name, from tests/ on the path: where JAX is absent, an
# installed package may own the name ``tests``
from test_torch_cuda import dev  # noqa: F401 (the card fixture)

pytestmark = pytest.mark.cuda

B = 32
TEXT_TOKENS = 64
REF_SAMPLES = 32512     # 1 + 32512 // 256 = 128 mel frames
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def inputs(seed, sr, b=B):
    """``b`` texts of 63 letters and spaces (64 tokens with the end mark)
    and ``b`` reference wavs of 128 frames: four harmonics of a random f0
    under a slow swell, with a little noise."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    texts = []
    for _ in range(b):
        chars = rng.choice(letters, TEXT_TOKENS - 1)
        chars[rng.choice(np.arange(2, TEXT_TOKENS - 3, 4), 8, replace=False)] = " "
        texts.append("".join(chars))
    t = np.arange(REF_SAMPLES) / sr
    wavs = []
    for _ in range(b):
        f0 = rng.uniform(90, 250)
        wav = sum(0.5 ** k * np.sin(2 * np.pi * (k + 1) * f0 * t + rng.uniform(0, 6.3))
                  for k in range(4))
        wav = wav * (0.3 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.5, 3) * t))
        wavs.append((wav + rng.normal(0, 0.01, REF_SAMPLES)).astype(np.float32))
    return texts, wavs


def launched():
    """The launch counters that moved since the last reset."""
    from gst_tacotron_tpu_torch import ops

    torch.cuda.synchronize()
    return {k: n for k, n in ops.launch_counts().items() if n}


def test_every_kernel_builds_and_the_card_is_read(dev):
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.kernel_bench import card_line

    assert all(k.library_path().exists() for k in ops.all_kernels())
    name, limit = card_line().split(",")
    assert name.strip() and limit.strip()


# K1 three times (the encoder's and the post-net's BiGRUs, the reference
# GRU), K2 once and K3 once for each 8 of the 32 reference wavs, both in
# their bf16 branches on the card, and K4 once
GST_LAUNCHES = {"gru_scan": 3, "refenc_stack": 1, "refenc_stack:bf16": 1, "stft_features": 4,
                "stft_features:bf16": 4, "decode_scan": 1}
# Griffin-Lim's kernel: one launcher call an iteration, 30 in the presets
GL_LAUNCHES = {"griffin_lim": 30}
# (preset, overrides, decode steps, launches beside GST_LAUNCHES)
PATHS = {"gst_lj": ("gst_lj", {}, 32, GL_LAUNCHES),
         "gst_lj_taco2": ("gst_lj", {"model.encoder.kind": "taco2"}, 32, GL_LAUNCHES),
         "gst_r1_location": ("gst_r1_location", {}, 64,
                             {"decode_scan:location_sensitive": 1, **GL_LAUNCHES}),
         "gst_wavernn": ("gst_wavernn", {}, 16, {"wavernn_sample": 1})}


@pytest.mark.parametrize("name", sorted(PATHS))
def test_synthesis_path_on_the_card(dev, name):
    """One batch through ``Synthesizer``: its launch counts; finite outputs
    of the expected shapes, the wav within [-1, 1], every step decoded, the
    alignments distributions; with the prenets deterministic, the mel within
    2e-3 of the plain path's and (WaveRNN) every sampled class within 1e-3
    of its step's best on the plain path's mel; Griffin-Lim under both
    ``audio.griffin_lim_bf16`` settings finite and apart; the Taco2
    encoder alone one K1 launch, within 1e-4 of its plain scans."""
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import apply_overrides, get_preset
    from gst_tacotron_tpu_torch.dsp.mulaw import mulaw_encode
    from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP
    from gst_tacotron_tpu_torch.ops.wavernn import score_gaps
    from gst_tacotron_tpu_torch.synthesize import VOCODER_SEED_OFFSET, Synthesizer
    from gst_tacotron_tpu_torch.text import batch_text_to_ids
    from gst_tacotron_tpu_torch.vocoder import WaveRNNVocoder
    from gst_tacotron_tpu_torch.weights import build_model, build_wavernn

    preset, overrides, steps, extra = PATHS[name]
    cfg = apply_overrides(get_preset(preset), {**overrides, "model.decoder.stop_threshold": 1.0,
                                               "model.decoder.max_decode_steps": steps})
    model = build_model(cfg, seed=0, device=dev)
    vocoder = None
    if cfg.model.vocoder.kind == "wavernn":
        vocoder = WaveRNNVocoder(cfg, build_wavernn(cfg, seed=1, device=dev), device=dev)
    texts, wavs = inputs(steps, cfg.audio.sample_rate)
    ops.reset_launch_counts()
    out = Synthesizer(cfg, model, device=dev, vocoder=vocoder)(texts, reference_wavs=wavs)
    assert launched() == {**GST_LAUNCHES, **extra}

    r, hop = cfg.model.decoder.reduction_factor, cfg.audio.hop_length
    n = steps * r
    shapes = {"mel": (B, n, cfg.model.num_mels), "linear": (B, n, cfg.model.num_freq),
              "alignments": (B, steps, TEXT_TOKENS),
              "wav": (B, n * hop if vocoder else hop * (n - 1)),
              "style_embedding": (B, cfg.model.gst.style_dim)}
    for key, shape in shapes.items():
        assert out[key].shape == shape, key
        assert np.all(np.isfinite(out[key])), key
    assert np.abs(out["wav"]).max() <= 1.0
    assert np.all(out["frame_lengths"] == n) and np.all(out["wav_lengths"] == n * hop)
    np.testing.assert_allclose(out["alignments"].sum(-1), 1.0, atol=1e-4)

    det, plain = (Synthesizer(cfg, model, device=dev, deterministic_prenet=True, plain=p,
                              vocoder=vocoder)(texts, reference_wavs=wavs) for p in (False, True))
    assert float(np.abs(det["mel"] - plain["mel"]).max()) <= 2e-3
    if vocoder:
        with torch.no_grad():
            mel = torch.from_numpy(plain["mel"]).to(dev)
            classes = mulaw_encode(torch.from_numpy(det["wav"]).to(dev),
                                   cfg.model.vocoder.wavernn_bits)
            gaps = score_gaps(vocoder.model.pack(), vocoder.model.cond_frames(mel), classes,
                              hop=hop, seed=VOCODER_SEED_OFFSET)
        assert float(gaps.max()) <= 1e-3
    else:
        linear = torch.from_numpy(out["linear"]).to(dev)
        gl = [TorchDSP(dataclasses.replace(cfg.audio, griffin_lim_bf16=flag), dev)
              .inv_linear_spectrogram(linear) for flag in (True, False)]
        assert all(bool(torch.isfinite(w).all()) for w in gl)
        assert not torch.equal(gl[0], gl[1])
    if cfg.model.encoder.kind == "taco2":
        ids, lens = batch_text_to_ids(texts)
        tok = torch.from_numpy(ids.astype(np.int64)).to(dev)
        tok_len = torch.from_numpy(lens.astype(np.int64)).to(dev)
        with torch.no_grad():
            ops.reset_launch_counts()
            enc = model.encoder(tok, tok_len)
            assert launched() == {"gru_scan": 1}
            plain_enc = model.encoder(tok, tok_len, plain=True)
        torch.testing.assert_close(enc, plain_enc, atol=1e-4, rtol=0)


def test_bf16_compute_synthesis_on_the_card(dev):
    """gst_lj at ``model.compute_dtype="bfloat16"``, prenets deterministic:
    the float32 path's launches, finite outputs, the mel apart from float32
    with a mean |d| under the JAX contract's 0.05."""
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import apply_overrides, get_preset
    from gst_tacotron_tpu_torch.synthesize import Synthesizer
    from gst_tacotron_tpu_torch.weights import build_model

    cfg = apply_overrides(get_preset("gst_lj"), {"model.decoder.stop_threshold": 1.0,
                                                 "model.decoder.max_decode_steps": 32})
    texts, wavs = inputs(16, cfg.audio.sample_rate)
    outs, counts = {}, {}
    for dtype in ("float32", "bfloat16"):
        c = apply_overrides(cfg, {"model.compute_dtype": dtype})
        synth = Synthesizer(c, build_model(c, seed=0, device=dev), device=dev,
                            deterministic_prenet=True)
        ops.reset_launch_counts()
        outs[dtype] = synth(texts, reference_wavs=wavs)
        counts[dtype] = launched()
    assert counts["bfloat16"] == counts["float32"] == {**GST_LAUNCHES, **GL_LAUNCHES}
    assert all(np.all(np.isfinite(outs["bfloat16"][k])) for k in ("mel", "linear", "wav"))
    assert 0.0 < float(np.abs(outs["bfloat16"]["mel"] - outs["float32"]["mel"]).mean()) < 0.05


CORPUS_UTTERANCES = 36
CORPUS_BATCH = 4


def wire_oracle(row, a, frames):
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


def max_err(results, refs):
    """Largest |difference| over every utterance's (mel, linear)."""
    return max(float(np.abs(r[i] - f[i]).max()) for r, f in zip(results, refs) for i in (0, 1))


def test_corpus_routes_against_the_host_oracle(dev, tmp_path):
    """At gst_lj's audio, a varied synthetic corpus: patterns with device
    features (K3 float32, launched at least once a planned call); each
    extractor route launching its own kernel once a device batch, within
    5e-4 (normalized dB) of the host float64 oracle, and the resident route
    in its bf16 mode (the card's default) within 5e-3 of its plain version
    and 0.05 of the oracle on loud mel bins; ``KernelDSP`` one K3″ launch a
    wav, within 5e-3 of the oracle. Then the bucketed loader, every bucket
    filling a batch: the prefetching stream's first batch is the epoch's,
    the two transports' epochs are as long, and each wire batch's features
    on the card keep the feature batch's integers, lie within 5e-4 of the
    wire rows' own host oracle and within the JAX test's budgets of the
    feature batch (MAE 1e-3, mel max 2e-2), zero past each true length."""
    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.config import apply_overrides, get_preset
    from gst_tacotron_tpu_torch.data import (BucketedLoader, PatternDataset, generate_patterns,
                                             synthetic_utterances)
    from gst_tacotron_tpu_torch.dsp import ref as dsp_ref
    from gst_tacotron_tpu_torch.dsp.device_features import DeviceFeatureExtractor
    from gst_tacotron_tpu_torch.ops.stft import KernelDSP
    from gst_tacotron_tpu_torch.train import _materialize_features

    cfg = apply_overrides(get_preset("gst_lj"), {"data.batch_size": CORPUS_BATCH})
    a = cfg.audio
    out = str(tmp_path / "patterns")
    ops.reset_launch_counts()
    # float32 by name: the patterns are held against the float64 oracle
    generate_patterns(synthetic_utterances(CORPUS_UTTERANCES, variable=True), a, out,
                      store_wav=True, device_features=True, device=dev, bf16=False)
    patterns = launched()
    ds = PatternDataset(out)
    items = [ds.load(i) for i in range(len(ds))]
    wavs = [it["wav"] for it in items]
    frames = [1 + len(w) // a.hop_length for w in wavs]
    oracle = [(dsp_ref.melspectrogram(w, a), dsp_ref.spectrogram(w, a)) for w in wavs]
    assert patterns.keys() == {"stft_features"}
    assert patterns["stft_features"] >= len(DeviceFeatureExtractor(a, dev).plan(frames))
    assert max_err([(it["mel"], it["linear"]) for it in items], oracle) <= 5e-4

    for route, kernel in (("resident", "stft_features"), ("fused", "stft_fused"),
                          ("frames", "stft_frames"), (None, None)):
        ex = DeviceFeatureExtractor(a, dev, stft_kernel=route, bf16=False)
        ops.reset_launch_counts()
        res = ex.extract(wavs)
        assert launched() == ({kernel: len(ex.plan(frames))} if kernel else {}), route
        assert max_err(res, oracle) <= 5e-4, route
    ex = DeviceFeatureExtractor(a, dev)
    ops.reset_launch_counts()
    res = ex.extract(wavs)
    calls = len(ex.plan(frames))
    assert launched() == {"stft_features": calls, "stft_features:bf16": calls}
    assert max_err(res, DeviceFeatureExtractor(a, dev, plain=True).extract(wavs)) <= 5e-3
    assert max(float(np.abs(r[0] - o[0])[o[0] > 0.5].max(initial=0.0))
               for r, o in zip(res, oracle)) <= 0.05
    kd = KernelDSP(a, dev)
    ops.reset_launch_counts()
    res = []
    for w in wavs:
        mel, lin = kd.features(torch.from_numpy(w)[None].to(dev))
        res.append((mel[0].cpu().numpy(), lin[0].cpu().numpy()))
    assert launched() == {"stft_frames": len(wavs)}
    assert max_err(res, oracle) <= 5e-3

    r = cfg.model.decoder.reduction_factor
    wire_cfg = apply_overrides(cfg, {"data.wav_transport": True})
    feat = BucketedLoader(ds, cfg.data, r, seed=0)
    wire = BucketedLoader(ds, wire_cfg.data, r, seed=0, audio_cfg=a)
    sizes = [len(m) for m in feat.bucket_members]
    assert min(sizes) >= CORPUS_BATCH, sizes
    stream = feat.stream()
    first = next(stream)
    stream.close()
    feature_batches, wire_batches = list(feat.epoch(0)), list(wire.epoch(0))
    assert len(feature_batches) == len(wire_batches) >= len(sizes)
    assert all(np.array_equal(first[k], feature_batches[0][k]) for k in first)
    for fb, wb in zip(feature_batches, wire_batches):
        mat = _materialize_features(wire_cfg, {k: torch.from_numpy(v).to(dev)
                                               for k, v in wb.items()})
        for k in ("tokens", "token_lengths", "mel_lengths", "speaker_ids"):
            assert np.array_equal(mat[k].cpu().numpy(), fb[k]), k
        t = fb["mel"].shape[1]
        true_frames = wb["ints"][:, -2]
        got = {k: mat[k].cpu().numpy() for k in ("mel", "linear")}
        for k, most in (("mel", 2e-2), ("linear", None)):
            d = np.abs(got[k][:, :t] - fb[k])
            assert d.mean() < 1e-3 and (most is None or d.max() < most), k
            for j, tf in enumerate(true_frames):
                assert np.all(got[k][j, tf:] == 0.0), k
        for j, (row, tf) in enumerate(zip(wb["wav"], true_frames)):
            for i, ref in enumerate(wire_oracle(row, a, tf)):
                assert float(np.abs(got[("mel", "linear")[i]][j, :tf] - ref).max()) <= 5e-4


def test_jax_export_fixture_on_the_card(dev, tmp_path):
    """tests/fixtures/jax_export (a tiny gst_lj state trained 2 steps by the
    JAX package, exported by tools/export_jax_workdir.py, with the JAX CPU
    outputs beside it): the synthesize CLI serves it, launching K1-K4 and
    writing a wav a text; the restored model's mel (float32 by name,
    prenets deterministic) within 2e-3 of the stored JAX mel with its frame
    lengths; ``Trainer`` resumes it at step 2 and takes step 3 within 1e-4
    (relative) of the JAX trainer's stored losses."""
    from scipy.io import wavfile

    from gst_tacotron_tpu_torch import ops
    from gst_tacotron_tpu_torch.checkpoint import CheckpointManager
    from gst_tacotron_tpu_torch.config import load_config
    from gst_tacotron_tpu_torch.data import generate_patterns, synthetic_utterances
    from gst_tacotron_tpu_torch.synthesize import Synthesizer
    from gst_tacotron_tpu_torch.synthesize import main as synthesize_main
    from gst_tacotron_tpu_torch.train import Trainer
    from gst_tacotron_tpu_torch.weights import build_model

    src = os.path.join(FIXTURES, "jax_export")
    exp = dict(np.load(os.path.join(src, "expected.npz")))
    wd = str(tmp_path / "jax_export")
    shutil.copytree(src, wd)
    cfg = load_config(os.path.join(wd, "config.json"))
    texts = [str(t) for t in exp["texts"]]
    ref = str(tmp_path / "ref.wav")
    wavfile.write(ref, cfg.audio.sample_rate, exp["ref_wav"])
    ops.reset_launch_counts()
    paths = synthesize_main(["--workdir", wd, "--out", str(tmp_path / "out"),
                             "--reference-wavs", ref, ref, "--texts", *texts])
    counts = launched()
    assert sum(p.endswith(".wav") for p in paths) == len(texts) == 2
    assert all(counts.get(k) for k in ("gru_scan", "refenc_stack", "stft_features",
                                       "decode_scan")), counts

    saved = CheckpointManager(os.path.join(wd, cfg.train.checkpoint_dir)).restore(
        map_location=dev)
    model = build_model(cfg, seed=0, device=dev)
    model.load_state_dict(saved["model"])
    out = Synthesizer(cfg, model, device=dev, deterministic_prenet=True, bf16=False)(
        texts, reference_wavs=[exp["ref_wav"]] * 2)
    assert float(np.abs(out["mel"] - exp["mel"]).max()) <= 2e-3
    assert out["frame_lengths"].tolist() == exp["frame_lengths"].tolist()

    patterns = str(tmp_path / "patterns")
    generate_patterns(synthetic_utterances(8, num_speakers=1), cfg.audio, patterns)
    trainer = Trainer(cfg, patterns, wd, device=dev)
    assert trainer.restore_if_available() and trainer.state.step == 2
    assert trainer.train(3).step == 3
    with open(os.path.join(wd, "logs", "metrics.jsonl")) as f:
        last = [json.loads(line) for line in f][-1]
    for name, value in zip(exp["next_loss_names"], exp["next_losses"]):
        assert abs(last[f"train/{name}"] - float(value)) <= 1e-4 * abs(float(value)), name
