"""The port's synthesis entry points on the CPU, at small widths:

* ``python -m gst_tacotron_tpu_torch.synthesize`` on a port trainer's
  workdir (one step of ``Trainer``): wavs and alignment PNGs from reference
  wavs, from token weights with ``--chunked-decoder``, with a ``--profile``
  trace, and through a WaveRNN restored from a ``VocoderTrainer`` workdir
  (``--vocoder wavernn --vocoder-workdir``); the JAX CLI's refusals (an override captured by
  ``--texts``, ``--token-weights`` with ``--reference-wavs``, a missing
  checkpoint directory);
* ``benchmark_synthesis``'s metric triple;
* ``mel_cepstral_distortion`` against the JAX package's (1e-9) and
  ``synthesis_metrics`` equal to it;
* the parity harness, as tests/test_parity_harness.py holds the JAX one:
  self-parity exact, a drifted fixture caught.
"""

import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from gst_tacotron_tpu.config import save_config
from gst_tacotron_tpu.metrics import mel_cepstral_distortion as jmcd
from gst_tacotron_tpu.metrics import synthesis_metrics as jsynthesis_metrics
from gst_tacotron_tpu_torch.config import apply_overrides, load_config
from gst_tacotron_tpu_torch.data import generate_patterns, synthetic_utterances
from gst_tacotron_tpu_torch.metrics import mel_cepstral_distortion, synthesis_metrics
from gst_tacotron_tpu_torch.parity import run_parity, save_fixture
from gst_tacotron_tpu_torch.synthesize import Synthesizer, benchmark_synthesis, main
from gst_tacotron_tpu_torch.train import Trainer
from gst_tacotron_tpu_torch.vocoder import load_wavernn_variables
from gst_tacotron_tpu_torch.vocoder_train import VocoderTrainer
from gst_tacotron_tpu_torch.weights import build_model

from tests.test_train_smoke import small_cfg

torch.set_num_threads(2)

SMALL = {"audio.hop_length": 256, "data.buckets": [[64, 320]], "data.val_fraction": 0.0,
         "model.decoder.max_decode_steps": 4, "audio.griffin_lim_iters": 2,
         "model.vocoder.wavernn_gru_dim": 16, "model.vocoder.wavernn_fc_dim": 16,
         "model.vocoder.wavernn_hop": 256}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A gst_lj port workdir after one train step, a vocoder workdir after
    one vocoder step, and a reference wav file."""
    root = tmp_path_factory.mktemp("cli")
    path = str(root / "config.json")
    save_config(small_cfg("gst_lj", **SMALL), path)
    cfg = load_config(path)
    patterns = str(root / "patterns")
    generate_patterns(synthetic_utterances(4), cfg.audio, patterns, store_wav=True)
    workdir = str(root / "work")
    Trainer(cfg, patterns, workdir, device="cpu").train(total_steps=1)
    vworkdir = str(root / "voc")
    vcfg = apply_overrides(cfg, {"model.vocoder.kind": "wavernn"})
    VocoderTrainer(vcfg, patterns, vworkdir, device="cpu", segment_frames=8,
                   batch_size=2).train(total_steps=1)
    wav = str(root / "ref.wav")
    t = np.arange(cfg.audio.sample_rate // 4) / cfg.audio.sample_rate
    wavfile.write(wav, cfg.audio.sample_rate,
                  (8000 * np.sin(2 * np.pi * 180 * t)).astype(np.int16))
    return {"cfg": cfg, "workdir": workdir, "vworkdir": vworkdir, "wav": wav}


def wavs_and_pngs(out_dir):
    names = sorted(os.listdir(out_dir))
    return ([n for n in names if n.endswith(".wav")],
            [n for n in names if n.endswith("_align.png")])


def test_cli_from_reference_wavs(work, tmp_path, capsys):
    out = str(tmp_path / "out")
    main(["--workdir", work["workdir"], "--out", out, "--device", "cpu",
          "--reference-wavs", work["wav"], work["wav"], "--texts", "first one.", "second."])
    wavs, pngs = wavs_and_pngs(out)
    assert wavs == ["synth_000.wav", "synth_001.wav"]
    assert len(pngs) == 2
    sr, data = wavfile.read(os.path.join(out, wavs[0]))
    assert sr == work["cfg"].audio.sample_rate and data.dtype == np.int16 and data.size > 0
    printed = capsys.readouterr().out
    assert "restored checkpoint at step 1" in printed and "diagonality" in printed


def test_cli_token_weights_chunked_decoder(work, tmp_path):
    out = str(tmp_path / "out")
    n = work["cfg"].model.gst.num_tokens
    weights = ",".join(["1"] + ["0"] * (n - 1))
    main(["--workdir", work["workdir"], "--out", out, "--device", "cpu", "--chunked-decoder",
          "--pallas-decoder", "--token-weights", weights, "--texts", "style check."])
    assert wavs_and_pngs(out)[0] == ["synth_000.wav"]


def test_cli_profile_writes_a_trace(work, tmp_path):
    """``--profile DIR``: the synthesis call traced by torch.profiler into
    DIR/trace.json."""
    import json

    main(["--workdir", work["workdir"], "--out", str(tmp_path / "out"), "--device", "cpu",
          "--profile", str(tmp_path / "prof"), "--texts", "traced."])
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_cli_wavernn_vocoder_from_its_workdir(work, tmp_path, capsys):
    out = str(tmp_path / "out")
    main(["--workdir", work["workdir"], "--out", out, "--device", "cpu", "--vocoder",
          "wavernn", "--vocoder-workdir", work["vworkdir"], "--texts", "neural vocoder."])
    assert wavs_and_pngs(out)[0] == ["synth_000.wav"]
    assert "restored wavernn vocoder" in capsys.readouterr().out
    flat = load_wavernn_variables(work["vworkdir"])
    assert all(k.startswith("params/") for k in flat) and "params/sample_embed/embedding" in flat


def test_cli_refuses_an_override_captured_by_texts(work, tmp_path, capsys):
    with pytest.raises(SystemExit):
        main(["--workdir", work["workdir"], "--out", str(tmp_path), "--device", "cpu",
              "--texts", "hello.", "model.decoder.max_decode_steps=3"])
    assert "put overrides BEFORE --texts" in capsys.readouterr().err


def test_cli_refuses_two_style_sources(work, tmp_path, capsys):
    with pytest.raises(SystemExit):
        main(["--workdir", work["workdir"], "--out", str(tmp_path), "--device", "cpu",
              "--token-weights", "1,0", "--reference-wavs", work["wav"], "--texts", "hi."])
    assert "mutually exclusive" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["--workdir", work["workdir"], "--out", str(tmp_path), "--device", "cpu",
              "--token-weights", "0.1,0.9", "--texts", "hi."])
    assert "model.gst.num_tokens" in capsys.readouterr().err


def test_cli_missing_workdir(tmp_path):
    with pytest.raises(FileNotFoundError, match="checkpoint directory"):
        main(["--workdir", str(tmp_path / "nope"), "--out", str(tmp_path), "--device", "cpu",
              "--texts", "hi."])


def test_benchmark_synthesis_triple(work):
    synth = Synthesizer(work["cfg"], build_model(work["cfg"], seed=0, device="cpu"),
                        device="cpu")
    m = benchmark_synthesis(synth, ["one.", "two two."], iterations=2)
    assert set(m) == {"audio_seconds_per_sec_per_chip", "decode_steps_per_sec",
                      "wall_seconds"}
    assert all(np.isfinite(v) and v > 0 for v in m.values())


def test_mcd_and_synthesis_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = rng.random((40, 80)).astype(np.float32)
    b = a + 0.02 * rng.standard_normal(a.shape).astype(np.float32)
    for x, y in ((a, b), (a, a), (a, b[:25]), (b, a + 0.05)):
        np.testing.assert_allclose(mel_cepstral_distortion(x, y), jmcd(x, y), rtol=0, atol=1e-9)
    assert mel_cepstral_distortion(a, a) == 0.0
    assert np.isnan(mel_cepstral_distortion(a[:0], b))
    assert synthesis_metrics(3.0, 0.5, 120, 1) == jsynthesis_metrics(3.0, 0.5, 120, 1)


@pytest.fixture(scope="module")
def synth(work):
    return Synthesizer(work["cfg"], build_model(work["cfg"], seed=1, device="cpu"),
                       device="cpu")


def test_self_parity_allclose(synth, tmp_path):
    fdir = str(tmp_path / "fixtures")
    os.makedirs(fdir)
    text = "the quick brown fox."
    out = synth([text], seed=0)
    frames = int(out["frame_lengths"][0])
    save_fixture(os.path.join(fdir, "fix0.npz"), text, out["mel"][0, :frames])
    report = str(tmp_path / "report.json")
    results = run_parity(synth, fdir, report_path=report)
    assert len(results) == 1
    assert results[0].mel_mae < 1e-5 and results[0].allclose_1e3
    assert os.path.exists(report)


def test_parity_detects_drift(synth, tmp_path):
    fdir = str(tmp_path / "fixtures2")
    os.makedirs(fdir)
    text = "a different sentence."
    out = synth([text], seed=0)
    frames = int(out["frame_lengths"][0])
    save_fixture(os.path.join(fdir, "fix1.npz"), text, out["mel"][0, :frames] + 0.05)
    np.savez(os.path.join(fdir, "params.npz"), w=np.zeros(3))      # not a fixture
    results = run_parity(synth, fdir)
    assert len(results) == 1
    assert results[0].mel_mae > 0.01 and not results[0].allclose_1e3
