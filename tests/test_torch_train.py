"""The port's trainers on the CPU: the contracts of tests/test_train_smoke.py
and tests/test_vocoder_train.py on ``gst_tacotron_tpu_torch.train`` and
``.vocoder_train``, at small widths (small_cfg's, with hop 256 and one
bucket of 320 frames to keep the CPU loops short), plus:

* with dropout on, 4 steps, save, restore and 4 more give the parameters of
  8 straight steps bit for bit (dropout is a function of seed and step, the
  loader stream resumes at the step);
* a wav-transport step's features are ``_materialize_features`` of its wire
  batch, and the device-corpus step, gathering the same rows on the device,
  gives the wav-transport step's losses bit for bit;
* a train step with every kernel entry point patched to raise still runs:
  the train path reaches no kernel;
* with no card, ``Trainer`` and ``VocoderTrainer`` without a device raise;
* the train CLI's multi-process flags parse, and a mesh that cannot hold
  the run is refused (tests/test_torch_parallel_*.py run the ranks).
"""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

from gst_tacotron_tpu.config import save_config
from gst_tacotron_tpu_torch.checkpoint import CheckpointManager
from gst_tacotron_tpu_torch.config import OptimizerConfig, apply_overrides, load_config
from gst_tacotron_tpu_torch.data import PatternDataset, generate_patterns, synthetic_utterances
from gst_tacotron_tpu_torch.synthesize import Synthesizer
from gst_tacotron_tpu_torch.parallel import make_mesh
from gst_tacotron_tpu_torch.train import (Trainer, _materialize_features, corpus_batch,
                                          main, make_schedule, parser, train_step)
from gst_tacotron_tpu_torch.vocoder_train import VocoderSegmentLoader, VocoderTrainer

from tests.test_train_smoke import small_cfg

torch.set_num_threads(2)

FAST = {"audio.hop_length": 256, "data.buckets": [[64, 320]], "data.val_fraction": 0.0}


def port_cfg(tmp_path_factory, preset="taco1_lj", **extra):
    """The port's copy of small_cfg(preset) with FAST and ``extra``."""
    path = str(tmp_path_factory.mktemp("cfg") / "config.json")
    save_config(small_cfg(preset, **{**FAST, **extra}), path)
    return load_config(path)


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    return port_cfg(tmp_path_factory)


@pytest.fixture(scope="module")
def pattern_dir(tmp_path_factory, cfg):
    out = str(tmp_path_factory.mktemp("patterns"))
    generate_patterns(synthetic_utterances(8), cfg.audio, out, store_wav=True)
    return out


def params_of(state):
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def assert_same_bits(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_schedule_shapes():
    sched = make_schedule(OptimizerConfig(learning_rate=1e-3, warmup_steps=100))
    early, peak, late = (float(sched(c)) for c in (10, 100, 10000))
    assert early < peak and late < peak


def test_train_loss_finite_and_resumes(cfg, pattern_dir, tmp_path):
    work = str(tmp_path / "work")
    trainer = Trainer(cfg, pattern_dir, work, device="cpu")
    metrics = trainer.step_batch(next(iter(trainer.loader.epoch(0))))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    state = trainer.train(total_steps=8)
    assert state.step == 8 and state.opt.count == 8
    logged = [json.loads(line) for line in open(os.path.join(work, "logs", "metrics.jsonl"))]
    assert [r["step"] for r in logged] == [2, 4, 6, 8]
    assert all(np.isfinite(r["train/loss"]) for r in logged)
    assert CheckpointManager(os.path.join(work, "checkpoints")).all_steps() == [4, 8]

    again = Trainer(cfg, pattern_dir, work, device="cpu")
    assert again.restore_if_available()
    assert again.state.step == 8 and again.state.opt.count == 8
    assert_same_bits(params_of(state), params_of(again.state))
    for name in ("mu", "nu"):
        assert_same_bits(getattr(state.opt, name), getattr(again.state.opt, name))


def test_dropout_resume_replays_straight_run(cfg, pattern_dir, tmp_path):
    straight = Trainer(cfg, pattern_dir, str(tmp_path / "a"), device="cpu")
    straight.train(total_steps=8)
    first = Trainer(cfg, pattern_dir, str(tmp_path / "b"), device="cpu")
    assert cfg.model.decoder.prenet_dropout > 0 and cfg.model.encoder.prenet_dropout > 0
    first.train(total_steps=4)
    resumed = Trainer(cfg, pattern_dir, str(tmp_path / "b"), device="cpu")
    assert resumed.restore_if_available() and resumed.state.step == 4
    resumed.train(total_steps=8)
    assert_same_bits(params_of(straight.state), params_of(resumed.state))


def test_synthesize_from_trained_state(cfg, pattern_dir, tmp_path):
    trainer = Trainer(cfg, pattern_dir, str(tmp_path / "work"), device="cpu")
    state = trainer.train(total_steps=2)
    synth = Synthesizer(cfg, state.model, device="cpu")
    out = synth(["hello world.", "a longer test sentence here."])
    assert out["wav"].shape[0] == 2 and np.all(np.isfinite(out["wav"]))
    assert out["mel"].shape[-1] == cfg.model.num_mels
    assert out["alignments"].shape[0] == 2
    assert np.all(out["frame_lengths"] >= 1)
    assert out["diagonality"].shape == (2,)
    paths = synth.save_outputs(out, str(tmp_path / "artifacts"))
    wavs = [p for p in paths if p.endswith(".wav")]
    assert len(wavs) == 2 and all(os.path.getsize(p) > 100 for p in wavs)


def test_train_gst_smoke(tmp_path_factory, pattern_dir, tmp_path):
    gst = port_cfg(tmp_path_factory, "gst_lj")
    state = Trainer(gst, pattern_dir, str(tmp_path / "gst"), device="cpu").train(total_steps=2)
    assert state.step == 2


def test_heldout_eval_runs(tmp_path_factory, pattern_dir, tmp_path):
    ev = port_cfg(tmp_path_factory, **{"data.val_fraction": 0.3, "loss.stop_masked": True})
    trainer = Trainer(ev, pattern_dir, str(tmp_path / "eval"), device="cpu")
    assert trainer.val_loader is not None
    train_ids = {i for m in trainer.loader.bucket_members for i in m}
    val_ids = {i for m in trainer.val_loader.bucket_members for i in m}
    assert val_ids and train_ids.isdisjoint(val_ids)
    metrics = trainer.run_eval(step=0, max_batches=2)
    assert metrics and all(np.isfinite(v) for v in metrics.values())
    assert "eval_loss" in metrics


def test_wav_transport_and_device_corpus_steps(tmp_path_factory, pattern_dir, tmp_path):
    wire = port_cfg(tmp_path_factory, "gst_lj", **{"data.wav_transport": True,
                                                   "data.device_corpus": True})
    trainer = Trainer(wire, pattern_dir, str(tmp_path / "w"), device="cpu")
    bucket, rows, spec = next(trainer.loader.stream_indices(0))
    wire_batch = trainer._device_batch(next(iter(trainer.loader.epoch(0))))
    c_wav, c_ints = trainer.corpus[bucket]
    sig_len = (spec.max_frames - 1) * wire.audio.hop_length + wire.audio.n_fft
    gathered = corpus_batch(c_wav, c_ints, torch.from_numpy(rows).long(), spec.max_text,
                            sig_len, spec.max_text)
    assert_same_bits(wire_batch, gathered)
    start = copy.deepcopy(trainer.state)
    by_wire = train_step(trainer.tx, wire, copy.deepcopy(start), wire_batch)
    by_features = train_step(trainer.tx, wire, copy.deepcopy(start),
                             _materialize_features(wire, wire_batch))
    by_rows = trainer.step_rows(bucket, rows, spec)
    assert_same_bits(by_wire, by_features)
    assert_same_bits(by_wire, by_rows)


ENTRY_POINTS = ("gru_scan", "bigru_scan", "refenc_stack", "decode_scan", "wavernn_sample",
                "stft_features", "stft_features_fused", "stft_features_frames")


def test_train_path_reaches_no_kernel(tmp_path_factory, pattern_dir, tmp_path, monkeypatch):
    """Every binding of every kernel entry point raises; a wav-transport GST
    train step still runs."""
    from gst_tacotron_tpu_torch.ops import decode, gru, refenc, stft, wavernn

    originals = {getattr(m, n) for m in (decode, gru, refenc, stft, wavernn)
                 for n in ENTRY_POINTS if hasattr(m, n)}
    assert len(originals) == len(ENTRY_POINTS)

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel entry point was called in the train step")

    patched = 0
    for name, mod in list(sys.modules.items()):
        if name.startswith("gst_tacotron_tpu_torch") and mod is not None:
            for attr in ENTRY_POINTS:
                if getattr(mod, attr, None) in originals:
                    monkeypatch.setattr(mod, attr, refuse)
                    patched += 1
    assert patched >= len(ENTRY_POINTS)
    wire = port_cfg(tmp_path_factory, "gst_lj", **{"data.wav_transport": True})
    trainer = Trainer(wire, pattern_dir, str(tmp_path / "w"), device="cpu")
    metrics = trainer.step_batch(next(iter(trainer.loader.epoch(0))))
    assert np.isfinite(float(metrics["loss"]))
    with pytest.raises(AssertionError, match="kernel entry point"):
        Synthesizer(wire, trainer.state.model, device="cpu")(["synthesis does reach one."])


def test_trainers_without_a_device_raise(cfg, pattern_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, pattern_dir, str(tmp_path / "t"))
    voc = apply_overrides(cfg, {"model.vocoder.kind": "wavernn",
                                "model.vocoder.wavernn_hop": cfg.audio.hop_length})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VocoderTrainer(voc, pattern_dir, str(tmp_path / "v"), segment_frames=8, batch_size=2)


def test_cli_refuses_parallel_flags(cfg, pattern_dir, tmp_path):
    """The multi-process flags parse; what the mesh cannot hold is refused:
    a model axis that does not divide the ranks, and a batch that does not
    divide the data axis (the JAX CLI drops the mesh there instead)."""
    args = parser().parse_args(["--patterns", "p", "--workdir", "w", "--coordinator",
                                "localhost:1234", "--num-processes", "2", "--process-id",
                                "1", "--model-parallelism", "2"])
    assert (args.coordinator, args.num_processes, args.process_id,
            args.model_parallelism) == ("localhost:1234", 2, 1, 2)
    with pytest.raises(ValueError, match="model_parallelism=2 does not divide 1 ranks"):
        main(["--patterns", pattern_dir, "--workdir", str(tmp_path), "--device", "cpu",
              "--model-parallelism", "2"])
    odd = apply_overrides(cfg, {"data.batch_size": 3})
    with pytest.raises(ValueError, match="does not divide over the mesh's data axis"):
        Trainer(odd, pattern_dir, str(tmp_path / "w"), device="cpu",
                mesh=make_mesh(1, ranks=[0, 1]))


def test_profile_window_writes_a_trace(cfg, pattern_dir, tmp_path):
    """``train --profile``: after 2 warm-up steps the window traces the
    third, and the trace is written when the loop ends."""
    trainer = Trainer(cfg, pattern_dir, str(tmp_path / "w"), device="cpu")
    trainer.train(total_steps=3, profile_dir=str(tmp_path / "prof"))
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "c"), keep=2)
    for step in (1, 2, 3):
        ckpt.save(step, {"step": step, "x": torch.full((2,), float(step))})
    assert ckpt.all_steps() == [2, 3] and ckpt.latest_step() == 3
    assert torch.equal(ckpt.restore()["x"], torch.full((2,), 3.0))
    assert ckpt.restore(2)["step"] == 2


# -- the vocoder trainer ------------------------------------------------------


@pytest.fixture(scope="module")
def voc_cfg(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("voc_cfg") / "config.json")
    from gst_tacotron_tpu.config import apply_overrides as japply
    from gst_tacotron_tpu.config import get_preset

    save_config(japply(get_preset("gst_wavernn"), {
        "audio.n_fft": 512, "audio.hop_length": 128, "audio.win_length": 512,
        "model.num_freq": 257, "model.vocoder.wavernn_gru_dim": 16,
        "model.vocoder.wavernn_fc_dim": 16, "model.vocoder.wavernn_hop": 128,
        "train.log_every": 2, "train.checkpoint_every": 2}), path)
    return load_config(path)


@pytest.fixture(scope="module")
def voc_patterns(tmp_path_factory, voc_cfg):
    out = str(tmp_path_factory.mktemp("voc_patterns"))
    generate_patterns(synthetic_utterances(4), voc_cfg.audio, out, store_wav=True)
    return out


def test_segment_loader_shapes(voc_patterns, voc_cfg):
    loader = VocoderSegmentLoader(PatternDataset(voc_patterns), hop=128, segment_frames=8,
                                  batch_size=3)
    batch = next(iter(loader))
    assert batch["mel"].shape == (3, 8, voc_cfg.audio.num_mels)
    assert batch["wav"].shape == (3, 8 * 128)
    assert np.all(np.abs(batch["wav"]) <= 1.0)


def test_segment_loader_requires_wav(tmp_path, voc_cfg):
    out = str(tmp_path / "nowav")
    generate_patterns(synthetic_utterances(2), voc_cfg.audio, out, store_wav=False)
    with pytest.raises(ValueError, match="store-wav"):
        VocoderSegmentLoader(PatternDataset(out), hop=128, segment_frames=8, batch_size=2)


def test_vocoder_trainer_steps_and_resume(voc_patterns, voc_cfg, tmp_path):
    work = str(tmp_path / "w")
    t1 = VocoderTrainer(voc_cfg, voc_patterns, work, device="cpu", segment_frames=8,
                        batch_size=2)
    state = t1.train(total_steps=2)
    assert state.step == 2
    logged = [json.loads(line) for line in
              open(os.path.join(work, "vocoder_logs", "metrics.jsonl"))]
    assert logged[-1]["step"] == 2 and np.isfinite(logged[-1]["vocoder/loss"])
    t2 = VocoderTrainer(voc_cfg, voc_patterns, work, device="cpu", segment_frames=8,
                        batch_size=2)
    assert t2.restore_if_available() and t2.state.step == 2
    assert_same_bits(params_of(state), params_of(t2.state))
    assert t2.train(total_steps=4).step == 4
