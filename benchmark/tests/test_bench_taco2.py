"""The gst_taco2.synth cell on the CPU at small widths: Tacotron 2 with GST
(LSTM decoder, BiLSTM encoder, conv post-net, Griffin-Lim from the mel
basis's pseudo-inverse) through ``drivers/synth_taco2.py``, judged by
``reference/judge_taco2.py``; four planted faults, each not correct; the
frozen work counts against the program's kernel bench; the
``postnet_ms.synth`` reader."""

from __future__ import annotations

import pytest
import torch

import small
from benchmark import common, run, work_taco2
from benchmark.drivers import synth, synth_taco2

torch.set_num_threads(2)

CELL = "gst_taco2.synth"
TACO2 = {"model.postnet.conv_channels": 16}


def config():
    cfg, spec = small.config("gst_taco2")
    return small_taco2(cfg, spec)


def small_taco2(cfg, spec):
    from gst_tacotron_tpu_torch.config import apply_overrides, to_dict

    cfg = apply_overrides(cfg, TACO2)
    spec["config"] = to_dict(cfg)
    return cfg, spec


def test_sound_run_is_correct():
    cfg, spec = config()
    assert cfg.model.decoder.kind == "taco2" and cfg.model.postnet.kind == "conv"
    assert cfg.model.encoder.rnn == "lstm"
    res = synth_taco2.run(small.context(CELL, seconds=0.2), cfg, spec)
    assert res.correct, res.checks
    assert res.attempted >= 1 and res.failed == 0
    limits = common.read_json(common.HERE / "workloads" / f"{CELL}.json")["limits"]
    assert {k: c["limit"] for k, c in res.checks.items()} == limits
    assert res.metrics["audio_s_per_s"] > 0
    # the LSTM decoder's counts, not the GRU decoder's
    assert res.layer["untraced"]["flops"] > 0 and res.layer["bounds"]["decode_scan"] > 0
    assert synth.judge.__name__ == "benchmark.reference.judge"


def _fault(monkeypatch, edit):
    """A run whose program's model ``edit`` changed after its weights were
    loaded (the reference keeps the seed's)."""
    real = synth.build

    def build(cfg, seed, dev):
        s, w, vw = real(cfg, seed, dev)
        with torch.no_grad():
            edit(s)
        return s, w, vw

    monkeypatch.setattr(synth, "build", build)
    return synth_taco2.run(small.context(CELL, seconds=0.1), *config())


def test_forget_gate_bias_zeroed_is_not_correct(monkeypatch):
    def edit(s):
        cell = s.model.decoder.cell.decoder_rnn
        h = cell.features
        cell.bias[h: 2 * h] = 0.0
        cell.recurrent_bias[h: 2 * h] = 0.0

    res = _fault(monkeypatch, edit)
    assert not res.correct
    assert res.checks["mel"]["value"] > res.checks["mel"]["limit"]


def test_postnet_residual_dropped_is_not_correct(monkeypatch):
    def edit(s):
        post = s.model.postnet
        post.forward = lambda mel, lengths=None, **kw: torch.zeros_like(mel)

    res = _fault(monkeypatch, edit)
    assert not res.correct
    assert res.checks["post"]["value"] > res.checks["post"]["limit"]


def test_unclamped_pseudo_inverse_is_not_correct(monkeypatch):
    """Griffin-Lim from the pseudo-inverse's amplitudes left unclamped:
    negative amplitudes under the power give no waveform the judge can
    read as sound."""
    from gst_tacotron_tpu_torch.dsp import torch_dsp

    real = torch_dsp.TorchDSP.mel_to_linear

    def unclamped(self, mel):
        real(self, mel)
        cfg = self.cfg
        amp = torch_dsp.db_to_amp(torch_dsp.denormalize_db(mel, cfg) + cfg.ref_level_db)
        return amp @ self._mel_pinv

    monkeypatch.setattr(torch_dsp.TorchDSP, "mel_to_linear", unclamped)
    res = synth_taco2.run(small.context(CELL, seconds=0.1), *config())
    assert not res.correct


def test_cell_state_not_carried_is_not_correct(monkeypatch):
    """Each LSTM's c reset to zero every step (the program's plain route on
    the CPU)."""
    from gst_tacotron_tpu_torch.ops import decode as D

    real = D._lstm_step

    def forgetful(w, st, *a):
        return real(w, st._replace(c_attn=torch.zeros_like(st.c_attn),
                                   c_dec=torch.zeros_like(st.c_dec)), *a)

    monkeypatch.setattr(D, "_lstm_step", forgetful)
    res = synth_taco2.run(small.context(CELL, seconds=0.1), *config())
    assert not res.correct
    assert res.checks["mel"]["value"] > res.checks["mel"]["limit"]


def test_work_counts_equal_the_kernel_bench():
    from gst_tacotron_tpu_torch import kernel_bench as kb

    cfg, spec = common.load_config("gst_taco2")
    cd = spec["config"]
    b, t, steps = 32, 192, cfg.model.decoder.max_decode_steps
    assert work_taco2.decode_step_flops(cd, b, t) == kb.lstm_decode_step_flops(cfg, b, t)
    n = work_taco2.decode_weights(cd)
    assert work_taco2.decode_scan_work(cd, b, t, steps, n) == tuple(
        kb.lstm_decode_scan_work(cfg, b, t, steps, n))
    # a step: about 44 MFLOP a row; the packed weights about 81 MB
    assert work_taco2.decode_step_flops(cd, 1, t) == pytest.approx(44e6, rel=0.02)
    assert 4 * n == pytest.approx(82.6e6, rel=0.01)


def test_decode_weights_count_the_packed_operands():
    from gst_tacotron_tpu_torch.models.tacotron import GSTTacotron
    from gst_tacotron_tpu_torch.text import NUM_SYMBOLS

    cfg, spec = common.load_config("gst_taco2")
    with torch.device("meta"):
        model = GSTTacotron(cfg.model, NUM_SYMBOLS)
    packed = model.decoder.cell.pack(differentiable=True)
    assert work_taco2.decode_weights(spec["config"]) == sum(v.numel() for v in packed.values())


def test_synth_call_flops_by_stage():
    _, spec = common.load_config("gst_taco2")
    f = work_taco2.synth_call_flops(spec["config"], 32, 192, [300] * 32, 576)
    assert set(f) == {"reference_mels", "style", "encoder", "decode", "postnet", "vocoder"}
    assert f["decode"] == pytest.approx(1.41e12, rel=0.02)
    assert f["postnet"] == pytest.approx(2.8e11, rel=0.05)
    assert f["encoder"] == pytest.approx(6.8e10, rel=0.05)


def test_postnet_ms_reader():
    read = run.load_metric("postnet_ms.synth").read
    layer = {"spans": {"calls": 4, "spans": {"gst.model.postnet": {"device_s": 0.02}}}}
    assert read(layer) == pytest.approx(5.0)
    assert read({"spans": {"calls": 4, "spans": {}}}) is None
    assert read({}) is None
