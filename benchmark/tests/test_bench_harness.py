"""The synthesis driver end to end on the CPU at small widths (the program
on its plain paths, the reference beside it), with the timed path broken
underneath, and the harness's find-by-name machinery."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import small
from benchmark import common, run
from benchmark.drivers import synth

torch.set_num_threads(2)


@pytest.mark.parametrize("preset,cell", [("gst_lj", "gst_lj.synth"),
                                         ("gst_wavernn", "gst_wavernn.synth")])
def test_sound_run_is_correct(preset, cell):
    res = synth.run(small.context(cell, seconds=0.2), *small.config(preset))
    assert res.correct, res.checks
    assert res.attempted >= 1 and res.failed == 0
    assert set(res.checks) == set(common.read_json(
        common.HERE / "workloads" / f"{cell}.json")["limits"])
    assert res.metrics["audio_s_per_s"] > 0 and res.metrics["setup_s"] > 0


def _altered(monkeypatch, alter):
    """Break the timed path where the answer is produced: every result a
    call returns passes through ``alter``."""
    from gst_tacotron_tpu_torch.synthesize import Synthesizer

    real = Synthesizer.to_host

    def to_host(self, out, tok_len):
        result = real(self, out, tok_len)
        alter(result)
        return result

    monkeypatch.setattr(Synthesizer, "to_host", to_host)


def _bump(key, index, by):
    def alter(result):
        result[key] = result[key].copy()
        result[key][index] += by
    return alter


@pytest.mark.parametrize("key,index,by", [
    ("mel", (1, 3, 5), 0.01),            # one decoded frame's bin
    ("wav", (2, slice(1000, 3000)), 0.05),   # a click in one row's waveform
    ("linear", (0, 4, 30), 0.01),        # one post-net bin
    ("style_embedding", (3, 2), 0.01),   # one row's style
])
def test_altered_answer_is_not_correct(monkeypatch, key, index, by):
    _altered(monkeypatch, _bump(key, index, by))
    res = synth.run(small.context(seconds=0.1), *small.config())
    assert not res.correct


def test_altered_sampled_class_is_not_correct(monkeypatch):
    """A WaveRNN class changed where it is sampled (every row's, one
    sample) reads a wide score gap."""
    def alter(result):
        wav = result["wav"].copy()
        wav[:, 50] = np.where(wav[:, 50] > 0, -0.9, 0.9)
        result["wav"] = wav

    _altered(monkeypatch, alter)
    res = synth.run(small.context("gst_wavernn.synth", seconds=0.1),
                    *small.config("gst_wavernn"))
    assert res.checks["gap"]["value"] > res.checks["gap"]["limit"]
    assert not res.correct


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    """Rows past the first half zeroed out (the answer for half the batch
    left out)."""
    def alter(result):
        for k in ("mel", "linear", "wav"):
            result[k] = result[k].copy()
            result[k][result[k].shape[0] // 2:] = 0.0

    _altered(monkeypatch, alter)
    assert not synth.run(small.context(seconds=0.1), *small.config()).correct


@pytest.mark.parametrize("preset,name,value", [
    ("gst_lj", "decoder.cell.attention_rnn.bias", 0.0),            # K4's GRU
    ("gst_lj", "decoder.cell.frame_proj.bias", 0.0),               # K4's output
    ("gst_lj", "postnet.cbhg.bigru.bwd.recurrent_bias", 0.0),      # K1
    ("gst_lj", "gst.reference_encoder.bn_2.bias", 0.0),            # K2's BatchNorm shift
    ("gst_lj", "gst.reference_encoder.bn_4.var", 1.0),             # K2's BatchNorm variance
    ("gst_lj", "encoder.cbhg.highway_1.t.bias", 0.0),              # the encoder's highway
    ("gst_wavernn", "vocoder.fc1.bias", 0.0),                      # K5
])
def test_a_dropped_bias_is_not_correct(monkeypatch, preset, name, value):
    """A kernel that leaves out a bias or a BatchNorm term: the program's
    copy of one such leaf set to what dropping it means, the reference's
    untouched."""
    real = synth.build

    def build(cfg, seed, dev):
        s, w, vw = real(cfg, seed, dev)
        model = s.vocoder.model if name.startswith("vocoder.") else s.model
        with torch.no_grad():
            model.state_dict()[name.removeprefix("vocoder.")].fill_(value)
        return s, w, vw

    monkeypatch.setattr(synth, "build", build)
    cell = f"{preset}.synth"
    assert not synth.run(small.context(cell, seconds=0.1), *small.config(preset)).correct


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["gst_tacotron_tpu_torch.ops", "gst_tacotron_tpu_torch", "jaxtyping", "jaxlib.xla",
             "gst_tacotron_tpu.config", "flax", "numpy"]
    assert common.forbidden_modules(names) == ["flax", "gst_tacotron_tpu.config", "jaxlib.xla"]


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "gst_lj.synth", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


_FAKE = textwrap.dedent('''
    import sys, torch
    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: 4
    from benchmark import run
    sys.exit(run.main(sys.argv[1:]))
''')


def _copy(tmp_path, with_program: bool):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(common.ROOT / "BENCHMARK.json", root)
    shutil.copytree(common.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "_out", "__pycache__"))
    if with_program:
        shutil.copytree(common.ROOT / "gst_tacotron_tpu_torch", root / "gst_tacotron_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
    (root / "fake.py").write_text(_FAKE)
    return root


def _run(root, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "fake.py", *args], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)


_DRIVER = textwrap.dedent('''
    """A throwaway driver: a canned result."""
    import sys, types
    from benchmark import common

    def run(ctx):
        if ctx.workload.get("load_jax"):
            sys.modules["jax"] = types.ModuleType("jax")
        return common.Result(correct=True, attempted=3, failed=0,
                             metrics={"setup_s": 1.5, "audio_s_per_s": 2.5},
                             device={"platform": "gpu", "kind": "x", "count": 1,
                                     "memory_peak_bytes": 1, "busy_s": 1.0, "window_s": 2.0},
                             checks={"n": {"value": 0.0, "limit": 1.0}},
                             layer={"tiny": ctx.workload["traffic"]["tiny"]})
''')


def test_a_cell_metric_and_driver_are_taken_from_new_files(tmp_path):
    """A throwaway cell, traffic mix, driver and metric, added as files and
    named in BENCHMARK.json, run with no edit to any file that was there."""
    root = _copy(tmp_path, with_program=False)
    b = root / "benchmark"
    (b / "drivers" / "canned.py").write_text(_DRIVER)
    (b / "workloads" / "tiny.canned.json").write_text(json.dumps({"driver": "canned"}))
    (b / "traffic" / "tiny_mix.json").write_text(json.dumps({"tiny": 7}))
    (b / "metrics" / "tiny.layer.py").write_text(
        "def read(layer):\n    return layer['tiny'] * 2.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.canned", "config": "gst_lj", "traffic": "tiny_mix",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "tiny.layer", "unit": "x", "better": "lower",
                               "source": "program_counter", "layer": "test",
                               "moves": "audio_s_per_s", "workloads": ["tiny.canned"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _run(root, "--workload", "tiny.canned", "--seed", "5", "--seconds", "1",
               "--trace", "1")
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metrics"] == {"tiny.layer": {"value": 14.0, "unit": "x"}}
    assert list(line)[-1] == "checks"
    out = _run(root, "--workload", "tiny.canned", "--seed", "5", "--seconds", "1")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line["metrics"]) == {"setup_s"}      # the metrics not listed for it
    assert out.stderr.strip().splitlines()[-1] == "[check] correct True"


def test_loaded_jax_refuses_the_result(tmp_path):
    root = _copy(tmp_path, with_program=False)
    b = root / "benchmark"
    (b / "drivers" / "canned.py").write_text(_DRIVER)
    (b / "workloads" / "gst_lj.synth.json").write_text(
        json.dumps({"driver": "canned", "load_jax": True}))
    out = _run(root, "--workload", "gst_lj.synth", "--seed", "5", "--seconds", "1")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "jax" in out.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files (no
    program) exits non-zero and prints no result, even where a card is."""
    root = _copy(tmp_path, with_program=False)
    out = _run(root, "--workload", "gst_lj.synth", "--seed", "5", "--seconds", "1")
    assert out.returncode != 0 and out.stdout.strip() == ""
