"""The port's style-contrast report (``gst_tacotron_tpu_torch/style_contrast.py``)
against the unchanged JAX tool (``tools/style_contrast.py``) on the same
weights, on the CPU.

A tiny gst_lj orbax workdir (tests/test_train_smoke.py's small widths, the
port's seeded init saved by the JAX ``CheckpointManager`` at step 0, as
tests/test_torch_jax_export.py builds its state without flax's init) is
exported by ``tools/export_jax_workdir.py``; the JAX tool runs on the orbax
workdir (its template init swapped for the same seeded one), the port's
module on the export with ``--device cpu``. Held:

* deterministic pass: the same conditions, frame lengths and
  ``frame_delta``s, every pairwise mel L1 within 1e-4 absolute (the golden
  gate's mel MAE budget, tests/test_golden_fixtures.py), the seed floor
  bit-identical on both sides;
* ``acoustic_stats``: the port's copy on JAX's wav arrays gives JAX's
  function's values exactly (also on the arrays scaled to a 0.5 peak, where
  the RMS does not round to 0); on each side's own wavs, the unrounded RMS
  and centroid agree within 1e-3 relative;
* stochastic pass: its dropout streams are not jax.random's, so only its
  keys, the number of floor values and a floor > 0.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from gst_tacotron_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from gst_tacotron_tpu.config import save_config
from gst_tacotron_tpu_torch import style_contrast as port_tool

from tests.test_torch_jax_export import port_seeded_init_state
from tests.test_train_smoke import small_cfg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "tools"))
import style_contrast as jax_tool  # noqa: E402
from export_jax_workdir import export  # noqa: E402

torch.set_num_threads(2)

FLOOR_SEEDS = 2
MEL_L1_TOL = 1e-4      # tests/test_golden_fixtures.py's mel MAE budget
STATS_RTOL = 1e-3


def recorder(fn, calls):
    """``fn`` that also records (wav, sr, result) of each call."""
    def wrapped(wav, sr):
        out = fn(wav, sr)
        calls.append((np.array(wav), sr, out))
        return out
    return wrapped


def raw_rms_centroid(wav, sr):
    """The unrounded RMS and centroid of ``acoustic_stats``' segment."""
    wav = np.asarray(wav, np.float64)
    win = min(len(wav), sr // 2)
    s0 = int(np.argmax(np.convolve(wav ** 2, np.ones(win), "valid")))
    seg = wav[s0: s0 + win]
    sp = np.abs(np.fft.rfft(seg))
    freqs = np.fft.rfftfreq(len(seg), 1.0 / sr)
    return np.sqrt(np.mean(seg ** 2)), (sp * freqs).sum() / max(sp.sum(), 1e-9)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    import gst_tacotron_tpu.train as jtrain

    tmp = tmp_path_factory.mktemp("style")
    work, port_work = str(tmp / "jax"), str(tmp / "port")
    cfg = small_cfg("gst_lj")
    os.makedirs(work)
    save_config(cfg, os.path.join(work, "config.json"))
    _, state = port_seeded_init_state(cfg, jax.random.PRNGKey(0), None)
    ckpt = JaxCheckpointManager(os.path.join(work, "checkpoints"))
    ckpt.save(0, state)
    ckpt.close()
    export(work, port_work)

    jax_calls, port_calls = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GST_TACOTRON_JAX_CACHE", "")        # no persistent cache outside tmp
        mp.setattr(jtrain, "init_state", port_seeded_init_state)
        mp.setattr(jax_tool, "acoustic_stats", recorder(jax_tool.acoustic_stats, jax_calls))
        mp.setattr(port_tool, "acoustic_stats", recorder(port_tool.acoustic_stats, port_calls))
        mp.setattr(sys, "argv", ["style_contrast.py", "--workdir", work, "--out",
                                 str(tmp / "jax.json"), "--floor-seeds", str(FLOOR_SEEDS)])
        jax_tool.main()
        port = port_tool.main(["--workdir", port_work, "--out", str(tmp / "port.json"),
                               "--floor-seeds", str(FLOOR_SEEDS), "--device", "cpu"])
    with open(tmp / "jax.json") as f:
        ref = json.load(f)
    with open(tmp / "port.json") as f:
        assert json.load(f) == json.loads(json.dumps(port))
    return {"jax": ref, "port": port, "jax_calls": jax_calls, "port_calls": port_calls}


def test_report_has_the_jax_tools_keys(reports):
    ref, got = reports["jax"], reports["port"]
    assert got.keys() == ref.keys()
    for part in ("deterministic_pass", "stochastic_pass", "summary"):
        assert got[part].keys() == ref[part].keys(), part
    assert got["conditions"] == ref["conditions"] == sorted(
        ["token0", "token3", "token5", "token7", "uniform", "ref_wav"])
    assert got["step"] == ref["step"] == 0 and got["text"] == ref["text"]


def test_deterministic_pass_matches_jax(reports):
    ref, got = reports["jax"]["deterministic_pass"], reports["port"]["deterministic_pass"]
    assert ref["seed_floor_bit_identical"] and got["seed_floor_bit_identical"]
    assert got["seed_floor_mel_l1"] == ref["seed_floor_mel_l1"] == 0.0
    assert got["pairwise"].keys() == ref["pairwise"].keys()
    for pair, want in ref["pairwise"].items():
        assert got["pairwise"][pair]["frame_delta"] == want["frame_delta"], pair
        assert abs(got["pairwise"][pair]["mel_l1"] - want["mel_l1"]) <= MEL_L1_TOL, pair
    for name, want in ref["acoustic_stats"].items():
        assert got["acoustic_stats"][name]["frames"] == want["frames"], name
    assert reports["port"]["summary"]["frame_lengths"] == reports["jax"]["summary"][
        "frame_lengths"]
    # style does something: every pair of one-hot conditions differs
    onehot = [v["mel_l1"] for k, v in got["pairwise"].items()
              if all(n.startswith("token") for n in k.split("|"))]
    assert len(onehot) == 6 and min(onehot) > 0


def test_acoustic_stats_is_the_jax_function(reports):
    jax_calls, port_calls = reports["jax_calls"], reports["port_calls"]
    assert len(jax_calls) == len(port_calls) == 6
    for wav, sr, want in jax_calls:
        assert port_tool.acoustic_stats(wav, sr) == want
        peak = np.abs(wav).max()
        if peak > 0:
            scaled = wav * (0.5 / peak)
            assert port_tool.acoustic_stats(scaled, sr) == jax_tool.acoustic_stats(scaled, sr)
    for (jwav, sr, _), (pwav, _, _) in zip(jax_calls, port_calls):
        assert jwav.shape == pwav.shape
        if len(jwav) >= sr // 10:
            np.testing.assert_allclose(raw_rms_centroid(pwav, sr), raw_rms_centroid(jwav, sr),
                                       rtol=STATS_RTOL)


def test_stochastic_pass_has_a_floor(reports):
    ref, got = reports["jax"]["stochastic_pass"], reports["port"]["stochastic_pass"]
    assert got["pairwise_mel_l1"].keys() == ref["pairwise_mel_l1"].keys()
    assert got["seed_floor_mel_l1_mean_of"] == FLOOR_SEEDS
    assert len(got["seed_floor_values"]) == len(ref["seed_floor_values"]) == FLOOR_SEEDS
    assert got["seed_floor_mel_l1"] > 0 and all(v > 0 for v in got["seed_floor_values"])


def test_style_contrast_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_tool.main(["--workdir", os.path.join(os.path.dirname(__file__), "fixtures",
                                                  "jax_export"),
                        "--out", str(tmp_path / "r.json")])
