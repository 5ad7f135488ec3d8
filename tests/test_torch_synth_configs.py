"""The two configurations of this slice end to end on the CPU, at the small
sizes of tests/test_train_smoke.py::small_cfg:

* gst_r1_location (location-sensitive attention, r=1): the port's
  ``Synthesizer`` against the JAX ``Synthesizer`` at
  ``deterministic_prenet=True``, with the same seeded JAX init carried over
  by ``weights.py``, within the golden gate's budgets (mel MAE < 1e-4,
  allclose 1e-3, MCD < 0.1 dB, equal frame lengths; test_torch_synth.py);
* gst_wavernn at the sizes of tests/test_config5_e2e.py: the same JAX mel
  through the flax greedy sampler and the port's gives equal waveforms, and
  the port's ``Synthesizer(vocoder=WaveRNNVocoder)`` gives the shapes and
  the [-1, 1] range the JAX test checks.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_tacotron_tpu.config import apply_overrides as japply
from gst_tacotron_tpu.config import save_config
from gst_tacotron_tpu.models.wavernn import WaveRNN as JWaveRNN
from gst_tacotron_tpu.synthesize import Synthesizer as JSynthesizer
from gst_tacotron_tpu.train import build_model as jbuild
from gst_tacotron_tpu_torch.config import load_config
from gst_tacotron_tpu_torch.synthesize import Synthesizer
from gst_tacotron_tpu_torch.vocoder import WaveRNNVocoder
from gst_tacotron_tpu_torch.weights import build_model, build_wavernn

from tests.test_torch_synth import assert_slice_close
from tests.test_train_smoke import small_cfg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "tools"))
from make_golden_fixtures import _prod_init_variables, flatten_tree  # noqa: E402

torch.set_num_threads(2)

TEXTS = ["location sensitive attention.", "a second, longer sentence of text."]


def reference_wavs(sr, n=2):
    t = np.arange(6000) / sr
    return [(0.3 * np.sin(2 * np.pi * (120 + 40 * i) * t)).astype(np.float32) for i in range(n)]


def both_configs(jcfg, tmp_path):
    """The JAX config with float32 Griffin-Lim and the port's copy of it,
    read back from the same JSON (so both iterate in float32)."""
    jcfg = japply(jcfg, {"audio.griffin_lim_bf16": False})
    path = str(tmp_path / "config.json")
    save_config(jcfg, path)
    return jcfg, load_config(path)


def jax_tacotron(jcfg):
    """The golden_prod fixture's seeded init, traced once (eager flax init
    takes several times longer)."""
    variables = jax.jit(lambda: _prod_init_variables(jcfg)[1])()
    model = jbuild(jcfg)
    flat = flatten_tree({"params": variables["params"],
                         "batch_stats": variables["batch_stats"]})
    return model, variables, flat


def test_gst_r1_location_matches_jax_synthesizer(tmp_path):
    jcfg, cfg = both_configs(small_cfg(
        "gst_r1_location", **{"model.attention.location_filters": 4,
                              "model.attention.location_kernel_size": 7,
                              "model.decoder.stop_threshold": 1.5}), tmp_path)
    assert cfg.model.attention.kind == "location_sensitive"
    assert cfg.model.decoder.reduction_factor == 1
    model, variables, flat = jax_tacotron(jcfg)
    refs = reference_wavs(jcfg.audio.sample_rate)
    ref = JSynthesizer(jcfg, model, variables, deterministic_prenet=True)(
        TEXTS, reference_wavs=refs, seed=0)
    ts = Synthesizer(cfg, build_model(cfg, flat=flat, device="cpu"), device="cpu",
                     deterministic_prenet=True)
    got = ts(TEXTS, reference_wavs=refs, seed=0)
    assert got["mel"].shape == ref["mel"].shape == (2, 10, 80)
    assert_slice_close(got, ref)
    np.testing.assert_allclose(got["alignments"], ref["alignments"], atol=1e-4)


@pytest.fixture(scope="module")
def wavernn_setup(tmp_path_factory):
    jcfg, cfg = both_configs(small_cfg("gst_wavernn", **{
        "model.vocoder.wavernn_gru_dim": 16, "model.vocoder.wavernn_fc_dim": 16,
        "model.vocoder.wavernn_hop": 128, "model.decoder.max_decode_steps": 6}),
        tmp_path_factory.mktemp("cfg"))
    model, variables, flat = jax_tacotron(jcfg)
    jvoc = JWaveRNN(jcfg.model.vocoder, jcfg.model.num_mels)
    hop = jcfg.model.vocoder.wavernn_hop
    vvars = jvoc.init(jax.random.PRNGKey(7), jnp.zeros((1, 2, 80)), jnp.zeros((1, 2 * hop)))
    vflat = flatten_tree({"params": vvars["params"]})
    return jcfg, cfg, model, variables, flat, jvoc, vvars, vflat


def test_gst_wavernn_greedy_samplers_agree_on_the_jax_mel(wavernn_setup):
    jcfg, cfg, model, variables, _, jvoc, vvars, vflat = wavernn_setup
    out = JSynthesizer(jcfg, model, variables, deterministic_prenet=True)(
        TEXTS, reference_wavs=reference_wavs(jcfg.audio.sample_rate), seed=0)
    mel = out["mel"]
    ref = np.asarray(jvoc.apply(vvars, jnp.asarray(mel), jax.random.PRNGKey(0),
                                greedy=True, method=jvoc.sample))
    voc = WaveRNNVocoder(cfg, build_wavernn(cfg, flat=vflat, device="cpu"), device="cpu",
                         greedy=True)
    got = voc({"mel": torch.from_numpy(np.array(mel))}).numpy()
    assert got.shape == ref.shape == (2, 12 * 128)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_gst_wavernn_synthesizer_with_the_wavernn_vocoder(wavernn_setup):
    _, cfg, _, _, flat, _, _, vflat = wavernn_setup
    voc = WaveRNNVocoder(cfg, build_wavernn(cfg, flat=vflat, device="cpu"), device="cpu")
    ts = Synthesizer(cfg, build_model(cfg, flat=flat, device="cpu"), device="cpu", vocoder=voc)
    out = ts(["hello world."], seed=0)
    hop = cfg.audio.hop_length
    r = cfg.model.decoder.reduction_factor
    assert out["wav"].shape == (1, cfg.model.decoder.max_decode_steps * r * hop)
    assert np.all(np.isfinite(out["wav"]))
    assert np.all(np.abs(out["wav"]) <= 1.0)
    assert out["wav_lengths"][0] == out["frame_lengths"][0] * hop
    # the vocoder draws from seed + 104729: the same call repeats, another seed differs
    assert np.array_equal(ts(["hello world."], seed=0)["wav"], out["wav"])
    assert not np.array_equal(ts(["hello world."], seed=1)["wav"], out["wav"])
