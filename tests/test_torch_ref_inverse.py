"""The inverse half of the port's host DSP (``dsp/ref.py``: ``istft``,
``griffin_lim``, ``inv_preemphasis``, ``db_to_amp``, ``denormalize_db``,
``inv_spectrogram``) and ``dsp/mel.py::mel_pseudo_inverse`` against the
JAX package's copies, in float64 on the same inputs, as tests/test_dsp.py
holds its own (the host Griffin-Lim is the reference-style bench's
vocoder)."""

import numpy as np
import pytest
from scipy import signal as sps

from gst_tacotron_tpu.config import AudioConfig as JAudioConfig
from gst_tacotron_tpu.dsp import mel as jmel
from gst_tacotron_tpu.dsp import ref as jref
from gst_tacotron_tpu_torch.config import AudioConfig
from gst_tacotron_tpu_torch.dsp import mel, ref

SMALL = dict(n_fft=512, hop_length=128, win_length=400, griffin_lim_iters=4)


def wav_of(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050
    return (0.5 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("length", [None, 5000, 7000])
def test_istft_matches_jax(length):
    cfg, jcfg = AudioConfig(**SMALL), JAudioConfig(**SMALL)
    spec = jref.stft(wav_of(), jcfg)
    np.testing.assert_array_equal(ref.istft(spec, cfg, length=length),
                                  jref.istft(spec, jcfg, length=length))
    full = AudioConfig(**{**SMALL, "win_length": 512})      # the window covers every sample
    x = wav_of(n=6144)                                       # whole hops
    rec = ref.istft(ref.stft(x, full), full, length=len(x))
    np.testing.assert_allclose(rec, x.astype(np.float64), atol=1e-9)


def test_griffin_lim_matches_jax():
    cfg, jcfg = AudioConfig(**SMALL), JAudioConfig(**SMALL)
    mag = np.abs(jref.stft(wav_of(), jcfg))
    np.testing.assert_allclose(ref.griffin_lim(mag, cfg, seed=3),
                               jref.griffin_lim(mag, jcfg, seed=3), rtol=0, atol=1e-12)


def test_inv_preemphasis_matches_jax_and_inverts():
    x = wav_of().astype(np.float64)
    np.testing.assert_array_equal(ref.inv_preemphasis(x, 0.97), jref.inv_preemphasis(x, 0.97))
    np.testing.assert_allclose(ref.inv_preemphasis(ref.preemphasis(x, 0.97), 0.97), x,
                               atol=1e-12)
    np.testing.assert_allclose(ref.inv_preemphasis(x, 0.97),
                               sps.lfilter([1.0], [1.0, -0.97], x), atol=0)


@pytest.mark.parametrize("symmetric", [True, False])
def test_db_maps_match_jax(symmetric):
    cfg = AudioConfig(symmetric_norm=symmetric)
    jcfg = JAudioConfig(symmetric_norm=symmetric)
    s = np.linspace(-6.0, 6.0, 101)
    np.testing.assert_array_equal(ref.denormalize_db(s, cfg), jref.denormalize_db(s, jcfg))
    np.testing.assert_array_equal(ref.db_to_amp(s * 10), jref.db_to_amp(s * 10))
    db = np.linspace(-100.0, 0.0, 41)
    np.testing.assert_allclose(ref.denormalize_db(ref.normalize_db(db, cfg), cfg), db,
                               atol=1e-9)


def test_inv_spectrogram_matches_jax():
    cfg, jcfg = AudioConfig(**SMALL), JAudioConfig(**SMALL)
    lin = jref.spectrogram(wav_of(), jcfg)
    got = ref.inv_spectrogram(lin, cfg, seed=1)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jref.inv_spectrogram(lin, jcfg, seed=1))


def test_mel_pseudo_inverse_matches_jax():
    basis = jmel.mel_filterbank(22050, 1024, 80, 0.0, 8000.0)
    got = mel.mel_pseudo_inverse(basis)
    np.testing.assert_array_equal(got, jmel.mel_pseudo_inverse(basis))
    assert got.shape == (513, 80) and got.dtype == np.float32
    np.testing.assert_allclose(basis @ got.astype(np.float64) @ basis, basis, atol=1e-5)
