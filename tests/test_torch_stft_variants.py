"""K3′ (frequency-split) and K3″ (pre-framed) STFT features, the
``normalize_linear`` flag of all three STFT wrappers, ``KernelDSP`` and every
route of the port's ``DeviceFeatureExtractor``, each against the JAX package
on the same numpy inputs: the Pallas kernels in interpret mode, ``JaxDSP``,
``PallasDSP`` and the JAX extractor's matching route, and the numpy oracle.
Tolerances: 5e-4 in normalized dB where the JAX tests ask it of the kernels
(``tests/test_device_features.py``), 5e-3 for the drop-in DSP
(``tests/test_pallas.py``), and the bf16 budget of ``tests/test_pallas.py``
(error below 0.05 where the reference mel is above 0.5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_tacotron_tpu.config import AudioConfig as JAudioConfig
from gst_tacotron_tpu.dsp import ref as jref
from gst_tacotron_tpu.dsp.device_features import DeviceFeatureExtractor as JExtractor
from gst_tacotron_tpu.dsp.jax_dsp import JaxDSP
from gst_tacotron_tpu.ops.stft_pallas import (PallasDSP, stft_features_pallas,
                                              stft_features_pallas_fused,
                                              stft_features_pallas_resident)
from gst_tacotron_tpu_torch.config import AudioConfig
from gst_tacotron_tpu_torch.dsp import ref as tref
from gst_tacotron_tpu_torch.dsp.device_features import DeviceFeatureExtractor
from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP
from gst_tacotron_tpu_torch.ops import stft as tstft

torch.set_num_threads(2)

# win == n_fft, and win < n_fft (live taps are a strict sub-span)
CONFIGS = [dict(n_fft=512, hop_length=128, win_length=512),
           dict(n_fft=512, hop_length=128, win_length=256)]


def _wav(n=3000, batch=3):
    """tests/test_pallas.py's signal: a tone plus noise."""
    rng = np.random.default_rng(3)
    t = np.arange(n) / 22050
    wav = 0.4 * np.sin(2 * np.pi * 330 * t)[None, :] + 0.05 * rng.standard_normal((batch, n))
    return wav.astype(np.float32)


def _prepped(cfg, wav):
    pad = cfg.n_fft // 2
    pre = np.stack([jref.preemphasis(w.astype(np.float64), cfg.preemphasis) for w in wav])
    return np.pad(pre, ((0, 0), (pad, pad)), mode="reflect").astype(np.float32)


def _close(got, ref, atol):
    for g, r in zip(got, ref):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=atol, rtol=1e-6)


@pytest.mark.parametrize("normalize_linear", [True, False])
@pytest.mark.parametrize("kw", CONFIGS)
def test_fused_plain_matches_pallas_fused(kw, normalize_linear):
    """3000 samples, batch 3: an odd frame count off every tile."""
    jcfg, cfg = JAudioConfig(**kw), AudioConfig(**kw)
    prepped = _prepped(cfg, _wav())
    ref = stft_features_pallas_fused(jnp.asarray(prepped), jcfg, interpret=True,
                                     normalize_linear=normalize_linear)
    got = tstft.stft_features_fused(torch.from_numpy(prepped), cfg,
                                    normalize_linear=normalize_linear)
    assert got[0].shape == (3, 1 + 3000 // 128, cfg.num_mels)
    _close(got, ref, 5e-4)


@pytest.mark.parametrize("kw", CONFIGS)
def test_fused_bf16_bases(kw):
    """bf16 bases: the plain version rounds frames and bases as the JAX
    kernel does (the two agree to float32 sums), and stays within the bf16
    budget of the float32 features on loud bins."""
    jcfg, cfg = JAudioConfig(**kw), AudioConfig(**kw)
    prepped = _prepped(cfg, _wav())
    ref = stft_features_pallas_fused(jnp.asarray(prepped), jcfg, interpret=True,
                                     bf16_bases=True)
    got = tstft.stft_features_fused(torch.from_numpy(prepped), cfg, bf16_bases=True)
    _close(got, ref, 5e-4)
    f32 = np.asarray(JaxDSP(jcfg).features_precentered(jnp.asarray(prepped))[0])
    loud = f32 > 0.5
    assert loud.any()
    assert np.abs(got[0].numpy() - f32)[loud].max() < 0.05


@pytest.mark.parametrize("normalize_linear", [True, False])
@pytest.mark.parametrize("kw", CONFIGS)
def test_frames_plain_matches_pallas_frames(kw, normalize_linear):
    """F = 37 random frames, off the JAX kernel's 128-frame tile."""
    jcfg, cfg = JAudioConfig(**kw), AudioConfig(**kw)
    frames = np.random.default_rng(0).standard_normal((37, cfg.n_fft)).astype(np.float32)
    ref = stft_features_pallas(jnp.asarray(frames), jcfg, interpret=True,
                               normalize_linear=normalize_linear)
    got = tstft.stft_features_frames(torch.from_numpy(frames), cfg,
                                     normalize_linear=normalize_linear)
    assert got[0].shape == (37, cfg.num_mels) and got[1].shape == (37, cfg.num_freq)
    _close(got, ref, 5e-4)


@pytest.mark.parametrize("kw", CONFIGS)
def test_resident_normalize_linear_false(kw):
    """K3's new flag: the raw linear magnitude, the mel still normalized."""
    jcfg, cfg = JAudioConfig(**kw), AudioConfig(**kw)
    prepped = _prepped(cfg, _wav())
    ref = stft_features_pallas_resident(jnp.asarray(prepped), jcfg, interpret=True,
                                        bf16=False, tile_f=8, normalize_linear=False)
    got = tstft.stft_features(torch.from_numpy(prepped), cfg, normalize_linear=False)
    _close(got, ref, 5e-4)
    assert float(got[1].max()) > 1.0          # magnitudes, not normalized dB


@pytest.mark.parametrize("kw", CONFIGS)
def test_kernel_dsp_matches_pallas_dsp_and_jax_dsp(kw):
    jcfg, cfg = JAudioConfig(**kw), AudioConfig(**kw)
    wav = _wav(n=4096, batch=2)
    got = tstft.KernelDSP(cfg, device="cpu").features(torch.from_numpy(wav))
    _close(got, PallasDSP(jcfg, interpret=True).features(jnp.asarray(wav)), 5e-3)
    _close(got, JaxDSP(jcfg).features(jnp.asarray(wav)), 5e-3)
    kd = tstft.KernelDSP(cfg, device="cpu")
    _close((kd.mel_spectrogram(torch.from_numpy(wav)),
            kd.linear_spectrogram(torch.from_numpy(wav))), got, 0.0)


def test_torch_dsp_forward_half_matches_jax_dsp():
    """TorchDSP's framing and forward features against JaxDSP's."""
    kw = CONFIGS[1]
    jd, td = JaxDSP(JAudioConfig(**kw)), TorchDSP(AudioConfig(**kw), "cpu")
    wav = _wav(n=2000, batch=2)
    jw, tw = jnp.asarray(wav), torch.from_numpy(wav)
    np.testing.assert_array_equal(td._frame(tw).numpy(), np.asarray(jd._frame(jw)))
    prepped = _prepped(AudioConfig(**kw), wav)
    np.testing.assert_array_equal(td.frame_precentered(torch.from_numpy(prepped)).numpy(),
                                  np.asarray(jd.frame_precentered(jnp.asarray(prepped))))
    frames = jd._frame(jw)
    _close(td.features_from_frames(torch.from_numpy(np.array(frames))),
           jd.features_from_frames(frames), 5e-4)
    _close(td.features(tw), jd.features(jw), 5e-4)
    _close((td.mel_spectrogram(tw), td.linear_spectrogram(tw)),
           (jd.mel_spectrogram(jw), jd.linear_spectrogram(jw)), 5e-4)
    np.testing.assert_allclose(td.magnitude(tw).numpy(), np.asarray(jd.magnitude(jw)),
                               atol=2e-5)
    spec = td.stft(tw).numpy()
    jspec = np.asarray(jd.stft(jw))
    np.testing.assert_allclose(spec.real, jspec.real, atol=2e-5)
    np.testing.assert_allclose(spec.imag, jspec.imag, atol=2e-5)


# the port's routes and the JAX extractor's matching use_pallas values
ROUTES = [("resident", "resident"), ("fused", "fused"), ("frames", True), (None, False)]


@pytest.mark.parametrize("route,jax_route", ROUTES, ids=lambda r: str(r))
@pytest.mark.parametrize("kw", CONFIGS)
def test_extractor_routes_match_jax_routes_and_oracle(kw, route, jax_route):
    """Every frame of uneven lengths in one batch, the reflect-padded tail
    included (the contract of tests/test_device_features.py)."""
    jcfg, cfg = JAudioConfig(**kw), AudioConfig(**kw)
    rng = np.random.default_rng(1)
    wavs = [rng.uniform(-0.5, 0.5, n).astype(np.float32) for n in (1000, 2500, 700, 1001)]
    jres = JExtractor(jcfg, use_pallas=jax_route, interpret=True, batch_size=4,
                      frame_bucket=8).extract(wavs)
    ex = DeviceFeatureExtractor(cfg, device="cpu", batch_size=4, frame_bucket=8,
                                stft_kernel=route)
    tres = ex.extract(wavs)
    assert ex.plan([1 + len(w) // cfg.hop_length for w in wavs]) == [[0, 2, 3], [1]]
    for wav, jr, tr in zip(wavs, jres, tres):
        _close(tr, jr, 5e-4)
        _close(tr, (tref.melspectrogram(wav, cfg), tref.spectrogram(wav, cfg)), 5e-4)
    # the plain flag runs each kernel route's plain version: the same numbers
    plain = DeviceFeatureExtractor(cfg, device="cpu", batch_size=4, frame_bucket=8,
                                   stft_kernel=route, plain=True).extract(wavs)
    for a, b in zip(tres, plain):
        _close(a, b, 0.0)


def test_extractor_rejects_unknown_route():
    with pytest.raises(ValueError, match="stft_kernel"):
        DeviceFeatureExtractor(AudioConfig(), device="cpu", stft_kernel=True)


def test_host_oracle_matches_jax_oracle():
    """The port's numpy oracle (dsp/ref.py) against the JAX package's."""
    cfg, jcfg = AudioConfig(**CONFIGS[1]), JAudioConfig(**CONFIGS[1])
    rng = np.random.default_rng(4)
    wav = rng.uniform(-0.5, 0.5, 3333).astype(np.float32)
    np.testing.assert_array_equal(tref.frame_signal(wav, 512, 128),
                                  jref.frame_signal(wav, 512, 128))
    np.testing.assert_array_equal(tref.stft(wav, cfg), jref.stft(wav, jcfg))
    np.testing.assert_array_equal(tref.spectrogram(wav, cfg), jref.spectrogram(wav, jcfg))
    np.testing.assert_array_equal(tref.melspectrogram(wav, cfg),
                                  jref.melspectrogram(wav, jcfg))
    x = np.geomspace(1e-7, 10.0, 40)
    np.testing.assert_array_equal(tref.amp_to_db(x), jref.amp_to_db(x))
    s = np.linspace(-120, 10, 40)
    for sym in (False, True):
        np.testing.assert_array_equal(
            tref.normalize_db(s, AudioConfig(symmetric_norm=sym)),
            jref.normalize_db(s, JAudioConfig(symmetric_norm=sym)))
