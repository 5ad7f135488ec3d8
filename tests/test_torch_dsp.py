"""The port's PyTorch DSP against ``JaxDSP`` (CPU): STFT and its inverse,
Griffin-Lim with momentum in float32 (griffin_lim_bf16=False on both sides)
and with the flag set (both transforms as DFT products on bfloat16 operands
with float32 sums, held to JaxDSP's low-precision forms and to the quality
contract of tests/test_dsp.py::test_griffin_lim_bf16_quality_neutral), the
blockwise inverse preemphasis and the dB companding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from gst_tacotron_tpu.config import AudioConfig as JAudioConfig
from gst_tacotron_tpu.dsp.jax_dsp import JaxDSP
from gst_tacotron_tpu.dsp import jax_dsp
from gst_tacotron_tpu_torch.config import AudioConfig
from gst_tacotron_tpu_torch.dsp import torch_dsp
from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP

torch.set_num_threads(2)

KW = dict(n_fft=512, hop_length=128, win_length=256, griffin_lim_iters=3,
          griffin_lim_momentum=0.99, griffin_lim_bf16=False)


KW_BF16 = {**KW, "griffin_lim_bf16": True}


@pytest.fixture(scope="module")
def dsps():
    return JaxDSP(JAudioConfig(**KW)), TorchDSP(AudioConfig(**KW), "cpu")


@pytest.fixture(scope="module")
def dsps_bf16():
    return JaxDSP(JAudioConfig(**KW_BF16)), TorchDSP(AudioConfig(**KW_BF16), "cpu")


def test_stft_and_inverse(dsps):
    jd, td = dsps
    rng = np.random.default_rng(0)
    wav = rng.uniform(-0.5, 0.5, (2, 128 * 20)).astype(np.float32)
    jre, jim = jd.stft_ri(jnp.asarray(wav))
    re, im = td.stft_ri(torch.from_numpy(wav))
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=2e-5)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=2e-5)
    back = td.istft_ri(re, im)
    np.testing.assert_allclose(back.numpy(), np.asarray(jd.istft_ri(jre, jim)), atol=2e-5)
    # away from the zero-window edges the round trip reproduces the signal
    np.testing.assert_allclose(back.numpy()[:, 256:-256], wav[:, 256:-256], atol=2e-5)


def test_stft_and_inverse_bf16(dsps_bf16):
    """One low-precision pass each way: the same bfloat16 operands (bases
    built float64 -> float32 -> bfloat16 as JAX builds them), float32 sums in
    another order, so within 1e-5 of the output's largest magnitude."""
    jd, td = dsps_bf16
    rng = np.random.default_rng(4)
    wav = rng.uniform(-0.5, 0.5, (2, 128 * 20)).astype(np.float32)
    jre, jim = jd.stft_ri(jnp.asarray(wav), low_precision=True)
    re, im = td.stft_ri(torch.from_numpy(wav), low_precision=True)
    scale = max(np.abs(np.asarray(jre)).max(), np.abs(np.asarray(jim)).max())
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=1e-5 * scale)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=1e-5 * scale)
    jback = np.asarray(jd.istft_ri(jre, jim, low_precision=True))
    back = td.istft_ri(re, im, low_precision=True).numpy()
    np.testing.assert_allclose(back, jback, atol=1e-5 * np.abs(jback).max())
    # the rounding is real: the float32 inverse differs by far more
    assert np.abs(td.istft_ri(re, im).numpy() - back).max() > 1e-4 * np.abs(jback).max()


def test_griffin_lim_bf16_matches_jax(dsps_bf16):
    """Three momentum iterations with the flag set. Both sides round the same
    operands, but a float32 sum taken in another order can land a value on
    the other side of a bfloat16 rounding step at the next iteration: 5e-3 of
    the peak (measured up to 1.5e-3 over three seeds on this CPU)."""
    jd, td = dsps_bf16
    rng = np.random.default_rng(1)
    spect = rng.uniform(0.2, 0.9, (2, 15, 257)).astype(np.float32)
    jwav = np.asarray(jd.inv_linear_spectrogram(jnp.asarray(spect)))
    wav = td.inv_linear_spectrogram(torch.from_numpy(spect)).numpy()
    assert wav.shape == jwav.shape
    np.testing.assert_allclose(wav, jwav, atol=5e-3 * np.abs(jwav).max())


@pytest.mark.parametrize("seed,iters", [(7, 15), (23, 15), (101, 30)])
def test_griffin_lim_bf16_quality_neutral(seed, iters):
    """The port's bf16 iterations against its float32 ones at production
    audio params, on the JAX test's signals: the spectral error within 5% of
    float32's and below 0.25 (tests/test_dsp.py's contract)."""
    from tests.test_dsp import make_wav

    wav = make_wav(np.random.default_rng(seed), n=65536)
    dspf = TorchDSP(AudioConfig(), "cpu")
    mag = dspf.magnitude(torch.from_numpy(wav[None, :].astype(np.float32)))

    def gl_err(bf16):
        d = TorchDSP(AudioConfig(griffin_lim_iters=iters, griffin_lim_momentum=0.99,
                                 griffin_lim_bf16=bf16), "cpu")
        rec = dspf.magnitude(d.griffin_lim(mag))
        return float(torch.linalg.norm(mag - rec) / torch.linalg.norm(mag))

    e32, e16 = gl_err(False), gl_err(True)
    assert e16 < e32 * 1.05, (e16, e32)
    assert e16 < 0.25, e16


def test_features_precentered(dsps):
    jd, td = dsps
    rng = np.random.default_rng(3)
    wav = rng.uniform(-0.5, 0.5, (2, 512 + 128 * 9)).astype(np.float32)
    for got, ref in zip(td.features_precentered(torch.from_numpy(wav)),
                        jd.features_precentered(jnp.asarray(wav))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4)


def test_griffin_lim_and_inverse_spectrogram(dsps):
    jd, td = dsps
    rng = np.random.default_rng(1)
    spect = rng.uniform(0.2, 0.9, (2, 15, 257)).astype(np.float32)
    jwav = np.asarray(jd.inv_linear_spectrogram(jnp.asarray(spect)))
    wav = td.inv_linear_spectrogram(torch.from_numpy(spect)).numpy()
    assert wav.shape == jwav.shape
    scale = np.abs(jwav).max()
    np.testing.assert_allclose(wav, jwav, atol=1e-4 * scale)


def test_inv_preemphasis_blockwise(dsps):
    jd, td = dsps
    rng = np.random.default_rng(2)
    n = 3 * torch_dsp.IIR_BLOCK + 37     # several blocks and a ragged tail
    wav = rng.uniform(-1, 1, (2, n)).astype(np.float32)
    got = td.inv_preemphasis(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, np.asarray(jd.inv_preemphasis(jnp.asarray(wav))),
                               atol=2e-5)
    np.testing.assert_allclose(got, sps.lfilter([1.0], [1.0, -0.97], wav, axis=1), atol=2e-5)
    pre = td.preemphasis(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(pre, np.asarray(jd.preemphasis(jnp.asarray(wav))), atol=1e-6)


@pytest.mark.parametrize("symmetric", [False, True])
def test_companding(symmetric):
    jcfg = JAudioConfig(symmetric_norm=symmetric)
    cfg = AudioConfig(symmetric_norm=symmetric)
    x = np.geomspace(1e-7, 10.0, 50).astype(np.float32)
    db = torch_dsp.amp_to_db(torch.from_numpy(x))
    np.testing.assert_allclose(db.numpy(), np.asarray(jax_dsp.amp_to_db(jnp.asarray(x))),
                               atol=1e-4)
    s = np.linspace(-120, 10, 50).astype(np.float32)
    n = torch_dsp.normalize_db(torch.from_numpy(s), cfg)
    np.testing.assert_allclose(n.numpy(), np.asarray(jax_dsp.normalize_db(jnp.asarray(s), jcfg)),
                               atol=1e-6)
    d = torch_dsp.denormalize_db(n, cfg)
    np.testing.assert_allclose(
        d.numpy(), np.asarray(jax_dsp.denormalize_db(jax_dsp.normalize_db(jnp.asarray(s), jcfg),
                                                     jcfg)), atol=1e-4)
    np.testing.assert_allclose(torch_dsp.db_to_amp(torch.from_numpy(s)).numpy(),
                               np.asarray(jax_dsp.db_to_amp(jnp.asarray(s))), rtol=1e-5)
