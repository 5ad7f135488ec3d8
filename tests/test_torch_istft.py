"""The inverse DSP's last pieces against ``JaxDSP`` (CPU): ``TorchDSP.istft``
of a complex spectrogram against both of JaxDSP's routes (``use_fft`` True
and False), within 1e-5, with the output length hop * (T - 1); the inverse
of the port's own STFT within 1e-5; ``num_frames_for`` and ``frame_indices`` against the JAX
functions, exactly; and the exports of ``gst_tacotron_tpu_torch.dsp``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_tacotron_tpu.config import AudioConfig as JAudioConfig
from gst_tacotron_tpu.dsp import jax_dsp
from gst_tacotron_tpu_torch import dsp as tdsp
from gst_tacotron_tpu_torch.config import AudioConfig
from gst_tacotron_tpu_torch.dsp.torch_dsp import TorchDSP, frame_indices, num_frames_for

torch.set_num_threads(2)

KW = [dict(n_fft=512, hop_length=128, win_length=256),
      dict(n_fft=600, hop_length=150, win_length=600)]


def spectrogram(rng, b, t, nf):
    re, im = rng.normal(0, 1, (2, b, t, nf)).astype(np.float32)
    return re, im


@pytest.mark.parametrize("kw", KW, ids=["512", "600"])
@pytest.mark.parametrize("use_fft", [True, False])
def test_istft_matches_jax_both_routes(kw, use_fft):
    jd = jax_dsp.JaxDSP(JAudioConfig(**kw), use_fft=use_fft)
    td = TorchDSP(AudioConfig(**kw), "cpu")
    re, im = spectrogram(np.random.default_rng(0), 2, 9, jd.cfg.num_freq)
    ref = np.asarray(jd.istft(jnp.asarray(re) + 1j * jnp.asarray(im)))
    got = td.istft(torch.complex(torch.from_numpy(re), torch.from_numpy(im))).numpy()
    assert got.shape == ref.shape == (2, kw["hop_length"] * 8)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_istft_inverts_the_stft():
    td = TorchDSP(AudioConfig(**KW[0]), "cpu")
    wav = torch.from_numpy(np.random.default_rng(1).normal(0, 0.3, (2, 128 * 12))
                           .astype(np.float32))
    a = td.istft(td.stft(wav))
    n = a.shape[1]
    torch.testing.assert_close(a, wav[:, :n], rtol=0, atol=1e-5)


@pytest.mark.parametrize("samples", [512, 513, 1000, 4096])
def test_frame_helpers_match_jax(samples):
    for n_fft, hop in ((512, 128), (400, 100)):
        np.testing.assert_array_equal(frame_indices(samples, n_fft, hop),
                                      jax_dsp.frame_indices(samples, n_fft, hop))
    assert num_frames_for(samples, AudioConfig(**KW[0])) == \
        jax_dsp.num_frames_for(samples, JAudioConfig(**KW[0]))


def test_dsp_package_exports():
    for name in ("TorchDSP", "num_frames_for", "frame_indices", "mel_filterbank",
                 "mulaw_encode", "mulaw_decode", "normalize_db", "denormalize_db"):
        assert name in tdsp.__all__ and hasattr(tdsp, name), name
